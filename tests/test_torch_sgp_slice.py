"""PyTorch port, the slice as a whole: SGP (``--workload sgp``) at
``--payload-dim 16 --sgp-samples 8`` on imp3D 216, fanout-all push-sum
over the fused gather and the routed deliveries, against the JAX
engine's run over its fused gather delivery in interpret mode (which its
own tests hold bitwise to its routed run) for a capped 24 rounds: the
same rounds, ``w`` bitwise (the learner moves only ``s``), ``s``, the
ratio and the train loss within 1e-5 (the learner's batched products
are XLA CPU's library dot on the JAX side); the port's pallas and routed
runs bitwise equal to each other, with 9 matvec calls a round."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import gossipprotocol_tpu as jx

import gossipprotocol_tpu_torch as tx


@pytest.fixture(scope="module", autouse=True)
def _one_openmp_thread():
    """This module's OpenMP code (torch's CPU kernels) runs on one
    thread, restored afterwards: once a process has run a parallel region
    on several threads, GNU OpenMP waits forever in a child forked from
    it, and the JAX package's shard builds fork their workers, so a later
    test of that kind in this test worker would hang."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_KW = dict(algorithm="push-sum", fanout="all", workload="sgp",
           payload_dim=16, sgp_samples=8, predicate="global", tol=1e-3,
           seed=1, max_rounds=24, chunk_rounds=8, plan_cache="none")
_runs: dict = {}


def _run(side, delivery):
    if (side, delivery) not in _runs:
        if side == "jax":
            _runs[side, delivery] = jx.run_simulation(
                jx.build_topology("imp3D", 216, seed=4),
                jx.RunConfig(delivery=delivery, **_KW))
        else:
            _runs[side, delivery] = tx.run_simulation(
                tx.build_topology("imp3D", 216, seed=4),
                tx.RunConfig(device="cpu", delivery=delivery, **_KW))
    return _runs[side, delivery]


@pytest.mark.parametrize("delivery", ["pallas", "routed"])
def test_slice_matches_jax(delivery):
    rj, rt = _run("jax", "pallas"), _run("port", delivery)
    assert rt.rounds == rj.rounds == 24
    st, sj = rt.final_state, rj.final_state
    assert st.s.shape == (216, 16)
    assert st.w.numpy().tobytes() == np.asarray(sj.w).tobytes()
    for f in ("s", "ratio"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(sj, f)), atol=1e-5)
    np.testing.assert_allclose(float(st.loss), float(np.asarray(sj.loss)),
                               rtol=1e-5)
    losses = [m["train_loss"] for m in rt.metrics if "train_loss" in m]
    assert len(losses) == 3 and losses[-1] == float(st.loss)


def test_pallas_equals_routed_bitwise():
    a, b = _run("port", "pallas").final_state, _run("port",
                                                    "routed").final_state
    for f in a._fields:
        assert getattr(a, f).numpy().tobytes() == \
            getattr(b, f).numpy().tobytes(), f


def test_matvec_calls_per_round():
    """ceil((16 + 1) / 2) = 9 calls of the delivery's matvec a round."""
    from gossipprotocol_tpu_torch.ops.pallasdelivery import PallasDelivery

    calls = []
    orig = PallasDelivery.matvec

    def counted(self, xs, xw, plain=False):
        calls.append(1)
        return orig(self, xs, xw, plain)

    PallasDelivery.matvec = counted
    try:
        kw = dict(_KW, max_rounds=3, chunk_rounds=1)
        tx.run_simulation(tx.build_topology("imp3D", 216, seed=4),
                          tx.RunConfig(device="cpu", delivery="pallas", **kw))
    finally:
        PallasDelivery.matvec = orig
    # warm-up chunk (1 round) + 3 rounds
    assert len(calls) == 9 * 4
