"""PyTorch port, fanout-one push-sum over the gather-inverted delivery
(``--delivery invert``, ``received_by_inversion``): the received sums,
the rounds and whole runs bitwise the JAX package's on the CPU
(tolerance 0), on a graph without and one with birth exclusions; the
preconditions (dense table, symmetric graph, component-closed dead set)
with the JAX package's messages."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.protocols import gossip as jg
from gossipprotocol_tpu.protocols import pushsum as jp
from gossipprotocol_tpu.protocols import state as jst

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.engine.driver import require_invertible
from gossipprotocol_tpu_torch.protocols import gossip as tg
from gossipprotocol_tpu_torch.protocols import pushsum as tp
from gossipprotocol_tpu_torch.protocols import state as tst
from gossipprotocol_tpu_torch.protocols.sampling import fold_in, key_data


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


def _same(a, b) -> bool:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


_GRAPHS = {"imp3D": ("imp3D", 216, {"seed": 4}),
           "er": ("er", 400, {"seed": 5, "avg_degree": 3.0})}


def _pair(graph):
    name, n, kw = _GRAPHS[graph]
    return jx.build_topology(name, n, **kw), tx.build_topology(name, n, **kw)


@pytest.mark.parametrize("rnd", [0, 9])
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_received_by_inversion_bitwise(graph, rnd):
    tj, tt = _pair(graph)
    n = tt.num_nodes
    rng = np.random.default_rng(rnd)
    s = rng.standard_normal(n).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    kt = fold_in(key_data(3, "cpu"), rnd)
    kj = jax.random.fold_in(jax.random.key(3), rnd)
    a = tp.received_by_inversion(tg.inverted_dense(tt, device="cpu"), kt,
                                 torch.from_numpy(s), torch.from_numpy(w))
    b = jp.received_by_inversion(jg.inverted_dense(tj), kj, s, w)
    assert _same(a[0], b[0]) and _same(a[1], b[1])


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_round_bitwise(graph):
    tj, tt = _pair(graph)
    n = tt.num_nodes
    alive = tt.birth_alive()
    all_alive = alive is None
    sj, st = jst.pushsum_init(n), tst.pushsum_init(n, device="cpu")
    if not all_alive:
        sj = sj._replace(alive=sj.alive & alive)
        st = st._replace(alive=torch.from_numpy(np.array(alive)))
    nj, nt = jg.inverted_dense(tj), tg.inverted_dense(tt, device="cpu")
    for _ in range(30):
        sj = jp.pushsum_round(sj, nj, jax.random.key(7), n=n,
                              all_alive=all_alive, targets_alive=True,
                              delivery="invert")
        st = tp.pushsum_round(st, nt, key_data(7, "cpu"), n=n,
                              all_alive=all_alive, targets_alive=True,
                              delivery="invert")
        for f in ("s", "w", "ratio", "streak", "converged"):
            assert _same(getattr(st, f), getattr(sj, f)), f


@pytest.mark.parametrize("predicate", ["delta", "global"])
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_run_matches_jax(graph, predicate):
    kw = dict(algorithm="push-sum", delivery="invert", predicate=predicate,
              eps=1e-7, tol=1e-3, seed=2, max_rounds=600)
    tj, tt = _pair(graph)
    rj = jx.run_simulation(tj, jx.RunConfig(**kw))
    rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", **kw))
    assert rt.converged == rj.converged
    if predicate == "delta":
        assert rt.rounds == rj.rounds
        for f in rt.final_state._fields:
            assert _same(getattr(rt.final_state, f),
                         getattr(rj.final_state, f)), f
    else:
        # the global mean's order (ROADMAP Queue 3): a streak can flip at
        # tol's border
        assert abs(rt.rounds - rj.rounds) <= 1


def test_invert_equals_scatter_rounds_on_card_contract():
    """Where every send lands, the inverted delivery delivers the
    scatter's multiset of messages: equal to it up to accumulation
    order (relative 1e-5 after 20 rounds)."""
    tt = tx.build_topology("imp3D", 216, seed=4)
    kw = dict(algorithm="push-sum", device="cpu", max_rounds=20,
              eps=0.0)
    a = tx.run_simulation(tt, tx.RunConfig(delivery="invert", **kw))
    b = tx.run_simulation(tt, tx.RunConfig(**kw))
    np.testing.assert_allclose(a.final_state.s.numpy(),
                               b.final_state.s.numpy(), rtol=1e-5)


def test_require_invertible_messages():
    from gossipprotocol_tpu.engine.driver import (
        require_invertible as jax_require,
    )

    for name, n in (("power_law", 100), ("full", 16)):
        with pytest.raises(ValueError) as et:
            require_invertible(tx.build_topology(name, n))
        with pytest.raises(ValueError) as ej:
            jax_require(jx.build_topology(name, n))
        assert str(et.value) == str(ej.value)


def test_faulted_invert_rejected():
    from gossipprotocol_tpu_torch.utils import faults as tf

    with pytest.raises(ValueError, match="delivery='invert' is exact only"):
        tx.RunConfig(device="cpu", algorithm="push-sum", delivery="invert",
                     fault_schedule=tf.build_schedule(
                         64, fail_fraction=0.1, fail_round=2))


def test_cli_invert_runs(capsys):
    rc = torch_main(["216", "imp3D", "push-sum", "--delivery", "invert",
                     "--predicate", "global", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "converged: True" in out
