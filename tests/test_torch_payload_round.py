"""PyTorch port, vector payloads in the fanout-all round: the port's
pallas and routed rounds with a ``[n, d]`` payload (synchronous and
Poisson clocks, all-alive and an arbitrary dead set) against the JAX
package's round over its fused gather delivery in interpret mode (which
its own tests hold bitwise to its routed delivery), each round bitwise
(tolerance 0), and whole engine runs with the same rounds and bitwise
final state."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.ops.pallasdelivery import build_pallas_delivery
from gossipprotocol_tpu.protocols import diffusion as jd
from gossipprotocol_tpu.protocols import state as jst

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.convert import state_from_numpy
from gossipprotocol_tpu_torch.ops import delivery as tdel
from gossipprotocol_tpu_torch.ops.pallasdelivery import (
    build_pallas_delivery as torch_build_pallas,
)
from gossipprotocol_tpu_torch.protocols import diffusion as td
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


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    if a.dtype == np.float64:
        return a.view(np.uint64)
    return a


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


_GRAPHS = {"imp3D": ("imp3D", 216, {"seed": 4}),
           "powerlaw": ("powerlaw", 400, {"seed": 3, "m": 3})}
_built: dict = {}


def _deliveries(graph):
    """(port pallas, port routed, JAX pallas) of one graph."""
    if graph not in _built:
        name, n, kw = _GRAPHS[graph]
        tj, tt = jx.build_topology(name, n, **kw), tx.build_topology(
            name, n, **kw)
        _built[graph] = (
            torch_build_pallas(tt, device="cpu"),
            tdel.build_routed_delivery(tt, device="cpu"),
            build_pallas_delivery(tj))
    return _built[graph]


def _carried(js):
    return state_from_numpy(*[np.asarray(getattr(js, f)) for f in (
        "s", "w", "ratio", "streak", "converged", "alive", "round")],
        device="cpu")


@pytest.mark.parametrize("clock", [(), (1.0, 1)], ids=["sync", "poisson"])
@pytest.mark.parametrize("d", [3, 16])
def test_vector_round_bitwise(d, clock):
    """Eight fanout-all rounds of a d-column payload through pallas and
    routed, each round bitwise the JAX round (the global predicate's
    streak included)."""
    tp, tr, jr = _deliveries("imp3D")
    n = tp.n
    js = jst.pushsum_init(n, payload_dim=d)
    ts = {"pallas": _carried(js), "routed": _carried(js)}
    key_j, key_t = jax.random.key(5), key_data(5, "cpu")
    for _ in range(8):
        js = jd.pushsum_diffusion_round_routed(
            js, jr, key_j, n=n, all_alive=True, predicate="global",
            tol=1e-3, interpret=True, clock=clock)
        for name, dl in (("pallas", tp), ("routed", tr)):
            st = ts[name]
            ts[name] = td.pushsum_diffusion_round_routed(
                st, dl, fold_in(key_t, st.round), all_alive=True,
                predicate="global", tol=1e-3, clock=clock)
            for f in ("s", "w", "ratio", "streak", "converged"):
                assert _same(getattr(ts[name], f), getattr(js, f)), (name, f)


def test_vector_round_dead_set_bitwise():
    """The general dead-set path (live-degree matvec) with a vector
    payload."""
    tp, _tr, jr = _deliveries("powerlaw")
    n = tp.n
    alive = np.random.default_rng(2).random(n) > 0.15
    js = jst.pushsum_init(n, payload_dim=3)._replace(alive=jnp.asarray(alive))
    ts = _carried(js)
    for _ in range(6):
        js = jd.pushsum_diffusion_round_routed(
            js, jr, jax.random.key(0), n=n, interpret=True)
        ts = td.pushsum_diffusion_round_routed(ts, tp)
        for f in ("s", "w", "ratio", "streak", "converged"):
            assert _same(getattr(ts, f), getattr(js, f)), f


@pytest.mark.parametrize("delivery", ["pallas", "routed"])
def test_run_vector_payload_matches_jax(delivery):
    """A whole run, d = 4, the port's pallas and routed engines against
    the JAX engine's pallas run: same rounds, bitwise final state."""
    kw = dict(algorithm="push-sum", fanout="all", payload_dim=4,
              predicate="global", tol=1e-4, max_rounds=40, chunk_rounds=8)
    name, n, gkw = _GRAPHS["imp3D"]
    rj = _run_jax(name, n, gkw, kw)
    rt = tx.run_simulation(tx.build_topology(name, n, **gkw), tx.RunConfig(
        device="cpu", delivery=delivery, plan_cache="none", **kw))
    assert rt.rounds == rj.rounds and rt.converged == rj.converged
    for f in ("s", "w", "ratio", "streak"):
        assert _same(getattr(rt.final_state, f), getattr(rj.final_state, f))


_jax_runs: dict = {}


def _run_jax(name, n, gkw, kw):
    key = (name, n, tuple(sorted(kw.items())))
    if key not in _jax_runs:
        _jax_runs[key] = jx.run_simulation(
            jx.build_topology(name, n, **gkw),
            jx.RunConfig(delivery="pallas", plan_cache="none", **kw))
    return _jax_runs[key]
