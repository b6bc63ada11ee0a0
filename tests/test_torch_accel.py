"""PyTorch port, accelerated averaging (``protocols/accel.py``): the
Chebyshev and EPD rounds bitwise the JAX package's on the CPU (tolerance
0, 30 rounds, scalar and vector payloads; XLA's fused multiply-adds in
``a·Wx + b·x_prev`` and ``1 − (γ²/4)·ω`` replayed), ``estimate_gamma``
equal (host float64), whole runs with the same rounds and bitwise state,
and the config's rejections with the JAX package's messages."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.protocols import accel as ja
from gossipprotocol_tpu.protocols import diffusion as jd

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.convert import accel_state_from_numpy
from gossipprotocol_tpu_torch.protocols import accel as ta
from gossipprotocol_tpu_torch.protocols import diffusion as td


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


_GRAPHS = {"imp3D": ("imp3D", 216, {"seed": 4}), "line": ("line", 64, {}),
           "powerlaw": ("powerlaw", 300, {"seed": 2})}
_FIELDS = ("s", "w", "ratio", "streak", "converged", "alive", "round",
           "s_prev", "w_prev", "omega")


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_estimate_gamma_equal(graph):
    name, n, kw = _GRAPHS[graph]
    assert ta.estimate_gamma(tx.build_topology(name, n, **kw)) == \
        ja.estimate_gamma(jx.build_topology(name, n, **kw))
    assert ta.estimate_gamma(tx.build_topology("full", 16)) == 0.0


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("variant", ["epd", "chebyshev"])
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_round_bitwise(graph, variant, d):
    name, n, kw = _GRAPHS[graph]
    tj, tt = jx.build_topology(name, n, **kw), tx.build_topology(name, n,
                                                                 **kw)
    gamma = ja.estimate_gamma(tj) if variant == "chebyshev" else 0.0
    sj = ja.accel_init(n, payload_dim=d)
    st = ta.accel_init(n, device="cpu", payload_dim=d)
    ej, et = jd.diffusion_edges(tj), td.diffusion_edges(tt, device="cpu")
    for _ in range(30):
        sj = ja.accel_round(sj, ej, jax.random.key(0), n=n, variant=variant,
                            gamma=gamma, all_alive=True, eps=1e-6)
        st = ta.accel_round(st, et, n=n, variant=variant, gamma=gamma,
                            all_alive=True, eps=1e-6)
        for f in _FIELDS:
            assert _same(getattr(st, f), getattr(sj, f)), f


@pytest.mark.parametrize("accel,lam", [("epd", None), ("chebyshev", None),
                                       ("chebyshev", 0.95)])
def test_run_matches_jax(accel, lam):
    kw = dict(algorithm="push-sum", fanout="all", accel=accel,
              accel_lambda=lam, eps=1e-7, max_rounds=400, chunk_rounds=16)
    rj = jx.run_simulation(jx.build_topology("line", 64),
                           jx.RunConfig(**kw))
    rt = tx.run_simulation(tx.build_topology("line", 64),
                           tx.RunConfig(device="cpu", **kw))
    assert rt.rounds == rj.rounds and rt.converged == rj.converged
    for f in _FIELDS:
        assert _same(getattr(rt.final_state, f),
                     getattr(rj.final_state, f)), f


def test_chebyshev_beats_plain():
    kw = dict(algorithm="push-sum", fanout="all", predicate="global",
              tol=1e-4, max_rounds=20000, device="cpu")
    topo = tx.build_topology("line", 50)
    plain = tx.run_simulation(topo, tx.RunConfig(**kw))
    cheb = tx.run_simulation(topo, tx.RunConfig(accel="chebyshev", **kw))
    assert cheb.converged and cheb.rounds * 2 <= plain.rounds


def test_carried_state_continues_bitwise():
    """A JAX accelerated state carried across continues bitwise."""
    tj = jx.build_topology("line", 64)
    kw = dict(algorithm="push-sum", fanout="all", accel="epd",
              chunk_rounds=8)
    mid = jx.run_simulation(tj, jx.RunConfig(max_rounds=8, **kw))
    end = jx.run_simulation(tj, jx.RunConfig(max_rounds=24, **kw))
    carried = accel_state_from_numpy(*[np.asarray(getattr(
        mid.final_state, f)) for f in _FIELDS], device="cpu")
    rt = tx.run_simulation(tx.build_topology("line", 64),
                           tx.RunConfig(device="cpu", max_rounds=24, **kw),
                           initial_state=carried)
    for f in _FIELDS:
        assert _same(getattr(rt.final_state, f), getattr(end.final_state, f))
    with pytest.raises(ValueError, match="omega"):
        accel_state_from_numpy(*[np.asarray(getattr(mid.final_state, f))
                                 for f in _FIELDS[:-1]], np.float64(0),
                               device="cpu")


@pytest.mark.parametrize("kw", [
    dict(algorithm="push-sum", accel="epd"),
    dict(algorithm="push-sum", fanout="all", delivery="pallas",
         accel="epd"),
    dict(algorithm="push-sum", fanout="all", accel="chebyshev",
         accel_lambda=1.0),
    dict(algorithm="push-sum", fanout="all", accel="quadratic"),
    dict(algorithm="push-sum", fanout="all", accel="epd",
         repair="rewire"),
])
def test_config_rejections_match_jax(kw):
    with pytest.raises(ValueError) as ej:
        jx.RunConfig(**kw)
    with pytest.raises(ValueError) as et:
        tx.RunConfig(device="cpu", **kw)
    assert str(et.value) == str(ej.value)


def test_accel_with_faults_rejected():
    from gossipprotocol_tpu.utils import faults as jf

    from gossipprotocol_tpu_torch.utils import faults as tf

    kw = dict(algorithm="push-sum", fanout="all", accel="epd")
    with pytest.raises(ValueError) as ej:
        jx.RunConfig(fault_schedule=jf.build_schedule(
            64, fail_fraction=0.1, fail_round=2), **kw)
    with pytest.raises(ValueError) as et:
        tx.RunConfig(device="cpu", fault_schedule=tf.build_schedule(
            64, fail_fraction=0.1, fail_round=2), **kw)
    assert str(et.value) == str(ej.value)
