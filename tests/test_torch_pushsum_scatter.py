"""PyTorch port, fanout-one push-sum over the scatter delivery
(protocols/pushsum.py ``pushsum_round_core``): bitwise the JAX package's
``pushsum_round`` on the CPU.

The one order that could differ is the scatter-add's. The JAX package's
text sums the messages into zeros (``segment_sum``) and adds the sum to
``s - s_sent``; XLA on the CPU rewrites that into a scatter of each
message straight onto ``s - s_sent``, in ascending sender order (held by
``test_xla_scatters_onto_the_addend``). The port's round does the same
with ``index_add_``, whose CPU loop adds in ascending index order (held
by ``test_index_add_sums_in_segment_sum_order``), so the trajectories
are bitwise equal. ``s * 0.5`` is exact and ``s - s*0.5`` equals
``s*0.5`` exactly, so a contraction by XLA changes nothing there. On the
card the float adds are atomics (equal up to accumulation order;
``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` (j)).

Under ``--predicate global`` the mean of the healthy rows is a float sum
over all nodes, taken in torch's order here and in XLA's there, so the
two means can differ by an ulp. It feeds only the streak: s, w and ratio
stay bitwise equal, and streak and converged are held equal on every
node whose ``|ratio - mean|`` stays more than 4 ulps of the mean away
from ``tol`` (ROADMAP.md Queue 3).

The JAX package's own CPU golden push-sum table (``tests/test_golden.py``
``GOLDEN_PUSHSUM["cpu"]``) was recorded under an XLA that kept the text's
order; under the installed one the JAX package itself misses four of its
six entries. The port is held to the installed JAX package's rounds at
those six graphs instead."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.engine import driver as jdriver
from gossipprotocol_tpu.protocols.state import pushsum_init as jax_init

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.convert import state_from_numpy
from gossipprotocol_tpu_torch.engine import driver as tdriver
from gossipprotocol_tpu_torch.protocols import sampling as ts
from gossipprotocol_tpu_torch.protocols.pushsum import pushsum_round


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


_GRAPHS = {
    "line": ("line", 200, {}),
    "full": ("full", 300, {}),
    "imp3D": ("imp3D", 512, {"seed": 2}),
    "er": ("erdos_renyi", 700, {"seed": 5, "avg_degree": 3.0}),
    "powerlaw": ("power_law", 400, {"seed": 3}),
}
_FIELDS = ("s", "w", "ratio", "streak", "converged", "alive")


def _topos(graph):
    name, n, kw = _GRAPHS[graph]
    return jx.build_topology(name, n, **kw), tx.build_topology(name, n, **kw)


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_states_equal(tstate, jstate, where=""):
    for f in _FIELDS:
        a, b = _bits(getattr(tstate, f)), _bits(getattr(jstate, f))
        assert a.shape == b.shape and np.array_equal(a, b), (f, where)
    assert int(tstate.round) == int(np.asarray(jstate.round)), where


def _carry(js):
    return state_from_numpy(*[np.asarray(getattr(js, f))
                              for f in _FIELDS + ("round",)], device="cpu")


def test_index_add_sums_in_segment_sum_order():
    """Many messages per target, values of mixed magnitude: any other
    summation order would change the last bits."""
    rng = np.random.default_rng(0)
    n = 20_000
    t = rng.integers(0, n // 50, n).astype(np.int32)
    v = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, t: jax.ops.segment_sum(
        v, t, num_segments=n // 50))(v, t))
    got = torch.zeros(n // 50).index_add_(0, torch.from_numpy(t),
                                          torch.from_numpy(v))
    assert np.array_equal(_bits(got), want.view(np.uint32))
    serial = np.zeros(n // 50, np.float32)
    np.add.at(serial, t, v)
    assert np.array_equal(_bits(got), serial.view(np.uint32))


def test_xla_scatters_onto_the_addend():
    """The JAX package's round, its ``s - s_sent + in_s`` as XLA on the
    CPU runs it: bitwise a scatter onto ``s - s_sent``, and not the text's
    order (a recorded departure, ROADMAP.md Queue 3; line 200, seed 0,
    round 1: 6 of 200 nodes differ by an ulp)."""
    from gossipprotocol_tpu.protocols import sampling as js

    tj, _ = _topos("line")
    cj = jx.RunConfig(algorithm="push-sum", fanout="one", seed=0)
    sj, core_j, _, _, _ = jdriver.build_protocol(tj, cj)
    nj = jdriver.device_arrays(tj, cj)
    got = np.asarray(core_j(sj, nj, jax.random.key(0)).s)
    t, v = js.sample_neighbors(nj, 200, jax.random.fold_in(
        jax.random.key(0), 0))
    s = np.asarray(sj.s)
    sent = np.where(np.asarray(v), s * np.float32(0.5), np.float32(0))
    onto = s - sent
    np.add.at(onto, np.asarray(t), sent)
    summed = np.zeros_like(s)
    np.add.at(summed, np.asarray(t), sent)
    assert np.array_equal(got.view(np.uint32), onto.view(np.uint32))
    assert not np.array_equal(got.view(np.uint32),
                              ((s - sent) + summed).view(np.uint32))


@pytest.mark.parametrize("predicate", ["delta", "global"])
@pytest.mark.parametrize("seed", [0, 9])
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_trajectory_bitwise_40_rounds(graph, seed, predicate):
    """40 rounds of the port's round against the JAX package's, state
    compared after every round (the ER graph runs the masked
    ``targets_alive`` round)."""
    tj, tt = _topos(graph)
    tol = 1e-3
    kw = dict(algorithm="push-sum", seed=seed, predicate=predicate, tol=tol)
    cj = jx.RunConfig(**kw)
    ct = tx.RunConfig(device="cpu", **kw)
    sj, core_j, _, _, flags_j = jdriver.build_protocol(tj, cj)
    st, core_t, _, flags_t = tdriver.build_protocol(tt, ct)
    assert flags_t == flags_j
    nj = jdriver.device_arrays(tj, cj)
    nt = tdriver.device_arrays(tt, ct)
    _assert_states_equal(st, sj, "init")
    base_t = ts.key_data(seed, device="cpu")
    border = np.zeros(tt.num_nodes, bool)
    for r in range(40):
        sj = core_j(sj, nj, jax.random.key(seed))
        st = core_t(st, nt, ts.fold_in(base_t, st.round))
        if predicate == "delta":
            _assert_states_equal(st, sj, f"round {r + 1}")
            continue
        for f in ("s", "w", "ratio"):
            assert np.array_equal(_bits(getattr(st, f)),
                                  _bits(getattr(sj, f))), (f, r + 1)
        s, w = (np.asarray(getattr(sj, f), np.float64) for f in "sw")
        alive = np.asarray(sj.alive)
        mean = np.float32(s[alive].sum() / w[alive].sum())
        dist = np.abs(np.asarray(sj.ratio, np.float64) - mean)
        border |= np.abs(dist - tol) <= 4 * np.spacing(mean)
        for f in ("streak", "converged"):
            a, b = getattr(st, f).numpy(), np.asarray(getattr(sj, f))
            assert np.array_equal(a[~border], b[~border]), (f, r + 1)


@pytest.mark.parametrize("graph", ["imp3D", "powerlaw", "full"])
def test_general_dead_set_round_bitwise(graph):
    """An arbitrary dead set: the sender also checks its target's
    liveness (``alive[targets]``), 16 rounds from a carried state."""
    tj, tt = _topos(graph)
    n = tt.num_nodes
    dead = np.random.default_rng(4).random(n) < 0.15
    sj = jax_init(n)._replace(alive=jnp.asarray(~dead))
    st = _carry(sj)
    nj = jdriver.device_arrays(tj, jx.RunConfig(algorithm="push-sum"))
    nt = tdriver.device_arrays(tt, tx.RunConfig(algorithm="push-sum",
                                                device="cpu"))
    from gossipprotocol_tpu.protocols.pushsum import pushsum_round as jround

    for r in range(16):
        sj = jround(sj, nj, jax.random.key(1), n=n, all_alive=False,
                    targets_alive=False)
        st = pushsum_round(st, nt, ts.key_data(1, "cpu"), n=n,
                           all_alive=False, targets_alive=False)
        _assert_states_equal(st, jax.device_get(sj), f"round {r + 1}")


@pytest.mark.parametrize("value_mode", ["scaled", "index"])
@pytest.mark.parametrize("graph", ["er", "line"])
def test_run_simulation_bitwise(graph, value_mode):
    tj, tt = _topos(graph)
    base = dict(algorithm="push-sum", seed=2, value_mode=value_mode,
                eps=1e-4, chunk_rounds=8, max_rounds=64)
    rj = jx.run_simulation(tj, jx.RunConfig(**base))
    rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", **base))
    assert rt.rounds == rj.rounds
    assert rt.converged == rj.converged
    _assert_states_equal(rt.final_state, rj.final_state)
    assert rt.estimate_error == rj.estimate_error


# the graphs of tests/test_golden.py (topology seed 11, run seed 42)
_GOLDEN_GRAPHS = [("line", 64), ("full", 128), ("3D", 64), ("imp3D", 64),
                  ("erdos_renyi", 128), ("power_law", 128)]


@pytest.mark.parametrize("key", _GOLDEN_GRAPHS,
                         ids=lambda k: f"{k[0]}-{k[1]}")
def test_golden_graph_rounds_equal_jax(key):
    """Default push-sum (fanout one, delta predicate) to convergence on
    the golden graphs: the installed JAX package's rounds and final
    state, exactly — but for a node whose weight halved into the float32
    subnormals in a receipt dry spell (power_law 128: node 85 by round
    649), which this XLA CPU build flushes to zero and the port keeps
    (the recorded subnormal divergence, ROADMAP.md Queue 3)."""
    name, n = key
    rj = jx.run_simulation(jx.build_topology(name, n, seed=11),
                           jx.RunConfig(algorithm="push-sum", seed=42))
    rt = tx.run_simulation(tx.build_topology(name, n, seed=11),
                           tx.RunConfig(algorithm="push-sum", seed=42,
                                        device="cpu"))
    assert rt.converged == rj.converged
    assert rt.rounds == rj.rounds
    w_t = rt.final_state.w.numpy()
    flushed = (np.abs(w_t) < np.finfo(np.float32).tiny) & (w_t != 0)
    assert np.all(np.asarray(rj.final_state.w)[flushed] == 0)
    for f in _FIELDS:
        a, b = _bits(getattr(rt.final_state, f)), _bits(
            getattr(rj.final_state, f))
        assert np.array_equal(a[~flushed], b[~flushed]), f


@pytest.mark.parametrize("kw", [dict(delivery="invert"),
                                dict(fanout="all", delivery="scatter"),
                                dict(fanout="all", delivery="routed",
                                     routed_design="pull")])
def test_unported_variants_raise(kw):
    """The pull design is refused by the config; the invert delivery and
    the fanout-all scatter run on one card and are refused by the sharded
    engine."""
    from gossipprotocol_tpu_torch.parallel import run_simulation_sharded

    with pytest.raises(tdriver.NotPortedError):
        cfg = tx.RunConfig(device="cpu", algorithm="push-sum", **kw)
        run_simulation_sharded(tx.build_topology("imp3D", 64), cfg,
                               num_devices=2)
