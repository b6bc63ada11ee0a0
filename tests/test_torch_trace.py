"""PyTorch port, per-round convergence traces (``obs/trace.py`` and the
trace rows of ``protocols/gossip.py``, ``pushsum.py``, ``diffusion.py``
and ``learn/sgp.py``): the trace rows of every branch equal the JAX
engine's — bitwise (tolerance 0) wherever the state is bitwise (gossip,
fanout-one push-sum, the diffusion scatter and pallas rounds under the
delta predicate, EPD acceleration; the sums taken in XLA's CPU order,
``tree_sum0``); under the global predicate the residual and mass columns
are bitwise and the converged fraction within the rows whose streak flips
at ``tol``'s border (ROADMAP Queue 3, the round's global mean); SGP rows
within relative 1e-5, the learner's own tolerance. The row functions on
the same state (dead rows, vector payloads, the walk's token) are
bitwise, and ``TraceWriter`` writes the JAX writer's rounds and lines
for the same rows and cap."""

from __future__ import annotations

import functools
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.obs import Telemetry as JTelemetry
from gossipprotocol_tpu.obs import trace as jtrace
from gossipprotocol_tpu.protocols import gossip as jg
from gossipprotocol_tpu.protocols import pushsum as jp
from gossipprotocol_tpu.protocols.state import GossipState as JGossip
from gossipprotocol_tpu.protocols.state import PushSumState as JPush

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.obs import Telemetry
from gossipprotocol_tpu_torch.obs import trace as ttrace
from gossipprotocol_tpu_torch.protocols import gossip as tg
from gossipprotocol_tpu_torch.protocols import pushsum as tp
from gossipprotocol_tpu_torch.protocols.state import GossipState, PushSumState


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


_GRAPH = ("imp3D", 64, {"seed": 4})
_DIFF = dict(algorithm="push-sum", fanout="all", plan_cache="none")
# (config, relative tolerance of the float columns: 0 = bitwise)
_RUNS = {
    "gossip": (dict(algorithm="gossip", seed=3), 0.0),
    "fanout_one": (dict(algorithm="push-sum", seed=3, eps=1e-6,
                        max_rounds=80), 0.0),
    "scatter": (dict(_DIFF, delivery="scatter", eps=1e-7,
                     max_rounds=60), 0.0),
    "pallas": (dict(_DIFF, delivery="pallas", eps=1e-7, max_rounds=24),
               0.0),
    "epd": (dict(_DIFF, delivery="scatter", accel="epd", eps=1e-7,
                 max_rounds=40), 0.0),
    "global": (dict(_DIFF, delivery="scatter", predicate="global",
                    tol=1e-4), 0.0),
    "sgp": (dict(_DIFF, delivery="scatter", workload="sgp", payload_dim=4,
                 predicate="global", tol=1e-3, max_rounds=30), 1e-5),
}


@functools.lru_cache(maxsize=None)
def _traces(case):
    kw = dict(_RUNS[case][0], chunk_rounds=8)
    tj = jx.build_topology(*_GRAPH[:2], **_GRAPH[2])
    tt = tx.build_topology(*_GRAPH[:2], **_GRAPH[2])
    dj = tempfile.mkdtemp(prefix="jtr_")
    dt = tempfile.mkdtemp(prefix="ttr_")
    telj, telt = JTelemetry(dj), Telemetry(dt)
    rj = jx.run_simulation(tj, jx.RunConfig(telemetry=telj, **kw))
    rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", telemetry=telt,
                                            **kw))
    telj.close()
    telt.close()
    return (rj, rt, jtrace.load_trace(os.path.join(dj, "trace.jsonl")),
            ttrace.load_trace(os.path.join(dt, "trace.jsonl")))


@pytest.mark.parametrize("case", list(_RUNS))
def test_trace_rows_match_jax(case):
    rj, rt, want, got = _traces(case)
    tol = _RUNS[case][1]
    assert rt.rounds == rj.rounds
    assert [r["round"] for r in got] == [r["round"] for r in want]
    assert len(got) == rt.rounds
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in ttrace.TRACE_FIELDS:
            if k not in a:
                continue
            if case == "global" and k == "converged_frac":
                continue
            if tol:
                assert a[k] == pytest.approx(b[k], rel=tol, abs=1e-9), k
            else:
                assert a[k] == b[k], (a["round"], k)


def test_global_predicate_converged_fraction_within_the_border():
    """The converged fraction under the global predicate: at most a few
    rows apart at the rounds whose streak flips at ``tol``'s border, and
    equal at the end (both runs converge at the same round)."""
    rj, rt, want, got = _traces("global")
    n = rt.num_nodes
    gaps = [abs(a["converged_frac"] - b["converged_frac"]) * n
            for a, b in zip(got, want)]
    assert max(gaps) <= 4 and gaps[-1] == 0


def test_walk_writes_no_trace_rows(tmp_path):
    """The reference walk's chunk of hops reads no device row a hop: no
    ``trace.jsonl`` rows, its counters still counted."""
    tt = tx.build_topology(*_GRAPH[:2], **_GRAPH[2])
    tel = Telemetry(str(tmp_path))
    res = tx.run_simulation(tt, tx.RunConfig(
        device="cpu", telemetry=tel, algorithm="push-sum",
        semantics="reference", seed=1))
    tel.close()
    assert tel.trace_summary() is None
    assert not ttrace.load_trace(str(tmp_path / "trace.jsonl"))
    assert tel.totals["sent"] == res.rounds


def _states(n=300, d=None, seed=5):
    """The same push-sum state for both packages: dead rows, a converged
    subset, weights spread over decades (one zero), ``d`` payload
    columns."""
    rng = np.random.default_rng(seed)
    shape = (n,) if d is None else (n, d)
    s = (rng.standard_normal(shape) * 3).astype(np.float32)
    w = (10.0 ** rng.uniform(-3, 1, n)).astype(np.float32)
    w[7] = 0.0
    ratio = (s / np.maximum(w, 1e-30).reshape((n,) + (1,) * (s.ndim - 1))
             ).astype(np.float32)
    streak = rng.integers(0, 4, n).astype(np.int32)
    conv = rng.random(n) < 0.4
    alive = rng.random(n) < 0.85
    rnd = np.int32(17)
    js = JPush(*(jnp.asarray(a) for a in (s, w, ratio, streak, conv, alive,
                                          rnd)))
    ts = PushSumState(*(torch.from_numpy(np.asarray(a)) for a in (
        s, w, ratio, streak, conv, alive, np.asarray(rnd))))
    return js, ts


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("d", [None, 1, 3, 40])
@pytest.mark.parametrize("n", [300, 5000])
def test_pushsum_trace_row_bitwise(n, d):
    js, ts = _states(n, d)
    want = _bits(jp.pushsum_trace_row(js))
    got = _bits(tp.pushsum_trace_row(ts).numpy())
    assert np.array_equal(np.isnan(want.view(np.float32)),
                          np.isnan(got.view(np.float32)))
    keep = ~np.isnan(want.view(np.float32))
    assert np.array_equal(want[keep], got[keep])


def test_walk_state_trace_row_bitwise():
    """The walk's in-flight token joins the mass columns."""
    from gossipprotocol_tpu.protocols.walk import pushsum_walk_init as jwi

    from gossipprotocol_tpu_torch.protocols.walk import (
        pushsum_walk_init as twi,
    )

    js = jwi(200, 3)._replace(msg_s=jnp.float32(0.25),
                              msg_w=jnp.float32(0.5))
    ts = twi(200, 3, device="cpu")._replace(
        msg_s=torch.tensor(0.25), msg_w=torch.tensor(0.5))
    assert np.array_equal(_bits(jp.pushsum_trace_row(js))[:4],
                          _bits(tp.pushsum_trace_row(ts).numpy())[:4])


@pytest.mark.parametrize("n", [50, 3000])
def test_gossip_trace_row_bitwise(n):
    rng = np.random.default_rng(n)
    counts = rng.integers(0, 12, n).astype(np.int32)
    conv = counts >= 10
    alive = rng.random(n) < 0.9
    js = JGossip(jnp.asarray(counts), jnp.asarray(conv), jnp.asarray(alive),
                 jnp.int32(4))
    ts = GossipState(torch.from_numpy(counts), torch.from_numpy(conv),
                     torch.from_numpy(alive), torch.tensor(4, dtype=torch.int32))
    want = np.asarray(jg.gossip_trace_row(js))
    got = tg.gossip_trace_row(ts).numpy()
    assert np.array_equal(_bits(want[:2]), _bits(got[:2]))
    assert np.isnan(got[2:]).all() and np.isnan(want[2:]).all()


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 100_001])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tree_sum0_is_xla_order(n, dtype):
    """``tree_sum0`` is bitwise ``jnp.sum`` on the CPU (XLA's windows of
    32 rows, level by level)."""
    import jax

    x = np.random.default_rng(n).standard_normal((n, 2)).astype(dtype)
    got = tp.tree_sum0(torch.from_numpy(x)).numpy()
    if dtype == np.float64:
        jax.config.update("jax_enable_x64", True)
    try:
        want = np.asarray(jnp.sum(jnp.asarray(x), axis=0))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _write_both(rows_per_chunk, cap, starts):
    dj, dt = tempfile.mkdtemp(), tempfile.mkdtemp()
    wj = jtrace.TraceWriter(os.path.join(dj, "t.jsonl"), cap=cap)
    wt = ttrace.TraceWriter(os.path.join(dt, "t.jsonl"), cap=cap)
    for start, rows in zip(starts, rows_per_chunk):
        wj.add(start, rows)
        wt.add(start, rows)
    wj.close()
    wt.close()
    with open(os.path.join(dj, "t.jsonl")) as fh:
        a = fh.read()
    with open(os.path.join(dt, "t.jsonl")) as fh:
        b = fh.read()
    return a, b, wj.summary(), wt.summary()


@pytest.mark.parametrize("cap", [2, 7, 64, None])
def test_trace_writer_matches_jax(cap):
    """Stride doubling: the same rounds, lines and summary as the JAX
    writer for the same chunks of rows (NaN columns left out)."""
    rng = np.random.default_rng(0 if cap is None else cap)
    rows, starts, r = [], [], 0
    for m in (16, 16, 5, 40, 16, 3, 100):
        block = rng.random((m, ttrace.NUM_TRACE_COLS)).astype(np.float32)
        block[:, 4] = np.nan
        rows.append(block)
        starts.append(r)
        r += m
    a, b, sa, sb = _write_both(rows, cap, starts)
    assert a == b and sa == sb
    assert sb["last_round"] == r


def test_default_trace_cap_env(monkeypatch):
    monkeypatch.setenv("GOSSIP_TPU_TRACE_CAP", "123")
    assert ttrace.default_trace_cap() == jtrace.default_trace_cap() == 123
    monkeypatch.delenv("GOSSIP_TPU_TRACE_CAP")
    assert ttrace.default_trace_cap() == jtrace.TRACE_CAP_DEFAULT


def test_load_trace_tolerates_torn_lines(tmp_path):
    p = tmp_path / "trace.jsonl"
    p.write_text(json.dumps({"v": 1, "kind": "trace", "round": 1,
                             "residual": 0.5}) + "\n{\"v\": 1, \"kin")
    assert ttrace.load_trace(str(p)) == jtrace.load_trace(str(p))
    assert len(ttrace.load_trace(str(p))) == 1
    assert ttrace.load_trace(str(tmp_path / "none.jsonl")) == []
