"""PyTorch port, run telemetry (``obs/telemetry.py``, ``obs/counters.py``,
the engine's host loop): with a telemetry hub the runs are bitwise the
runs without one (gossip, fanout-one push-sum, diffusion over pallas,
routed, the megakernel and the scatter, SGP, the walk and ``--devices
2``); the message counters of every chunk and the mass drift in ULPs
equal the JAX engine's for the same seed and config (loss windows, a dead
set whose recount runs a second matvec, a Poisson clock, GALA's group
clock, the walk, a repair) — tolerance 0: the same integers and the same ULP counts; the
megakernel counts whole rounds (rounds × directed edges); the chunk
runners without telemetry run the operation sequence of the chunk before
telemetry, and with it fetch nothing inside a chunk; ``events.jsonl`` and
``trace.json`` have the JAX package's structure."""

from __future__ import annotations

import functools
import json
import os
import tempfile

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.obs import Telemetry as JTelemetry
from gossipprotocol_tpu.utils import faults as jfaults

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.engine import driver as tdriver
from gossipprotocol_tpu_torch.obs import Telemetry, write_manifest
from gossipprotocol_tpu_torch.parallel import run_simulation_sharded
from gossipprotocol_tpu_torch.protocols.sampling import key_data, round_keys
from gossipprotocol_tpu_torch.utils import faults as tfaults
from gossipprotocol_tpu_torch.utils.checkpoint import topology_fingerprint


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


def _same_state(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


_GRAPH = ("imp3D", 64, {"seed": 4})
_DIFF = dict(algorithm="push-sum", fanout="all", predicate="global",
             plan_cache="none")

# on against off, the port alone
_INVARIANT = {
    "gossip": dict(algorithm="gossip", seed=3),
    "fanout_one": dict(algorithm="push-sum", seed=3, eps=1e-6,
                       max_rounds=200),
    "pallas": dict(_DIFF, delivery="pallas"),
    "routed": dict(_DIFF, delivery="routed"),
    "megakernel": dict(_DIFF, delivery="megakernel", rounds_per_kernel=4),
    "scatter": dict(_DIFF, delivery="scatter"),
    "sgp": dict(_DIFF, delivery="pallas", workload="sgp", payload_dim=4,
                tol=1e-3, max_rounds=40),
    "walk": dict(algorithm="push-sum", semantics="reference", seed=1),
}


@pytest.mark.parametrize("case", list(_INVARIANT))
def test_telemetry_changes_nothing(case, tmp_path):
    """Same rounds, same executed rounds, bitwise final state; the hub
    saw counters on every path."""
    topo = tx.build_topology(*_GRAPH[:2], **_GRAPH[2])
    kw = dict(_INVARIANT[case], chunk_rounds=8)
    tel = Telemetry(str(tmp_path))
    on = tx.run_simulation(topo, tx.RunConfig(device="cpu", telemetry=tel,
                                              **kw))
    tel.close()
    off = tx.run_simulation(topo, tx.RunConfig(device="cpu", **kw))
    assert (on.rounds, on.rounds_executed, on.converged) == (
        off.rounds, off.rounds_executed, off.converged)
    assert _same_state(on.final_state, off.final_state)
    assert tel.totals["sent"] > 0
    assert tel.totals["sent"] == sum(m.get("sent", 0) for m in on.metrics)


def test_sharded_telemetry_changes_nothing(tmp_path):
    """``--devices 2``: bitwise the run without telemetry, the totals
    every round's directed edges, and the shard-balance block's per-shard
    rows summing to them."""
    topo = tx.build_topology(*_GRAPH[:2], **_GRAPH[2])
    kw = dict(_DIFF, delivery="pallas", build_workers=1, chunk_rounds=8,
              plan_cache=None)
    tel = Telemetry(str(tmp_path / "s"))
    cfg = tx.RunConfig(device="cpu", telemetry=tel, **kw)
    on = run_simulation_sharded(topo, cfg, num_devices=2)
    write_manifest(tel, cfg, topo, on, num_devices=2)
    tel.close()
    off = run_simulation_sharded(topo, tx.RunConfig(device="cpu", **kw),
                                 num_devices=2)
    assert on.rounds == off.rounds
    assert _same_state(on.final_state, off.final_state)
    # all alive: every round ships one share a directed edge
    assert tel.totals["sent"] == on.rounds * topo.num_directed_edges
    assert tel.totals["delivered"] == tel.totals["sent"]
    with open(tmp_path / "s" / "run.json") as fh:
        bal = json.load(fh)["shard_balance"]
    assert bal["num_shards"] == 2
    assert sum(bal["sent"]) == tel.totals["sent"]
    assert sum(bal["delivered"]) == tel.totals["delivered"]


# the JAX engine's runs: (graph, config, schedule arguments)
_LOSS = dict(drop_prob=0.2, drop_window=(0, 12))
_KILL = dict(fail_fraction=0.1, fail_round=3)
_PAIRS = {
    "loss_gossip": (_GRAPH, dict(algorithm="gossip", seed=3), _LOSS),
    "loss_fanout_one": (_GRAPH, dict(algorithm="push-sum", seed=3,
                                     eps=1e-6, max_rounds=60), _LOSS),
    "loss_scatter": (_GRAPH, dict(_DIFF, delivery="scatter"), _LOSS),
    "poisson_fanout_one": (_GRAPH, dict(algorithm="push-sum", seed=3,
                                        clock="poisson",
                                        activation_rate=0.7, eps=1e-6,
                                        max_rounds=60), {}),
    "dead_pallas": (_GRAPH, dict(_DIFF, delivery="pallas", max_rounds=12),
                    _KILL),
    "repair_pallas": (_GRAPH, dict(_DIFF, delivery="pallas", max_rounds=12,
                                   repair="rewire"), _KILL),
    "walk": (_GRAPH, dict(algorithm="push-sum", semantics="reference",
                          seed=1), {}),
    "gala_poisson": (_GRAPH, dict(_DIFF, delivery="scatter",
                                  workload="gala", groups=4, payload_dim=4,
                                  clock="poisson", tol=1e-3,
                                  max_rounds=24), {}),
}


@functools.lru_cache(maxsize=None)
def _pair(case):
    """``(JAX result, port result, JAX hub, port hub)`` of one case, run
    once for the tests below (chunks of 4 rounds, 64 for the walk)."""
    graph, kw, sched = _PAIRS[case]
    kw = dict(kw, chunk_rounds=64 if case == "walk" else 4)
    n = graph[1]
    tj = jx.build_topology(graph[0], n, **graph[2])
    tt = tx.build_topology(graph[0], n, **graph[2])
    sj = tsch = None
    if sched:
        sj = jfaults.build_schedule(n, seed=3, max_rounds=10**6, **sched)
        tsch = tfaults.build_schedule(n, seed=3, max_rounds=10**6, **sched)
    telj = JTelemetry(tempfile.mkdtemp(prefix="jtel_"))
    telt = Telemetry(tempfile.mkdtemp(prefix="ttel_"))
    rj = jx.run_simulation(tj, jx.RunConfig(telemetry=telj,
                                            fault_schedule=sj, **kw))
    rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", telemetry=telt,
                                            fault_schedule=tsch, **kw))
    telj.close()
    telt.close()
    return rj, rt, telj, telt


def _chunk_rows(res, fields):
    return [tuple(m.get(f) for f in fields) for m in res.metrics
            if "sent" in m]


@pytest.mark.parametrize("case", list(_PAIRS))
def test_counters_match_jax(case):
    """Every chunk's (round, sent, delivered, dropped) and the run totals
    equal the JAX engine's."""
    rj, rt, telj, telt = _pair(case)
    assert rt.rounds == rj.rounds
    rows = ("round", "sent", "delivered", "dropped")
    assert _chunk_rows(rt, rows) == _chunk_rows(rj, rows)
    assert telt.totals == telj.totals
    if case.startswith("loss"):
        assert telt.totals["dropped"] > 0
    if case.startswith("dead"):
        # the recount: dead receivers took nothing
        assert telt.totals["delivered"] < telt.totals["sent"]


@pytest.mark.parametrize("case", list(_PAIRS))
def test_mass_drift_matches_jax(case):
    """The mass drift in ULPs of every chunk, and its maximum, equal the
    JAX engine's (the baseline and the sums taken in XLA's order on the
    CPU, ``protocols/pushsum.py`` ``tree_sum0``)."""
    rj, rt, telj, telt = _pair(case)
    rows = ("round", "mass_drift_ulps", "w_drift_ulps")
    assert _chunk_rows(rt, rows) == _chunk_rows(rj, rows)
    assert telt.max_mass_drift_ulps == telj.max_mass_drift_ulps
    assert telt.max_w_drift_ulps == telj.max_w_drift_ulps


def test_megakernel_counts_whole_rounds(tmp_path):
    """The megakernel's counters are K-round rows sliced to the rounds
    that ran: every message of every round, rounds × directed edges. The
    JAX engine sums its whole buffer, so its last chunk counts the rows
    of a super-step that stopped at convergence too; every earlier chunk
    equals it."""
    kw = dict(_DIFF, delivery="megakernel", rounds_per_kernel=4,
              predicate="delta", eps=1e-6, chunk_rounds=8)
    tj = jx.build_topology(*_GRAPH[:2], **_GRAPH[2])
    tt = tx.build_topology(*_GRAPH[:2], **_GRAPH[2])
    telj = JTelemetry(str(tmp_path / "j"))
    telt = Telemetry(str(tmp_path / "t"))
    rj = jx.run_simulation(tj, jx.RunConfig(telemetry=telj, **kw))
    rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", telemetry=telt,
                                            **kw))
    telj.close()
    telt.close()
    assert rt.rounds == rj.rounds and rt.rounds % 4
    assert telt.totals["sent"] == rt.rounds * tt.num_directed_edges
    assert telt.totals["delivered"] == telt.totals["sent"]
    rows = ("round", "sent", "delivered", "dropped")
    got, want = _chunk_rows(rt, rows), _chunk_rows(rj, rows)
    assert got[:-1] == want[:-1]
    assert got[-1][0] == want[-1][0] and got[-1][1] < want[-1][1]


def test_routed_recount_equals_pallas(tmp_path):
    """Under a dead set the routed delivery's recount (its matvec a
    second time in the round) gives the pallas delivery's counts."""
    topo = tx.build_topology(*_GRAPH[:2], **_GRAPH[2])
    sched = tfaults.build_schedule(64, seed=3, max_rounds=10**6, **_KILL)
    totals = {}
    for d in ("pallas", "routed"):
        tel = Telemetry(str(tmp_path / d))
        tx.run_simulation(topo, tx.RunConfig(
            device="cpu", telemetry=tel, fault_schedule=sched,
            delivery=d, max_rounds=12, chunk_rounds=4,
            **{k: v for k, v in _DIFF.items() if k != "delivery"}))
        tel.close()
        totals[d] = tel.totals
    assert totals["pallas"] == totals["routed"]
    assert totals["pallas"]["delivered"] < totals["pallas"]["sent"]


class _Ops(TorchDispatchMode):
    """Record the aten operations run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _pre_telemetry_chunk(round_core, done_fn, extra_stats, base_key):
    """The chunk as the engine ran it before telemetry existed."""
    def chunk(state, delivery, start_round, round_limit):
        count = max(0, round_limit - start_round)
        keys = (None if base_key is None
                else round_keys(base_key, state.round, count))
        for i in range(count):
            active = ~done_fn(state)
            new = (round_core(state, delivery) if keys is None
                   else round_core(state, delivery, keys[i]))
            state = tdriver._freeze(active, new, state)
        extra = [] if extra_stats is None else extra_stats(state, delivery)
        return state, torch.stack([state.round,
                                   done_fn(state).to(torch.int32), *extra])

    return chunk


_OPS_CASES = {
    "fanout_one": dict(algorithm="push-sum"),
    "pallas": dict(algorithm="push-sum", fanout="all", delivery="pallas"),
    "gossip": dict(algorithm="gossip"),
}


def _built(cfg):
    topo = tx.build_topology("imp3D", 64)
    rc = tx.RunConfig(device="cpu", plan_cache="none", **cfg)
    state, core, done, flags = tdriver.build_protocol(topo, rc)
    delivery = tdriver.device_arrays(topo, rc)
    extra = core.extra_stats if isinstance(core, tdriver.GossipCore) else None
    key = key_data(0, "cpu") if tdriver.draws(rc) else None
    return topo, rc, state, core, done, flags, delivery, extra, key


@pytest.mark.parametrize("case", list(_OPS_CASES))
def test_off_chunk_is_the_pre_telemetry_chunk(case):
    """Telemetry off: the chunk runs the operation sequence of the chunk
    before telemetry existed, and returns the same stats."""
    _, _, state, core, done, _, delivery, extra, key = _built(
        _OPS_CASES[case])
    seqs = []
    for make in (lambda: tdriver.make_chunk_runner(core, done, extra,
                                                   base_key=key),
                 lambda: _pre_telemetry_chunk(core, done, extra, key)):
        with _Ops() as rec:
            _, stats = make()(state, delivery, 0, 3)
        seqs.append((rec.ops, stats.tolist()))
    assert seqs[0] == seqs[1]


def test_off_megakernel_chunk_is_the_pre_telemetry_chunk():
    from gossipprotocol_tpu_torch.ops.megakernel import pad_state, unpad_state

    _, _, state, core, done, _, mk, _, _ = _built(dict(
        algorithm="push-sum", fanout="all", delivery="megakernel",
        rounds_per_kernel=4))

    def pre(st, mk_, start, limit):
        ms = pad_state(st)
        for _ in range(-(-max(0, limit - start) // 4)):
            ms = core(ms, mk_)
        st = unpad_state(ms, st.alive)
        return st, torch.stack([st.round, done(st).to(torch.int32)])

    seqs = []
    for chunk in (tdriver.make_megakernel_chunk_runner(core, done, 4), pre):
        with _Ops() as rec:
            _, stats = chunk(state, mk, 0, 8)
        seqs.append((rec.ops, stats.tolist()))
    assert seqs[0] == seqs[1]


@pytest.mark.parametrize("case", list(_OPS_CASES))
def test_on_chunk_fetches_nothing_inside(case):
    """Telemetry on: the counters and trace rows add operations but no
    host read (``aten._local_scalar_dense``, what ``.item()`` runs); the
    one fetch is the caller's ``tolist`` of the stats."""
    from gossipprotocol_tpu_torch.obs.counters import make_counter_fn
    from gossipprotocol_tpu_torch.obs.trace import make_trace_fn

    topo, rc, state, core, done, flags, delivery, extra, key = _built(
        _OPS_CASES[case])
    chunk = tdriver.make_chunk_runner(
        core, done, extra, base_key=key,
        counter_fn=make_counter_fn(topo, rc, all_alive=flags[0],
                                   targets_alive=flags[1]),
        trace_fn=make_trace_fn(topo, rc), records=True, mass=True)
    with _Ops() as rec:
        _, stats = chunk(state, delivery, 0, 3)
    assert not [op for op in rec.ops if "_local_scalar_dense" in op
                or op.startswith("aten.item")]
    assert stats.dim() == 1


def test_events_and_trace_json_structure(tmp_path):
    """``events.jsonl`` lines carry ``"v": 1``, open with ``start`` and
    close with ``end``; the top-level spans are the engine's phases, the
    fault batch a ``fault_event`` span; ``trace.json`` is a Chrome trace
    whose events mirror the spans (``ph`` X with ``dur``, instants ``i``,
    ``tid`` 1 + depth)."""
    topo = tx.build_topology(*_GRAPH[:2], **_GRAPH[2])
    sched = tfaults.build_schedule(64, seed=3, max_rounds=10**6, **_KILL)
    tel = Telemetry(str(tmp_path))
    cfg = tx.RunConfig(device="cpu", telemetry=tel, fault_schedule=sched,
                       max_rounds=12, chunk_rounds=4, delivery="pallas",
                       **{k: v for k, v in _DIFF.items()
                          if k != "delivery"})
    res = tx.run_simulation(topo, cfg)
    tel.close()
    write_manifest(tel, cfg, topo, res)
    with open(tmp_path / "events.jsonl") as fh:
        recs = [json.loads(line) for line in fh]
    assert all(r["v"] == 1 for r in recs)
    assert recs[0]["kind"] == "start" and recs[-1]["kind"] == "end"
    spans = [r for r in recs if r["kind"] == "span"]
    top = {r["name"] for r in spans if r["depth"] == 0}
    assert {"protocol_build", "plan_compile", "predict_rounds",
            "warm_start", "mass_baseline", "chunk", "fault_event",
            "device_sync"} <= top
    metrics = [r["rec"] for r in recs if r["kind"] == "metric"]
    # chunks stop at the strike's round: 0-3, 3-7, 7-11, 11-12
    assert [m["round"] for m in metrics if "sent" in m] == [3, 7, 11, 12]
    assert sum(r["name"] == "chunk" for r in spans) == 4
    fault = [r for r in spans if r["name"] == "fault_event"]
    assert fault[0]["attrs"]["round"] == 3 and fault[0]["attrs"]["kills"]
    names = {r["name"] for r in recs if r["kind"] == "event"}
    assert {"plan_cache", "prediction", "predicted_vs_actual"} <= names
    with open(tmp_path / "trace.json") as fh:
        doc = json.load(fh)
    assert doc["otherData"]["v"] == 1 and doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert len(evs) == sum(r["kind"] in ("span", "event") for r in recs)
    for ev in evs:
        assert ev["pid"] == 1 and ev["ph"] in ("X", "i")
        assert ev["ph"] == "i" or ev["dur"] >= 0
    assert {ev["name"] for ev in evs if ev["ph"] == "X"} == {
        r["name"] for r in spans}
    assert {ev["tid"] for ev in evs if ev["ph"] == "X"} == {
        1 + r["depth"] for r in spans}
    with open(tmp_path / "run.json") as fh:
        man = json.load(fh)
    assert man["counters"] == tel.totals and man["device"] == "cpu"
    assert man["topology"]["fingerprint"] == topology_fingerprint(topo)
    assert os.path.isfile(tmp_path / "trace.jsonl")


def test_drain_stops_like_jax(tmp_path):
    """An installed stop check ends the run at the first chunk boundary,
    as in the JAX engine: the same round, a ``drained`` record, the result
    stamped ``drain``; clearing it restores the normal run."""
    from gossipprotocol_tpu.engine import driver as jdriver

    kw = dict(algorithm="push-sum", seed=3, chunk_rounds=4,
              eps=1e-6, max_rounds=60)
    tj = jx.build_topology(*_GRAPH[:2], **_GRAPH[2])
    tt = tx.build_topology(*_GRAPH[:2], **_GRAPH[2])
    try:
        jdriver.install_stop_check(lambda: True)
        tdriver.install_stop_check(lambda: True)
        rj = jx.run_simulation(tj, jx.RunConfig(**kw))
        rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", **kw))
    finally:
        jdriver.install_stop_check(None)
        tdriver.install_stop_check(None)
    assert rt.stopped == rj.stopped == "drain"
    assert rt.rounds == rj.rounds == 4
    assert rt.metrics[-1] == rj.metrics[-1] == {
        "event": "drained", "round": 4, "checkpointed": False}
    assert tx.run_simulation(tt, tx.RunConfig(device="cpu", **kw)
                             ).stopped is None
