"""PyTorch port, topology-schedule events (events/plan.py, events/
engine.py): plan parsing, digests, churn generation, edge-event
application and the resume replay byte for byte the JAX package's; a
churned fanout-all run on the port's pallas delivery, with two plan
rebuilds mid-run, bitwise the JAX routed run over its capped rounds; the
float64 mass assertion firing on a forged rebuild that does not conserve
mass."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.events import engine as je
from gossipprotocol_tpu.events import plan as jp
from gossipprotocol_tpu.utils import faults as jf

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.events import engine as te
from gossipprotocol_tpu_torch.events import plan as tp
from gossipprotocol_tpu_torch.utils import faults as tf


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


def _csr_equal(a, b):
    return (a.offsets.tobytes() == b.offsets.tobytes()
            and a.indices.tobytes() == b.indices.tobytes()
            and a.offsets.dtype == b.offsets.dtype
            and a.indices.dtype == b.indices.dtype)


_DOC = {
    "add_edges": [{"round": 40, "edges": [[0, 5], [3, 9]]},
                  {"round": 40, "edges": [[1, 7]]}],
    "remove_edges": [{"round": 60, "edges": [[1, 2]]}],
    "swap_neighbors": [{"round": 80, "pairs": [[[0, 1], [2, 3]]]}],
    "churn": {"rate": 0.02, "model": "edge", "period": 25},
    "value_faults": [{"round": 12, "rate": 0.05, "model": "scale:3"}],
    "kill": [{"round": 10, "ids": [1, 2]}],
    "revive": [{"round": 30, "ids": [1, 2]}],
    "loss": [{"start": 5, "stop": 25, "prob": 0.2}],
}


def test_parse_event_plan_equal(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(_DOC))
    pt, st = tp.parse_event_plan(str(path), num_nodes=16, seed=2)
    pj, sj = jp.parse_event_plan(str(path), num_nodes=16, seed=2)
    assert pt.digest() == pj.digest() != "none"
    assert pt.value_fault_digest() == pj.value_fault_digest() != "none"
    assert st.digest() == sj.digest()
    assert pt.explicit_rounds() == pj.explicit_rounds()
    for name in ("adds", "removes", "swaps"):
        a, b = getattr(pt, name), getattr(pj, name)
        assert sorted(a) == sorted(b)
        assert all(a[r].tobytes() == b[r].tobytes() for r in a)
    assert [pt.next_churn_round(r) for r in (0, 25, 26)] == [
        pj.next_churn_round(r) for r in (0, 25, 26)]


_BAD = [
    [1, 2],
    {"bogus_key": []},
    {"add_edges": {"round": 1}},
    {"add_edges": [{"edges": [[0, 1]]}]},
    {"add_edges": [{"round": 4}]},
    {"add_edges": [{"round": 4, "edges": [[0, 1, 2]]}]},
    {"add_edges": [{"round": 4, "edges": []}]},
    {"add_edges": [{"round": -2, "edges": [[0, 1]]}]},
    {"remove_edges": [{"round": 4, "edges": [[0, 99]]}]},
    {"swap_neighbors": [{"round": 4, "edges": [[0, 1]]}]},
    {"churn": {"rate": 0.1}},
    {"churn": {"rate": 0.1, "model": "teleport"}},
    {"churn": {"rate": 0.0, "model": "edge"}},
    {"churn": {"rate": 0.1, "model": "edge", "phase": 3}},
    {"value_faults": [{"rate": 0.1}]},
    {"value_faults": [{"rate": 0.1, "model": "scale:1"}]},
    {"kill": [{"round": 3}]},
]


@pytest.mark.parametrize("doc", _BAD, ids=range(len(_BAD)))
def test_malformed_event_plans_raise_the_same_message(doc):
    msgs = []
    for mod in (tp, jp):
        with pytest.raises((ValueError, KeyError)) as e:
            mod.parse_event_plan(doc, num_nodes=16)
        msgs.append((type(e.value).__name__, str(e.value)))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("arg", ["0.05,edge", "0.2, swap, 7", "0.05",
                                 "x,edge", "0.05,edge,z", "0.05,edge,1,2",
                                 "0.05,teleport"])
def test_parse_churn_arg_equal(arg):
    out = []
    for mod in (tp, jp):
        try:
            spec = mod.parse_churn_arg(arg)
            out.append((spec.rate, spec.model, spec.period))
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


@pytest.mark.parametrize("model", ["edge", "swap"])
def test_generate_and_apply_churn_byte_equal(model):
    tt = tx.build_topology("imp3D", 216, seed=3)
    tj = jx.build_topology("imp3D", 216, seed=3)
    for r in (10, 20, 37):
        spec_t, spec_j = tp.ChurnSpec(0.03, model, 10), jp.ChurnSpec(
            0.03, model, 10)
        gt = tp.generate_churn(tt, spec_t, run_seed=9, event_round=r)
        gj = jp.generate_churn(tj, spec_j, run_seed=9, event_round=r)
        assert all(a.tobytes() == b.tobytes() and a.shape == b.shape
                   for a, b in zip(gt, gj))
        tt, st = tp.apply_edge_events(tt, removes=gt[0], adds=gt[1],
                                      swaps=gt[2])
        tj, sj = jp.apply_edge_events(tj, removes=gj[0], adds=gj[1],
                                      swaps=gj[2])
        assert st == sj and st["changed"]
        assert _csr_equal(tt, tj)


def test_apply_edge_events_skips_as_jax():
    tt, tj = tx.build_topology("line", 8), jx.build_topology("line", 8)
    ev = dict(removes=[[0, 1], [5, 7], [3, 3]], adds=[[0, 7], [2, 3]],
              swaps=[[1, 2, 4, 5], [0, 1, 2, 3]])
    a, sa = tp.apply_edge_events(tt, **ev)
    b, sb = jp.apply_edge_events(tj, **ev)
    assert sa == sb and _csr_equal(a, b)


@pytest.mark.parametrize("policy", ["off", "rewire"])
def test_replay_topology_events_equal(policy):
    tt, tj = tx.build_topology("imp3D", 216, seed=3), jx.build_topology(
        "imp3D", 216, seed=3)
    kw = dict(fail_fraction=0.1, fail_round=7, revive_round=15, seed=4)
    st, sj = tf.build_schedule(216, **kw), jf.build_schedule(216, **kw)
    pt = tp.EventPlan.from_events(adds={12: [[0, 100]]},
                                  churn=tp.ChurnSpec(0.05, "edge", 6))
    pj = jp.EventPlan.from_events(adds={12: [[0, 100]]},
                                  churn=jp.ChurnSpec(0.05, "edge", 6))
    quar = {9: np.array([3, 4, 5])}
    for upto in (6, 7, 13, 25):
        a = te.replay_topology_events(tt, st, pt, policy, 4, upto,
                                      quarantines=quar)
        b = je.replay_topology_events(tj, sj, pj, policy, 4, upto,
                                      quarantines=quar)
        assert _csr_equal(a, b)


_CHURN_BASE = dict(algorithm="push-sum", fanout="all", seed=3,
                   max_rounds=30, predicate="global", plan_cache="none")


@pytest.fixture(scope="module")
def churned_routed_run():
    """The JAX routed run (Pallas interpreter) on imp3D 216 with swap
    churn every 12 rounds: rebuilds at rounds 12 and 24, 30 rounds."""
    tj = jx.build_topology("imp3D", 216, seed=4)
    plan = jp.EventPlan(churn=jp.ChurnSpec(0.05, "swap", 12))
    return jx.run_simulation(tj, jx.RunConfig(
        event_plan=plan, delivery="routed", **_CHURN_BASE))


def test_churned_pallas_run_bitwise_with_jax_routed(churned_routed_run):
    tt = tx.build_topology("imp3D", 216, seed=4)
    plan = tp.EventPlan(churn=tp.ChurnSpec(0.05, "swap", 12))
    rt = tx.run_simulation(tt, tx.RunConfig(
        device="cpu", event_plan=plan, delivery="pallas", **_CHURN_BASE))
    rj = churned_routed_run
    got = [m for m in rt.metrics if m.get("event") == "churn"]
    want = [m for m in rj.metrics if m.get("event") == "churn"]
    keys = ("round", "generated", "changed", "edges_added", "edges_removed",
            "edges_swapped", "edges_skipped")
    assert len(got) == 2
    assert [[m[k] for k in keys] for m in got] == [
        [m[k] for k in keys] for m in want]
    assert (rt.rounds, rt.converged) == (rj.rounds, rj.converged)
    for f in ("s", "w", "ratio", "streak", "converged", "alive"):
        a = getattr(rt.final_state, f).numpy()
        b = np.asarray(getattr(rj.final_state, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def test_gossip_event_plan_run_bitwise():
    """Explicit edge events, a kill and loss in one plan, gossip on the
    scatter delivery."""
    doc = {"add_edges": [{"round": 3, "edges": [[0, 40], [5, 60]]}],
           "remove_edges": [{"round": 6, "edges": [[0, 1], [0, 4]]}],
           "kill": [{"round": 4, "ids": [20]}],
           "loss": [{"start": 0, "stop": 10, "prob": 0.3}]}
    pt, st = tp.parse_event_plan(doc, num_nodes=64)
    pj, sj = jp.parse_event_plan(doc, num_nodes=64)
    base = dict(algorithm="gossip", seed=2, max_rounds=200, chunk_rounds=16)
    rt = tx.run_simulation(tx.build_topology("imp3D", 64), tx.RunConfig(
        device="cpu", event_plan=pt, fault_schedule=st, **base))
    rj = jx.run_simulation(jx.build_topology("imp3D", 64), jx.RunConfig(
        event_plan=pj, fault_schedule=sj, **base))
    assert [m["edges_removed"] for m in rt.metrics
            if m.get("event") == "churn"] == [0, 2]
    assert (rt.rounds, rt.converged) == (rj.rounds, rj.converged)
    for f in ("counts", "converged", "alive"):
        assert np.array_equal(getattr(rt.final_state, f).numpy(),
                              np.asarray(getattr(rj.final_state, f)))


def test_forged_rebuild_trips_the_mass_assertion():
    """A rebuild hook that moves push-sum mass is refused in float64, with
    the JAX engine's message."""
    tt = tx.build_topology("imp3D", 64)
    plan = tp.EventPlan.from_events(adds={2: [[0, 40]]})
    cfg = tx.RunConfig(algorithm="push-sum", device="cpu", event_plan=plan)
    state = tx.pushsum_init(64, device="cpu")
    events = te.HostEvents(tt, cfg, start_round=2)

    def forged(new_topo, st):
        return None, st._replace(s=st.s * 1.5), {}

    with pytest.raises(AssertionError, match="event rebuild changed "
                                             "protocol mass"):
        events.fire(state, tt, 2, forged)

    events = te.HostEvents(tt, cfg, start_round=2)
    honest = events.fire(state, tt, 2, lambda t, st: (None, st, {}))
    assert honest[3][0]["event"] == "churn" and honest[3][0]["changed"]


def test_host_events_schedule_as_jax():
    """Due rounds and the next event round, the churn pointer included,
    over a resume point in the middle of the schedule."""
    tt, tj = tx.build_topology("imp3D", 64), jx.build_topology("imp3D", 64)
    kw = dict(fail_fraction=0.1, fail_round=5, revive_round=13, seed=0)
    ct = tx.RunConfig(algorithm="push-sum", fault_schedule=tf.build_schedule(
        64, **kw), event_plan=tp.EventPlan(churn=tp.ChurnSpec(0.1, "edge",
                                                             4)))
    cj = jx.RunConfig(algorithm="push-sum", fault_schedule=jf.build_schedule(
        64, **kw), event_plan=jp.EventPlan(churn=jp.ChurnSpec(0.1, "edge",
                                                             4)))
    from gossipprotocol_tpu.obs import as_telemetry

    for start in (0, 5, 6, 13):
        a = te.HostEvents(tt, ct, start_round=start)
        b = je.HostEvents(tj, cj, start_round=start, tel=as_telemetry(None))
        for r in range(start, start + 12):
            assert a.due(r) == b.due(r)
            assert a.next_round(100) == b.next_round(100)
    assert dataclasses.replace(ct.events, churn=None).digest() == "none"
