"""PyTorch port, overlay repair (topology/repair.py): the repaired CSR
byte for byte the JAX package's for ``prune`` and ``rewire`` (revived ids
included), the resume replay of a repaired adjacency, and runs under
``--repair rewire`` bitwise the JAX engine's — gossip and fanout-one
push-sum on the scatter delivery, fanout-all push-sum on the port's
pallas delivery against JAX's pallas delivery (Pallas interpreter), each
across the mid-run rebuild. The JAX line-interior test that misses its
``rtol`` on this CPU (float32 Σw drift, 62.000843 against 62) is a JAX
accumulation fact, not a repair one: the port is held to the JAX run's
bits, not to the exact 62."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.topology import repair as jr
from gossipprotocol_tpu.utils import faults as jf

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.topology import repair as tr
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


_GRAPHS = {
    "line": ("line", 64, {}),
    "imp3D": ("imp3D", 216, {"seed": 2}),
    "er": ("erdos_renyi", 300, {"seed": 1, "avg_degree": 6.0}),
    "powerlaw": ("power_law", 128, {"seed": 3}),
}


def _topos(graph):
    name, n, kw = _GRAPHS[graph]
    return tx.build_topology(name, n, **kw), jx.build_topology(name, n, **kw)


def _csr_equal(a, b):
    return (a.offsets.dtype == b.offsets.dtype
            and a.indices.dtype == b.indices.dtype
            and a.offsets.tobytes() == b.offsets.tobytes()
            and a.indices.tobytes() == b.indices.tobytes()
            and a.kind == b.kind and a.num_nodes == b.num_nodes)


@pytest.mark.parametrize("policy", ["off", "prune", "rewire"])
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_repair_topology_byte_equal(graph, policy):
    tt, tj = _topos(graph)
    rng = np.random.default_rng(7)
    for frac, event_round in ((0.05, 3), (0.3, 11), (0.6, 40)):
        alive = rng.random(tt.num_nodes) > frac
        dead = np.flatnonzero(~alive)
        revived = dead[: max(1, dead.size // 4)]
        alive[revived] = True
        a, sa = tr.repair_topology(tt, alive, policy, run_seed=5,
                                   event_round=event_round, revived=revived)
        b, sb = jr.repair_topology(tj, alive, policy, run_seed=5,
                                   event_round=event_round, revived=revived)
        assert sa == sb
        assert (a is tt) == (b is tj)
        assert _csr_equal(a, b)


def test_repair_refusals_match():
    full_t, full_j = tx.build_topology("full", 16), jx.build_topology(
        "full", 16)
    alive = np.ones(16, bool)
    msgs = []
    for mod, topo in ((tr, full_t), (jr, full_j)):
        with pytest.raises(ValueError) as e:
            mod.repair_topology(topo, alive, "prune", run_seed=0,
                                event_round=1)
        msgs.append(str(e.value))
        with pytest.raises(ValueError) as e:
            mod.validate_policy("bogus")
        msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]


@pytest.mark.parametrize("policy", ["prune", "rewire"])
def test_replay_repaired_topology_equal(policy):
    tt, tj = _topos("er")
    kw = dict(fail_fraction=0.1, fail_round=4, revive_round=9, seed=3)
    st, sj = tf.build_schedule(tt.num_nodes, **kw), jf.build_schedule(
        tj.num_nodes, **kw)
    for upto in (4, 5, 9, 10, 30):
        a = tr.replay_repaired_topology(tt, st, policy, 3, upto)
        b = jr.replay_repaired_topology(tj, sj, policy, 3, upto)
        assert _csr_equal(a, b)


def _run_pair(graph, base, kw):
    tt, tj = _topos(graph)
    st = tf.build_schedule(tt.num_nodes, **kw)
    sj = jf.build_schedule(tj.num_nodes, **kw)
    rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", fault_schedule=st,
                                            **base))
    rj = jx.run_simulation(tj, jx.RunConfig(fault_schedule=sj, **base))
    return rt, rj


def _assert_same_run(rt, rj, fields):
    assert (rt.rounds, rt.converged) == (rj.rounds, rj.converged)
    for f in fields:
        a = getattr(rt.final_state, f).numpy()
        b = np.asarray(getattr(rj.final_state, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    want = [m for m in rj.metrics if m.get("event") == "repair"]
    got = [m for m in rt.metrics if m.get("event") == "repair"]
    keys = ("round", "policy", "changed", "nodes_pruned", "edges_dropped",
            "edges_spliced", "stubs_unmatched")
    assert [[m[k] for k in keys] for m in got] == [
        [m[k] for k in keys] for m in want]


@pytest.mark.parametrize("policy", ["prune", "rewire"])
def test_gossip_repair_run_bitwise(policy):
    rt, rj = _run_pair("line", dict(algorithm="gossip", seed=1,
                                    repair=policy, max_rounds=300,
                                    chunk_rounds=16),
                       dict(fail_fraction=0.1, fail_round=4, seed=1))
    _assert_same_run(rt, rj, ("counts", "converged", "alive"))


def test_pushsum_rewire_run_bitwise():
    """An interior kill on a line: rewire keeps the survivors together,
    across a revive that re-attaches the returning nodes."""
    rt, rj = _run_pair("line", dict(algorithm="push-sum", seed=7,
                                    repair="rewire", predicate="global",
                                    tol=1e-3, max_rounds=200,
                                    chunk_rounds=16),
                       dict(fail_fraction=0.1, fail_round=4, revive_round=9,
                            seed=7))
    _assert_same_run(rt, rj, ("s", "w", "ratio", "streak", "converged",
                              "alive"))


def test_fanout_all_rewire_bitwise_with_jax_pallas():
    """The pallas delivery rebuilt mid-run from the rewired CSR (its
    plan-cache key changes with the adjacency): bitwise the JAX package's
    pallas run over 30 rounds."""
    base = dict(algorithm="push-sum", fanout="all", delivery="pallas",
                seed=7, repair="rewire", predicate="global", max_rounds=30,
                plan_cache="none")
    rt, rj = _run_pair("line", base, dict(fail_fraction=0.1, fail_round=5,
                                          seed=7))
    assert any(m.get("event") == "repair" and m["changed"]
               for m in rt.metrics)
    _assert_same_run(rt, rj, ("s", "w", "ratio", "streak", "converged",
                              "alive"))


def test_rewire_keeps_line_survivors_alive():
    """Under ``off`` an interior kill strands a segment (the partition
    rule kills it); under ``rewire`` every survivor stays alive."""
    tt, _ = _topos("line")
    sched = tf.FaultSchedule.from_events(kills={3: [20, 21, 40]})
    base = tx.RunConfig(algorithm="push-sum", fanout="all",
                        delivery="pallas", seed=0, device="cpu",
                        predicate="global", max_rounds=20,
                        fault_schedule=sched)
    off = tx.run_simulation(tt, base)
    rew = tx.run_simulation(tt, dataclasses.replace(base, repair="rewire"))
    assert int(off.final_state.alive.sum()) < 61
    assert int(rew.final_state.alive.sum()) == 61
