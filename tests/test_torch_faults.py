"""PyTorch port, fault schedules and loss windows (utils/faults.py, the
drop draws of protocols/sampling.py, and the engine's kill/revive
strikes): the schedule model, its digest and the drop draws byte for byte
the JAX package's; gossip and fanout-one push-sum runs under kills,
revives and loss bitwise the JAX engine's (same chunks on both sides: a
stalled rumor stops at a chunk end). The fused deliveries under a kill
strike are in ``test_torch_faults_fused.py``."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.protocols import sampling as js
from gossipprotocol_tpu.utils import faults as jf

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.protocols import sampling as ts
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


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def _assert_final_equal(rt, rj, fields):
    assert rt.rounds == rj.rounds
    assert rt.converged == rj.converged
    for f in fields:
        a = getattr(rt.final_state, f).numpy()
        b = np.asarray(getattr(rj.final_state, f))
        assert _bits_equal(a, b), f


# ---------------------------------------------------------- the schedule

_SUGAR = [
    dict(fail_fraction=0.1, fail_round=5),
    dict(fail_fraction=0.25, fail_round=3, revive_round=9, seed=4),
    dict(drop_prob=0.2),
    dict(drop_prob=0.3, drop_window=(2, 17), fail_fraction=0.05,
         fail_round=1, seed=9),
]


@pytest.mark.parametrize("kw", _SUGAR, ids=range(len(_SUGAR)))
def test_build_schedule_and_digest_equal(kw):
    a = tf.build_schedule(300, max_rounds=500, **kw)
    b = jf.build_schedule(300, max_rounds=500, **kw)
    assert a.digest() == b.digest()
    assert a.static_loss_windows() == b.static_loss_windows()
    for name in ("kills", "revives"):
        ta, tb = getattr(a, name), getattr(b, name)
        assert sorted(ta) == sorted(tb)
        for r in ta:
            assert _bits_equal(np.asarray(ta[r]), np.asarray(tb[r]))


_DOC = {
    "kill": [{"round": 5, "ids": [3, 4]}, {"round": 5, "ids": [4, 6]},
             {"round": 12, "fraction": 0.25, "seed": 7}],
    "revive": [{"round": 30, "ids": [3, 4]}],
    "loss": [{"start": 0, "stop": 15, "prob": 0.1},
             {"start": 10, "stop": 20, "prob": 0.35}],
}
_BAD = [
    {"kill": [{"round": 5}]},
    {"bogus": []},
    {"loss": [{"start": 4, "stop": 4, "prob": 0.1}]},
    {"loss": [{"start": 0, "stop": 4, "prob": 1.0}]},
    {"kill": [{"round": 2, "ids": [1]}], "revive": [{"round": 2,
                                                       "ids": [1]}]},
    {"kill": [{"round": 2, "ids": [400]}]},
    [1, 2],
]


def test_fault_plan_json_and_merge_equal(tmp_path):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(_DOC))
    a = tf.FaultSchedule.from_json(str(path), 64, seed=3)
    b = jf.FaultSchedule.from_json(str(path), 64, seed=3)
    assert a.digest() == b.digest() != "none"
    sugar = (tf.build_schedule(64, fail_fraction=0.1, fail_round=5),
             jf.build_schedule(64, fail_fraction=0.1, fail_round=5))
    assert (tf.merge_schedules(a, sugar[0]).digest()
            == jf.merge_schedules(b, sugar[1]).digest())
    assert tf.FaultSchedule().digest() == jf.FaultSchedule().digest()
    assert (tf.as_schedule(None, {7: [1, 2]}).digest()
            == jf.as_schedule(None, {7: [1, 2]}).digest())


@pytest.mark.parametrize("doc", _BAD, ids=range(len(_BAD)))
def test_bad_fault_plans_raise_the_same_message(doc):
    msgs = []
    for mod in (tf, jf):
        with pytest.raises(ValueError) as e:
            mod.FaultSchedule.from_json(doc, 300)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kw", [
    dict(revive_round=9),
    dict(fail_fraction=0.1, fail_round=5, revive_round=5),
    dict(drop_window=(0, 5)),
])
def test_bad_sugar_raises_the_same_message(kw):
    msgs = []
    for mod in (tf, jf):
        with pytest.raises(ValueError) as e:
            mod.build_schedule(64, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("graph", ["line", "imp3D", "er", "full"])
def test_partition_rule_equal(graph):
    name, n, kw = {"line": ("line", 64, {}), "imp3D": ("imp3D", 216, {}),
                   "er": ("erdos_renyi", 300, {"seed": 2,
                                               "avg_degree": 3.0}),
                   "full": ("full", 40, {})}[graph]
    tt, tj = tx.build_topology(name, n, **kw), jx.build_topology(name, n,
                                                                 **kw)
    rng = np.random.default_rng(11)
    for frac in (0.05, 0.3, 0.9):
        alive = rng.random(tt.num_nodes) > frac
        for policy in ("off", "prune", "rewire"):
            assert _bits_equal(tf.apply_partition_rule(tt, alive, policy),
                               jf.apply_partition_rule(tj, alive, policy))


# ---------------------------------------------------------- the drop draws

def test_loss_probability_bitwise():
    """Overlapping windows over rounds 0-60, each factor 1 - p rounded
    once from the double, composed in float32."""
    rng = np.random.default_rng(5)
    for _ in range(6):
        windows = tuple(
            (int(a), int(a + rng.integers(1, 30)), float(rng.random() * 0.9))
            for a in rng.integers(0, 40, size=rng.integers(1, 4)))
        for r in range(0, 61, 3):
            mine = ts.loss_probability(torch.tensor(r, dtype=torch.int32),
                                       windows)
            want = js.loss_probability(jnp.int32(r), windows)
            assert mine.dtype == torch.float32
            assert _bits_equal(mine.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_drop_mask_bitwise(seed):
    """Random round keys, probabilities (incl. 0 and values whose 2³²
    multiple sits near a float32 rounding step of the draw) and id pairs:
    the drop decisions are the JAX package's, per sender and per edge."""
    rng = np.random.default_rng(seed & 0xFFFF)
    n = 5000
    ids = np.arange(n, dtype=np.int32)
    ids2 = rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
    base_t = ts.key_data(seed, device="cpu")
    base_j = jax.random.key(seed & 0xFFFFFFFF)
    probs = [0.0, 0.2, 0.5, 1 - 2**-24, float(np.float32(rng.random()))]
    for r in (0, 3, 17):
        kt = ts.fold_in(ts.fold_in(base_t, r), ts.LOSS_FOLD)
        kj = jax.random.fold_in(jax.random.fold_in(base_j, r), js.LOSS_FOLD)
        for p in probs:
            pt = torch.tensor(p, dtype=torch.float32)
            pj = jnp.float32(p)
            for second in (None, ids2):
                mine = ts.drop_mask(
                    kt, pt, torch.from_numpy(ids),
                    None if second is None else torch.from_numpy(second))
                want = js.drop_mask(kj, pj, jnp.asarray(ids),
                                    None if second is None
                                    else jnp.asarray(second))
                assert np.array_equal(mine.numpy(), np.asarray(want))


# ---------------------------------------------------------- the runs

_RUNS = {
    "kill": dict(fail_fraction=0.15, fail_round=4),
    "kill_revive": dict(fail_fraction=0.2, fail_round=3, revive_round=11),
    "loss": dict(drop_prob=0.3, drop_window=(2, 30)),
    "all": dict(fail_fraction=0.1, fail_round=6, revive_round=14,
                drop_prob=0.25, drop_window=(0, 20)),
}


def _schedules(n, seed, kw, max_rounds):
    return (tf.build_schedule(n, seed=seed, max_rounds=max_rounds, **kw),
            jf.build_schedule(n, seed=seed, max_rounds=max_rounds, **kw))


_GRAPHS = {"line": ("line", 64, {}), "imp3D": ("imp3D", 216, {"seed": 1})}
# each schedule on one graph: kills strand line segments, revives and
# loss mix on the lattice
_CASES = [("line", "kill"), ("line", "loss"), ("imp3D", "kill_revive"),
          ("imp3D", "all")]


@pytest.mark.parametrize("graph,run", _CASES)
def test_gossip_faults_bitwise(graph, run):
    name, n, kw = _GRAPHS[graph]
    tt, tj = tx.build_topology(name, n, **kw), jx.build_topology(name, n,
                                                                 **kw)
    st, sj = _schedules(tt.num_nodes, 3, _RUNS[run], 400)
    # the same chunks on both sides: a stalled rumor stops at a chunk end
    base = dict(algorithm="gossip", seed=3, max_rounds=400, chunk_rounds=16)
    rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", fault_schedule=st,
                                            **base))
    rj = jx.run_simulation(tj, jx.RunConfig(fault_schedule=sj, **base))
    _assert_final_equal(rt, rj, ("counts", "converged", "alive"))


@pytest.mark.parametrize("graph,run", _CASES)
def test_pushsum_fanout_one_faults_bitwise(graph, run):
    """The scatter round under kills, revives and loss: a dropped or
    undeliverable half stays at its sender; fresh-born revived rows."""
    name, n, kw = _GRAPHS[graph]
    tt, tj = tx.build_topology(name, n, **kw), jx.build_topology(name, n,
                                                                 **kw)
    st, sj = _schedules(tt.num_nodes, 5, _RUNS[run], 200)
    base = dict(algorithm="push-sum", seed=5, max_rounds=200,
                predicate="global", tol=1e-3, chunk_rounds=16)
    rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", fault_schedule=st,
                                            **base))
    rj = jx.run_simulation(tj, jx.RunConfig(fault_schedule=sj, **base))
    _assert_final_equal(rt, rj, ("s", "w", "ratio", "streak", "converged",
                                 "alive"))


def test_strikes_take_the_fast_paths_away():
    tt = tx.build_topology("imp3D", 64)
    from gossipprotocol_tpu_torch.engine.driver import build_protocol

    loss = tf.build_schedule(64, drop_prob=0.2)
    kill = tf.build_schedule(64, fail_fraction=0.1, fail_round=3)
    for sched, want in ((None, (True, True)), (loss, (True, True)),
                        (kill, (False, False))):
        cfg = tx.RunConfig(algorithm="push-sum", device="cpu",
                           fault_schedule=sched)
        assert build_protocol(tt, cfg)[3] == want


@pytest.mark.parametrize("cfg", [
    dict(algorithm="push-sum", fanout="all", delivery="pallas"),
    dict(algorithm="push-sum", fanout="all", delivery="routed"),
    dict(algorithm="push-sum", fanout="all", delivery="megakernel"),
])
def test_fused_deliveries_refuse_loss_as_jax(cfg):
    loss = (tf.build_schedule(64, drop_prob=0.2),
            jf.build_schedule(64, drop_prob=0.2))
    msgs = []
    for mod, sched in ((tx, loss[0]), (jx, loss[1])):
        with pytest.raises(ValueError) as e:
            mod.RunConfig(fault_schedule=sched, **cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
