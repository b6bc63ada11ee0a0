"""PyTorch port, value faults and the health sentinel (events/plan.py
``value_fault_ids``, the engine's ``sentinel_bad_mask``,
``inject_value_fault``, ``quarantine_rows``, ``revive_rows`` and the trip
handling of its host loop): the injected rows, the poisoned and repaired
states and the runs under ``nan``, ``inf`` and ``scale:K`` with the
sentinel ``on``, ``quarantine`` and ``rollback`` equal the JAX engine's —
the trip round, the quarantined ids, the rollback target, the rounds and
the final state bitwise. The faults are decisive ones, far from the
256-ULP tripwire (the port sums the mass in XLA's CPU order,
``protocols/pushsum.py`` ``tree_sum0``). With the sentinel off the chunk
is the operation sequence of the chunk before the sentinel."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.engine import driver as jdriver
from gossipprotocol_tpu.events import plan as jp
from gossipprotocol_tpu.protocols.state import PushSumState as JState

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.engine import driver as tdriver
from gossipprotocol_tpu_torch.events import plan as tp
from gossipprotocol_tpu_torch.protocols.sampling import key_data, round_keys


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


@pytest.mark.parametrize("n,rate,model,rnd,seed", [
    (64, 0.05, "nan", 5, 7), (1000, 0.001, "inf", 6, 0),
    (4096, 0.3, "scale:-2.5", 1, 11), (100, 1.0, "stuck", 9, 2**33 + 1),
])
def test_value_fault_ids_equal(n, rate, model, rnd, seed):
    a = tp.value_fault_ids(
        n, tp.ValueFaultSpec(rate, model, rnd), run_seed=seed)
    b = jp.value_fault_ids(n, jp.ValueFaultSpec(rate, model, rnd),
                           run_seed=seed)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arg", ["0.05,nan", "0.1,scale:4,3", "0.1,inf,x",
                                 "2,nan", "0.1,scale:1", "0.1,stuck:3",
                                 "0.1,bogus", "0.1"])
def test_parse_value_faults_arg_equal(arg):
    out = []
    for mod in (tp, jp):
        try:
            v = mod.parse_value_faults_arg(arg)
            out.append((v.rate, v.model, v.round))
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


def _random_state(n, seed):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=n).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    s[rng.integers(0, n, 3)] = np.nan
    s[rng.integers(0, n, 2)] = np.inf
    w[rng.integers(0, n, 2)] = -0.5
    w[rng.integers(0, n, 2)] = 0.0
    fields = dict(s=s, w=w, ratio=(s / np.maximum(w, 1e-30)).astype(
        np.float32), streak=rng.integers(0, 4, n).astype(np.int32),
        converged=rng.random(n) < 0.3, alive=rng.random(n) < 0.8,
        round=np.int32(12))
    t = tx.PushSumState(**{k: torch.from_numpy(np.array(v))
                           for k, v in fields.items()})
    j = JState(**{k: jnp.asarray(v) for k, v in fields.items()})
    return t, j


def _equal(t, j):
    return all(getattr(t, f).numpy().tobytes()
               == np.asarray(getattr(j, f)).tobytes() for f in t._fields)


@pytest.mark.parametrize("mode", ["scaled", "index"])
def test_state_surgery_equals_jax(mode):
    t, j = _random_state(500, 3)
    assert np.array_equal(tdriver.sentinel_bad_mask(t).numpy(),
                          np.asarray(jdriver.sentinel_bad_mask(j)))
    ids = np.array([0, 7, 99, 499])
    ct = tx.RunConfig(algorithm="push-sum", value_mode=mode)
    cj = jx.RunConfig(algorithm="push-sum", value_mode=mode)
    assert _equal(tdriver.quarantine_rows(t, ids),
                  jdriver.quarantine_rows(j, ids))
    assert _equal(tdriver.revive_rows(t, ids, ct, 500),
                  jdriver.revive_rows(j, ids, cj, 500))
    for model in ("nan", "inf", "stuck", "scale:3.7", "scale:-1e6"):
        vt = tp.ValueFaultSpec(0.1, model, 4)
        vj = jp.ValueFaultSpec(0.1, model, 4)
        assert _equal(tdriver.inject_value_fault(t, ids, vt, ct, 500),
                      jdriver.inject_value_fault(j, ids, vj, cj, 500))
    # revived rows are bitwise initial rows
    init = tx.pushsum_init(500, value_mode=mode, device="cpu")
    rev = tdriver.revive_rows(t, np.arange(500), ct, 500)
    for f in ("s", "w", "ratio", "streak", "converged"):
        assert torch.equal(getattr(rev, f), getattr(init, f))


def test_ulp_drift_equals_jax():
    from gossipprotocol_tpu.obs.counters import ulp_drift

    for v, b in ((1.0, 1.0), (1.0000001, 1.0), (np.nan, 3.0),
                 (np.inf, 3.0), (12.5, 12.0), (0.0, 0.0)):
        v32, b32 = np.float32(v), np.float32(b)
        got, want = tdriver.ulp_drift(v32, b32), ulp_drift(v32, b32)
        assert got == want or (np.isnan(got) and np.isnan(want))


_MODELS = ("nan", "inf", "scale:1000")
_MODES = ("on", "quarantine", "rollback")


def _run(mod, plan_mod, topo, model, mode, tmp_path, tag, **extra):
    plan = plan_mod.EventPlan(value_faults=(
        plan_mod.ValueFaultSpec(0.05, model, 5),))
    kw = dict(seed=7, algorithm="push-sum", max_rounds=200,
              sentinel=mode, repair="rewire", chunk_rounds=4,
              event_plan=plan, **extra)
    if mode == "rollback":
        kw.update(checkpoint_every=1,
                  checkpoint_dir=str(tmp_path / tag))
    return mod.run_simulation(topo, mod.RunConfig(**kw))


@pytest.mark.parametrize("mode", _MODES)
@pytest.mark.parametrize("model", _MODELS)
def test_sentinel_runs_equal_jax(model, mode, tmp_path):
    """The trip at the same round with the same cause, the same rows
    quarantined, the same rollback; then the same rounds and final state
    bitwise. (``scale:1000`` is finite: no row is bad, the host's mass
    tripwire trips and the loop accepts the new mass level.)"""
    rt = _run(tx, tp, tx.build_topology("imp3D", 64), model, mode,
              tmp_path, "t", device="cpu")
    rj = _run(jx, jp, jx.build_topology("imp3D", 64), model, mode,
              tmp_path, "j")

    def events(res):
        return [(m["event"], m["round"], m.get("cause"), m.get("nodes"),
                 m.get("ids"), m.get("from_round"))
                for m in res.metrics if "event" in m
                and m["event"] != "repair"]

    assert events(rt) == events(rj)
    assert any(e[0] == "sentinel_trip" for e in events(rt))
    if model != "scale:1000" and mode != "on":
        quar = [e for e in events(rt) if e[0] == "quarantine"]
        want = tp.value_fault_ids(64, tp.ValueFaultSpec(0.05, model, 5),
                                  run_seed=7)
        assert quar and quar[0][4] == want.tolist()
    assert (rt.rounds, rt.converged) == (rj.rounds, rj.converged)
    for f in ("s", "w", "ratio", "streak", "converged", "alive"):
        a = getattr(rt.final_state, f).numpy()
        b = np.asarray(getattr(rj.final_state, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


class _Ops(TorchDispatchMode):
    """Record the aten operations run under it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _pre_sentinel_chunk(round_core, done_fn, extra_stats, base_key):
    """The chunk as the engine ran it before the sentinel existed."""
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


@pytest.mark.parametrize("cfg", [
    dict(algorithm="push-sum"),
    dict(algorithm="push-sum", fanout="all", delivery="pallas"),
    dict(algorithm="gossip"),
], ids=["fanout_one", "pallas", "gossip"])
def test_sentinel_off_chunk_is_the_pre_sentinel_chunk(cfg):
    topo = tx.build_topology("imp3D", 64)
    plan = (tp.EventPlan(value_faults=(tp.ValueFaultSpec(0.1, "nan", 3),))
            if cfg["algorithm"] == "push-sum" else None)
    rc = tx.RunConfig(device="cpu", event_plan=plan, plan_cache="none",
                      **cfg)
    state, core, done, _ = tdriver.build_protocol(topo, rc)
    delivery = tdriver.device_arrays(topo, rc)
    extra = core.extra_stats if isinstance(core, tdriver.GossipCore) else None
    key = key_data(0, "cpu") if tdriver.draws(rc) else None
    seqs = []
    for make in (
            lambda: tdriver.make_chunk_runner(core, done, extra,
                                              base_key=key),
            lambda: _pre_sentinel_chunk(core, done, extra, key)):
        with _Ops() as rec:
            out, stats = make()(state, delivery, 0, 3)
        seqs.append((rec.ops, stats.tolist(), out))
    assert seqs[0][0] == seqs[1][0] and seqs[0][1] == seqs[1][1]
    if cfg["algorithm"] == "push-sum":
        on = tdriver.make_chunk_runner(
            core, done, extra, base_key=key,
            sentinel_fn=tdriver.make_sentinel_fn(rc))
        with _Ops() as rec:
            _, stats_on = on(state, delivery, 0, 3)
        assert len(rec.ops) > len(seqs[0][0])
        assert stats_on.tolist()[:2] == seqs[0][1][:2]
