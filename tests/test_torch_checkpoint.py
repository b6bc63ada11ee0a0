"""PyTorch port, checkpoints and resume (utils/checkpoint.py, the engine's
saves, ``--resume``, ``--auto-resume``): a checkpoint holds the JAX
package's array names, dtypes and ``__meta__`` keys for the same run (the
port's tag and ``saved_at`` excepted) and the same values; a run resumed
from a checkpoint in the middle ends bitwise where the uninterrupted run
ends, also across fault strikes, repair, churn and a sentinel quarantine;
a trajectory-field mismatch and a JAX checkpoint are refused with exit
2; ``resume_argv`` is the JAX CLI's; a sticky CUDA error re-executes the
CLI from the newest checkpoint and a program error is raised."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import gossipprotocol_tpu as jx
from gossipprotocol_tpu import cli as jcli
from gossipprotocol_tpu.events import plan as jp
from gossipprotocol_tpu.utils import checkpoint as jck
from gossipprotocol_tpu.utils import faults as jf

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch import cli as tcli
from gossipprotocol_tpu_torch.engine import resume_simulation
from gossipprotocol_tpu_torch.events import plan as tp
from gossipprotocol_tpu_torch.utils import checkpoint as tck
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


_KILL = dict(fail_fraction=0.1, fail_round=5, seed=2)


@pytest.mark.parametrize("algorithm", ["gossip", "push-sum"])
def test_checkpoint_files_match_jax(tmp_path, algorithm):
    """The same run saved by both engines every 4-round chunk: the same
    files, arrays (names, dtypes, shapes, bytes) and metadata."""
    base = dict(algorithm=algorithm, seed=2, max_rounds=12, chunk_rounds=4,
                checkpoint_every=1)
    tt, tj = tx.build_topology("imp3D", 64), jx.build_topology("imp3D", 64)
    rt = tx.run_simulation(tt, tx.RunConfig(
        device="cpu", fault_schedule=tf.build_schedule(64, **_KILL),
        checkpoint_dir=str(tmp_path / "t"), **base))
    rj = jx.run_simulation(tj, jx.RunConfig(
        fault_schedule=jf.build_schedule(64, **_KILL),
        checkpoint_dir=str(tmp_path / "j"), **base))
    names = [os.path.basename(p) for p in rt.checkpoints]
    assert names == [os.path.basename(p) for p in rj.checkpoints]
    assert len(names) >= 3
    for pt, pj in zip(rt.checkpoints, rj.checkpoints):
        with np.load(pt) as zt, np.load(pj) as zj:
            assert sorted(zt.files) == sorted(zj.files)
            for f in zt.files:
                if f == "__meta__":
                    continue
                a, b = zt[f], zj[f]
                assert (a.dtype, a.shape) == (b.dtype, b.shape), f
                assert a.tobytes() == b.tobytes(), f
            mt = json.loads(str(zt["__meta__"]))
            mj = json.loads(str(zj["__meta__"]))
        assert mt.pop(tck.PACKAGE_KEY) == tck.PACKAGE_TAG
        mt.pop("saved_at"), mj.pop("saved_at")
        assert mt == mj


def test_trajectory_meta_matches_jax():
    kw = dict(fail_fraction=0.2, fail_round=3, revive_round=8,
              drop_prob=0.1, seed=4)
    cfgs = (
        (tx.RunConfig(algorithm="push-sum", fanout="all", delivery="pallas",
                      repair="rewire", seed=4, predicate="global",
                      fault_schedule=tf.build_schedule(64, **{
                          k: v for k, v in kw.items() if k != "drop_prob"}),
                      event_plan=tp.EventPlan(
                          churn=tp.ChurnSpec(0.1, "swap", 5))),
         jx.RunConfig(algorithm="push-sum", fanout="all", delivery="pallas",
                      repair="rewire", seed=4, predicate="global",
                      fault_schedule=jf.build_schedule(64, **{
                          k: v for k, v in kw.items() if k != "drop_prob"}),
                      event_plan=jp.EventPlan(
                          churn=jp.ChurnSpec(0.1, "swap", 5)))),
        (tx.RunConfig(algorithm="gossip", alert_quorum=7, threshold=4,
                      fault_schedule=tf.build_schedule(64, **kw)),
         jx.RunConfig(algorithm="gossip", alert_quorum=7, threshold=4,
                      fault_schedule=jf.build_schedule(64, **kw))),
        (tx.RunConfig(algorithm="push-sum", event_plan=tp.EventPlan(
            value_faults=(tp.ValueFaultSpec(0.1, "nan", 3),)),
            sentinel="quarantine"),
         jx.RunConfig(algorithm="push-sum", event_plan=jp.EventPlan(
             value_faults=(jp.ValueFaultSpec(0.1, "nan", 3),)),
             sentinel="quarantine")),
    )
    for ct, cj in cfgs:
        assert tck.trajectory_meta(ct) == jck.trajectory_meta(cj)
    assert tck.TRAJECTORY_FIELDS == jck.TRAJECTORY_FIELDS
    assert tck.LEGACY_FIELD_DEFAULTS == jck.LEGACY_FIELD_DEFAULTS


def _bitwise(a, b):
    return all(x.dtype == y.dtype and torch.equal(
        x.view(torch.int32) if x.dtype == torch.float32 else x,
        y.view(torch.int32) if y.dtype == torch.float32 else y)
        for x, y in zip(a, b))


_RESUMES = {
    "pushsum_faults": ("imp3D", 216, dict(
        algorithm="push-sum", seed=3, predicate="global", tol=1e-3,
        max_rounds=120, fault_schedule=tf.build_schedule(
            216, fail_fraction=0.1, fail_round=5, revive_round=17,
            drop_prob=0.2, seed=3))),
    "pallas_repair_churn": ("imp3D", 216, dict(
        algorithm="push-sum", fanout="all", delivery="pallas", seed=3,
        predicate="global", max_rounds=60, repair="rewire",
        plan_cache="none",
        fault_schedule=tf.build_schedule(216, fail_fraction=0.1,
                                         fail_round=5, seed=3),
        event_plan=tp.EventPlan(churn=tp.ChurnSpec(0.05, "swap", 9)))),
    "gossip_events": ("line", 64, dict(
        algorithm="gossip", seed=1, max_rounds=400, repair="prune",
        fault_schedule=tf.build_schedule(64, fail_fraction=0.05,
                                         fail_round=3, seed=1),
        event_plan=tp.EventPlan.from_events(adds={7: [[0, 30]]}))),
}


@pytest.mark.parametrize("case", list(_RESUMES))
def test_resume_mid_run_is_bitwise(tmp_path, case):
    name, n, kw = _RESUMES[case]
    topo = tx.build_topology(name, n)
    cfg = tx.RunConfig(device="cpu", chunk_rounds=4, checkpoint_every=1,
                       checkpoint_dir=str(tmp_path), **kw)
    full = tx.run_simulation(topo, cfg)
    assert len(full.checkpoints) >= 4
    for path in full.checkpoints[1:len(full.checkpoints) // 2 + 2]:
        state, meta = tck.load(path)
        assert int(state.round) == meta["round"] < full.rounds
        res = resume_simulation(topo, dataclasses.replace(
            cfg, checkpoint_every=0, checkpoint_dir=None), state)
        assert (res.rounds, res.converged) == (full.rounds, full.converged)
        assert _bitwise(res.final_state, full.final_state), path


def test_resume_after_a_quarantine_is_bitwise(tmp_path):
    """The checkpoint's "quarantines" metadata is replayed into the
    adjacency on resume (the CLI's path), so the resumed run continues on
    the quarantined, rewired graph."""
    topo = tx.build_topology("imp3D", 64)
    cfg = tx.RunConfig(
        algorithm="push-sum", seed=7, max_rounds=200, device="cpu",
        sentinel="quarantine", repair="rewire", chunk_rounds=4,
        checkpoint_every=1, checkpoint_dir=str(tmp_path),
        event_plan=tp.EventPlan(value_faults=(
            tp.ValueFaultSpec(0.05, "nan", 5),)))
    full = tx.run_simulation(topo, cfg)
    assert full.converged
    after = [p for p in full.checkpoints if tck.peek_meta(p)["round"] > 8]
    state, meta = tck.load(after[0])
    assert meta["quarantines"][0][0] == 5
    res = resume_simulation(topo, dataclasses.replace(
        cfg, checkpoint_every=0, checkpoint_dir=None,
        quarantine_log=tuple((int(r), tuple(ids))
                             for r, ids in meta["quarantines"])), state)
    assert res.rounds == full.rounds
    assert _bitwise(res.final_state, full.final_state)


def _cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_refuses_mismatch_and_jax_checkpoints(tmp_path, capsys):
    argv = ["64", "imp3D", "push-sum", "--chunk-rounds", "4",
            "--max-rounds", "12", "--checkpoint-every", "1",
            "--fail-fraction", "0.1", "--fail-round", "3"]
    dirs = {"t": str(tmp_path / "t"), "j": str(tmp_path / "j")}
    assert _cli(tcli.main, argv + ["--device", "cpu", "--checkpoint-dir",
                                   dirs["t"]], capsys)[0] == 1
    assert _cli(jcli.main, argv + ["--backend", "cpu", "--checkpoint-dir",
                                   dirs["j"]], capsys)[0] == 1
    # a trajectory-field mismatch, in the JAX CLI's words
    bad = ["64", "imp3D", "push-sum", "--seed", "5", "--fail-fraction",
           "0.1", "--fail-round", "3", "--repair", "prune"]
    rc_t, _, err_t = _cli(tcli.main, bad + ["--device", "cpu", "--resume",
                                            dirs["t"]], capsys)
    rc_j, _, err_j = _cli(jcli.main, bad + ["--backend", "cpu", "--resume",
                                            dirs["j"]], capsys)
    assert rc_t == rc_j == 2
    assert err_t.startswith("checkpoint mismatch: seed 0 != 5")
    assert err_t == err_j
    # a checkpoint of the JAX package, named or in a directory
    for target in (dirs["j"], tck.latest(dirs["j"])):
        rc, out, err = _cli(tcli.main, argv + ["--device", "cpu",
                                               "--resume", target], capsys)
        assert rc == 2 and out == ""
        assert "gossipprotocol_tpu" in err and "JAX package" in err
    with pytest.raises(tck.ForeignCheckpointError):
        tck.load(tck.latest(dirs["j"]))
    # the port's own checkpoint resumes
    rc, out, _ = _cli(tcli.main, argv + ["--device", "cpu", "--resume",
                                         dirs["t"], "--max-rounds", "40"],
                      capsys)
    assert rc in (0, 1) and "Push Sum Starts" in out
    empty = tmp_path / "empty"
    empty.mkdir()
    for target in (empty, tmp_path / "absent.npz"):
        head = ["64", "imp3D", "gossip", "--resume", str(target)]
        got = _cli(tcli.main, head + ["--device", "cpu"], capsys)
        want = _cli(jcli.main, head + ["--backend", "cpu"], capsys)
        assert got == want and got[0] == 2


_ARGVS = [
    ["100", "line", "gossip"],
    ["100", "line", "gossip", "--resume", "old", "--auto-resume", "3"],
    ["100", "line", "gossip", "--resume=old", "--auto-resume=3",
     "--restarted", "--seed", "4"],
    ["64", "imp3D", "push-sum", "--checkpoint-dir", "d",
     "--checkpoint-every", "2", "--auto-resume", "1"],
]


@pytest.mark.parametrize("argv", _ARGVS, ids=range(len(_ARGVS)))
@pytest.mark.parametrize("target", [None, "ckdir"])
def test_resume_argv_equals_jax(argv, target):
    assert tcli.resume_argv(argv, target, 2) == jcli.resume_argv(
        argv, target, 2)


def test_auto_resume_reexecs_on_a_sticky_cuda_error(tmp_path, monkeypatch,
                                                    capsys):
    from gossipprotocol_tpu_torch.engine import driver

    argv = ["64", "imp3D", "push-sum", "--device", "cpu", "--chunk-rounds",
            "4", "--checkpoint-every", "1", "--checkpoint-dir",
            str(tmp_path), "--auto-resume", "2"]
    # a first run leaves checkpoints behind
    assert _cli(tcli.main, argv + ["--max-rounds", "8"], capsys)[0] == 1
    seen = []
    monkeypatch.setattr(tcli, "_reexec",
                        lambda new_argv: seen.append(new_argv) or 0)

    def dies(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(driver, "run_simulation", dies)
    rc, out, err = _cli(tcli.main, argv, capsys)
    assert rc == 0
    assert seen == [tcli.resume_argv(argv, str(tmp_path), 1)]
    assert "accelerator runtime died (RuntimeError); resuming from" in err

    def bug(*a, **k):
        raise RuntimeError("index 7 is out of bounds")

    monkeypatch.setattr(driver, "run_simulation", bug)
    with pytest.raises(RuntimeError, match="out of bounds"):
        tcli.main(argv)
    assert len(seen) == 1
    assert not tcli._is_runtime_death(ValueError(
        "an illegal memory access was encountered"))
