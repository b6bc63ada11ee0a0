"""PyTorch port, the CLI flags of faults, events, repair, checkpoints and
the sentinel: every run prints the JAX CLI's lines (the banner, the
convergence time line, the round count and verdict, the estimate error)
with the same exit code, and every bad spec exits 2 with the JAX CLI's
message; ``--devices 2`` with any of these flags exits 2 and names it;
none of them is left in ``UNPORTED_FLAGS``."""

from __future__ import annotations

import json
import re

import pytest
import torch

from gossipprotocol_tpu.cli import main as jax_main

from gossipprotocol_tpu_torch import cli as tcli


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


SLICE_FLAGS = ("--fail-fraction", "--fail-round", "--revive-round",
               "--drop-prob", "--drop-window", "--fault-plan",
               "--event-plan", "--churn", "--value-faults", "--sentinel",
               "--checkpoint-dir", "--checkpoint-every", "--resume",
               "--auto-resume", "--restarted")


def test_slice_flags_are_ported():
    assert not set(SLICE_FLAGS) & set(tcli.UNPORTED_FLAGS)


def _both(argv, capsys):
    """``((rc, out, err) of the port, (rc, out, err) of the JAX CLI)``."""
    got = tcli.main(argv + ["--device", "cpu"])
    t = capsys.readouterr()
    try:
        want = jax_main(argv)
    except SystemExit as e:  # the JAX CLI lets argparse exit
        want = e.code
    j = capsys.readouterr()
    return (got, t.out, t.err), (want, j.out, j.err)


def _summary(out):
    """The lines both CLIs print alike, and (rounds, converged) from the
    rounds line (the port adds the executed rounds and its device)."""
    lines = [ln for ln in out.splitlines()
             if not ln.startswith(("Convergence Time:", "rounds:"))]
    m = re.search(r"^rounds: (\d+) .*converged: (\w+)", out, re.M)
    assert re.search(r"^Convergence Time: [0-9.]+ ms$", out, re.M)
    return lines, (int(m.group(1)), m.group(2))


_PLAN = {"add_edges": [{"round": 3, "edges": [[0, 40]]}],
         "kill": [{"round": 4, "ids": [7, 8]}],
         "revive": [{"round": 9, "ids": [7]}],
         "loss": [{"start": 0, "stop": 6, "prob": 0.2}]}

_RUNS = {
    "gossip_kill": ["64", "imp3D", "gossip", "--fail-fraction", "0.1",
                    "--fail-round", "3"],
    "gossip_churn": ["64", "imp3D", "gossip", "--churn", "0.1,edge,5"],
    "pushsum_loss_revive": ["64", "imp3D", "push-sum", "--drop-prob",
                            "0.2", "--drop-window", "0", "10",
                            "--fail-fraction", "0.1", "--fail-round", "2",
                            "--revive-round", "8", "--predicate", "global"],
    "pushsum_plan": ["64", "imp3D", "push-sum", "--event-plan", "{plan}",
                     "--repair", "prune", "--predicate", "global"],
    "pushsum_fault_plan": ["64", "line", "push-sum", "--fault-plan",
                           "{plan}", "--max-rounds", "60"],
    "sentinel_quarantine": ["64", "imp3D", "push-sum", "--value-faults",
                            "0.05,nan,5", "--sentinel", "quarantine",
                            "--repair", "rewire"],
    "sentinel_on": ["64", "imp3D", "push-sum", "--value-faults",
                    "0.05,inf,5", "--sentinel"],
    "pallas_rewire": ["64", "line", "push-sum", "--fanout", "all",
                      "--delivery", "pallas", "--fail-fraction", "0.1",
                      "--fail-round", "4", "--repair", "rewire",
                      "--predicate", "global", "--max-rounds", "30"],
}


@pytest.mark.parametrize("run", list(_RUNS))
def test_runs_print_the_jax_lines(run, tmp_path, capsys):
    plan = tmp_path / "plan.json"
    doc = dict(_PLAN)
    if run == "pushsum_fault_plan":
        doc = {k: v for k, v in doc.items() if k != "add_edges"}
    plan.write_text(json.dumps(doc))
    argv = [a.replace("{plan}", str(plan)) for a in _RUNS[run]]
    # the same chunks on both sides: a stop found at a chunk end is the
    # same round
    argv += ["--chunk-rounds", "4"]
    (rc_t, out_t, err_t), (rc_j, out_j, err_j) = _both(argv, capsys)
    assert rc_t == rc_j, (err_t, err_j)
    assert _summary(out_t) == _summary(out_j)
    assert err_t == err_j == ""


_BAD = [
    ["64", "imp3D", "gossip", "--revive-round", "9"],
    ["64", "imp3D", "gossip", "--fail-fraction", "0.1", "--fail-round",
     "5", "--revive-round", "5"],
    ["64", "imp3D", "gossip", "--drop-window", "0", "5"],
    ["64", "imp3D", "gossip", "--fault-plan", "{missing}"],
    ["64", "imp3D", "gossip", "--fault-plan", "{bad}"],
    ["64", "imp3D", "gossip", "--event-plan", "{bad}"],
    ["64", "imp3D", "gossip", "--churn", "0.1,teleport"],
    ["64", "imp3D", "gossip", "--churn", "0.1"],
    ["64", "full", "gossip", "--churn", "0.1,edge"],
    ["64", "imp3D", "push-sum", "--value-faults", "0.1,nan,0"],
    ["64", "imp3D", "push-sum", "--value-faults", "x,nan"],
    ["64", "imp3D", "push-sum", "--value-faults", "0.1,nan",
     "--event-plan", "{vf}"],
    ["64", "imp3D", "gossip", "--value-faults", "0.1,nan"],
    ["64", "imp3D", "gossip", "--sentinel"],
    ["64", "imp3D", "push-sum", "--sentinel", "rollback"],
    ["64", "imp3D", "gossip", "--semantics", "reference", "--repair",
     "prune"],
    ["64", "imp3D", "gossip", "--semantics", "reference", "--churn",
     "0.1,edge"],
    ["64", "imp3D", "push-sum", "--fanout", "all", "--delivery",
     "pallas", "--drop-prob", "0.1"],
    ["64", "imp3D", "push-sum", "--fanout", "all", "--delivery",
     "megakernel", "--rounds-per-kernel", "4", "--fail-fraction", "0.1"],
    ["64", "imp3D", "push-sum", "--fanout", "all", "--delivery",
     "megakernel", "--sentinel"],
]


@pytest.mark.parametrize("argv", _BAD, ids=range(len(_BAD)))
def test_bad_specs_exit_2_with_the_jax_message(argv, tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"kill": [{"round": 3}], "bogus": 1}))
    vf = tmp_path / "vf.json"
    vf.write_text(json.dumps({"value_faults": [{"rate": 0.1,
                                                 "model": "inf"}]}))
    subs = {"{missing}": str(tmp_path / "missing.json"), "{bad}": str(bad),
            "{vf}": str(vf)}
    argv = [subs.get(a, a) for a in argv]
    (rc_t, out_t, err_t), (rc_j, out_j, err_j) = _both(argv, capsys)
    assert rc_t == rc_j == 2
    assert err_t == err_j and err_t
    assert out_t == out_j


def test_reference_walk_with_faults_raises_as_jax(capsys):
    """The JAX engine refuses faults on the reference walk from inside
    the run (a ValueError the CLI does not catch); so does the port."""
    argv = ["64", "imp3D", "push-sum", "--semantics", "reference",
            "--fail-fraction", "0.1"]
    msgs = []
    for main, extra in ((tcli.main, ["--device", "cpu"]), (jax_main, [])):
        with pytest.raises(ValueError) as e:
            main(argv + extra)
        msgs.append(str(e.value))
    capsys.readouterr()
    assert msgs[0] == msgs[1] and "cannot take faults" in msgs[0]


@pytest.mark.parametrize("argv", [
    ["64", "imp3D", "gossip", "--fail-fraction", "1.5"],
    ["64", "imp3D", "gossip", "--drop-prob", "-0.1"],
    ["64", "imp3D", "gossip", "--sentinel", "maybe"],
    ["64", "imp3D", "gossip", "--repair", "heal"],
])
def test_usage_errors_exit_2_as_jax(argv, capsys):
    """argparse's own errors: the same last line but for the program
    name."""
    (rc_t, _, err_t), (rc_j, _, err_j) = _both(argv, capsys)
    assert rc_t == rc_j == 2
    last_t = err_t.strip().splitlines()[-1]
    last_j = err_j.strip().splitlines()[-1]
    assert last_t.replace("gossipprotocol_tpu_torch",
                          "gossipprotocol_tpu") == last_j


_PALLAS = ["--fanout", "all", "--delivery", "pallas"]


@pytest.mark.parametrize("flags,name", [
    (_PALLAS + ["--fail-fraction", "0.1"], "--fail-fraction"),
    (["--drop-prob", "0.1"], "--drop-prob"),
    (_PALLAS + ["--churn", "0.1,edge"], "--churn"),
    (_PALLAS + ["--repair", "rewire"], "--repair"),
    (_PALLAS + ["--sentinel"], "--sentinel"),
    (_PALLAS + ["--value-faults", "0.1,nan"], "--value-faults"),
    (_PALLAS + ["--checkpoint-dir", "d", "--checkpoint-every", "1"],
     "--checkpoint-dir"),
    (_PALLAS + ["--resume", "d"], "--resume"),
    (_PALLAS + ["--auto-resume", "2"], "--auto-resume"),
])
def test_devices_refuse_every_slice_flag(flags, name, capsys):
    rc = tcli.main(["64", "imp3D", "push-sum", "--devices", "2",
                    "--device", "cpu"] + flags)
    err = capsys.readouterr().err
    assert rc == 2
    assert err.startswith(f"option not yet ported with --devices: {name}")


def test_sharded_engine_refuses_slice_configs():
    import gossipprotocol_tpu_torch as tx
    from gossipprotocol_tpu_torch.engine.driver import NotPortedError
    from gossipprotocol_tpu_torch.parallel import run_simulation_sharded
    from gossipprotocol_tpu_torch.utils import faults

    topo = tx.build_topology("imp3D", 64)
    cfg = tx.RunConfig(algorithm="push-sum", fanout="all", delivery="pallas",
                       device="cpu", repair="rewire",
                       fault_schedule=faults.build_schedule(
                           64, fail_fraction=0.1, fail_round=2))
    with pytest.raises(NotPortedError, match="--fail-fraction.*--repair"):
        run_simulation_sharded(topo, cfg, num_devices=2)
