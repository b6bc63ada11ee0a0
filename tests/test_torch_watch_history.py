"""PyTorch port, the offline tools (``obs/watch.py``, ``obs/history.py``)
and the serve daemon's host-side readers they use (``serve/journal.py``,
``serve/lifecycle.py``, ``obs/slo.py``, ``obs/anomaly.py``
``daemon_flags``): on the same inputs — port telemetry dirs (a run, a
sweep, a run still going), a journal written with the JAX package's
``Journal``, and a root of bench records, manifests and a journal — the
port gives the JAX package's frames, index records, flags, SLO verdicts
and progress, apart from the clock line of each frame; and the JAX
package's exit codes."""

from __future__ import annotations

import io
import json
import os

import pytest
import torch

from gossipprotocol_tpu.obs import anomaly as janomaly
from gossipprotocol_tpu.obs import history as jhistory
from gossipprotocol_tpu.obs import slo as jslo
from gossipprotocol_tpu.obs import watch as jwatch
from gossipprotocol_tpu.serve import journal as jjournal
from gossipprotocol_tpu.serve import lifecycle as jlifecycle
from gossipprotocol_tpu.serve.supervisor import MSG_QUEUE_FULL

from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.obs import anomaly, history, slo, watch
from gossipprotocol_tpu_torch.serve import journal, lifecycle

T0 = 1_700_000_000.0  # fixed epoch for the synthetic journals


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Port telemetry dirs: a finished run, a finished sweep, and a copy
    of the run's events alone (a run still going)."""
    root = tmp_path_factory.mktemp("runs")
    dirs = {}
    for name, argv in (
            ("run", ["64", "imp3D", "push-sum", "--drop-prob", "0.05"]),
            ("sweep", ["64", "imp3D", "gossip", "--sweep-seeds", "3",
                       "--round-budget", "20"])):
        d = str(root / "artifacts" / name)
        torch_main(argv + ["--device", "cpu", "--telemetry-dir", d,
                           "--quiet"])
        dirs[name] = d
    running = root / "artifacts" / "running"
    running.mkdir()
    with open(os.path.join(dirs["run"], "events.jsonl")) as fh:
        lines = fh.readlines()
    (running / "events.jsonl").write_text("".join(lines[:len(lines) // 2]))
    dirs["running"] = str(running)
    dirs["root"] = str(root)
    return dirs


def _frames(main, argv, capsys):
    code = main(argv)
    out = capsys.readouterr().out
    # the clock line ("watch DIR  [HH:MM:SS]", "fleet DIR  [...]") differs
    return code, [ln for ln in out.splitlines()
                  if not ln.startswith(("watch ", "fleet "))]


@pytest.mark.parametrize("which", ["run", "sweep", "running"])
def test_watch_frame_matches_jax(runs, which, capsys):
    argv = [runs[which], "--max-frames", "1", "--interval", "0.05"]
    code, port = _frames(watch.main, argv, capsys)
    jcode, ref = _frames(jwatch.main, argv, capsys)
    assert code == jcode == 0
    assert port == ref
    text = "\n".join(port)
    if which == "running":
        assert "(running)" in text
    else:
        assert "FINISHED" in text
    if which == "sweep":
        assert "sweep     lanes converged" in text


def test_watch_exit_codes_match_jax(tmp_path, capsys):
    for argv in ([], ["-h"], [str(tmp_path / "absent")],
                 ["--max-frames", "x"], ["--interval"], ["--max-frames", "1"],
                 ["--queue-dir", str(tmp_path / "absent")]):
        assert watch.main(list(argv)) == jwatch.main(list(argv)), argv
        capsys.readouterr()
    empty = tmp_path / "empty"
    empty.mkdir()
    code, port = _frames(watch.main, [str(empty), "--max-frames", "1"],
                         capsys)
    assert code == 0
    assert "(no telemetry yet" in "\n".join(port)


def _journal(q, running_tel=None):
    """A journal through the JAX package's writer: one finished request,
    a retry, a running one (publishing to ``running_tel``), a pending
    one, a queue-full refusal and a prediction blowout."""
    j = jjournal.Journal(str(q))
    recs = [
        ("accepted", "req-done", T0, {}),
        ("admitted", "req-done", T0 + 0.1,
         {"prediction_confidence": "analytic", "predicted_rounds": 2}),
        ("started", "req-done", T0 + 0.5, {"pid": 123}),
        ("retry", "req-done", T0 + 1.0, {"reason": "infra"}),
        ("started", "req-done", T0 + 1.5, {"pid": 124}),
        ("finished", "req-done", T0 + 3.0, {"converged": True,
                                            "rounds": 25}),
        ("accepted", "req-run", T0 + 4.0, {}),
        ("admitted", "req-run", T0 + 4.2, {}),
        ("started", "req-run", T0 + 4.4,
         {"pid": 2, "telemetry_dir": running_tel}),
        ("accepted", "req-q", T0 + 5.0, {}),
        ("admitted", "req-q", T0 + 5.1, {}),
        ("accepted", "req-sat", T0 + 6.0, {}),
        ("refused", "req-sat", T0 + 6.1,
         {"reason": MSG_QUEUE_FULL.format(depth=8, max_queue=8)}),
    ]
    for event, rid, ts, fields in recs:
        rec = j.append(event, rid, **fields)
        rec["ts"] = ts
    j.close()
    # fixed timestamps, so the SLO figures do not depend on the clock
    lines = []
    for (event, rid, ts, fields), line in zip(
            recs, open(j.paths.journal).read().splitlines()):
        rec = json.loads(line)
        rec["ts"] = ts
        lines.append(json.dumps(rec))
    with open(j.paths.journal, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return j.paths


def test_fleet_frame_matches_jax(runs, tmp_path, capsys):
    paths = _journal(tmp_path / "q", runs["running"])
    (tmp_path / "q" / "incoming" / "x.json").write_text("{}")
    argv = ["--queue-dir", str(tmp_path / "q"), "--max-frames", "1"]
    code, port = _frames(watch.main, argv, capsys)
    jcode, ref = _frames(jwatch.main, argv, capsys)
    assert code == jcode == 0
    assert port == ref
    text = "\n".join(port)
    assert "queue depth 3 (1 running, 1 pending, 1 incoming)" in text
    assert "worker  req-run  round " in text
    assert "! " + anomaly.MSG_QUEUE_SATURATED.format(n=1) in text
    assert os.path.isfile(paths.journal)


def test_readers_match_jax(runs, tmp_path):
    paths = _journal(tmp_path / "q", runs["running"])
    states = journal.replay(journal.read_journal(paths.journal))
    jstates = jjournal.replay(jjournal.read_journal(paths.journal))
    assert sorted(states) == sorted(jstates)
    for rid, st in states.items():
        js = jstates[rid]
        assert (st.phase, st.verdict, st.terminal, st.retries,
                st.queue_wait_s, st.admission_latency_s) == (
            js.phase, js.verdict, js.terminal, js.retries,
            js.queue_wait_s, js.admission_latency_s)
    flags = anomaly.daemon_flags(states)
    assert flags == janomaly.daemon_flags(jstates)
    assert any("prediction blowout" in f for f in flags)
    port_slos = slo.evaluate_slos(states.values())
    ref_slos = jslo.evaluate_slos(jstates.values())
    assert slo.slo_doc(port_slos) == jslo.slo_doc(ref_slos)
    out, jout = io.StringIO(), io.StringIO()
    slo.render_slos(port_slos, out)
    jslo.render_slos(ref_slos, jout)
    assert out.getvalue() == jout.getvalue()
    for tel_dir in (runs["run"], runs["running"], str(tmp_path / "none")):
        assert (lifecycle.run_progress(tel_dir)
                == jlifecycle.run_progress(tel_dir))
    qp, jqp = journal.QueuePaths(str(tmp_path / "q")), jjournal.QueuePaths(
        str(tmp_path / "q"))
    for rid in states:
        assert (lifecycle.request_progress(qp, states[rid])
                == jlifecycle.request_progress(jqp, jstates[rid]))


def test_lifecycle_merge_matches_jax(runs, tmp_path):
    """The lifecycle writers that wait for the daemon (the epoch anchor,
    the trace events, the summaries, the merge into ``trace.json`` and
    ``run.json``) give JAX's documents on the same run and journal."""
    import shutil

    paths = _journal(tmp_path / "q", runs["running"])
    states = journal.replay(journal.read_journal(paths.journal))
    jstates = jjournal.replay(jjournal.read_journal(paths.journal))
    assert (lifecycle.read_epoch0(runs["run"])
            == jlifecycle.read_epoch0(runs["run"]))
    for rid, st in states.items():
        assert (lifecycle.lifecycle_summary(st)
                == jlifecycle.lifecycle_summary(jstates[rid]))
        assert (lifecycle.lifecycle_trace_events(st, 1.0e9, tid=3)
                == jlifecycle.lifecycle_trace_events(jstates[rid], 1.0e9,
                                                     tid=3))
    docs = []
    for name, mod, sts in (("port", lifecycle, states),
                           ("jax", jlifecycle, jstates)):
        tel_dir = str(tmp_path / name)
        shutil.copytree(runs["run"], tel_dir)
        trace = mod.merge_lifecycle(tel_dir, list(sts.values()))
        assert trace == os.path.join(tel_dir, "trace.json")
        with open(trace) as fh, open(os.path.join(tel_dir,
                                                  "run.json")) as mh:
            docs.append((json.load(fh), json.load(mh)["lifecycle"]))
    for trace, _summaries in docs:
        # the writer's own package name, the one field that differs
        assert trace.pop("otherData")["source"].endswith(".obs")
    assert docs[0] == docs[1]
    assert lifecycle.merge_lifecycle(str(tmp_path / "port"), []) is None


def test_build_index_matches_jax(runs, tmp_path, capsys):
    root = runs["root"]
    for seq, val in ((1, 10.0), (2, 12.0)):
        with open(os.path.join(root, f"BENCH_r{seq:02d}.json"), "w") as fh:
            json.dump({"n": seq, "rc": 0, "parsed": {
                "metric": "demo_metric", "value": val, "unit": "s",
                "rounds": 60 + seq, "nodes": 1000, "backend": "cpu",
                "prediction_ratio": 1.4}}, fh)
    _journal(os.path.join(root, "artifacts", "q"), runs["running"])
    records = history.build_index(root, write=False)
    assert records == jhistory.build_index(root, write=False)
    kinds = [r["kind"] for r in records]
    assert kinds.count("bench") == 2 and kinds.count("sweep") == 1
    assert kinds.count("sweep_lane") == 3 and "request" in kinds
    assert kinds.count("run") == 2
    out, jout = io.StringIO(), io.StringIO()
    history.render_history(records, out)
    jhistory.render_history(records, jout)
    assert out.getvalue() == jout.getvalue()
    assert "indexed sweeps (1)" in out.getvalue()


def test_history_exit_codes(tmp_path, capsys):
    root = str(tmp_path)
    for seq, val in ((1, 10.0), (2, 12.0)):
        with open(os.path.join(root, f"BENCH_r{seq:02d}.json"), "w") as fh:
            json.dump({"n": seq, "rc": 0, "parsed": {
                "metric": "demo_metric", "value": val, "unit": "s",
                "rounds": 60 + seq, "nodes": 1000, "backend": "cpu",
                "prediction_ratio": 1.4}}, fh)
    assert torch_main(["history", root]) == 0
    out = capsys.readouterr().out
    assert "demo_metric" in out and "+20.0%" in out
    assert "pred-ratio 1.40" in out
    index = os.path.join(root, history.INDEX_RELPATH)
    with open(index) as fh:
        assert [json.loads(ln)["kind"] for ln in fh] == ["bench", "bench"]
    assert torch_main(["history", root, "--metric", "nope",
                       "--no-write"]) == 0
    assert "demo_metric" not in capsys.readouterr().out
    assert torch_main(["history", "-h"]) == 0
    assert torch_main(["history", root, "--metric"]) == 2
    assert torch_main(["history", str(tmp_path / "nope")]) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert torch_main(["history", str(empty)]) == 2
    for argv in ([root, "--metric"], [str(tmp_path / "nope")],
                 [str(empty)]):
        assert jhistory.main(list(argv)) == 2
    capsys.readouterr()
