"""PyTorch port, the records and the ``report`` subcommand
(``obs/anomaly.py``, ``obs/report.py``, ``utils/metrics.py`` and the
CLI's telemetry flags): ``anomaly_flags`` gives the JAX package's flags
for the same manifest, metrics and trace; ``report`` renders a port
telemetry dir (the JAX renderer's text but for the version line) with
the JAX exit codes; ``--metrics-out`` writes the JAX CLI's records (every
key and value, the event records' timings aside) and appends under
``--restarted``; the five flags parse and reject as the JAX CLI's do,
and a dir holding another run's manifest is refused."""

from __future__ import annotations

import copy
import io
import json
import os

import pytest
import torch

from gossipprotocol_tpu.cli import main as jax_main
from gossipprotocol_tpu.obs import anomaly as janom
from gossipprotocol_tpu.obs import report as jreport
from gossipprotocol_tpu.obs.telemetry import Telemetry as JTelemetry
from gossipprotocol_tpu.utils import metrics as jmetrics

from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.obs import TelemetryDirCollision, Telemetry
from gossipprotocol_tpu_torch.obs import anomaly as tanom
from gossipprotocol_tpu_torch.obs import report as treport
from gossipprotocol_tpu_torch.utils import metrics as tmetrics


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


_BASE = {
    "config": {"algorithm": "push-sum", "payload_wire": "f32",
               "fault_schedule": {"kill_events": 0},
               "event_plan": {"add_events": 0, "remove_events": 0,
                              "swap_events": 0, "churn": None,
                              "value_fault_events": 0}},
    "result": {"converged": True, "rounds": 40},
    "counters": {"sent": 100, "delivered": 100, "dropped": 0},
    "max_mass_drift_ulps": 1.0, "max_w_drift_ulps": 0.0,
    "prediction": None, "shard_balance": None, "sentinel": None,
    "sweep": None,
}


def _m(**patch):
    doc = copy.deepcopy(_BASE)
    for k, v in patch.items():
        doc[k] = v
    return doc


_PLATEAU = [{"round": r, "residual": 1e-3} for r in range(1, 12)]
_DIVERGE = [{"round": r, "residual": 1e-4 * 2 ** r} for r in range(1, 12)]
# (manifest, metric records, trace rows)
_SCENARIOS = {
    "healthy": (_m(), [{"round": 40, "alive": 10, "converged": 10}], None),
    "not_converged": (_m(result={"converged": False, "rounds": 9}), [],
                      _PLATEAU),
    "diverging": (_m(result={"converged": False, "rounds": 9}), [],
                  _DIVERGE),
    "stalled": (_m(), [{"round": 8, "stalled": True}], None),
    "underflow": (_m(), [{"round": 8, "w_underflow": 3}], None),
    "dropped": (_m(counters={"sent": 10, "delivered": 7, "dropped": 3}),
                [], None),
    "drift": (_m(max_mass_drift_ulps=400.0), [], None),
    "drift_lossy_wire": (_m(max_mass_drift_ulps=400.0,
                            config=dict(_BASE["config"],
                                        payload_wire="bf16")), [], None),
    "imbalance": (_m(counters={"sent": 10, "delivered": 7, "dropped": 0}),
                  [], None),
    "imbalance_with_kills": (
        _m(counters={"sent": 10, "delivered": 7, "dropped": 0},
           config=dict(_BASE["config"],
                       fault_schedule={"kill_events": 1})), [], None),
    "shard_skew": (_m(shard_balance={"num_shards": 2,
                                     "sent": [30000, 5000],
                                     "sent_skew_max_over_mean": 1.714}),
                   [], None),
    "sentinel": (_m(result={"converged": False, "rounds": 9}),
                 [{"event": "sentinel_trip", "round": 6,
                   "cause": "nonfinite", "nodes": 2, "mode": "on"}], None),
    "over_budget": (_m(result={"converged": False, "rounds": 10},
                       prediction={"predicted_rounds": 5,
                                   "budget_rounds": 40,
                                   "over_budget": True}),
                    [{"event": "over_budget", "round": 10,
                      "budget_rounds": 10}], None),
    "blowout": (_m(prediction={"confidence": "analytic",
                               "actual_rounds": 90, "budget_rounds": 40,
                               "predicted_rounds": 5,
                               "budget_factor": 8}), [], None),
    "no_manifest": (None, [{"round": 4}], _PLATEAU),
}


@pytest.mark.parametrize("case", list(_SCENARIOS))
def test_anomaly_flags_equal_jax(case):
    manifest, metrics, trace = _SCENARIOS[case]
    got = tanom.anomaly_flags(manifest, metrics, trace)
    assert got == janom.anomaly_flags(manifest, metrics, trace)
    assert bool(got) == (case not in ("healthy", "drift_lossy_wire",
                                      "imbalance_with_kills"))


def test_schema_equal_jax():
    assert tmetrics.SCHEMA_VERSION == jmetrics.SCHEMA_VERSION
    assert tmetrics.schema() == jmetrics.schema()


_RUN = ["64", "imp3D", "push-sum", "--fanout", "all", "--delivery",
        "pallas", "--predicate", "global", "--chunk-rounds", "8",
        "--seed", "3", "--plan-cache", "none"]


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    """One port CLI run with ``--telemetry-dir`` and ``--metrics-out``."""
    d = tmp_path_factory.mktemp("port_tel")
    rc = torch_main(_RUN + ["--device", "cpu", "--telemetry-dir",
                            str(d / "tel"), "--metrics-out",
                            str(d / "m.jsonl"), "--quiet"])
    assert rc == 0
    return d


def test_report_renders_a_port_dir(port_dir, capsys):
    assert torch_main(["report", str(port_dir / "tel")]) == 0
    text = capsys.readouterr().out
    assert "anomalies: none" in text and "messages: sent=" in text
    assert "phases (host wall time):" in text and "residual trace" in text
    assert "torch " in text.splitlines()[0]
    # the JAX renderer reads the port's dir: the same text but the
    # version line
    buf = io.StringIO()
    jreport.render(jreport.load_telemetry_dir(str(port_dir / "tel")), buf)
    assert buf.getvalue().splitlines()[1:] == text.splitlines()[1:]


def test_report_exit_codes(port_dir, tmp_path, capsys):
    tel = str(port_dir / "tel")
    assert treport.main([]) == 2
    assert treport.main(["-h"]) == 0
    assert treport.main([str(tmp_path / "missing")]) == 2
    (tmp_path / "empty").mkdir()
    assert treport.main([str(tmp_path / "empty")]) == 2
    newer = tmp_path / "newer"
    newer.mkdir()
    (newer / "run.json").write_text(json.dumps({"v": 99}))
    assert treport.main([str(newer)]) == 2
    assert treport.main([tel, "--compare", tel]) == 0
    assert treport.main([tel, "--compare"]) == 2
    assert treport.main([tel, "--threshold", "x"]) == 2
    slow = tmp_path / "slow"
    slow.mkdir()
    with open(os.path.join(tel, "run.json")) as fh:
        doc = json.load(fh)
    doc["result"]["rounds"] *= 2
    (slow / "run.json").write_text(json.dumps(doc))
    assert treport.main([str(slow), "--compare", tel]) == 3
    for argv in ([], [str(tmp_path / "missing")], [str(newer)],
                 [str(slow), "--compare", tel]):
        assert treport.main(argv) == jreport.main(argv)
    capsys.readouterr()


def test_partial_dir_reports_incomplete(tmp_path, capsys):
    t = Telemetry(str(tmp_path))
    with t.span("chunk"):
        pass
    t.metric({"round": 4})
    t.close()
    assert treport.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "run incomplete" in out and "run.json missing" in out


_TIMINGS = ("event_s", "rebuild_s", "plan_patch_s", "warm_s")


def _records(path):
    with open(path) as fh:
        recs = [json.loads(line) for line in fh]
    return [{k: v for k, v in r.items() if k not in _TIMINGS}
            for r in recs]


@pytest.mark.parametrize("extra", [
    ["--drop-prob", "0.2"],
    ["--telemetry-dir", "TEL", "--drop-prob", "0.1"],
    ["--fail-fraction", "0.1", "--fail-round", "3", "--repair", "rewire"],
], ids=["loss", "loss_telemetry", "repair"])
def test_metrics_out_equals_jax(extra, tmp_path, capsys):
    """The JSONL records of the same run, JAX CLI against port CLI: every
    key and value but the host timings of the event records (the
    telemetry run stamps ``"v": 1`` on both)."""
    argv = ["64", "imp3D", "push-sum", "--fanout", "all", "--delivery",
            "scatter", "--predicate", "global", "--chunk-rounds", "8",
            "--seed", "3", "--max-rounds", "40"]
    outs = {}
    for name, main, dev in (("jax", jax_main, []),
                            ("torch", torch_main, ["--device", "cpu"])):
        args = [str(tmp_path / f"{name}_tel") if a == "TEL" else a
                for a in extra]
        path = tmp_path / f"{name}.jsonl"
        rc = main(argv + args + dev + ["--metrics-out", str(path),
                                      "--quiet"])
        assert rc in (0, 1)
        outs[name] = (rc, _records(path))
    capsys.readouterr()
    assert outs["torch"] == outs["jax"]
    assert len(outs["torch"][1]) >= 5


def test_metrics_out_appends_under_restarted(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    base = ["64", "imp3D", "gossip", "--device", "cpu", "--quiet",
            "--metrics-out", str(path)]
    assert torch_main(base) == 0
    first = path.read_text().splitlines()
    assert torch_main(base + ["--restarted"]) == 0
    lines = path.read_text().splitlines()
    assert lines[:len(first)] == first
    assert json.loads(lines[len(first)])["event"] == "restarted_from_scratch"
    assert torch_main(base) == 0  # a fresh run truncates
    assert path.read_text().splitlines() == first
    capsys.readouterr()


@pytest.mark.parametrize("argv,rc,needle", [
    (["--round-budget", "x"], 2, "--round-budget must be a positive"),
    (["--round-budget", "0"], 2, "round_budget must be None"),
    (["--trace-cap", "x"], 2, "--trace-cap"),
    (["--round-budget", "5"], 1, ""),
    (["--trace-cap", "8"], 0, ""),
])
def test_cli_flag_checks_match_jax(argv, rc, needle, capsys):
    """The flags' argparse types and checks, as the JAX CLI's: the same
    exit codes, the port's error naming the flag. ``--trace-cap`` without
    ``--telemetry-dir`` is accepted and does nothing, as in the JAX CLI."""
    base = ["64", "imp3D", "gossip", "--quiet"]
    assert torch_main(base + argv + ["--device", "cpu"]) == rc
    err = capsys.readouterr().err
    assert needle in err
    try:
        jrc = jax_main(base + argv)
    except SystemExit as e:  # the JAX CLI lets argparse exit
        jrc = e.code
    assert jrc == rc
    capsys.readouterr()


def test_cli_telemetry_and_profile_dirs(tmp_path, capsys):
    tel, prof = tmp_path / "tel", tmp_path / "prof"
    rc = torch_main(["64", "imp3D", "gossip", "--device", "cpu",
                     "--telemetry-dir", str(tel), "--trace-cap", "4",
                     "--round-budget", "auto", "--profile-dir", str(prof)])
    out = capsys.readouterr().out
    assert rc == 0 and f"telemetry: {tel}" in out
    with open(tel / "run.json") as fh:
        man = json.load(fh)
    assert man["profile_dir"] == str(prof) and man["trace"]["cap"] == 4
    assert man["config"]["round_budget"] == "auto"
    assert man["prediction"]["model"] == "gossip-heuristic"
    assert [f for f in os.listdir(prof) if f.endswith(".json")]
    spans = [json.loads(line) for line in open(tel / "events.jsonl")]
    assert any(r.get("name") == "profiler_trace" and r["depth"] == 1
               for r in spans)
    assert any(r.get("name") == "topology_build" for r in spans)


def test_telemetry_dir_collision_like_jax(tmp_path):
    """A dir holding another run's manifest is refused by both packages'
    hubs (``collision='uniquify'`` suffixes it instead)."""
    (tmp_path / "run.json").write_text(json.dumps({"request_id": "a"}))
    with pytest.raises(TelemetryDirCollision) as et:
        Telemetry(str(tmp_path), run_id="b")
    with pytest.raises(ValueError) as ej:
        JTelemetry(str(tmp_path), run_id="b")
    assert str(et.value) == str(ej.value)
    t = Telemetry(str(tmp_path), run_id="b", collision="uniquify")
    t.close()
    assert t.dir == str(tmp_path) + "-2"
