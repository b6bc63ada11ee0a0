"""Human-readable rendering of a telemetry dir (port of
``gossipprotocol_tpu/obs/report.py``).

``python -m gossipprotocol_tpu_torch report DIR`` reads what a ``--telemetry-dir``
run left behind — ``run.json``, ``events.jsonl``, ``trace.jsonl`` — and
prints the summary you'd want before trusting (or debugging) the run:
where the wall time went, what the counters totalled, how convergence
progressed round by round, how the analytic prediction compared to
reality, and any anomaly the records can prove
(:mod:`gossipprotocol_tpu_torch.obs.anomaly`).

A dir with events but no manifest (killed run, or one still running) gets
a *partial* report under a ``run incomplete`` banner — partial telemetry
is an answer, not an error.

``report DIR --compare BASELINE_DIR [--threshold F]`` additionally diffs
the run against a baseline telemetry dir: rounds, time-to-convergence,
and per-phase wall time, exiting 3 when either regresses beyond the
threshold (default 0.2 = 20%).

Exit codes: 0 on success (including partial reports), 2 when DIR is
missing/empty or the records carry a schema major version newer than
this reader (absent ``"v"`` means version 1 — see
:mod:`gossipprotocol_tpu_torch.utils.metrics`), 3 when ``--compare`` found a
regression beyond the threshold.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional, TextIO

from gossipprotocol_tpu_torch.obs.anomaly import anomaly_flags  # re-export
from gossipprotocol_tpu_torch.obs.resources import load_resources
from gossipprotocol_tpu_torch.obs.trace import load_trace
from gossipprotocol_tpu_torch.utils.metrics import SCHEMA_VERSION

__all__ = ["ReportError", "load_telemetry_dir", "sparkline",
           "anomaly_flags", "render", "compare", "main"]

_SPARK = "▁▂▃▄▅▆▇█"

# --compare: relative slowdown beyond this fraction is a regression
COMPARE_THRESHOLD_DEFAULT = 0.2


class ReportError(Exception):
    """Unreadable telemetry dir / incompatible schema — exit code 2."""


def _check_version(doc: Dict[str, Any], where: str) -> None:
    v = doc.get("v", 1)  # absent "v" IS version 1 by contract
    if not isinstance(v, int) or v > SCHEMA_VERSION:
        raise ReportError(
            f"{where} has schema version {v!r}, but this reader understands "
            f"up to {SCHEMA_VERSION}. Upgrade gossipprotocol_tpu_torch to read it."
        )


def load_telemetry_dir(path: str) -> Dict[str, Any]:
    """Read ``run.json`` + ``events.jsonl`` + ``trace.jsonl``; any may be
    absent (a run killed before close still leaves partial events and
    trace rows), all absent is an error."""
    manifest: Optional[Dict[str, Any]] = None
    events: List[Dict[str, Any]] = []
    mpath = os.path.join(path, "run.json")
    epath = os.path.join(path, "events.jsonl")
    if os.path.isfile(mpath):
        with open(mpath) as fh:
            manifest = json.load(fh)
        _check_version(manifest, mpath)
    if os.path.isfile(epath):
        with open(epath) as fh:
            for i, line in enumerate(fh):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn final line from a killed run
                if i == 0:
                    _check_version(rec, epath)
                events.append(rec)
    trace = load_trace(os.path.join(path, "trace.jsonl"))
    resources = load_resources(path)
    if manifest is None and not events and not trace and resources is None:
        raise ReportError(
            f"no telemetry found under {path!r} (expected run.json and/or "
            "events.jsonl — was the run launched with --telemetry-dir?)"
        )
    return {"manifest": manifest, "events": events, "trace": trace,
            "resources": resources}


def sparkline(values: List[float], width: int = 40) -> str:
    """Map a series onto ▁..█; downsamples to ``width`` by striding."""
    if not values:
        return ""
    if len(values) > width:
        stride = len(values) / width
        values = [values[int(i * stride)] for i in range(width)]
    lo, hi = min(values), max(values)
    span = hi - lo
    if span <= 0:
        return _SPARK[-1] * len(values) if hi > 0 else _SPARK[0] * len(values)
    return "".join(
        _SPARK[min(len(_SPARK) - 1, int((v - lo) / span * (len(_SPARK) - 1)))]
        for v in values
    )


def _phases_from_events(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Fallback rollup when run.json never landed (crashed run)."""
    out: Dict[str, Dict[str, float]] = {}
    for rec in events:
        if rec.get("kind") != "span" or rec.get("depth", 0) != 0:
            continue
        agg = out.setdefault(rec["name"], {"count": 0, "total_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += rec.get("dur_s", 0.0)
    return out


def _wall_from_events(events: List[Dict[str, Any]]) -> Optional[float]:
    for rec in reversed(events):
        if rec.get("kind") == "end":
            return rec.get("wall_s")
    last = 0.0
    for rec in events:
        if "start_s" in rec:
            last = max(last, rec["start_s"] + rec.get("dur_s", 0.0))
    return last or None


def _metric_recs(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    return [r["rec"] for r in events if r.get("kind") == "metric" and "rec" in r]


def _fmt_bytes(n: Any) -> str:
    if not isinstance(n, (int, float)):
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return "?"


def _render_resources(data: Dict[str, Any], manifest, out: TextIO) -> None:
    res = data.get("resources")
    balance = (manifest or {}).get("shard_balance")
    if not res and not balance:
        return
    out.write("\nresources:\n")
    if res:
        host = res.get("host") or {}
        if host.get("peak_rss_bytes") is not None:
            out.write(
                f"  host RSS: {_fmt_bytes(host.get('rss_bytes'))} current, "
                f"{_fmt_bytes(host['peak_rss_bytes'])} peak\n")
        peaks = [s["device_peak_bytes"] for s in res.get("samples") or []
                 if isinstance(s.get("device_peak_bytes"), (int, float))]
        if peaks:
            out.write(f"  device memory: {_fmt_bytes(max(peaks))} peak "
                      "allocated (torch.cuda.max_memory_allocated)\n")
        for prog in res.get("programs") or []:
            cost = prog.get("cost") or {}
            mem = prog.get("memory") or {}
            parts = []
            if cost.get("flops") is not None:
                parts.append(f"{cost['flops']:.3e} flops")
            if cost.get("bytes accessed") is not None:
                parts.append(f"{_fmt_bytes(cost['bytes accessed'])} accessed")
            if mem.get("argument_size_in_bytes") is not None:
                parts.append(
                    f"args {_fmt_bytes(mem['argument_size_in_bytes'])}")
            if mem.get("temp_size_in_bytes") is not None:
                parts.append(
                    f"temp {_fmt_bytes(mem['temp_size_in_bytes'])}")
            if mem.get("output_size_in_bytes") is not None:
                parts.append(
                    f"out {_fmt_bytes(mem['output_size_in_bytes'])}")
            label = prog.get("label", "?")
            # execution-shape tag, e.g. `chunk [2-shard, pallas, K=16,
            # bf16]`: the shard count subsumes the "sharded" engine word
            shards = prog.get("num_shards")
            k = prog.get("rounds_per_kernel")
            hs = prog.get("hub_split")
            tags = [t for t in (
                f"{shards}-shard" if shards else prog.get("engine"),
                prog.get("delivery"),
                f"K={k}" if k else None,
                prog.get("payload_wire"),
                f"split={hs}" if hs else None,
            ) if t]
            if tags:
                label = f"{label} [{', '.join(tags)}]"
            out.write(f"  program {label}: "
                      + (", ".join(parts) if parts else "(no analysis)")
                      + "\n")
        notes = res.get("notes") or {}
        if notes.get("exchange_bytes_per_round") is not None:
            out.write(
                f"  edge-share exchange: "
                f"{_fmt_bytes(notes['exchange_bytes_per_round'])}/round\n")
        if notes.get("routed_table_bytes") is not None:
            out.write(
                f"  routed tables: "
                f"{_fmt_bytes(notes['routed_table_bytes'])}\n")
    if balance:
        skew = balance.get("sent_skew_max_over_mean")
        out.write(
            f"  shard balance ({balance.get('num_shards', '?')} shards): "
            f"sent={balance.get('sent')}"
            + (f"  skew {skew:.3f}x max/mean" if isinstance(skew, float)
               else "")
            + "\n")


def render(data: Dict[str, Any], out: TextIO) -> None:
    manifest = data["manifest"]
    events = data["events"]
    trace = data.get("trace") or []
    metrics = _metric_recs(events)

    # incomplete banner -------------------------------------------------
    if manifest is None:
        out.write(
            "*** run incomplete: no run.json yet (crashed or still "
            "running) — partial report from events/trace ***\n"
        )

    # header -------------------------------------------------------------
    if manifest is not None:
        cfg = manifest.get("config", {})
        topo = manifest.get("topology", {})
        out.write(
            f"run: {cfg.get('algorithm', '?')} on {topo.get('kind', '?')}"
            f"-{topo.get('num_nodes', '?')}  "
            f"[{manifest.get('device', '?')} "
            f"({manifest.get('device_name', '?')})"
            f" x{manifest.get('num_devices', '?')}, "
            f"gossipprotocol_tpu_torch "
            f"{manifest.get('package_version', '?')}, "
            f"torch {manifest.get('torch_version', '?')}]\n"
        )
        if manifest.get("resume"):
            r = manifest["resume"]
            out.write(f"resumed: from {r.get('from')} at round {r.get('round')}\n")
        result = manifest.get("result")
        if result is not None:
            err = result.get("estimate_error")
            out.write(
                f"result: {'converged' if result.get('converged') else 'NOT converged'}"
                f" after {result.get('rounds')} rounds, "
                f"{result.get('wall_ms', 0.0):.1f} ms run"
                f" + {result.get('compile_ms', 0.0):.1f} ms compile"
                + (f", estimate error {err:.3e}" if err is not None else "")
                + ("  [drained]" if result.get("stopped") == "drain"
                   else "")
                + "\n"
            )

    # hub split ----------------------------------------------------------
    hs = (manifest or {}).get("hub_split")
    if hs:
        out.write(
            f"hub split: {hs.get('classes', '?')} classes -> "
            f"{hs.get('subclasses', '?')} sub-classes "
            f"(max degree {hs.get('max_degree', '?')})\n"
        )

    # prediction ---------------------------------------------------------
    pred = (manifest or {}).get("prediction")
    if pred:
        gamma = pred.get("gamma")
        gpart = f", gamma={gamma:.6f}" if isinstance(gamma, float) else ""
        out.write(
            f"prediction: {pred.get('model', '?')}"
            f" ({pred.get('confidence', '?')}{gpart})"
            f" predicted {pred.get('predicted_rounds', '?')} rounds,"
            f" budget {pred.get('budget_rounds', '?')}"
        )
        if pred.get("actual_rounds") is not None:
            ratio = pred.get("actual_over_predicted")
            out.write(
                f"; actual {pred['actual_rounds']}"
                + (f" ({ratio:.2f}x predicted)" if ratio is not None else "")
            )
        out.write("\n")

    # phase table --------------------------------------------------------
    phases = (manifest or {}).get("phases") or _phases_from_events(events)
    wall = (manifest or {}).get("wall_s") or _wall_from_events(events)
    if phases:
        out.write("\nphases (host wall time):\n")
        rows = sorted(phases.items(), key=lambda kv: -kv[1]["total_s"])
        namew = max(len(n) for n, _ in rows)
        covered = 0.0
        for name, agg in rows:
            covered += agg["total_s"]
            pct = (100.0 * agg["total_s"] / wall) if wall else 0.0
            out.write(
                f"  {name:<{namew}}  {agg['total_s']:>9.3f} s"
                f"  x{int(agg['count']):<5d} {pct:5.1f}%\n"
            )
        if wall:
            out.write(
                f"  {'(total)':<{namew}}  {covered:>9.3f} s of "
                f"{wall:.3f} s wall ({100.0 * covered / wall:.1f}% covered)\n"
            )

    # counters -----------------------------------------------------------
    counters = (manifest or {}).get("counters")
    if counters:
        out.write(
            f"\nmessages: sent={counters.get('sent', 0)}"
            f" delivered={counters.get('delivered', 0)}"
            f" dropped={counters.get('dropped', 0)}\n"
        )
        drift = manifest.get("max_mass_drift_ulps")
        # SGP/GALA inject mass by design (the gradient step), so a
        # conservation claim would be meaningless there — the driver
        # never measures it
        if drift is not None and (
            manifest.get("config", {}).get("workload", "avg")
            not in ("sgp", "gala")
        ):
            out.write(
                f"push-sum mass drift: |Σs| ≤ {drift:g} ULPs,"
                f" |Σw − n| ≤ {manifest.get('max_w_drift_ulps', 0.0):g} ULPs\n"
            )

    # sweep rollup --------------------------------------------------------
    sweep = (manifest or {}).get("sweep")
    if sweep:
        frac = sweep.get("converged_fraction")
        out.write(
            f"\nsweep: {sweep.get('lanes', '?')} lanes, "
            f"{sweep.get('converged_lanes', '?')} converged"
            + (f" ({frac:.0%})" if isinstance(frac, (int, float)) else "")
            + f", rounds p50 {sweep.get('rounds_p50', 0):.0f}"
            f" / p95 {sweep.get('rounds_p95', 0):.0f}"
            f" / max {sweep.get('rounds_max', '?')}"
            + ("  OVER BUDGET" if sweep.get("over_budget") else "")
            + "\n"
        )
        spec = sweep.get("spec") or {}
        axes = spec.get("axes")
        if axes:
            out.write(f"  axes ({spec.get('mode', 'product')}): "
                      + ", ".join(f"{k}[{len(v)}]" for k, v in axes.items())
                      + "\n")
        lanes = sweep.get("per_lane") or []
        shown = lanes[:16]
        for lr in shown:
            over = lr.get("overrides") or {}
            desc = ", ".join(f"{k}={v}" for k, v in over.items()) or "-"
            out.write(
                f"  lane {lr.get('lane', '?'):>3}  {desc:<28} "
                f"{'converged' if lr.get('converged') else 'NOT converged'}"
                f" @ {lr.get('rounds', '?')} rounds\n")
        if len(lanes) > len(shown):
            out.write(f"  ... {len(lanes) - len(shown)} more lanes "
                      "(see run.json / run_index.jsonl)\n")

    # resource observatory -----------------------------------------------
    _render_resources(data, manifest, out)

    # convergence sparkline ----------------------------------------------
    if metrics:
        frac = [
            (r.get("converged", 0) / r["alive"]) if r.get("alive") else 0.0
            for r in metrics if "alive" in r or "converged" in r
        ]
        chunked = [r for r in metrics if "round" in r]
        if frac and chunked:
            first, last = chunked[0].get("round", "?"), chunked[-1].get("round", "?")
            out.write(
                f"\nconvergence (fraction of alive nodes, rounds {first}..{last}):\n"
                f"  {sparkline(frac)}  {frac[-1] * 100:.1f}% final\n"
            )

    # per-round residual trace -------------------------------------------
    residuals = [
        (r["round"], r["residual"]) for r in trace
        if isinstance(r.get("residual"), (int, float))
        and r["residual"] == r["residual"]
    ]
    if residuals:
        vals = [v for _, v in residuals]
        tsum = (manifest or {}).get("trace") or {}
        out.write(
            f"\nresidual trace (per-round, rounds {residuals[0][0]}.."
            f"{residuals[-1][0]}, {len(residuals)} rows"
            + (f", stride {tsum['stride']}" if tsum.get("stride") else "")
            + f"):\n  {sparkline(vals)}  {vals[-1]:.3e} final\n"
        )

    # train-loss sparkline (SGP runs record a "train_loss" per chunk) -----
    losses = [
        r["train_loss"] for r in metrics
        if isinstance(r.get("train_loss"), (int, float))
        and r["train_loss"] == r["train_loss"]  # drop NaN
        and r["train_loss"] != float("inf")  # drop the pre-round ∞ sentinel
    ]
    if losses:
        out.write(
            f"\ntrain loss (mean over alive nodes):\n"
            f"  {sparkline(losses)}  {losses[-1]:.3e} final\n"
        )

    # topology-schedule events (events/) ---------------------------------
    churn_recs = [r for r in metrics if r.get("event") == "churn"]
    if churn_recs:
        added = sum(int(r.get("edges_added", 0)) for r in churn_recs)
        removed = sum(int(r.get("edges_removed", 0)) for r in churn_recs)
        swapped = sum(int(r.get("edges_swapped", 0)) for r in churn_recs)
        skipped = sum(int(r.get("edges_skipped", 0)) for r in churn_recs)
        gen = sum(1 for r in churn_recs if r.get("generated"))
        out.write(
            f"\nchurn applied: {len(churn_recs)} event round(s)"
            f" ({gen} generated) — edges +{added} -{removed}"
            f" ~{swapped} swapped, {skipped} skipped\n"
        )

    # data-fault sentinel (value faults, trips, quarantines) --------------
    vf_recs = [r for r in metrics if r.get("event") == "value_fault"]
    for r in vf_recs:
        out.write(
            f"\nvalue fault injected: {int(r.get('nodes', 0))} node(s) at "
            f"round {r.get('round', '?')} (model {r.get('model', '?')}, "
            f"rate {r.get('rate', '?')})\n"
        )
    trip_recs = [r for r in metrics if r.get("event") == "sentinel_trip"]
    for r in trip_recs:
        out.write(
            f"sentinel trip: {r.get('cause', '?')} on "
            f"{int(r.get('nodes', 0))} node(s) at round "
            f"{r.get('round', '?')} (mode {r.get('mode', '?')})\n"
        )
    for r in metrics:
        if r.get("event") == "rollback":
            out.write(
                f"rollback: restored round {r.get('round', '?')} from "
                f"round {r.get('from_round', '?')} "
                f"({os.path.basename(str(r.get('checkpoint', '?')))})\n"
            )
    quar_recs = [r for r in metrics if r.get("event") == "quarantine"]
    for r in quar_recs:
        out.write(
            f"quarantined: {int(r.get('nodes', 0))} node(s) at round "
            f"{r.get('round', '?')} (repair {r.get('policy', '?')})\n"
        )

    # anomalies ----------------------------------------------------------
    flags = anomaly_flags(manifest, metrics, trace)
    if flags:
        out.write("\nanomalies:\n")
        for f in flags:
            out.write(f"  ! {f}\n")
    else:
        out.write("\nanomalies: none\n")


# ---------------------------------------------------------------------------
# --compare: regression diff against a baseline telemetry dir


def _run_summary(data: Dict[str, Any]) -> Dict[str, Any]:
    manifest = data.get("manifest") or {}
    result = manifest.get("result") or {}
    pred = manifest.get("prediction") or {}
    return {
        "label": (f"{manifest.get('config', {}).get('algorithm', '?')} on "
                  f"{manifest.get('topology', {}).get('kind', '?')}-"
                  f"{manifest.get('topology', {}).get('num_nodes', '?')}"),
        "converged": result.get("converged"),
        "rounds": result.get("rounds"),
        "wall_ms": result.get("wall_ms"),
        "compile_ms": result.get("compile_ms"),
        "phases": manifest.get("phases") or {},
        "ratio": pred.get("actual_over_predicted"),
    }


def _rel_delta(cur: Optional[float], base: Optional[float]) -> Optional[float]:
    if not isinstance(cur, (int, float)) or not isinstance(base, (int, float)):
        return None
    if base <= 0:
        return None
    return (cur - base) / base


def compare(data: Dict[str, Any], baseline: Dict[str, Any], out: TextIO,
            threshold: float = COMPARE_THRESHOLD_DEFAULT) -> bool:
    """Diff ``data`` against ``baseline``; returns True when rounds or
    time-to-convergence regressed beyond ``threshold`` (relative).
    Per-phase wall deltas are reported but never gate — compile and I/O
    phases are too noisy across machines to fail a build on."""
    cur, base = _run_summary(data), _run_summary(baseline)
    out.write(f"\ncompare: {cur['label']} vs baseline {base['label']}\n")
    if cur["label"] != base["label"]:
        out.write("  (warning: configs differ — deltas may be meaningless)\n")
    regressed = False
    for key, unit, gate in (("rounds", "rounds", True),
                            ("wall_ms", "ms", True),
                            ("compile_ms", "ms", False)):
        d = _rel_delta(cur[key], base[key])
        if d is None:
            continue
        mark = ""
        if gate and d > threshold:
            regressed = True
            mark = f"  REGRESSION (> {threshold:.0%} threshold)"
        out.write(
            f"  {key:<11} {cur[key]:>12.1f} vs {base[key]:>12.1f} {unit}"
            f"  ({d:+.1%}){mark}\n"
        )
    if cur["ratio"] is not None and base["ratio"] is not None:
        out.write(
            f"  {'pred ratio':<11} {cur['ratio']:>12.2f} vs "
            f"{base['ratio']:>12.2f} x  (actual/predicted rounds)\n"
        )
    shared = sorted(set(cur["phases"]) & set(base["phases"]))
    for name in shared:
        d = _rel_delta(cur["phases"][name].get("total_s"),
                       base["phases"][name].get("total_s"))
        if d is None:
            continue
        out.write(
            f"  phase {name:<16} {cur['phases'][name]['total_s']:>9.3f} vs "
            f"{base['phases'][name]['total_s']:>9.3f} s  ({d:+.1%})\n"
        )
    if regressed:
        out.write(f"compare: REGRESSION beyond {threshold:.0%} detected\n")
    else:
        out.write(f"compare: within {threshold:.0%} of baseline\n")
    return regressed


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(
            "usage: python -m gossipprotocol_tpu_torch report TELEMETRY_DIR "
            "[--compare BASELINE_DIR] [--threshold F]",
            file=sys.stderr if not argv else sys.stdout,
        )
        return 0 if argv else 2
    # `--compare` is a mode flag; dirs are positional in order, so both
    # `report DIR --compare BASELINE` and `report --compare DIR BASELINE`
    # read as (current, baseline)
    compare_mode = False
    threshold = COMPARE_THRESHOLD_DEFAULT
    paths: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--compare":
            compare_mode = True
            i += 1
        elif a == "--threshold":
            if i + 1 >= len(argv):
                print("report: --threshold needs a value", file=sys.stderr)
                return 2
            try:
                threshold = float(argv[i + 1])
            except ValueError:
                print(f"report: bad --threshold {argv[i + 1]!r}",
                      file=sys.stderr)
                return 2
            i += 2
        else:
            paths.append(a)
            i += 1
    if not paths:
        print("report: missing TELEMETRY_DIR", file=sys.stderr)
        return 2
    path = paths[0]
    baseline_dir: Optional[str] = None
    if compare_mode or len(paths) > 1:
        if len(paths) < 2:
            print("report: --compare needs a BASELINE_DIR", file=sys.stderr)
            return 2
        baseline_dir = paths[1]
    if not os.path.isdir(path):
        print(f"report: {path!r} is not a directory", file=sys.stderr)
        return 2
    try:
        data = load_telemetry_dir(path)
    except ReportError as e:
        print(f"report: {e}", file=sys.stderr)
        return 2
    render(data, sys.stdout)
    if baseline_dir is not None:
        if not os.path.isdir(baseline_dir):
            print(f"report: baseline {baseline_dir!r} is not a directory",
                  file=sys.stderr)
            return 2
        try:
            baseline = load_telemetry_dir(baseline_dir)
        except ReportError as e:
            print(f"report: baseline: {e}", file=sys.stderr)
            return 2
        if compare(data, baseline, sys.stdout, threshold=threshold):
            return 3
    return 0
