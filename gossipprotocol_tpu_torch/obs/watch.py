"""Live monitoring of a telemetry dir while the run is still going (port
of ``gossipprotocol_tpu/obs/watch.py``: the same frames, host only).

``python -m gossipprotocol_tpu_torch watch DIR`` tails what the run has
written so far — ``events.jsonl`` and ``trace.jsonl`` grow line by line,
``run.json`` lands at the end — and refreshes a compact status frame
every ``--interval`` seconds: current round, residual, converged
fraction, message totals, and any anomaly the partial records already
prove. On a tty each refresh clears the screen; piped output gets
separator-delimited frames instead (so CI logs stay readable).

Exits 0 as soon as the manifest reports a result (the run finished) or
after ``--max-frames`` refreshes; exits 2 when DIR is not a directory.
A dir that has no telemetry *yet* is not an error — watch waits for it.

``watch --queue-dir D`` is the fleet mode: instead of one run's
telemetry it tails a serve daemon's queue dir — queue depth, what each
worker is currently executing (request id + last published round), the
SLO burn rates from :mod:`gossipprotocol_tpu_torch.obs.slo`, and the
daemon-level anomaly rules. The fleet frame never "finishes" (a daemon
is long-lived); it exits only via ``--max-frames`` or ^C.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Any, Dict, List, Optional, TextIO

from gossipprotocol_tpu_torch.obs.anomaly import anomaly_flags, daemon_flags
from gossipprotocol_tpu_torch.obs.report import (
    ReportError,
    _metric_recs,
    load_telemetry_dir,
    sparkline,
)

INTERVAL_DEFAULT = 2.0

# journal phases that mean "a worker is executing this request now"
_RUNNING_PHASES = ("started", "batched")


def _frame(data: Dict[str, Any], out: TextIO) -> bool:
    """Write one status frame; returns True when the run is finished."""
    manifest = data["manifest"]
    events = data["events"]
    trace = data.get("trace") or []
    metrics = _metric_recs(events)

    result = (manifest or {}).get("result")
    chunked = [r for r in metrics if "round" in r]
    last = chunked[-1] if chunked else {}
    rid = (manifest or {}).get("request_id")
    if rid:
        out.write(f"request {rid} (daemon-executed)\n")
    rnd = (result or {}).get("rounds", last.get("round", 0))
    out.write(f"round {rnd}")
    if result is not None:
        out.write(
            f"  FINISHED: "
            f"{'converged' if result.get('converged') else 'NOT converged'}"
            f" in {result.get('wall_ms', 0.0):.1f} ms\n"
        )
    else:
        out.write("  (running)\n")
    sweep = (manifest or {}).get("sweep")
    if sweep:
        # finished sweep: the manifest rollup is authoritative
        out.write(
            f"sweep     lanes converged "
            f"{sweep.get('converged_lanes', 0)}/{sweep.get('lanes', '?')}"
            f"  rounds p50 {sweep.get('rounds_p50', 0):.0f}"
            f" / p95 {sweep.get('rounds_p95', 0):.0f}\n")
    elif "lanes" in last:
        # still running: the latest chunk record carries the lane tally
        out.write(
            f"sweep     lanes converged "
            f"{last.get('lanes_done', 0)}/{last['lanes']}"
            f"  slowest lane at round {last.get('round', 0)}"
            f" (fastest frozen at {last.get('rounds_min', 0)})\n")
    alive = last.get("alive")
    if alive:
        out.write(
            f"alive {alive}  converged {last.get('converged', 0)}/{alive}\n")
    residuals = [
        r["residual"] for r in trace
        if isinstance(r.get("residual"), (int, float))
        and r["residual"] == r["residual"]
    ]
    if residuals:
        out.write(
            f"residual  {sparkline(residuals)}  {residuals[-1]:.3e}\n")
    # live sentinel status: trips/quarantines the partial record already
    # shows (the manifest rollup only lands when the run finishes)
    trips = [r for r in metrics if r.get("event") == "sentinel_trip"]
    quars = [r for r in metrics if r.get("event") == "quarantine"]
    if trips or quars:
        last_t = trips[-1] if trips else {}
        qn = sum(int(r.get("nodes", 0)) for r in quars)
        out.write(
            f"sentinel  {len(trips)} trip(s)"
            + (f", last {last_t.get('cause', '?')} at round "
               f"{last_t.get('round', '?')}" if trips else "")
            + (f"; quarantined {qn} node(s)" if quars else "")
            + "\n"
        )
    counters = (manifest or {}).get("counters")
    if counters:
        out.write(
            f"messages  sent={counters.get('sent', 0)}"
            f" delivered={counters.get('delivered', 0)}"
            f" dropped={counters.get('dropped', 0)}\n"
        )
    resources = data.get("resources")
    if resources:
        host = resources.get("host") or {}
        peak = host.get("peak_rss_bytes")
        if isinstance(peak, (int, float)):
            samples = resources.get("samples") or []
            cur = next(
                (s["rss_bytes"] for s in reversed(samples)
                 if isinstance(s.get("rss_bytes"), (int, float))),
                host.get("rss_bytes"),
            )
            out.write(
                f"host RSS  {cur / 2**20:.0f} MiB"
                f" (peak {peak / 2**20:.0f} MiB)\n"
                if isinstance(cur, (int, float))
                else f"host RSS  peak {peak / 2**20:.0f} MiB\n"
            )
    flags = anomaly_flags(manifest, metrics, trace)
    # a still-running dir has no manifest by design — not an anomaly yet
    flags = [f for f in flags if not f.startswith("run.json missing")
             or result is not None]
    if flags:
        for f in flags:
            out.write(f"! {f}\n")
    else:
        out.write("anomalies: none\n")
    return result is not None


def _fleet_frame(paths, out: TextIO) -> None:
    """One frame of the fleet view over a serve queue dir."""
    from gossipprotocol_tpu_torch.obs import slo as slo_mod
    from gossipprotocol_tpu_torch.serve import journal as journal_mod
    from gossipprotocol_tpu_torch.serve import lifecycle as lifecycle_mod

    states = journal_mod.replay(journal_mod.read_journal(paths.journal))
    running = [st for st in states.values()
               if st.phase in _RUNNING_PHASES]
    pending = [st for st in states.values()
               if not st.terminal and st.phase not in _RUNNING_PHASES]
    try:
        incoming = len([f for f in os.listdir(paths.incoming)
                        if f.endswith(".json")])
    except OSError:
        incoming = 0
    out.write(
        f"queue depth {len(running) + len(pending) + incoming}"
        f" ({len(running)} running, {len(pending)} pending"
        + (f", {incoming} incoming" if incoming else "")
        + ")\n")
    for st in sorted(running, key=lambda s: s.id):
        prog = lifecycle_mod.request_progress(paths, st) or {}
        rnd = prog.get("round")
        phase = prog.get("phase")
        out.write(
            f"worker  {st.id}"
            + (f"  round {rnd}" if rnd is not None else "")
            + (f"  phase {phase}" if phase else "  (starting)")
            + "\n")
    done = sum(1 for st in states.values() if st.terminal)
    out.write(f"settled {done} request(s)\n")
    slo_mod.render_slos(
        slo_mod.evaluate_slos(states.values()), out)
    flags = daemon_flags(states)
    if flags:
        for f in flags:
            out.write(f"! {f}\n")
    else:
        out.write("anomalies: none\n")


def _fleet_loop(queue_dir: str, interval: float,
                max_frames: Optional[int]) -> int:
    from gossipprotocol_tpu_torch.serve import journal as journal_mod

    if not os.path.isdir(queue_dir):
        print(f"watch: {queue_dir!r} is not a directory", file=sys.stderr)
        return 2
    paths = journal_mod.QueuePaths(os.path.abspath(queue_dir))
    out = sys.stdout
    tty = out.isatty()
    frames = 0
    while True:
        if tty:
            out.write("\x1b[2J\x1b[H")
        else:
            out.write(f"--- frame {frames + 1} ---\n")
        out.write(f"fleet {queue_dir}  [{time.strftime('%H:%M:%S')}]\n")
        _fleet_frame(paths, out)
        out.flush()
        frames += 1
        if max_frames is not None and frames >= max_frames:
            return 0
        time.sleep(interval)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(
            "usage: python -m gossipprotocol_tpu_torch watch TELEMETRY_DIR "
            "[--interval S] [--max-frames N]\n"
            "       python -m gossipprotocol_tpu_torch watch --queue-dir D "
            "[--interval S] [--max-frames N]",
            file=sys.stderr if not argv else sys.stdout,
        )
        return 0 if argv else 2
    interval = INTERVAL_DEFAULT
    max_frames: Optional[int] = None
    queue_dir: Optional[str] = None
    paths: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("--interval", "--max-frames", "--queue-dir"):
            if i + 1 >= len(argv):
                print(f"watch: {a} needs a value", file=sys.stderr)
                return 2
            try:
                if a == "--interval":
                    interval = max(0.05, float(argv[i + 1]))
                elif a == "--max-frames":
                    max_frames = int(argv[i + 1])
                else:
                    queue_dir = argv[i + 1]
            except ValueError:
                print(f"watch: bad {a} {argv[i + 1]!r}", file=sys.stderr)
                return 2
            i += 2
        else:
            paths.append(a)
            i += 1
    if queue_dir is not None:
        return _fleet_loop(queue_dir, interval, max_frames)
    if not paths:
        print("watch: missing TELEMETRY_DIR", file=sys.stderr)
        return 2
    path = paths[0]
    if not os.path.isdir(path):
        print(f"watch: {path!r} is not a directory", file=sys.stderr)
        return 2

    out = sys.stdout
    tty = out.isatty()
    frames = 0
    while True:
        try:
            data = load_telemetry_dir(path)
        except ReportError:
            data = None  # nothing written yet — keep waiting
        if tty:
            out.write("\x1b[2J\x1b[H")  # clear screen, home cursor
        else:
            out.write(f"--- frame {frames + 1} ---\n")
        out.write(f"watch {path}  [{time.strftime('%H:%M:%S')}]\n")
        finished = False
        if data is None:
            out.write("(no telemetry yet — waiting for the run to start)\n")
        else:
            finished = _frame(data, out)
        out.flush()
        frames += 1
        if finished:
            return 0
        if max_frames is not None and frames >= max_frames:
            return 0
        time.sleep(interval)
