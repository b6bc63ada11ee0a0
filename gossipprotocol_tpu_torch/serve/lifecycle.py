"""Request-lifecycle tracing: journal events → Perfetto spans (port of
``gossipprotocol_tpu/serve/lifecycle.py``, host only, whole; the serve
daemon that calls most of it is not ported yet).

The journal records *when* each request transition happened; the run's
own telemetry records *what the worker did* between ``started`` and the
terminal event. This module folds the two into one Perfetto view:
:func:`merge_lifecycle` turns a request's journal events into
Chrome-trace spans on the daemon track (``pid 2``, one ``tid`` per
request, named after the request id) and merges them into the run's
existing ``trace.json`` (``pid 1`` — ``topology_build``/``chunk`` spans
untouched), anchored on the run's own epoch so the daemon spans line up
above the run phases on a shared timeline. Events that precede the
worker's start (``accepted``, ``admitted``) land at negative ``ts``,
which Perfetto renders fine.

Span derivation is positional: each non-final journal event opens a span
named after it that closes at the next event's timestamp
(``accepted`` → ``admitted`` → ``started`` → …), and the final event
becomes an instant. A compact per-request summary (phase durations +
outcome) is also stamped into ``run.json`` as ``lifecycle`` so
``report`` can print the daemon timeline without loading the trace.

:func:`run_progress` is the live-status side: tail a (possibly still
running) telemetry dir for the last published round and the current
phase — served by the daemon's ``/status/<id>`` and rendered by
``serve status`` and the fleet ``watch``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from gossipprotocol_tpu_torch.obs.telemetry import (
    TRACE_PID_DAEMON,
    write_trace_doc,
)
from gossipprotocol_tpu_torch.serve import journal as journal_mod

# how much of the tail of events.jsonl run_progress reads — enough for
# the last few chunk records without rescanning a long run's history
_TAIL_BYTES = 64 * 1024


def read_epoch0(tel_dir: str) -> Optional[float]:
    """The run's wall-clock epoch at telemetry start (the ``start``
    record's ``epoch_s``) — the anchor that puts journal timestamps and
    the run's perf-counter-relative span timestamps on one timeline."""
    try:
        with open(os.path.join(tel_dir, "events.jsonl")) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("kind") == "start":
                    epoch = rec.get("epoch_s")
                    if isinstance(epoch, (int, float)):
                        return float(epoch)
                return None
    except OSError:
        return None
    return None


def lifecycle_trace_events(st: journal_mod.RequestState,
                           anchor_epoch: float,
                           tid: int = 1) -> List[Dict[str, Any]]:
    """One request's journal events as Chrome-trace events on the daemon
    track: metadata naming the track after the request id, one span per
    non-final transition, an instant for the final one."""
    events: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": TRACE_PID_DAEMON,
         "tid": tid, "args": {"name": "serve daemon"}},
        {"name": "thread_name", "ph": "M", "pid": TRACE_PID_DAEMON,
         "tid": tid, "args": {"name": f"request {st.id}"}},
    ]
    recs = [r for r in st.events if isinstance(r.get("ts"), (int, float))]
    for i, rec in enumerate(recs):
        ts_us = round((rec["ts"] - anchor_epoch) * 1e6, 3)
        args = {k: v for k, v in rec.items()
                if k not in ("v", "ts", "event") and v is not None
                and isinstance(v, (str, int, float, bool))}
        ev: Dict[str, Any] = {"name": rec["event"], "cat": "daemon",
                              "pid": TRACE_PID_DAEMON, "tid": tid,
                              "ts": ts_us}
        if i + 1 < len(recs):
            ev["ph"] = "X"
            ev["dur"] = round((recs[i + 1]["ts"] - rec["ts"]) * 1e6, 3)
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        if args:
            ev["args"] = args
        events.append(ev)
    return events


def lifecycle_summary(st: journal_mod.RequestState) -> Dict[str, Any]:
    """Compact phase-duration summary for the run manifest."""
    recs = [r for r in st.events if isinstance(r.get("ts"), (int, float))]
    phases = [
        {"phase": rec["event"],
         "dur_s": round(recs[i + 1]["ts"] - rec["ts"], 3)}
        for i, rec in enumerate(recs[:-1])
    ]
    return {
        "request_id": st.id,
        "outcome": st.phase,
        "phases": phases,
        "queue_wait_s": st.queue_wait_s,
        "run_wall_s": st.run_wall_s,
        "retries": st.retries,
    }


def merge_lifecycle(tel_dir: str,
                    states: List[journal_mod.RequestState]
                    ) -> Optional[str]:
    """Merge the requests' lifecycle spans into ``tel_dir/trace.json``
    (created if the worker died before writing one) and stamp the
    ``lifecycle`` summaries into ``run.json``. Idempotent: a re-settle
    (infra retry, resume) replaces the previous daemon track wholesale.
    Returns the trace path, or None when there was nothing to merge."""
    states = [st for st in states if st.events]
    if not states:
        return None
    anchor = read_epoch0(tel_dir)
    if anchor is None:
        # worker never started telemetry: anchor at the first journal
        # event so the daemon track still renders from ts 0
        anchor = min(r["ts"] for st in states for r in st.events
                     if isinstance(r.get("ts"), (int, float)))
    trace_path = os.path.join(tel_dir, "trace.json")
    try:
        with open(trace_path) as fh:
            existing = json.load(fh).get("traceEvents") or []
    except (OSError, json.JSONDecodeError):
        existing = []
    merged = [ev for ev in existing
              if ev.get("pid") != TRACE_PID_DAEMON]
    for tid, st in enumerate(sorted(states, key=lambda s: s.id), 1):
        merged.extend(lifecycle_trace_events(st, anchor, tid=tid))
    try:
        os.makedirs(tel_dir, exist_ok=True)
        write_trace_doc(trace_path, merged)
    except OSError:
        return None
    _stamp_manifest(tel_dir, states)
    return trace_path


def _stamp_manifest(tel_dir: str,
                    states: List[journal_mod.RequestState]) -> None:
    path = os.path.join(tel_dir, "run.json")
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return  # no manifest to annotate (stamp_outcome handles those)
    doc["lifecycle"] = [lifecycle_summary(st)
                        for st in sorted(states, key=lambda s: s.id)]
    tmp = path + f".tmp{os.getpid()}"
    try:
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=2)
            fh.write("\n")
        os.replace(tmp, path)
    except OSError:
        pass


# ---------------------------------------------------------------------
# live progress (the /status satellite)


def run_progress(tel_dir: str) -> Optional[Dict[str, Any]]:
    """What the worker has published so far: the last round any chunk
    record carried, the most recent phase span, and whether a result
    landed. None when the worker has not created the telemetry dir yet.
    Reads only the tail of ``events.jsonl`` — cheap enough for a status
    poll against a long run."""
    events_path = os.path.join(tel_dir, "events.jsonl")
    try:
        size = os.path.getsize(events_path)
        with open(events_path, "rb") as fh:
            if size > _TAIL_BYTES:
                fh.seek(size - _TAIL_BYTES)
                fh.readline()  # discard the torn first line
            tail = fh.read().decode("utf-8", "replace")
    except OSError:
        return None
    last_round: Optional[int] = None
    phase: Optional[str] = None
    for line in tail.splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        kind = rec.get("kind")
        if kind == "metric":
            rnd = (rec.get("rec") or {}).get("round")
            if isinstance(rnd, int):
                last_round = rnd
        elif kind == "span":
            phase = rec.get("name")
        elif kind == "end":
            phase = "finished"
    finished = False
    try:
        with open(os.path.join(tel_dir, "run.json")) as fh:
            finished = (json.load(fh).get("result")) is not None
    except (OSError, json.JSONDecodeError):
        pass
    return {"round": last_round, "phase": phase,
            "finished": finished, "telemetry_dir": tel_dir}


def request_progress(paths: journal_mod.QueuePaths,
                     st: journal_mod.RequestState
                     ) -> Optional[Dict[str, Any]]:
    """:func:`run_progress` for a journal request: resolve the telemetry
    dir the worker was started with (batch members share the batch's)."""
    started = st.first("started") or st.first("batched")
    if started is None:
        return None
    tel_dir = (started.get("telemetry_dir")
               or paths.telemetry_dir(st.id))
    return run_progress(tel_dir)
