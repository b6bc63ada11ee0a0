"""Host-side span recorder: ``events.jsonl`` + Chrome-trace ``trace.json``
(port of ``gossipprotocol_tpu/obs/telemetry.py``).

A :class:`Telemetry` instance is created by the CLI when ``--telemetry-dir``
is set (or constructed directly by library callers) and
threaded to the engine via ``RunConfig.telemetry``.  Everywhere else in the
engine the accessor :func:`as_telemetry` turns ``None`` into the module
singleton :data:`NULL` so call sites never branch on presence.

Design constraints, in order:

* **Crash-durable**: every span/event is appended to ``events.jsonl`` the
  moment it closes (line-buffered), so a killed run still leaves a usable
  record; ``trace.json`` is additionally written on :meth:`Telemetry.close`
  and whenever ``write_trace`` is called.
* **Cheap**: one ``time.perf_counter`` pair and one ``json.dumps`` per
  span; no locks (the engine host loop is single-threaded), no buffering
  of unbounded history beyond the finished-span list needed for the trace.
* **Rollup-correct**: only *top-level* spans (depth 0) count toward the
  per-phase wall-time rollup, so nesting ``checkpoint_save`` inside a
  ``chunk`` span never double-counts.

Every line in ``events.jsonl`` carries ``"v": 1`` (see
:data:`gossipprotocol_tpu_torch.utils.metrics.SCHEMA_VERSION`); readers must
treat an absent ``"v"`` as version 1 and refuse higher major versions.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional

# Events/trace share the metrics record schema version: both are "run
# telemetry records" and are read together by obs.report.
from gossipprotocol_tpu_torch.utils.metrics import SCHEMA_VERSION

COUNTER_TOTAL_FIELDS = ("sent", "delivered", "dropped")

# Chrome-trace process ids: the run's own host spans, and the serve
# daemon's request-lifecycle track (serve/lifecycle.py), as in the JAX
# package
TRACE_PID_RUN = 1
TRACE_PID_DAEMON = 2


def write_trace_doc(path: str, events: List[Dict[str, Any]]) -> str:
    """Atomically write a Perfetto-loadable Chrome-trace document. The
    one trace.json writer, so the envelope never drifts."""
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"source": "gossipprotocol_tpu_torch.obs",
                      "v": SCHEMA_VERSION},
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)
    return path


class TelemetryDirCollision(ValueError):
    """The target dir already holds another run's ``run.json``.

    Raised (collision="refuse", the default) instead of silently
    appending this run's events into a different run's record;
    collision="uniquify" suffixes the dir instead.
    """


def _manifest_run_id(out_dir: str):
    """The ``request_id`` of an existing ``run.json`` in ``out_dir``;
    None when there is no manifest; the string "<unreadable>" when one
    exists but cannot be parsed (treated as a different run — fail
    closed)."""
    path = os.path.join(out_dir, "run.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            return json.load(fh).get("request_id") or "<unidentified>"
    except (OSError, json.JSONDecodeError):
        return "<unreadable>"


class _Span:
    """Handle yielded by :meth:`Telemetry.span`; ``set()`` adds attrs late."""

    __slots__ = ("name", "attrs", "depth", "t0", "start_s")

    def __init__(self, name: str, attrs: Dict[str, Any], depth: int, t0: float, start_s: float):
        self.name = name
        self.attrs = attrs
        self.depth = depth
        self.t0 = t0
        self.start_s = start_s

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)


class Telemetry:
    """Records host spans + run totals for one simulation run.

    Parameters
    ----------
    out_dir:
        Directory for ``events.jsonl`` / ``trace.json`` / ``run.json``
        (created if missing).
    counters:
        When True (the CLI default) the engine also folds on-device
        message counters through every chunk — a real (small) per-round
        cost.  False: spans and manifest only, with the chunk runners
        enqueuing what they enqueue without telemetry.
    traces:
        Fold the per-round observatory trace buffer through every chunk
        (:mod:`gossipprotocol_tpu_torch.obs.trace`) and append rows to
        ``trace.jsonl``.  ``None`` (default) follows ``counters``, so
        pre-trace constructions keep their exact chunk runners.
    trace_cap:
        Downsampling cap for ``trace.jsonl`` (rows before the stride
        doubles); ``None`` = ``$GOSSIP_TPU_TRACE_CAP`` or 4096.
    resources:
        Record the resource observatory (host RSS + CUDA memory samples
        at span boundaries) into ``resources.json``.  ``None`` (default)
        = on: it is purely host-side, so it never perturbs a round.
    attribution:
        Keep the sharded on-device counters *unreduced* per shard so the
        manifest can report shard-balance skew.  ``None`` (default)
        follows ``counters``; pass False to keep only the reduced
        counters.
    """

    enabled = True
    prediction = None  # obs.predict round prediction, set by the driver
    profile_dir = None  # torch.profiler trace dir when --profile-dir is set
    sweep = None  # sweep rollup, set by the sweep engine (sweep/engine.py)
    admission = None  # serve admission verdict (not ported: always None)

    def __init__(self, out_dir: str, *, counters: bool = True,
                 traces: Optional[bool] = None,
                 trace_cap: Optional[int] = None,
                 resources: Optional[bool] = None,
                 attribution: Optional[bool] = None,
                 run_id: Optional[str] = None,
                 collision: str = "refuse"):
        self.dir = os.path.abspath(out_dir)
        self.run_id = run_id
        if run_id is not None:
            # collision guard: a dir already holding a DIFFERENT run's
            # manifest must not silently accumulate this run's events.
            # Only guarded when the caller identifies the run; anonymous
            # CLI runs keep the historical overwrite-on-reuse behavior.
            existing = _manifest_run_id(self.dir)
            if existing is not None and existing != run_id:
                if collision == "uniquify":
                    base, n = self.dir, 2
                    while True:
                        cand = f"{base}-{n}"
                        ex = _manifest_run_id(cand)
                        if ex is None or ex == run_id:
                            self.dir = cand
                            break
                        n += 1
                else:
                    raise TelemetryDirCollision(
                        f"telemetry dir {self.dir} already holds run.json "
                        f"from a different run (request_id {existing!r}, "
                        f"this run is {run_id!r}) — pick a fresh dir, or "
                        "pass collision='uniquify'")
        os.makedirs(self.dir, exist_ok=True)
        self.counters_on = bool(counters)
        self.traces_on = bool(counters if traces is None else traces)
        self.resources_on = bool(True if resources is None else resources)
        self.attribution_on = bool(
            self.counters_on if attribution is None else attribution)
        self.shard_totals = None  # np.int64 [num_shards, 3] when attributed
        if self.resources_on:
            from gossipprotocol_tpu_torch.obs.resources import ResourceRecorder

            self._resources = ResourceRecorder()
        else:
            self._resources = None
        self._trace_cap = trace_cap
        self._trace_writer = None
        self._t0 = time.perf_counter()
        self._epoch0 = time.time()
        self._depth = 0
        self._finished: List[Dict[str, Any]] = []
        self._closed = False
        self.totals: Dict[str, int] = {k: 0 for k in COUNTER_TOTAL_FIELDS}
        self.max_mass_drift_ulps = 0.0
        self.max_w_drift_ulps = 0.0
        self._events = open(os.path.join(self.dir, "events.jsonl"), "a", buffering=1)
        self._emit({"kind": "start", "epoch_s": self._epoch0, "pid": os.getpid()})

    # ---------------------------------------------------------------- spans

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[_Span]:
        """Time a host-side phase; nested use is fine (depth is recorded)."""
        sp = _Span(name, dict(attrs), self._depth, time.perf_counter(), 0.0)
        sp.start_s = sp.t0 - self._t0
        self._depth += 1
        try:
            yield sp
        finally:
            self._depth -= 1
            dur = time.perf_counter() - sp.t0
            rec = {
                "kind": "span",
                "name": sp.name,
                "start_s": round(sp.start_s, 6),
                "dur_s": round(dur, 6),
                "depth": sp.depth,
            }
            if sp.attrs:
                rec["attrs"] = sp.attrs
            self._finished.append(rec)
            self._emit(rec)
            if sp.depth == 0 and self._resources is not None:
                self._resources.sample(sp.name)

    def mark_span(self, name: str, start_s: float, dur_s: float,
                  **attrs: Any) -> None:
        """Record an already-elapsed interval as a *nested* span (depth 1).

        Used for intervals measured outside the ``span()`` context — the
        torch.profiler trace wraps the whole run, so recording it at depth
        0 would double-count every phase in the rollup.
        """
        rec: Dict[str, Any] = {
            "kind": "span",
            "name": name,
            "start_s": round(start_s, 6),
            "dur_s": round(dur_s, 6),
            "depth": 1,
        }
        if attrs:
            rec["attrs"] = attrs
        self._finished.append(rec)
        self._emit(rec)

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instant (zero-duration) host event."""
        rec = {
            "kind": "event",
            "name": name,
            "start_s": round(time.perf_counter() - self._t0, 6),
        }
        if attrs:
            rec["attrs"] = attrs
        self._finished.append(rec)
        self._emit(rec)

    def metric(self, record: Dict[str, Any]) -> None:
        """Mirror a per-chunk metrics record into ``events.jsonl``."""
        self._emit({"kind": "metric", "rec": record})

    # ------------------------------------------------------------- counters

    def add_counters(self, sent: int, delivered: int, dropped: int) -> None:
        self.totals["sent"] += int(sent)
        self.totals["delivered"] += int(delivered)
        self.totals["dropped"] += int(dropped)

    def note_mass_drift(self, s_ulps: float, w_ulps: float) -> None:
        self.max_mass_drift_ulps = max(self.max_mass_drift_ulps, float(s_ulps))
        self.max_w_drift_ulps = max(self.max_w_drift_ulps, float(w_ulps))

    def add_shard_counters(self, totals) -> None:
        """Accumulate one chunk's per-shard counter partials — an int64
        ``[num_shards, 3]`` array whose sum over shards the driver has
        already asserted equals the reduced totals bitwise."""
        import numpy as np

        totals = np.asarray(totals, dtype=np.int64)
        if self.shard_totals is None:
            self.shard_totals = totals.copy()
        else:
            self.shard_totals = self.shard_totals + totals

    def shard_balance(self) -> Optional[Dict[str, Any]]:
        """Per-shard attribution summary for the manifest; None when the
        run was single-device or attribution was off."""
        if self.shard_totals is None:
            return None
        totals = self.shard_totals
        sent = totals[:, 0].astype(float)
        mean = float(sent.mean()) if sent.size else 0.0
        doc: Dict[str, Any] = {
            "num_shards": int(totals.shape[0]),
            "sent": [int(x) for x in totals[:, 0]],
            "delivered": [int(x) for x in totals[:, 1]],
            "dropped": [int(x) for x in totals[:, 2]],
            "sent_skew_max_over_mean": (
                round(float(sent.max()) / mean, 6) if mean > 0 else None
            ),
        }
        if self._resources is not None:
            exch = self._resources.notes.get("exchange_bytes_per_round")
            if isinstance(exch, (int, float)) and totals.shape[0] > 0:
                doc["edge_share_bytes_per_round_per_shard"] = int(
                    exch / totals.shape[0])
        return doc

    # -------------------------------------------------------------- resources

    def record_compiled(self, label: str, compiled, **attrs: Any) -> None:
        """Record one built chunk runner (the port compiles no program:
        its cost and memory analysis are null, with the reason)."""
        if self._resources is not None:
            self._resources.record_compiled(label, compiled, **attrs)

    def sample_resources(self, tag: str) -> None:
        if self._resources is not None:
            self._resources.sample(tag)

    def note_resource(self, key: str, value: Any) -> None:
        if self._resources is not None:
            self._resources.note(key, value)

    def write_resources(self) -> Optional[str]:
        if self._resources is None:
            return None
        from gossipprotocol_tpu_torch.obs.resources import write_resources

        return write_resources(self.dir, self._resources)

    # ---------------------------------------------------------------- traces

    def add_trace_rows(self, start_round: int, rows) -> None:
        """Append one chunk's per-round trace rows (rounds
        ``start_round+1 ..``) to ``trace.jsonl`` — no-op with traces off."""
        if not self.traces_on or self._closed:
            return
        from gossipprotocol_tpu_torch.obs.trace import TraceWriter

        if self._trace_writer is None:
            self._trace_writer = TraceWriter(
                os.path.join(self.dir, "trace.jsonl"), cap=self._trace_cap)
        stride0 = self._trace_writer.stride
        self._trace_writer.add(start_round, rows)
        if self._trace_writer.stride != stride0:
            self.event("trace_downsample",
                       stride=self._trace_writer.stride,
                       rows_written=self._trace_writer.rows_written)

    def trace_summary(self) -> Optional[Dict[str, int]]:
        if self._trace_writer is None:
            return None
        return self._trace_writer.summary()

    # -------------------------------------------------------------- outputs

    def wall_s(self) -> float:
        return time.perf_counter() - self._t0

    def phase_rollup(self) -> Dict[str, Dict[str, float]]:
        """Aggregate top-level spans by name: ``{name: {count, total_s}}``.

        Depth > 0 spans are excluded so nested phases (a checkpoint save
        inside a chunk) are counted exactly once, under their parent.
        """
        out: Dict[str, Dict[str, float]] = {}
        for rec in self._finished:
            if rec["kind"] != "span" or rec["depth"] != 0:
                continue
            agg = out.setdefault(rec["name"], {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += rec["dur_s"]
        for agg in out.values():
            agg["total_s"] = round(agg["total_s"], 6)
        return out

    def write_trace(self, path: Optional[str] = None) -> str:
        """Write Chrome trace event format (Perfetto / chrome://tracing)."""
        path = path or os.path.join(self.dir, "trace.json")
        events = []
        for rec in self._finished:
            ev: Dict[str, Any] = {
                "name": rec["name"],
                "cat": "host",
                "pid": TRACE_PID_RUN,
                "tid": 1 + rec.get("depth", 0),
                "ts": round(rec["start_s"] * 1e6, 3),
            }
            if rec["kind"] == "span":
                ev["ph"] = "X"
                ev["dur"] = round(rec["dur_s"] * 1e6, 3)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            if rec.get("attrs"):
                ev["args"] = rec["attrs"]
            events.append(ev)
        return write_trace_doc(path, events)

    def close(self) -> None:
        """Write ``trace.json`` and close ``events.jsonl``; idempotent."""
        if self._closed:
            return
        self._closed = True
        try:
            if self._resources is not None:
                self._resources.sample("close")
                self.write_resources()
            self.write_trace()
            self._emit({"kind": "end", "wall_s": round(self.wall_s(), 6)})
        finally:
            if self._trace_writer is not None:
                self._trace_writer.close()
            self._events.close()

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _emit(self, rec: Dict[str, Any]) -> None:
        if self._events.closed:
            return
        rec = {"v": SCHEMA_VERSION, **rec}
        self._events.write(json.dumps(rec) + "\n")


class NullTelemetry:
    """No-op stand-in used whenever telemetry is off.

    Mirrors the full :class:`Telemetry` surface so engine code is written
    once, unconditionally.  ``counters_on`` is False, which is what keeps
    the chunk runners' launches identical to a telemetry-free build
    (the counter fold is never installed).
    """

    enabled = False
    counters_on = False
    traces_on = False
    resources_on = False
    attribution_on = False
    prediction = None
    profile_dir = None
    sweep = None
    admission = None
    run_id = None
    shard_totals = None
    dir = None

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[_Span]:
        yield _NULL_SPAN

    def mark_span(self, name: str, start_s: float, dur_s: float,
                  **attrs: Any) -> None:
        pass

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def metric(self, record: Dict[str, Any]) -> None:
        pass

    def add_counters(self, sent: int, delivered: int, dropped: int) -> None:
        pass

    def note_mass_drift(self, s_ulps: float, w_ulps: float) -> None:
        pass

    def add_shard_counters(self, totals) -> None:
        pass

    def shard_balance(self) -> Optional[Dict[str, Any]]:
        return None

    def record_compiled(self, label: str, compiled, **attrs: Any) -> None:
        pass

    def sample_resources(self, tag: str) -> None:
        pass

    def note_resource(self, key: str, value: Any) -> None:
        pass

    def write_resources(self) -> Optional[str]:
        return None

    def add_trace_rows(self, start_round: int, rows) -> None:
        pass

    def trace_summary(self) -> Optional[Dict[str, int]]:
        return None

    def wall_s(self) -> float:
        return 0.0

    def phase_rollup(self) -> Dict[str, Dict[str, float]]:
        return {}

    def write_trace(self, path: Optional[str] = None) -> Optional[str]:
        return None

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullTelemetry":
        return self

    def __exit__(self, *exc: Any) -> None:
        pass


class _NullSpan:
    def set(self, **attrs: Any) -> None:
        pass


_NULL_SPAN = _NullSpan()
NULL = NullTelemetry()


def as_telemetry(obj: Any) -> Any:
    """``RunConfig.telemetry`` accessor: ``None`` -> the no-op singleton."""
    return NULL if obj is None else obj
