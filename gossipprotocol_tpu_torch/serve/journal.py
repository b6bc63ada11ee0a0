"""Queue-dir layout + the crash-durable request journal (port of
``gossipprotocol_tpu/serve/journal.py``, host only: the readers that
``watch --queue-dir`` and ``history`` use, and the writer).

The queue dir is the daemon's whole durable state:

.. code-block:: text

    QUEUE_DIR/
      incoming/<id>.json     # client drop-off (atomic tmp+rename)
      requests/<id>.json     # accepted copy, daemon-owned
      journal.jsonl          # append-only request state transitions
      runs/<id>/telemetry/   # per-request telemetry (run.json, events)
      runs/<id>/ckpt/        # per-request checkpoints (when configured)
      runs/<id>/admission.json  # the admission verdict doc

``journal.jsonl`` is the record of truth: one JSON line per transition,
written line-buffered through an append-only handle (same crash
durability contract as telemetry's ``events.jsonl``). Everything else —
in-memory queues, worker tables — is reconstructed from it by
:func:`replay` when the daemon restarts, which is what makes a SIGKILLed
daemon resumable.

Event vocabulary (``event`` field):

``accepted``    request file seen and moved under ``requests/``
``admitted``    admission passed (capacity + budget), queued for dispatch
``refused``     admission refused; ``reason`` carries the message
``started``     worker spawned (``pid``, ``argv``, ``telemetry_dir``)
``batched``     request joined a sweep batch (``batch``, ``lane``)
``finished``    worker exited normally (``converged``, ``rounds``)
``over_budget`` run stopped at its round budget, stamped by the driver
``timeout``     wall-clock watchdog killed a hung worker
``failed``      worker died (bad config, crash, retries exhausted)
``retry``       device-side infra failure; re-queued with backoff
``drained``     SIGTERM drain: checkpoint saved, run paused
``interrupted`` daemon died mid-run with no checkpoint to resume
``recovered``   journal replay re-queued the request after a restart
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

from gossipprotocol_tpu_torch.utils.metrics import SCHEMA_VERSION

# phases with no further transitions; everything else is live after a
# replay ("drained"/"started" resume, "admitted"/"accepted" re-queue)
TERMINAL_EVENTS = frozenset(
    {"refused", "finished", "over_budget", "timeout", "failed",
     "interrupted"})


@dataclasses.dataclass
class QueuePaths:
    """Path arithmetic for one queue dir (pure; mkdirs on ``ensure``)."""

    root: str

    @property
    def incoming(self) -> str:
        return os.path.join(self.root, "incoming")

    @property
    def requests(self) -> str:
        return os.path.join(self.root, "requests")

    @property
    def journal(self) -> str:
        return os.path.join(self.root, "journal.jsonl")

    def request_file(self, rid: str) -> str:
        return os.path.join(self.requests, f"{rid}.json")

    def run_dir(self, rid: str) -> str:
        return os.path.join(self.root, "runs", rid)

    def telemetry_dir(self, rid: str) -> str:
        return os.path.join(self.run_dir(rid), "telemetry")

    def checkpoint_dir(self, rid: str) -> str:
        return os.path.join(self.run_dir(rid), "ckpt")

    def admission_file(self, rid: str) -> str:
        return os.path.join(self.run_dir(rid), "admission.json")

    def worker_log(self, rid: str) -> str:
        return os.path.join(self.run_dir(rid), "worker.log")

    def ensure(self) -> None:
        for d in (self.root, self.incoming, self.requests,
                  os.path.join(self.root, "runs")):
            os.makedirs(d, exist_ok=True)


class Journal:
    """Append-only journal over ``QUEUE_DIR/journal.jsonl``.

    Single-writer by design: only the daemon appends (clients drop files
    into ``incoming/``), so records never interleave. The handle is
    line-buffered append like telemetry's events stream — each
    transition survives a SIGKILL of the daemon the moment ``append``
    returns.
    """

    def __init__(self, queue_dir: str):
        self.paths = QueuePaths(os.path.abspath(queue_dir))
        self.paths.ensure()
        self._fh = None
        # optional per-record hook (the metrics exporter's live feed);
        # called AFTER the line is durable, so an observer crash can
        # never lose a transition
        self.observer = None

    def append(self, event: str, request_id: str, **fields: Any) -> Dict:
        rec = {"v": SCHEMA_VERSION, "ts": round(time.time(), 3),
               "event": event, "request_id": request_id}
        rec.update(fields)
        if self._fh is None:
            self._fh = open(self.paths.journal, "a", buffering=1)
        self._fh.write(json.dumps(rec) + "\n")
        if self.observer is not None:
            self.observer(rec)
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def records(self) -> List[Dict]:
        return read_journal(self.paths.journal)


def read_journal(path: str) -> List[Dict]:
    """Every parseable record, in append order. A torn final line (the
    daemon died mid-write) is skipped, never fatal."""
    out: List[Dict] = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict) and rec.get("request_id"):
                    out.append(rec)
    except OSError:
        pass
    return out


@dataclasses.dataclass
class RequestState:
    """One request's reconstructed state: the full event list plus the
    derived phase the supervisor and the status CLI both read."""

    id: str
    events: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def last(self) -> Dict:
        return self.events[-1] if self.events else {}

    @property
    def phase(self) -> str:
        # no events yet = dropped in incoming/, not seen by the daemon
        return self.last.get("event", "submitted")

    @property
    def terminal(self) -> bool:
        return self.phase in TERMINAL_EVENTS

    def first(self, event: str) -> Optional[Dict]:
        for rec in self.events:
            if rec.get("event") == event:
                return rec
        return None

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Seconds between acceptance and first start (or refusal)."""
        acc = self.first("accepted")
        if acc is None:
            return None
        end = self.first("started") or self.first("refused")
        if end is None:
            return None
        return round(max(0.0, end["ts"] - acc["ts"]), 3)

    @property
    def admission_latency_s(self) -> Optional[float]:
        """Seconds between acceptance and the admission verdict."""
        acc = self.first("accepted")
        if acc is None:
            return None
        end = self.first("admitted") or self.first("refused")
        if end is None:
            return None
        return round(max(0.0, end["ts"] - acc["ts"]), 3)

    @property
    def run_wall_s(self) -> Optional[float]:
        """Seconds between first worker start and the terminal event."""
        start = self.first("started") or self.first("batched")
        if start is None or not self.terminal:
            return None
        return round(max(0.0, self.last["ts"] - start["ts"]), 3)

    @property
    def retries(self) -> int:
        """Infra-failure retry events consumed by this request."""
        return sum(1 for rec in self.events
                   if rec.get("event") == "retry")

    @property
    def verdict(self) -> Optional[str]:
        """Admission verdict: "admitted", "refused", or None (not yet
        evaluated)."""
        if self.first("refused") is not None:
            return "refused"
        if self.first("admitted") is not None:
            return "admitted"
        return None


def replay(records: List[Dict]) -> Dict[str, RequestState]:
    """Fold the journal into per-request state, in first-seen order."""
    out: Dict[str, RequestState] = {}
    for rec in records:
        rid = rec["request_id"]
        if rid not in out:
            out[rid] = RequestState(rid)
        out[rid].events.append(rec)
    return out
