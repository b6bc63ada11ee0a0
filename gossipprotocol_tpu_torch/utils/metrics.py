"""Structured metrics and the reference's output lines (port of
``gossipprotocol_tpu/utils/metrics.py``).

Every chunk of rounds emits a structured record (round, #converged,
ratio spread), streamable to a JSONL file (:class:`JsonlMetricsWriter`,
``--metrics-out``), and the final metric is printed in the reference's
exact format (``print_convergence_time``), format-compatible with the F#
simulator's ``printfn`` lines.

Record schema: version :data:`SCHEMA_VERSION` (currently 1), described by
:func:`schema`, the JAX package's. A record without a ``"v"`` field IS
version 1 — stamping is opt-in (the telemetry path turns it on). Readers
(``obs/report.py``) accept absent-``v`` records and refuse higher major
versions loudly.
"""

from __future__ import annotations

import json
import sys
from typing import IO, Optional

# Single schema version for every telemetry record family (per-chunk
# metrics records, events.jsonl lines, run.json manifests): they are read
# together by `python -m gossipprotocol_tpu_torch report` and version together.
SCHEMA_VERSION = 1


def schema() -> dict:
    """Machine-readable description of the version-1 record families.

    Not a validator — a contract note for downstream consumers and the
    ``report`` subcommand's version gate.
    """
    return {
        "v": SCHEMA_VERSION,
        "chunk_record": {
            "round": "int — cumulative round count at chunk end",
            "converged": "int — alive nodes whose predicate holds",
            "alive": "int — alive nodes",
            "ratio_min/ratio_max": "float — push-sum estimate spread",
            "w_underflow": "int — alive rows with w == 0 (dry-spell wall)",
            "spreading": "int — gossip rows still able to deliver a hit",
            "sent/delivered/dropped":
                "int — message counters (telemetry runs only)",
            "mass_drift_ulps/w_drift_ulps":
                "float — |Σ − baseline| in baseline ULPs (telemetry runs)",
            "stalled": "bool — gossip liveness failure, run ended early",
        },
        "event_record": {
            "event": "str — 'repair' | 'resumed' | 'restarted_from_scratch'",
        },
    }


class JsonlMetricsWriter:
    """Append one JSON object per metrics record to a file (or stream).

    Context-manager use is the exception-safe form — the file is flushed
    and closed on any exit path::

        with JsonlMetricsWriter(path) as w:
            w({"round": 0})

    Resume contract: a resume (or recovery re-exec) of the same logical
    run MUST pass ``mode="a"`` so the pre-crash records survive and one
    file covers the whole trajectory; semantics are then at-least-once
    (chunks after the last checkpoint replay and re-emit), with a marker
    record separating the attempts — consumers dedup on ``round`` after
    the marker. The ``"w"`` default is for fresh runs: rerunning with the
    same ``--metrics-out`` must not interleave unrelated runs in one file.

    ``stamp_version=True`` adds ``"v": SCHEMA_VERSION`` to every record;
    off by default so a telemetry-free run's output is byte-identical to
    pre-telemetry builds (absent ``"v"`` means version 1 by definition).
    """

    def __init__(self, path_or_stream, mode: str = "w",
                 stamp_version: bool = False):
        if isinstance(path_or_stream, str):
            self._fh: IO = open(path_or_stream, mode, buffering=1)
            self._owns = True
        else:
            self._fh = path_or_stream
            self._owns = False
        self._stamp = bool(stamp_version)
        self._closed = False

    def __call__(self, record: dict) -> None:
        if self._stamp and "v" not in record:
            record = {"v": SCHEMA_VERSION, **record}
        self._fh.write(json.dumps(record) + "\n")

    def close(self) -> None:
        """Flush and (for owned files) close; idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._owns:
            self._fh.close()
        else:
            # borrowed stream: the caller owns the lifetime, but records
            # must still be durable once the writer is done with it
            try:
                self._fh.flush()
            except (OSError, ValueError):
                pass

    def __enter__(self) -> "JsonlMetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def print_start_banner(algorithm: str, stream: Optional[IO] = None) -> None:
    """Reference start banners: "Gossip Starts" / "Push Sum Starts"
    (``Program.fs:198,204``)."""
    stream = stream or sys.stdout
    print("Gossip Starts" if algorithm == "gossip" else "Push Sum Starts",
          file=stream)


def print_convergence_time(wall_ms: float, stream: Optional[IO] = None) -> None:
    """The reference's single output metric, ``printfn "Convergence Time:
    %f ms"`` (``Program.fs:55``)."""
    stream = stream or sys.stdout
    print(f"Convergence Time: {wall_ms:f} ms", file=stream)
