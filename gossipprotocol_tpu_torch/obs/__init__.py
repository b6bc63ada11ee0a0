"""Unified run telemetry (port of ``gossipprotocol_tpu/obs``, the run
side).

* :mod:`~gossipprotocol_tpu_torch.obs.telemetry` — host-side spans
  streamed to ``events.jsonl`` plus a Chrome-trace ``trace.json``
  (Perfetto-loadable), beside ``--profile-dir``'s ``torch.profiler``
  trace of the card;
* :mod:`~gossipprotocol_tpu_torch.obs.counters` — message counters
  (sent / delivered / dropped, push-sum mass drift in ULPs) folded
  through the chunk loop, read from the states only, so convergence stays
  bitwise identical with telemetry on;
* :mod:`~gossipprotocol_tpu_torch.obs.trace` — per-round convergence
  trace rows and the downsampling ``trace.jsonl`` writer;
* :mod:`~gossipprotocol_tpu_torch.obs.manifest` — ``run.json``: the full
  config, versions, digests, resume lineage and the per-phase wall-time
  rollup;
* :mod:`~gossipprotocol_tpu_torch.obs.predict` — the analytic round
  prediction behind ``--round-budget auto``;
* :mod:`~gossipprotocol_tpu_torch.obs.anomaly` and
  :mod:`~gossipprotocol_tpu_torch.obs.report` — ``python -m
  gossipprotocol_tpu_torch report DIR`` renders a telemetry dir;
* :mod:`~gossipprotocol_tpu_torch.obs.resources` — host RSS and CUDA
  memory samples at span boundaries (``resources.json``).

Zero-cost contract: with ``RunConfig.telemetry`` unset every engine code
path sees :class:`NullTelemetry` (no-op spans, ``counters_on=False``), so
the chunk runners enqueue exactly what they enqueue without this package.
"""

from gossipprotocol_tpu_torch.obs.manifest import write_manifest  # noqa: F401
from gossipprotocol_tpu_torch.obs.telemetry import (  # noqa: F401
    NULL,
    NullTelemetry,
    Telemetry,
    TelemetryDirCollision,
    as_telemetry,
    write_trace_doc,
)
