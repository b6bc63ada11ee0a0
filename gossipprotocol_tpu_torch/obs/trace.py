"""On-device per-round convergence traces (port of
``gossipprotocol_tpu/obs/trace.py``).

The telemetry counters see chunk-granularity aggregates; the observatory
needs the *per-round* curve — how far from consensus is the system right
now, at what rate is it closing, is mass conserved — without a host
fetch a round. :func:`make_trace_fn` mirrors
:func:`~gossipprotocol_tpu_torch.obs.counters.make_counter_fn`'s dispatch: one
trace-row function per protocol family, each implemented next to the
round it observes (``protocols/pushsum.py``, ``protocols/gossip.py``,
``protocols/diffusion.py``, ``learn/sgp.py``).

The returned function has one fixed call shape for both engines::

    trace_fn(new_state) -> float32[NUM_TRACE_COLS]   (a device tensor)

and is called once per round by the chunk runner; the chunk's rows ride
its one int32 fetch as float32 bits (``engine/driver.py`` ``chunk_stats``)
next to the counter rows. The sharded engine passes its shard-ordered
sum (``parallel/sharded.py`` ``shard_sum``).

Correctness contract (pinned by tests/test_torch_telemetry.py):

* trace functions only **read** the post-round state — no state bit and
  no RNG stream is perturbed, so the trajectory with traces on is
  bitwise identical to traces off;
* with ``trace_fn=None`` the chunk runners enqueue what they enqueued
  before traces existed.

The reference walk (``--semantics reference`` push-sum) runs a chunk of
hops as one kernel on the card, with no device op a hop to read a row
from: the engine writes no trace rows for it (its counters are counted
on the host from the hop count).

Columns (NaN = not applicable to the protocol):

* ``residual`` — push-sum: max over alive nodes (and payload dims) of
  |s/w − mean|, the consensus residual against the alive-mass mean;
  gossip: fraction of alive nodes the rumor has not reached yet (both
  decrease toward 0 on a healthy run).
* ``converged_frac`` — converged alive nodes / alive nodes.
* ``mass_s`` / ``mass_w`` — Σs (summed over payload dims) and Σw over
  every row, the conservation terms. f32 trace precision; the ULP-exact
  drift tracking stays with the counter machinery.
* ``train_loss`` — SGP: mean train loss over alive nodes.

Host side, :class:`TraceWriter` appends rows to a crash-durable
``trace.jsonl``, downsampling past a configurable cap: whenever another
``cap`` rows have been written the round stride doubles, so a run of R
rounds writes at most ``cap · (1 + log2(R / cap))`` lines — a 100k-round
run at the default cap of 4096 stays under ~25k lines.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from gossipprotocol_tpu_torch.utils.metrics import SCHEMA_VERSION

TRACE_FIELDS = ("residual", "converged_frac", "mass_s", "mass_w",
                "train_loss")
NUM_TRACE_COLS = len(TRACE_FIELDS)

TRACE_CAP_DEFAULT = 4096


def default_trace_cap() -> int:
    return int(os.environ.get("GOSSIP_TPU_TRACE_CAP", TRACE_CAP_DEFAULT))


def make_trace_fn(
    topo,
    cfg,
    *,
    all_sum: Optional[Callable] = None,
    all_max: Optional[Callable] = None,
) -> Callable:
    """Build the per-round trace-row function for this run's branch.

    ``all_sum`` reduces over the node axis preserving trailing dims
    (``sum0`` single-card, the shard-ordered sum of the sharded engine);
    ``all_max`` is the full max. ``topo`` is unused today but kept for
    signature parity with
    :func:`~gossipprotocol_tpu_torch.obs.counters.make_counter_fn`.
    """
    del topo
    kw: Dict[str, Any] = {}
    if all_sum is not None:
        kw["all_sum"] = all_sum
    if all_max is not None:
        kw["all_max"] = all_max
    if cfg.algorithm == "gossip":
        from gossipprotocol_tpu_torch.protocols.gossip import gossip_trace_row

        return lambda s: gossip_trace_row(s, **kw)
    if cfg.workload in ("sgp", "gala"):
        from gossipprotocol_tpu_torch.learn.sgp import sgp_trace_row

        return lambda s: sgp_trace_row(s, **kw)
    if cfg.fanout == "all":
        from gossipprotocol_tpu_torch.protocols.diffusion import (
            diffusion_trace_row,
        )

        return lambda s: diffusion_trace_row(s, **kw)
    from gossipprotocol_tpu_torch.protocols.pushsum import pushsum_trace_row

    return lambda s: pushsum_trace_row(s, **kw)


class TraceWriter:
    """Append-only ``trace.jsonl`` with stride-doubling downsampling.

    Rows arrive in per-chunk batches (one float32 row per executed
    round); only rounds divisible by the current stride are written.
    Every ``cap`` written rows the stride doubles, bounding the file at
    ``cap·(1 + log2(total_rounds/cap))`` lines. Line-buffered append, so
    a killed run keeps everything written so far.
    """

    def __init__(self, path: str, cap: Optional[int] = None):
        self.path = path
        self.cap = max(2, int(cap if cap is not None else default_trace_cap()))
        self.stride = 1
        self.rows_written = 0
        self.last_round = 0
        self._fh = open(path, "a", buffering=1)

    def add(self, start_round: int, rows: np.ndarray) -> None:
        """Append the rows for rounds ``start_round+1 .. start_round+m``
        (``rows`` is ``[m, NUM_TRACE_COLS]``, the valid prefix of one
        chunk's trace buffer)."""
        if self._fh.closed:
            return
        rows = np.asarray(rows, np.float64)
        for i in range(rows.shape[0]):
            rnd = start_round + 1 + i
            self.last_round = rnd
            if rnd % self.stride:
                continue
            rec: Dict[str, Any] = {
                "v": SCHEMA_VERSION, "kind": "trace", "round": rnd,
            }
            for name, val in zip(TRACE_FIELDS, rows[i]):
                v = float(val)
                if v == v:  # NaN column = not applicable to this protocol
                    rec[name] = v
            self._fh.write(json.dumps(rec) + "\n")
            self.rows_written += 1
            if self.rows_written % self.cap == 0:
                self.stride *= 2

    def summary(self) -> Dict[str, int]:
        return {
            "rows_written": self.rows_written,
            "stride": self.stride,
            "cap": self.cap,
            "last_round": self.last_round,
        }

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Read a ``trace.jsonl`` (the file, not the dir); missing file or
    torn lines are tolerated — traces are a best-effort record."""
    rows: List[Dict[str, Any]] = []
    if not os.path.isfile(path):
        return rows
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn final line from a killed run
            if rec.get("kind") == "trace":
                rows.append(rec)
    return rows
