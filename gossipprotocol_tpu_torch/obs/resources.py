"""Resource observatory: what a run *costs*, not just how long it takes
(port of ``gossipprotocol_tpu/obs/resources.py``).

Three record families, all host-side (nothing here enqueues work on the
card, so the zero-cost-off contract is trivially safe):

* **chunk runners** — the driver records every chunk runner it builds
  (:meth:`ResourceRecorder.record_compiled`). The JAX package asks XLA's
  compiled program for ``cost_analysis()`` and ``memory_analysis()``; the
  port compiles no program (a chunk is eager PyTorch operations and the
  hand-written kernels), so both fields are null, with the reason in
  ``analysis``, and no number is made up for them;
* **samples** — host RSS (``/proc/self/status``, read only) plus
  ``torch.cuda.memory_allocated``, ``memory_reserved`` and
  ``max_memory_allocated`` summed over the visible cards, taken at span
  boundaries and at close, capped at :data:`MAX_SAMPLES` (a
  dropped-sample counter keeps truncation loud);
* **notes** — scalar facts other layers compute anyway (the sharded
  exchange's bytes a round) parked where the report can find them.

Everything is wrapped in broad ``except Exception`` guards: resource
introspection must never be the reason a run dies. The document lands as
``resources.json`` beside the manifest (atomic tmp+rename) when the
telemetry hub closes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from gossipprotocol_tpu_torch.utils.metrics import SCHEMA_VERSION

# span-boundary samples kept before further ones are dropped (counted)
MAX_SAMPLES = 256

# why a chunk runner's cost and memory fields are null
NO_PROGRAM_ANALYSIS = (
    "no compiled program: a chunk is eager PyTorch operations and "
    "hand-written CUDA kernels, with no XLA cost or memory analysis")


def host_rss_bytes() -> Optional[int]:
    """Current resident set size, or None when unknowable."""
    return _proc_status_bytes("VmRSS")


def host_peak_rss_bytes() -> Optional[int]:
    """Peak (high-water-mark) resident set size."""
    peak = _proc_status_bytes("VmHWM")
    if peak is not None:
        return peak
    try:  # non-Linux fallback: ru_maxrss is KiB on Linux, bytes on macOS
        import resource
        import sys

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(rss if sys.platform == "darwin" else rss * 1024)
    except Exception:
        return None


def _proc_status_bytes(field: str) -> Optional[int]:
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith(field + ":"):
                    return int(line.split()[1]) * 1024  # value is in kB
    except Exception:
        pass
    return None


def _cuda_ready():
    """``torch`` when a CUDA context exists in this process (sampling
    never creates one), else None."""
    try:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_initialized():
            return torch
    except Exception:
        pass
    return None


def device_info_doc() -> List[Dict[str, Any]]:
    """One record per visible card (``torch.cuda.get_device_properties``)
    with its CUDA memory counters; empty without a card, which is itself
    the answer "no device memory accounting here"."""
    out: List[Dict[str, Any]] = []
    try:
        import torch

        if not torch.cuda.is_available():
            return out
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            rec: Dict[str, Any] = {
                "id": i,
                "platform": "cuda",
                "device_kind": str(props.name),
                "total_memory_bytes": int(props.total_memory),
                "multi_processor_count": int(props.multi_processor_count),
                "capability": f"{props.major}.{props.minor}",
            }
            if torch.cuda.is_initialized():
                rec["memory_stats"] = {
                    "allocated_bytes": int(torch.cuda.memory_allocated(i)),
                    "reserved_bytes": int(torch.cuda.memory_reserved(i)),
                    "max_allocated_bytes": int(
                        torch.cuda.max_memory_allocated(i)),
                }
            out.append(rec)
    except Exception:
        pass
    return out


class ResourceRecorder:
    """Accumulates the resource document for one run."""

    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self.programs: List[Dict[str, Any]] = []
        self.samples: List[Dict[str, Any]] = []
        self.samples_dropped = 0
        self.notes: Dict[str, Any] = {}

    def record_compiled(self, label: str, compiled=None,
                        **attrs: Any) -> None:
        """Record one chunk runner; never raises. ``compiled`` is kept for
        the JAX package's call shape and is not read."""
        del compiled
        try:
            rec: Dict[str, Any] = {"label": label}
            rec.update({k: v for k, v in attrs.items() if v is not None})
            rec.update(cost=None, memory=None, analysis=NO_PROGRAM_ANALYSIS)
            self.programs.append(rec)
        except Exception:
            pass

    def sample(self, tag: str) -> None:
        """Snapshot host RSS + the CUDA memory counters; capped."""
        if len(self.samples) >= MAX_SAMPLES:
            self.samples_dropped += 1
            return
        rec: Dict[str, Any] = {
            "tag": tag,
            "t_s": round(time.perf_counter() - self._t0, 6),
        }
        rss = host_rss_bytes()
        if rss is not None:
            rec["rss_bytes"] = rss
        torch = _cuda_ready()
        if torch is not None:
            try:
                cards = range(torch.cuda.device_count())
                rec["device_bytes_in_use"] = sum(
                    int(torch.cuda.memory_allocated(i)) for i in cards)
                rec["device_bytes_reserved"] = sum(
                    int(torch.cuda.memory_reserved(i)) for i in cards)
                rec["device_peak_bytes"] = sum(
                    int(torch.cuda.max_memory_allocated(i)) for i in cards)
            except Exception:
                pass
        self.samples.append(rec)

    def note(self, key: str, value: Any) -> None:
        self.notes[key] = value

    def doc(self) -> Dict[str, Any]:
        return {
            "v": SCHEMA_VERSION,
            "kind": "run_resources",
            "host": {
                "rss_bytes": host_rss_bytes(),
                "peak_rss_bytes": host_peak_rss_bytes(),
            },
            "devices": device_info_doc(),
            "programs": self.programs,
            "samples": self.samples,
            "samples_dropped": self.samples_dropped,
            "notes": self.notes,
        }


def write_resources(out_dir: str, recorder: ResourceRecorder) -> Optional[str]:
    """Write ``resources.json`` (atomic tmp+rename); never raises."""
    try:
        path = os.path.join(out_dir, "resources.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(recorder.doc(), fh, indent=2)
            fh.write("\n")
        os.replace(tmp, path)
        return path
    except Exception:
        return None


def load_resources(out_dir: str) -> Optional[Dict[str, Any]]:
    """Read ``resources.json`` from a telemetry dir; None when absent or
    unreadable (partial dirs are normal, not errors)."""
    try:
        with open(os.path.join(out_dir, "resources.json")) as fh:
            return json.load(fh)
    except Exception:
        return None
