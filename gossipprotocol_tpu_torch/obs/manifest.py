"""Run manifest: one ``run.json`` that makes a telemetry dir self-describing
(port of ``gossipprotocol_tpu/obs/manifest.py``).

Everything a reader needs to interpret ``events.jsonl`` / ``trace.json`` /
the metrics stream without the launching shell: the full RunConfig, the
software stack (package, torch and CUDA runtime versions, the device's name
and count), content
digests identifying the topology and fault schedule (the same digests the
checkpoint trajectory metadata uses, so manifests and checkpoints
cross-reference), resume lineage, the final metric, counter totals, and
the per-phase wall-time rollup.

Written once, atomically, when the run finishes (or dies — the CLI writes
it in a ``finally``); ``events.jsonl`` stays the crash-durable record.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

from gossipprotocol_tpu_torch.utils.metrics import SCHEMA_VERSION

# runtime-only fields that either cannot serialize (callbacks, the
# telemetry hub itself) or are captured in richer form elsewhere
# ("sweep" lands as the top-level sweep rollup with per-lane records)
_SKIP_CONFIG_FIELDS = ("metrics_callback", "telemetry", "fault_schedule",
                       "fault_plan", "event_plan", "sweep",
                       "quarantine_log")


def config_doc(cfg) -> Dict[str, Any]:
    """RunConfig -> json-able dict; the fault schedule and event plan
    are folded to their normalized digests + event counts rather than
    dumped raw (large id/edge lists belong in the plan files, not every
    manifest)."""
    doc: Dict[str, Any] = {}
    for f in dataclasses.fields(cfg):
        if f.name in _SKIP_CONFIG_FIELDS:
            continue
        doc[f.name] = getattr(cfg, f.name)
    sched = cfg.schedule
    doc["fault_schedule"] = {
        "digest": sched.digest(),
        "kill_events": len(sched.kills),
        "revive_events": len(sched.revives),
        "loss_windows": len(sched.loss),
    }
    plan = cfg.events
    doc["event_plan"] = {
        "digest": plan.digest(),
        "add_events": len(plan.adds),
        "remove_events": len(plan.removes),
        "swap_events": len(plan.swaps),
        "churn": (None if plan.churn is None else
                  {"rate": plan.churn.rate, "model": plan.churn.model,
                   "period": int(plan.churn.period)}),
        # value-fault injections: count + the same digest the checkpoint
        # trajectory metadata pins ("none" when the plan has no faults)
        "value_fault_events": len(plan.value_faults),
        "value_faults": plan.value_fault_digest(),
    }
    return doc


def build_manifest(
    tel,
    cfg,
    topo,
    result=None,
    *,
    device: Optional[str] = None,
    num_devices: int = 1,
    resumed_from: Optional[str] = None,
    resume_round: Optional[int] = None,
    error: Optional[str] = None,
) -> Dict[str, Any]:
    """Assemble the manifest document (pure; :func:`write_manifest` does
    the I/O). ``result`` is None when the run died before finishing —
    the manifest still lands with config + phases so the wreck is
    diagnosable. ``device`` is the run's device (``cuda``, ``cuda:0``,
    ``cpu``); the JAX package's ``jax_version`` and ``backend`` become
    ``torch_version``, ``cuda_runtime``, ``device``, ``device_name`` and
    ``device_count``. ``num_devices`` is the run's shard count
    (``--devices``)."""
    import torch

    from gossipprotocol_tpu_torch import version as pkg_version
    from gossipprotocol_tpu_torch.utils import checkpoint as ckpt_mod

    dev = str(device if device is not None else getattr(cfg, "device", "cpu"))
    device_name = "cpu"
    if dev.startswith("cuda") and torch.cuda.is_available():
        index = torch.device(dev).index
        device_name = torch.cuda.get_device_name(
            index if index is not None else 0)

    doc: Dict[str, Any] = {
        "v": SCHEMA_VERSION,
        "kind": "run_manifest",
        "package_version": pkg_version.__version__,
        "torch_version": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "device": dev,
        "device_name": device_name,
        "device_count": (torch.cuda.device_count()
                         if torch.cuda.is_available() else 0),
        "num_devices": int(num_devices),
        # the JAX package's serve daemon fields (not ported: None)
        "request_id": getattr(tel, "run_id", None),
        "admission": getattr(tel, "admission", None),
        "config": config_doc(cfg),
        "topology": {
            "kind": topo.kind,
            "num_nodes": int(topo.num_nodes),
            "num_directed_edges": int(topo.num_directed_edges),
            "implicit_full": bool(topo.implicit_full),
            "fingerprint": ckpt_mod.topology_fingerprint(topo),
        },
        "resume": (
            {"from": resumed_from, "round": resume_round}
            if resumed_from is not None else None
        ),
        "phases": tel.phase_rollup(),
        "wall_s": round(tel.wall_s(), 6),
        "counters": (dict(tel.totals) if tel.counters_on else None),
        "max_mass_drift_ulps": (
            tel.max_mass_drift_ulps if tel.counters_on else None
        ),
        "max_w_drift_ulps": (
            tel.max_w_drift_ulps if tel.counters_on else None
        ),
        # obs/predict.py round prediction, updated by the driver with the
        # actual outcome (predicted_rounds / actual_rounds / over_budget)
        "prediction": getattr(tel, "prediction", None),
        # hub-splitting layout geometry on routed/pallas/megakernel runs
        # (classes / subclasses / max_degree); None on degree-regular
        # graphs, where the layout and kernels are the pre-split ones
        "hub_split": getattr(tel, "hub_split", None),
        # trace.jsonl bookkeeping (rows written, final stride, cap)
        "trace": (tel.trace_summary()
                  if hasattr(tel, "trace_summary") else None),
        # per-shard counter attribution (resource observatory): per-shard
        # sent/delivered/dropped totals + skew; None off / single-device
        "shard_balance": (tel.shard_balance()
                          if hasattr(tel, "shard_balance") else None),
        # sweep rollup (lanes, converged fraction, round percentiles,
        # per-lane records) when the run was a batched sweep; None else
        "sweep": getattr(tel, "sweep", None),
        # torch.profiler trace dir when the run was profiled
        "profile_dir": getattr(tel, "profile_dir", None),
        # sibling resources.json (host RSS and CUDA memory samples) when
        # the resource observatory is on
        "resources": ("resources.json"
                      if getattr(tel, "resources_on", False)
                      and tel.dir is not None else None),
    }
    # sentinel rollup: trip/quarantine counts from the run's own metric
    # records (None when the sentinel was off — healthy manifests stay
    # byte-stable modulo this one null key)
    if getattr(cfg, "sentinel", "off") != "off":
        recs = result.metrics if result is not None else []
        quars = [m for m in recs if m.get("event") == "quarantine"]
        doc["sentinel"] = {
            "mode": cfg.sentinel,
            "trips": sum(1 for m in recs
                         if m.get("event") == "sentinel_trip"),
            "rollbacks": sum(1 for m in recs
                             if m.get("event") == "rollback"),
            "quarantine_events": len(quars),
            "quarantined_nodes": sum(int(m.get("nodes", 0)) for m in quars),
        }
    else:
        doc["sentinel"] = None
    if result is not None:
        err = result.estimate_error
        doc["result"] = {
            "converged": bool(result.converged),
            "rounds": int(result.rounds),
            "wall_ms": float(result.wall_ms),
            "compile_ms": float(result.compile_ms),
            "num_nodes": int(result.num_nodes),
            "algorithm": result.algorithm,
            "estimate_error": None if err is None else float(err),
            "checkpoints": list(result.checkpoints),
            # "drain" when a graceful stop ended the run early
            # (install_stop_check); None for normally-finished runs
            "stopped": getattr(result, "stopped", None),
        }
    if error is not None:
        doc["error"] = error
    return doc


def write_manifest(tel, cfg, topo, result=None, **kw) -> Optional[str]:
    """Write ``run.json`` into the telemetry dir (atomic tmp+rename).
    No-op (returns None) when telemetry is off."""
    if not tel.enabled or tel.dir is None:
        return None
    doc = build_manifest(tel, cfg, topo, result, **kw)
    path = os.path.join(tel.dir, "run.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=False)
        fh.write("\n")
    os.replace(tmp, path)
    return path
