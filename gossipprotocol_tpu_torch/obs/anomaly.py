"""Anomaly rules over a run's telemetry records (port of the run-level
rules of ``gossipprotocol_tpu/obs/anomaly.py``).

:func:`anomaly_flags` is the one entry point: given the manifest, the
chunk-granularity metric records, and (optionally) the per-round trace
rows from ``trace.jsonl``, it returns human-readable flags for every
condition the records can *prove* — no heuristics that fire on healthy
runs, because CI asserts ``anomalies: none`` on clean chaos smokes.

Rule groups:

* **record rules** (manifest + metrics — the original ``report`` checks,
  texts unchanged): did-not-converge, gossip stall, w-underflow,
  link-loss drops, mass drift beyond ULP tolerance, missing manifest;
* **counter rules**: sent ≠ delivered + dropped on runs where the
  identity must hold (push-sum without churn — gossip legitimately
  suppresses receiver-side, and dead receivers ignore shares);
* **budget rules**: the run tripped an enforced ``round_budget`` (the
  driver's structured ``over_budget`` record), or overshot the analytic
  prediction's ``budget_factor × predicted`` bound;
* **trace rules** (need ``trace.jsonl``, gated on *not converged* so a
  finished run never trips them): residual plateau (stall) and residual
  growth (divergence) over the last :data:`TRACE_WINDOW` trace rows.

:func:`daemon_flags` is the serve-daemon counterpart over replayed
journal states (queue saturation, prediction-ratio blowout, retry
storm) — same contract: rules only fire on provable conditions, so a
healthy daemon smoke renders ``anomalies: none``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

# trace rules look at the last this-many trace rows
TRACE_WINDOW = 8
# plateau: relative residual span across the window below this
STALL_REL_SPAN = 1e-3
# divergence: last residual at least this factor above the window's first
DIVERGE_FACTOR = 2.0
# mass drift beyond this many ULPs is flagged (matches the driver's own
# loss-window bookkeeping slack)
DRIFT_ULP_TOL = 64.0
# shard attribution: max/mean sent skew beyond this factor is flagged —
# a balanced partition sits near 1.0, and padding rows send nothing, so
# a sustained 1.5x means one shard owns disproportionate edge work
SHARD_SKEW_FACTOR = 1.5
# ... but only once enough messages flowed for the ratio to mean
# anything (tiny smoke runs legitimately skew on integer granularity)
SHARD_SKEW_MIN_SENT = 10_000
# daemon rules: retries across the journal before the storm rule fires
# (one request's in-policy retries — at most retry_attempts-1 = 2 by
# default — never trip it)
RETRY_STORM_MIN = 3
# ... and how far past its admission-time prediction a finished request
# must run (matches obs.predict.BUDGET_FACTOR: within the auto budget
# is healthy by definition)
PREDICTION_BLOWOUT_FACTOR = 8.0

# pinned daemon-rule message heads (tests and CI grep these verbatim)
MSG_QUEUE_SATURATED = (
    "queue SATURATED: {n} request(s) refused queue-full — raise "
    "--max-queue or add workers")
MSG_PREDICTION_BLOWOUT = (
    "prediction blowout: {rid} ran {rounds} rounds, {ratio:.1f}x its "
    "admission-time prediction of {predicted}")
MSG_RETRY_STORM = (
    "retry STORM: {n} infra retries across {m} request(s) — "
    "accelerator runtime flapping")


def _finite(x: Any) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def _record_flags(manifest: Optional[Dict[str, Any]],
                  metrics: List[Dict[str, Any]]) -> List[str]:
    flags: List[str] = []
    result = (manifest or {}).get("result")
    if (result is not None and not result.get("converged", True)
            and not (manifest or {}).get("sweep")):
        # sweep runs get the lane-resolved flag from _sweep_flags instead
        flags.append("DID NOT CONVERGE within the round budget")
    if any(r.get("stalled") for r in metrics):
        flags.append("gossip STALLED (live spreaders exhausted before quorum)")
    peak_underflow = max((r.get("w_underflow", 0) or 0 for r in metrics),
                         default=0)
    if peak_underflow:
        flags.append(
            f"push-sum w-underflow: up to {peak_underflow} alive rows hit "
            "w == 0 (dry-spell wall — consider f64)"
        )
    counters = (manifest or {}).get("counters")
    if counters and counters.get("dropped", 0) > 0:
        flags.append(f"{counters['dropped']} messages dropped by link loss")
    drift = (manifest or {}).get("max_mass_drift_ulps")
    wdrift = (manifest or {}).get("max_w_drift_ulps")
    # a lossy --payload-wire deliberately rounds edge shares on the
    # sharded exchange, so drift there is the documented cost of the
    # knob, not an anomaly — same gating as churn on the counter rule.
    # Likewise a value-fault/quarantine run: the injected corruption and
    # the containment kill both displace mass by construction, which is
    # the sentinel's story (its own rule below), not honest drift
    wire = (manifest or {}).get("config", {}).get("payload_wire", "f32")
    displaced = (
        ((manifest or {}).get("config", {}).get("event_plan") or {})
        .get("value_fault_events", 0) > 0
        or any(r.get("event") in ("sentinel_trip", "quarantine")
               for r in metrics)
    )
    if (drift is not None and wire == "f32" and not displaced
            and max(drift, wdrift or 0.0) > DRIFT_ULP_TOL):
        flags.append(
            f"push-sum mass drift up to {max(drift, wdrift or 0.0):.0f} ULPs "
            "(large for the dtype — check loss windows / dtype choice)"
        )
    return flags


def _counter_flags(manifest: Optional[Dict[str, Any]]) -> List[str]:
    """sent = delivered + dropped must hold exactly on push-sum runs with
    no churn (every attempted share either moves mass or is dropped by a
    loss window). Gossip breaks the identity by design (receiver-side
    suppression is "sent, not delivered"), dead receivers ignoring
    shares break it under kill schedules, and topology-schedule events
    (events/) legitimately change per-round sent/delivered totals when a
    mid-run edge rewrite strands in-flight accounting or the partition
    rule executes a split-off component — all gated out rather than
    special-cased, so this rule never fires on a healthy run."""
    if manifest is None:
        return []
    counters = manifest.get("counters")
    cfg = manifest.get("config", {})
    sched = cfg.get("fault_schedule", {})
    plan = cfg.get("event_plan") or {}
    has_events = (plan.get("add_events", 0) > 0
                  or plan.get("remove_events", 0) > 0
                  or plan.get("swap_events", 0) > 0
                  or plan.get("churn") is not None
                  or plan.get("value_fault_events", 0) > 0)
    quarantined = ((manifest.get("sentinel") or {})
                   .get("quarantine_events", 0) > 0)
    if (not counters
            or cfg.get("algorithm") != "push-sum"
            or sched.get("kill_events", 0) > 0
            or has_events
            or quarantined):
        return []
    sent = int(counters.get("sent", 0))
    delivered = int(counters.get("delivered", 0))
    dropped = int(counters.get("dropped", 0))
    if sent != delivered + dropped:
        return [
            f"counter imbalance: sent={sent} but delivered={delivered} + "
            f"dropped={dropped} = {delivered + dropped} "
            "(messages unaccounted for outside loss windows)"
        ]
    return []


def _shard_flags(manifest: Optional[Dict[str, Any]]) -> List[str]:
    """Per-device attribution rule: a multi-shard run whose max/mean sent
    skew exceeds :data:`SHARD_SKEW_FACTOR` has an unbalanced partition.
    Silent on single-device runs (no ``shard_balance`` block), on runs
    below :data:`SHARD_SKEW_MIN_SENT` total messages, and with
    attribution off — so healthy smokes stay ``anomalies: none``."""
    balance = (manifest or {}).get("shard_balance")
    if not balance or balance.get("num_shards", 0) < 2:
        return []
    skew = balance.get("sent_skew_max_over_mean")
    total_sent = sum(balance.get("sent") or [])
    if not _finite(skew) or total_sent < SHARD_SKEW_MIN_SENT:
        return []
    if skew > SHARD_SKEW_FACTOR:
        return [
            f"shard imbalance: max/mean sent skew {skew:.2f}x across "
            f"{balance['num_shards']} shards (> {SHARD_SKEW_FACTOR}x — "
            "one shard owns disproportionate edge work)"
        ]
    return []


def _sweep_flags(manifest: Optional[Dict[str, Any]]) -> List[str]:
    """Lane-resolved convergence rule for batched sweeps: any lane left
    unconverged is flagged with the lane tally (replacing the generic
    DID-NOT-CONVERGE text, which would hide how many lanes finished).
    Silent on non-sweep manifests and on fully-converged sweeps."""
    sweep = (manifest or {}).get("sweep")
    if not isinstance(sweep, dict):
        return []
    lanes = sweep.get("lanes")
    conv = sweep.get("converged_lanes")
    if (isinstance(lanes, int) and isinstance(conv, int) and conv < lanes):
        stuck = [lr.get("lane") for lr in sweep.get("per_lane") or []
                 if not lr.get("converged")]
        detail = (f" (lanes {', '.join(str(i) for i in stuck[:8])}"
                  + (", ..." if len(stuck) > 8 else "") + ")"
                  if stuck else "")
        return [
            f"sweep: only {conv}/{lanes} lanes converged within the "
            f"round budget{detail}"
        ]
    return []


def _sentinel_flags(manifest: Optional[Dict[str, Any]],
                    metrics: List[Dict[str, Any]]) -> List[str]:
    """Health-sentinel rule: a trip the run did NOT recover from is an
    anomaly. A trip that was contained (quarantine/rollback) on a run
    that then converged is the sentinel doing its job — the report's
    quarantine section tells that story, and the chaos-smoke CI contract
    (converged containment run => ``anomalies: none``) stays intact."""
    trips = [r for r in metrics if r.get("event") == "sentinel_trip"]
    if not trips:
        return []
    result = (manifest or {}).get("result")
    if result is not None and result.get("converged", False):
        return []
    last = trips[-1]
    return [
        f"sentinel TRIPPED at round {last.get('round', '?')} "
        f"({last.get('cause', '?')}, {last.get('nodes', '?')} node(s), "
        f"mode {last.get('mode', '?')}) and the run did not recover"
    ]


def _budget_flags(manifest: Optional[Dict[str, Any]],
                  metrics: List[Dict[str, Any]]) -> List[str]:
    flags: List[str] = []
    pred = (manifest or {}).get("prediction")
    over_recs = [r for r in metrics if r.get("event") == "over_budget"]
    if over_recs or (pred and pred.get("over_budget")):
        # the structured record carries the budget the driver actually
        # enforced (explicit --round-budget N, not the auto prediction's
        # bound) — prefer it over the prediction block's fields
        rec = over_recs[-1] if over_recs else {}
        flags.append(
            f"EXCEEDED round budget: stopped at round "
            f"{rec.get('round', (pred or {}).get('actual_rounds', '?'))} "
            f"of budget "
            f"{rec.get('budget_rounds', (pred or {}).get('budget_rounds', '?'))}"
            f" (predicted "
            f"{(pred or {}).get('predicted_rounds', rec.get('predicted_rounds', '?'))}"
            f" rounds)"
        )
    elif (pred and pred.get("confidence") == "analytic"
          and _finite(pred.get("actual_rounds"))
          and _finite(pred.get("budget_rounds"))
          and pred["actual_rounds"] > pred["budget_rounds"]):
        flags.append(
            f"round blowout: {pred['actual_rounds']} rounds > "
            f"{pred.get('budget_factor', '?')}x the analytic prediction "
            f"({pred.get('predicted_rounds', '?')} rounds)"
        )
    return flags


def _trace_flags(manifest: Optional[Dict[str, Any]],
                 trace: Optional[List[Dict[str, Any]]]) -> List[str]:
    """Residual-shape rules. Only meaningful while the run has NOT
    converged — a converged run's tail is flat at ~0 by definition, so
    both rules gate on the manifest's converged bit (absent manifest =
    crashed run = not converged, rules apply)."""
    if not trace:
        return []
    result = (manifest or {}).get("result")
    if result is not None and result.get("converged", False):
        return []
    residuals = [r["residual"] for r in trace
                 if _finite(r.get("residual"))]
    if len(residuals) < TRACE_WINDOW:
        return []
    window = residuals[-TRACE_WINDOW:]
    first, last = window[0], window[-1]
    lo, hi = min(window), max(window)
    flags: List[str] = []
    if last >= first * DIVERGE_FACTOR and last > 0:
        flags.append(
            f"residual DIVERGING: {first:.3e} -> {last:.3e} over the last "
            f"{TRACE_WINDOW} trace rows"
        )
    elif hi > 0 and (hi - lo) <= STALL_REL_SPAN * hi:
        flags.append(
            f"residual PLATEAU: stuck at {last:.3e} over the last "
            f"{TRACE_WINDOW} trace rows without converging"
        )
    return flags


def anomaly_flags(
    manifest: Optional[Dict[str, Any]],
    metrics: List[Dict[str, Any]],
    trace: Optional[List[Dict[str, Any]]] = None,
) -> List[str]:
    """Every anomaly the records prove, most fundamental first.

    ``manifest`` is the parsed ``run.json`` (None when the run died
    before writing it), ``metrics`` the chunk metric records from
    ``events.jsonl``, ``trace`` the rows
    :func:`~gossipprotocol_tpu_torch.obs.trace.load_trace` returned (optional —
    trace rules are skipped without it).
    """
    flags = _record_flags(manifest, metrics)
    flags += _sweep_flags(manifest)
    flags += _counter_flags(manifest)
    flags += _shard_flags(manifest)
    flags += _sentinel_flags(manifest, metrics)
    flags += _budget_flags(manifest, metrics)
    flags += _trace_flags(manifest, trace)
    if manifest is None:
        flags.append("run.json missing: run likely crashed before finishing")
    return flags


# ---------------------------------------------------------------------
# daemon-level rules (serve/ journal states, not run telemetry)


def daemon_flags(states: Dict[str, Any]) -> List[str]:
    """Every daemon anomaly the journal proves, for a replayed
    ``{request_id: RequestState}`` map (``serve.journal.replay``):

    * **queue saturation** — any request refused with the supervisor's
      queue-full message means the backlog ceiling was actually hit;
    * **prediction-ratio blowout** — a finished request that ran more
      than :data:`PREDICTION_BLOWOUT_FACTOR` times the rounds its
      admission-time *analytic* prediction priced (heuristic-confidence
      predictions never fire, same gating as the run-level rule);
    * **retry storm** — :data:`RETRY_STORM_MIN` or more infra retries
      across the journal: one request's in-policy retries stay silent,
      a flapping accelerator runtime does not.

    Same contract as :func:`anomaly_flags`: no rule fires on a healthy
    queue, because CI asserts ``anomalies: none`` on clean smokes.
    """
    from gossipprotocol_tpu_torch.obs import slo as slo_mod

    flags: List[str] = []
    sts = list(states.values())
    saturated = [st for st in sts
                 if st.phase == "refused"
                 and str(st.last.get("reason", "")).startswith("queue full")]
    if saturated:
        flags.append(MSG_QUEUE_SATURATED.format(n=len(saturated)))
    for st in sts:
        admitted = st.first("admitted")
        if admitted is None or admitted.get(
                "prediction_confidence") != "analytic":
            continue
        ratio = slo_mod.prediction_ratio(st)
        if ratio is not None and ratio > PREDICTION_BLOWOUT_FACTOR:
            final = st.first("finished") or st.first("over_budget") or {}
            flags.append(MSG_PREDICTION_BLOWOUT.format(
                rid=st.id, rounds=final.get("rounds"), ratio=ratio,
                predicted=admitted.get("predicted_rounds")))
    retries = sum(st.retries for st in sts)
    if retries >= RETRY_STORM_MIN:
        flags.append(MSG_RETRY_STORM.format(
            n=retries, m=sum(1 for st in sts if st.retries)))
    return flags
