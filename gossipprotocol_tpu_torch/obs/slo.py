"""Declarative serving SLOs + burn rates over the request journal (port
of ``gossipprotocol_tpu/obs/slo.py``, host only).

An :class:`SLOSpec` names a per-request indicator, a threshold the
indicator must stay under, and an objective — the fraction of requests
that must meet it. :func:`evaluate_slos` folds replayed journal states
into one :class:`SLOStatus` per spec with the classic burn rate:

    burn = (bad / total) / (1 - objective)

burn 1.0 = exactly spending the error budget; > 1.0 = breached. A spec
with no measurable requests yet reports ``total == 0`` and burn 0 — an
idle daemon is never "breached".

Indicators (all derived from the journal, no live daemon needed):

``admission_latency_s``   accepted → admission verdict
``queue_wait_s``          accepted → first worker start (or refusal)
``prediction_ratio``      actual rounds / admission-time predicted
                          rounds — the serving-side closure of
                          obs/predict.py's spectral bound; measurable
                          only for finished requests whose ``admitted``
                          journal event carried ``predicted_rounds``
                          (the supervisor stamps it at admission).

The daemon-level anomaly rules (queue saturation, prediction-ratio
blowout, retry storm) build on these indicators in
:func:`gossipprotocol_tpu_torch.obs.anomaly.daemon_flags`; the fleet
``watch --queue-dir`` mode renders both live.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

from gossipprotocol_tpu_torch.serve import journal as journal_mod


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One serving objective: ``objective`` of requests keep
    ``indicator`` at or under ``threshold``."""

    name: str
    indicator: str      # admission_latency_s | queue_wait_s | prediction_ratio
    threshold: float
    objective: float    # target good fraction, e.g. 0.95
    description: str = ""


DEFAULT_SLOS = (
    SLOSpec("admission_latency", "admission_latency_s", 2.0, 0.99,
            "accepted -> admission verdict within 2s for 99%"),
    SLOSpec("queue_wait", "queue_wait_s", 30.0, 0.95,
            "accepted -> worker start within 30s for 95%"),
    SLOSpec("prediction_ratio", "prediction_ratio", 8.0, 0.95,
            "actual rounds within 8x the admission-time prediction "
            "for 95% of finished requests"),
)


@dataclasses.dataclass
class SLOStatus:
    spec: SLOSpec
    good: int
    bad: int

    @property
    def total(self) -> int:
        return self.good + self.bad

    @property
    def bad_fraction(self) -> float:
        return self.bad / self.total if self.total else 0.0

    @property
    def burn_rate(self) -> float:
        budget = 1.0 - self.spec.objective
        if budget <= 0.0:
            return float("inf") if self.bad else 0.0
        return round(self.bad_fraction / budget, 3)

    @property
    def breached(self) -> bool:
        return self.burn_rate > 1.0


def prediction_ratio(st: journal_mod.RequestState) -> Optional[float]:
    """Actual rounds over admission-predicted rounds; None when either
    side is missing (request not finished, prediction not stamped)."""
    admitted = st.first("admitted")
    if admitted is None:
        return None
    predicted = admitted.get("predicted_rounds")
    if not isinstance(predicted, (int, float)) or predicted <= 0:
        return None
    final = st.first("finished") or st.first("over_budget")
    if final is None:
        return None
    rounds = final.get("rounds")
    if not isinstance(rounds, (int, float)):
        return None
    return round(float(rounds) / float(predicted), 3)


def indicator_value(st: journal_mod.RequestState,
                    indicator: str) -> Optional[float]:
    if indicator == "admission_latency_s":
        return st.admission_latency_s
    if indicator == "queue_wait_s":
        return st.queue_wait_s
    if indicator == "prediction_ratio":
        return prediction_ratio(st)
    raise ValueError(f"unknown SLO indicator {indicator!r}")


def evaluate_slos(states: Iterable[journal_mod.RequestState],
                  specs: Iterable[SLOSpec] = DEFAULT_SLOS
                  ) -> List[SLOStatus]:
    """One status per spec over every measurable request. Requests whose
    indicator is not (yet) derivable — still queued, never admitted, old
    journals without the stamped prediction — are skipped, not counted
    bad: the burn rate only spends budget on *proven* misses."""
    states = list(states)
    out: List[SLOStatus] = []
    for spec in specs:
        good = bad = 0
        for st in states:
            value = indicator_value(st, spec.indicator)
            if value is None:
                continue
            if value <= spec.threshold:
                good += 1
            else:
                bad += 1
        out.append(SLOStatus(spec, good, bad))
    return out


def render_slos(statuses: List[SLOStatus], out) -> None:
    """The fleet watch frame's SLO lines."""
    for s in statuses:
        line = (f"slo {s.spec.name:<18} "
                f"{s.good}/{s.total} within {s.spec.threshold:g}"
                f"{'s' if s.spec.indicator.endswith('_s') else 'x'}"
                f"  burn {s.burn_rate:.2f}x")
        if s.breached:
            line += "  BREACHED"
        out.write(line + "\n")


def slo_doc(statuses: List[SLOStatus]) -> List[Dict[str, Any]]:
    """JSON-able form (the /status and watch --json surfaces)."""
    return [{
        "name": s.spec.name,
        "indicator": s.spec.indicator,
        "threshold": s.spec.threshold,
        "objective": s.spec.objective,
        "good": s.good,
        "bad": s.bad,
        "burn_rate": s.burn_rate,
        "breached": s.breached,
    } for s in statuses]
