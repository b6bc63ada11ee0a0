"""Analytic round prediction from the topology's spectrum (port of
``gossipprotocol_tpu/obs/predict.py``; host-only, numpy).

Push-sum averaging contracts the consensus error by γ = |λ₂(W)| per
application of the mixing matrix, so the round count to residual ``tol``
obeys the classical bound (Kempe et al.; in the tight spectral form of
the recent gossip-convergence analyses, e.g. arXiv:2507.16601)

    T(tol) ≲ (ln n + ln(1/tol)) / (−ln γ)

:func:`predict_rounds` evaluates that bound for this run's configuration
before the first chunk: γ comes from ``cfg.accel_lambda`` when the
user supplied a spectral bound, otherwise from the same host
power-iteration the Chebyshev acceleration uses
(:func:`~gossipprotocol_tpu_torch.protocols.accel.estimate_gamma` — O(iters·E)
numpy on the CSR). The streak/plateau tail the predicates append rides
on top as ``+ streak_target + 1``.

Gossip (rumor spreading with a hit threshold) has no contraction rate;
its prediction is an explicitly-labelled heuristic — O(log n) spread plus
one expected hit per node per round until the threshold — kept so the
budget machinery and predicted-vs-actual report work uniformly.

``round_budget="auto"`` turns the prediction into an enforced budget of
``BUDGET_FACTOR × predicted`` rounds: a run that overshoots the analytic
bound by that factor is not converging at the predicted rate and exits
with a structured ``over_budget`` record instead of grinding to
``max_rounds``.

The power iteration is gated by edge count (``PREDICT_EDGE_CAP``,
overridable via ``$GOSSIP_TPU_PREDICT_EDGE_CAP``): past the cap
:func:`maybe_predict_rounds` declines unless the caller *requires* a
prediction (``round_budget="auto"``), in which case it pays the cost —
an explicit request beats a silent no-budget run.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional

BUDGET_FACTOR = 8
PREDICT_EDGE_CAP_DEFAULT = 5_000_000
# power iteration sweeps: small graphs have the tiniest eigengaps between
# λ₂ and λ₃ (a line's are O(1/n²) apart), so give them many iterations;
# the budget is ~constant host work either way (iters · E ≈ 4e7)
PREDICT_ITERS_BUDGET = 40_000_000
PREDICT_ITERS_MIN = 200
PREDICT_ITERS_MAX = 5_000


def predict_edge_cap() -> int:
    return int(os.environ.get("GOSSIP_TPU_PREDICT_EDGE_CAP",
                              PREDICT_EDGE_CAP_DEFAULT))


def _num_edges(topo) -> int:
    if topo.implicit_full:
        # K_n is handled analytically (estimate_gamma returns 0.0) — the
        # cap gate should never refuse it
        return 0
    return int(topo.num_directed_edges)


def _estimate_gamma(topo, cfg) -> float:
    if cfg.accel_lambda is not None:
        return float(cfg.accel_lambda)
    from gossipprotocol_tpu_torch.protocols.accel import estimate_gamma

    edges = max(_num_edges(topo), 1)
    iters = max(PREDICT_ITERS_MIN,
                min(PREDICT_ITERS_MAX, PREDICT_ITERS_BUDGET // edges))
    return estimate_gamma(topo, iters=iters)


def predict_rounds(topo, cfg) -> Dict[str, Any]:
    """Predicted round count + auto budget for this (topology, config).

    Returns a json-able dict (it goes verbatim into ``events.jsonl`` and
    the run manifest): model name, γ and spectral gap, effective
    tolerance, ``predicted_rounds``, and ``budget_rounds`` =
    ``BUDGET_FACTOR × predicted`` clamped to ``cfg.max_rounds``.
    """
    n = max(int(topo.num_nodes), 2)
    edges = _num_edges(topo)
    doc: Dict[str, Any] = {
        "num_nodes": n,
        "num_edges": edges,
        "budget_factor": BUDGET_FACTOR,
        "clock": getattr(cfg, "clock", "sync"),
    }
    # poisson clock: each engine round only a Bernoulli(p) subset of
    # senders fires (p = 1 − e^{−rate}, the thinned-process activation),
    # so one *synchronous-equivalent* contraction step takes ~1/p rounds
    # — the classical continuous-time slowdown (arXiv:2011.02379). Sync
    # keeps the factor at exactly 1 (bitwise-unchanged prediction doc
    # modulo the new clock fields).
    slowdown = 1.0
    if getattr(cfg, "clock", "sync") == "poisson":
        from gossipprotocol_tpu_torch.async_ import (
            activation_probability, clock_spec,
        )

        p = activation_probability(
            clock_spec("poisson", cfg.activation_rate))
        doc["activation_rate"] = float(cfg.activation_rate)
        doc["activation_probability"] = round(p, 12)
        slowdown = 1.0 / p
    if cfg.algorithm == "gossip":
        # heuristic, not a bound: O(log n) spread (push-only rumor needs
        # ~log2 n + ln n rounds on an expander), then ~1 hit per node per
        # round until the threshold-th hit lands
        predicted = math.ceil(math.log2(n) + math.log(n)) + int(cfg.threshold)
        doc.update(model="gossip-heuristic", confidence="heuristic",
                   gamma=None, spectral_gap=None, tol=None)
    else:
        gamma = min(max(_estimate_gamma(topo, cfg), 0.0), 1.0 - 1e-12)
        tol_eff = float(cfg.tol if cfg.predicate == "global" else cfg.eps)
        if gamma <= 0.0:
            mixing = 1  # K_n: one W application mixes completely
        else:
            mixing = math.ceil(
                (math.log(n) + math.log(1.0 / tol_eff)) / -math.log(gamma))
        # the predicates append a confirmation tail on top of mixing:
        # streak_target small-delta rounds (delta) / in-tol rounds (global),
        # plus the round that first crosses
        predicted = mixing + int(cfg.streak_target) + 1
        doc.update(model="spectral-pushsum", confidence="analytic",
                   gamma=round(gamma, 12),
                   spectral_gap=round(1.0 - gamma, 12), tol=tol_eff)
    if slowdown != 1.0:
        predicted = math.ceil(predicted * slowdown)
    if getattr(cfg, "workload", "avg") in ("sgp", "gala"):
        # learning workloads stop on consensus AND a loss plateau; the
        # spectral bound only covers the mixing part, so the prediction
        # is a lower bound — downgraded so the anomaly engine's
        # round-blowout rule (analytic-only) never fires on a healthy
        # training run
        doc["confidence"] = "heuristic"
    predicted = max(1, int(predicted))
    doc["predicted_rounds"] = predicted
    doc["budget_rounds"] = int(
        min(cfg.max_rounds, predicted * BUDGET_FACTOR))
    return doc


def maybe_predict_rounds(topo, cfg, required: bool = False
                         ) -> Optional[Dict[str, Any]]:
    """:func:`predict_rounds`, declined (None) when the power iteration
    would be too expensive — unless the caller requires a prediction
    (``round_budget="auto"``), which overrides the cap. Gossip's
    heuristic needs no spectra, so the cap never gates it."""
    if (not required and cfg.algorithm != "gossip"
            and _num_edges(topo) > predict_edge_cap()):
        return None
    if (cfg.algorithm != "gossip" and cfg.accel_lambda is None
            and hasattr(topo, "csr_slice")):
        # a streamed build has no global CSR for the host power
        # iteration; γ is only available when the user supplies the
        # spectral bound (--accel-lambda)
        return None
    return predict_rounds(topo, cfg)
