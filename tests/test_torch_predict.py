"""PyTorch port, the analytic round prediction and round budgets
(``obs/predict.py``, the engine's ``compute_prediction`` and its budget):
``predict_rounds`` gives the JAX package's dict for the same topology and
config (line, imp3D and the implicit complete graph; push-sum under both
predicates, gossip, a Poisson clock, SGP and a given spectral bound —
host float64, tolerance 0); the edge cap declines alike; ``--round-budget
N`` and ``auto`` stop at the JAX engine's round with the same
``over_budget`` record and the same closing prediction block; and the
config's budget checks carry the JAX messages."""

from __future__ import annotations

import pytest
import torch

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.obs import Telemetry as JTelemetry
from gossipprotocol_tpu.obs import predict as jpred

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.obs import Telemetry
from gossipprotocol_tpu_torch.obs import predict as tpred


@pytest.fixture(scope="module", autouse=True)
def _one_openmp_thread():
    """This module's OpenMP code (torch's CPU kernels) runs on one
    thread, restored afterwards: once a process has run a parallel region
    on several threads, GNU OpenMP waits forever in a child forked from
    it, and the JAX package's shard builds fork their workers, so a later
    test of that kind in this test worker would hang."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_TOPOS = {"line": ("line", 64, {}), "imp3D": ("imp3D", 216, {"seed": 2}),
          "full": ("full", 100, {})}
_RUN_TOPO = {"imp3D64": ("imp3D", 64, {"seed": 2})}
_CFGS = {
    "delta": dict(algorithm="push-sum"),
    "global": dict(algorithm="push-sum", fanout="all", predicate="global",
                   tol=1e-3),
    "gossip": dict(algorithm="gossip", threshold=7),
    "poisson": dict(algorithm="push-sum", clock="poisson",
                    activation_rate=0.3),
    "sgp": dict(algorithm="push-sum", fanout="all", workload="sgp",
                predicate="global", payload_dim=4),
    "lambda": dict(algorithm="push-sum", fanout="all", accel="chebyshev",
                   accel_lambda=0.9),
    "budget_cap": dict(algorithm="push-sum", max_rounds=50),
}


def _topos(name):
    kind, n, kw = {**_TOPOS, **_RUN_TOPO}[name]
    return jx.build_topology(kind, n, **kw), tx.build_topology(kind, n, **kw)


@pytest.mark.parametrize("cfg", list(_CFGS))
@pytest.mark.parametrize("topo", list(_TOPOS))
def test_predict_rounds_equal(topo, cfg):
    tj, tt = _topos(topo)
    want = jpred.predict_rounds(tj, jx.RunConfig(**_CFGS[cfg]))
    got = tpred.predict_rounds(tt, tx.RunConfig(device="cpu", **_CFGS[cfg]))
    assert got == want


def test_edge_cap_declines_alike(monkeypatch):
    monkeypatch.setenv("GOSSIP_TPU_PREDICT_EDGE_CAP", "10")
    tj, tt = _topos("imp3D")
    kw = dict(algorithm="push-sum")
    assert jpred.maybe_predict_rounds(tj, jx.RunConfig(**kw)) is None
    assert tpred.maybe_predict_rounds(tt, tx.RunConfig(device="cpu",
                                                       **kw)) is None
    got = tpred.maybe_predict_rounds(tt, tx.RunConfig(device="cpu", **kw),
                                     required=True)
    assert got == jpred.maybe_predict_rounds(tj, jx.RunConfig(**kw),
                                             required=True)
    # gossip's heuristic needs no spectra: never declined
    assert tpred.maybe_predict_rounds(
        tt, tx.RunConfig(device="cpu", algorithm="gossip")) is not None
    assert tpred.predict_edge_cap() == jpred.predict_edge_cap() == 10


# (config, budget): an explicit budget below the run's rounds, and the
# auto budget of a run that cannot converge (fanout-one push-sum keeps
# moving its ratios, so no row stays within tol 1e-12), so it stops at 8x
# the prediction, and one that converges inside it
_BUDGETS = {
    "explicit": (dict(algorithm="push-sum", fanout="all",
                      predicate="global", tol=1e-6), 10),
    "auto": (dict(algorithm="push-sum", predicate="global", tol=1e-12),
             "auto"),
    "auto_converges": (dict(algorithm="push-sum", fanout="all",
                            predicate="global", tol=1e-3), "auto"),
}


@pytest.mark.parametrize("case", list(_BUDGETS))
def test_round_budget_matches_jax(case, tmp_path):
    kw, budget = _BUDGETS[case]
    kw = dict(kw, round_budget=budget, chunk_rounds=16)
    tj, tt = _topos("imp3D64")
    telj = JTelemetry(str(tmp_path / "j"))
    telt = Telemetry(str(tmp_path / "t"))
    rj = jx.run_simulation(tj, jx.RunConfig(telemetry=telj, **kw))
    rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", telemetry=telt,
                                            **kw))
    telj.close()
    telt.close()
    assert (rt.rounds, rt.converged) == (rj.rounds, rj.converged)
    pick = lambda res: [m for m in res.metrics  # noqa: E731
                        if m.get("event") == "over_budget"]
    assert pick(rt) == pick(rj)
    assert bool(pick(rt)) == (case != "auto_converges")
    assert telt.prediction == telj.prediction
    assert telt.prediction["actual_rounds"] == rt.rounds


def test_budget_without_telemetry():
    """A budget with no telemetry hub stops the run with its record."""
    _, tt = _topos("line")
    res = tx.run_simulation(tt, tx.RunConfig(
        device="cpu", algorithm="push-sum", fanout="all",
        predicate="global", tol=1e-6, round_budget=7))
    assert res.rounds == 7 and not res.converged
    assert res.metrics[-1]["event"] == "over_budget"
    assert res.metrics[-1]["budget_source"] == "explicit"


@pytest.mark.parametrize("budget", [0, -3, True, 2.5, "never"])
def test_round_budget_rejections_match_jax(budget):
    with pytest.raises(ValueError) as ej:
        jx.RunConfig(round_budget=budget)
    with pytest.raises(ValueError) as et:
        tx.RunConfig(device="cpu", round_budget=budget)
    assert str(et.value) == str(ej.value)


def test_auto_budget_unavailable_raises_the_jax_message(monkeypatch):
    """``auto`` where the predictor declines (made to here): both engines
    raise the same message instead of running unbudgeted."""
    monkeypatch.setattr(tpred, "maybe_predict_rounds",
                        lambda *a, **k: None)
    monkeypatch.setattr(jpred, "maybe_predict_rounds",
                        lambda *a, **k: None)
    tj, tt = _topos("line")
    with pytest.raises(ValueError) as ej:
        jx.run_simulation(tj, jx.RunConfig(round_budget="auto"))
    with pytest.raises(ValueError) as et:
        tx.run_simulation(tt, tx.RunConfig(device="cpu",
                                           round_budget="auto"))
    assert str(et.value) == str(ej.value)
