"""PyTorch port, batched sweeps (``sweep/``): the sweep plans against the
JAX package's (lane order, lane configs, ``describe`` and every rejection
message), and on the CPU each lane of a port sweep bitwise equal to its
standalone port run AND to the JAX package's ``run_sweep`` lane
(tolerance 0: the same bits, the same rounds) — seed sweeps of gossip and
fanout-one push-sum (scatter and invert) and every traced axis, with
staggered freezing; one delivery build a sweep; the envelope's
rejections; the manifest's sweep rollup and per-lane counters equal to
the JAX package's; and ``--sweep`` / ``--sweep-seeds`` through the CLI."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.cli import main as jax_main
from gossipprotocol_tpu.sweep import SweepSpec as JSpec
from gossipprotocol_tpu.sweep.engine import SweepConfigError as JSweepError

from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.engine import driver as tdriver
from gossipprotocol_tpu_torch.engine.driver import RunConfig, run_simulation
from gossipprotocol_tpu_torch.sweep import SweepSpec
from gossipprotocol_tpu_torch.sweep.engine import SweepConfigError
from gossipprotocol_tpu_torch.topology import build_topology


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


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    if a.dtype == np.float64:
        return a.view(np.uint64)
    return a


def _same_state(port, ref) -> bool:
    return all(np.array_equal(_bits(getattr(port, f)),
                              _bits(getattr(ref, f)))
               for f in port._fields)


# ---- the sweep plans ------------------------------------------------------

_PLANS = [
    ({"axes": {"algorithm": ["gossip", "push-sum"]}}, None),
    ({"axes": {"wibble": [1, 2]}}, None),
    ({"axes": {"lr": [0.1, 0.2]}}, None),
    ({"axes": {"seed": [0, 1, 2], "eps": [1e-9]}, "mode": "zip"}, None),
    ({"axes": {}}, None),
    ({"axes": {"seed": []}}, None),
    ({"axes": {"drop_prob": [1.0]}}, None),
    ({"axes": {"threshold": [0]}}, None),
    ({"axes": {"eps": [0.0]}}, None),
    ({"axes": {"tol": [-1.0]}}, None),
    ({"axes": {"activation_rate": [0.0]}}, None),
    ({"axes": {"seed_node": [-1]}}, None),
    ({"axes": {"seed": [1.5]}}, None),
    ({"axes": {"eps": ["x"]}}, None),
    ({"axes": {"eps": [float("inf")]}}, None),
    ({"axes": {"seed": [0]}, "extra": 1}, None),
    ({"axes": {"seed": [0]}, "mode": "cross"}, None),
    ({"axes": [1, 2]}, None),
    ([1, 2], None),
    ({"seed": [0, 1]}, 1),                      # bare axes mapping
    ({"axes": {"seed": [0, 1], "eps": [1e-9, 1e-7]}}, 2),
    ({"axes": {"seed": [3, 4], "eps": [1e-9, 1e-7]}, "mode": "zip"}, 1),
    ({"axes": {"threshold": [5, 10], "seed_node": [0, 3]}}, 3),
    ({"axes": {"drop_prob": [0.0, 0.25], "tol": [1e-3]}}, 1),
]


@pytest.mark.parametrize("doc,lane", _PLANS,
                         ids=[f"plan{i}" for i in range(len(_PLANS))])
def test_spec_matches_jax(doc, lane):
    """Both packages accept the same plans with the same lane order,
    overrides and ``describe``, and refuse the rest word for word."""
    def build(cls):
        try:
            return cls.from_plan(doc), None
        except ValueError as e:
            return None, str(e)

    port, port_err = build(SweepSpec)
    ref, ref_err = build(JSpec)
    assert port_err == ref_err
    if ref is None:
        assert lane is None
        return
    assert port.lanes == ref.lanes and port.axis_names == ref.axis_names
    assert port.traced_names == ref.traced_names
    assert port.describe() == ref.describe()
    for i in range(ref.lanes):
        assert port.lane_overrides(i) == ref.lane_overrides(i)
    cfg = port.lane_config(RunConfig(algorithm="push-sum", max_rounds=500),
                           lane)
    jcfg = ref.lane_config(jx.RunConfig(algorithm="push-sum",
                                        max_rounds=500), lane)
    for name in ("seed", "seed_node", "eps", "tol", "threshold"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert ([(w.start, w.stop, w.prob) for w in cfg.schedule.loss]
            == [(w.start, w.stop, w.prob) for w in jcfg.schedule.loss])


def test_spec_from_file_and_seeds_match_jax(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    for path in (str(bad), str(tmp_path / "missing.json")):
        with pytest.raises(ValueError) as pe:
            SweepSpec.from_file(path)
        with pytest.raises(ValueError) as je:
            JSpec.from_file(path)
        assert str(pe.value).split(":")[0] == str(je.value).split(":")[0]
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"axes": {"seed": [4, 5]}}))
    assert (SweepSpec.from_file(str(good)).describe()
            == JSpec.from_file(str(good)).describe())
    assert (SweepSpec.from_seeds(3, base_seed=7).describe()
            == JSpec.from_seeds(3, base_seed=7).describe())
    for cls in (SweepSpec, JSpec):
        with pytest.raises(ValueError, match="at least one lane"):
            cls.from_seeds(0)
    with pytest.raises(ValueError, match="poisson"):
        SweepSpec(axes=(("activation_rate", (0.5,)),)).lane_config(
            RunConfig(), 0)


# ---- lanes bitwise: the port's standalone run and the JAX lane ----------

# (graph, base config, sweep axes); n <= 216, B <= 3
_LANE_CASES = {
    "gossip-seeds": (("imp3D", 64, {"seed": 3}),
                     dict(algorithm="gossip", chunk_rounds=32),
                     {"seed": [0, 1, 2]}),
    "gossip-seeds-csr": (("power_law", 200, {"seed": 3}),
                         dict(algorithm="gossip", chunk_rounds=16,
                              max_rounds=400),
                         {"seed": [0, 1]}),
    "pushsum-seeds": (("imp3D", 64, {"seed": 3}),
                      dict(algorithm="push-sum", chunk_rounds=32),
                      {"seed": [0, 1, 2]}),
    "pushsum-seeds-invert": (("imp3D", 64, {"seed": 3}),
                             dict(algorithm="push-sum", delivery="invert",
                                  chunk_rounds=32),
                             {"seed": [0, 1, 2]}),
    "pushsum-eps-staggered": (("imp3D", 64, {"seed": 2}),
                              dict(algorithm="push-sum", seed=4,
                                   chunk_rounds=32),
                              {"eps": [1e-4, 1e-10]}),
    "pushsum-tol": (("imp3D", 64, {"seed": 2}),
                    dict(algorithm="push-sum", seed=4, predicate="global",
                         chunk_rounds=16),
                    {"tol": [1e-2, 1e-4]}),
    "gossip-threshold": (("3D", 64, {}),
                         dict(algorithm="gossip", seed=9, chunk_rounds=16),
                         {"threshold": [5, 10]}),
    "pushsum-drop": (("imp3D", 64, {"seed": 2}),
                     dict(algorithm="push-sum", seed=1, predicate="global",
                          chunk_rounds=16),
                     {"drop_prob": [0.0, 0.2]}),
    "gossip-drop": (("imp3D", 64, {"seed": 2}),
                    dict(algorithm="gossip", seed=1, chunk_rounds=16),
                    {"drop_prob": [0.1, 0.3]}),
    "gossip-poisson-rate": (("imp3D", 64, {"seed": 2}),
                            dict(algorithm="gossip", seed=1,
                                 clock="poisson", chunk_rounds=16),
                            {"activation_rate": [0.5, 2.0]}),
    "pushsum-poisson-rate": (("imp3D", 64, {"seed": 2}),
                             dict(algorithm="push-sum", seed=1,
                                  clock="poisson", predicate="global",
                                  chunk_rounds=16),
                             {"activation_rate": [0.5, 2.0]}),
}


@pytest.mark.parametrize("case", sorted(_LANE_CASES))
def test_lanes_bitwise(case):
    (kind, n, topo_kw), base, axes = _LANE_CASES[case]
    topo = build_topology(kind, n, **topo_kw)
    cfg = RunConfig(**base, device="cpu")
    spec = SweepSpec.from_plan({"axes": axes})
    res = run_simulation(topo, dataclasses.replace(cfg, sweep=spec))
    ref = jx.run_simulation(
        jx.build_topology(kind, n, **topo_kw),
        jx.RunConfig(**base, sweep=JSpec.from_plan({"axes": axes})))
    assert res.lanes == ref.lanes == spec.lanes
    assert res.converged == ref.converged
    for i in range(spec.lanes):
        assert res.lane_records[i]["rounds"] == ref.lane_records[i]["rounds"]
        assert (res.lane_records[i]["converged"]
                == ref.lane_records[i]["converged"])
        assert _same_state(res.lane_state(i), ref.lane_state(i)), i
        solo = run_simulation(topo, spec.lane_config(cfg, i))
        assert solo.rounds == res.lane_records[i]["rounds"]
        assert solo.converged == res.lane_records[i]["converged"]
        assert _same_state(res.lane_state(i), solo.final_state), i
    if case == "pushsum-eps-staggered":
        rounds = [lr["rounds"] for lr in res.lane_records]
        assert rounds[0] < rounds[1], "eps should stagger convergence"


def test_lane_round_matches_two_standalone_rounds():
    """One lane-batched round of two different keys is, lane for lane, the
    standalone round of that lane's key — on a graph where nodes take
    several senders, in ascending sender order."""
    from gossipprotocol_tpu_torch.protocols.pushsum import pushsum_round_core
    from gossipprotocol_tpu_torch.protocols.sampling import (
        device_topology, fold_in, key_data,
    )
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init

    topo = build_topology("power_law", 128, seed=5)
    nbrs = device_topology(topo, device="cpu")
    st = pushsum_init(128, device="cpu")
    keys = [fold_in(key_data(s, "cpu"), 3) for s in (0, 9)]
    lanes = type(st)(*(torch.stack([x, x]) for x in st))
    eps = torch.tensor([1e-3, 1e-9], dtype=torch.float32)
    got = pushsum_round_core(lanes, nbrs, torch.stack(keys), n=128, eps=eps,
                             all_alive=True)
    for i, e in enumerate((1e-3, 1e-9)):
        want = pushsum_round_core(st, nbrs, keys[i], n=128, eps=e,
                                  all_alive=True)
        assert _same_state(type(st)(*(x[i] for x in got)), want)


def test_sweep_builds_delivery_tables_once(monkeypatch):
    calls = []
    real = tdriver.device_arrays
    monkeypatch.setattr(
        tdriver, "device_arrays",
        lambda *a, **k: calls.append(1) or real(*a, **k))
    topo = build_topology("imp3D", 27, seed=2)
    cfg = RunConfig(algorithm="push-sum", seed=0, chunk_rounds=32,
                    device="cpu", sweep=SweepSpec.from_seeds(4))
    res = run_simulation(topo, cfg)
    assert res.converged and res.lanes == 4
    assert len(calls) == 1, f"expected one shared build, saw {len(calls)}"


def test_sweep_fetches_once_a_chunk(monkeypatch):
    """Each chunk's stats reach the host in one fetch: the lane stats are
    read once a chunk record (push-sum, no telemetry: no baseline, no
    branch observation)."""
    reads = []
    real = tdriver.StatsLayout.parse
    monkeypatch.setattr(tdriver.StatsLayout, "parse",
                        lambda self, v: reads.append(1) or real(self, v))
    topo = build_topology("imp3D", 64, seed=3)
    res = run_simulation(topo, RunConfig(
        algorithm="push-sum", chunk_rounds=16, device="cpu",
        sweep=SweepSpec.from_seeds(3)))
    assert res.converged
    assert len(reads) == len(res.metrics) > 1


def test_sweep_rejects_resume():
    topo = build_topology("imp3D", 27, seed=2)
    cfg = RunConfig(algorithm="gossip", device="cpu",
                    sweep=SweepSpec.from_seeds(2))
    with pytest.raises(ValueError, match="cannot resume"):
        run_simulation(topo, cfg, initial_state=object())


@pytest.mark.parametrize("kw,axes", [
    (dict(algorithm="push-sum", workload="sgp", predicate="global",
          fanout="all"), {"seed": [0, 1]}),
    (dict(algorithm="push-sum", fanout="all", accel="epd"),
     {"seed": [0, 1]}),
    (dict(algorithm="push-sum", fanout="all"), {"seed": [0, 1]}),
    (dict(algorithm="push-sum", fanout="all", delivery="pallas"),
     {"seed": [0, 1]}),
    (dict(algorithm="gossip", round_budget="auto"), {"seed": [0, 1]}),
    (dict(algorithm="gossip", repair="rewire"), {"seed": [0, 1]}),
    (dict(algorithm="gossip", checkpoint_every=1, checkpoint_dir="ck"),
     {"seed": [0, 1]}),
    (dict(algorithm="gossip"), {"activation_rate": [0.5, 1.0]}),
])
def test_envelope_rejections_match_jax(kw, axes):
    topo = build_topology("imp3D", 27, seed=2)
    jtopo = jx.build_topology("imp3D", 27, seed=2)
    with pytest.raises((SweepConfigError, ValueError)) as pe:
        run_simulation(topo, RunConfig(**kw, device="cpu",
                                       sweep=SweepSpec.from_plan(
                                           {"axes": axes})))
    with pytest.raises((JSweepError, ValueError)) as je:
        jx.run_simulation(jtopo, jx.RunConfig(
            **kw, sweep=JSpec.from_plan({"axes": axes})))
    assert str(pe.value) == str(je.value)
    assert isinstance(pe.value, SweepConfigError) == isinstance(
        je.value, JSweepError)


def test_sentinel_refuses_sweeps():
    with pytest.raises(ValueError, match="run sentinel runs unswept"):
        RunConfig(algorithm="push-sum", sentinel="on",
                  sweep=SweepSpec.from_seeds(2))


# ---- telemetry: the manifest's rollup and per-lane counters --------------

@pytest.mark.parametrize("argv", [
    ["64", "imp3D", "push-sum", "--sweep-seeds", "3", "--drop-prob", "0.1",
     "--predicate", "global", "--seed", "2"],
    ["64", "imp3D", "gossip", "--sweep-seeds", "2", "--seed", "5"],
])
def test_manifest_rollup_matches_jax(argv, tmp_path, capsys):
    """The sweep rollup of ``run.json`` (lanes, converged fraction, round
    percentiles, over-budget flag, the spec and every lane's record with
    its sent / delivered / dropped totals) is the JAX package's; the
    message totals too. Timings are not compared."""
    port_dir, jax_dir = str(tmp_path / "p"), str(tmp_path / "j")
    assert torch_main(argv + ["--device", "cpu",
                              "--telemetry-dir", port_dir]) == 0
    port_out = capsys.readouterr().out
    assert jax_main(argv + ["--telemetry-dir", jax_dir]) == 0
    jax_out = capsys.readouterr().out
    with open(os.path.join(port_dir, "run.json")) as fh:
        port = json.load(fh)
    with open(os.path.join(jax_dir, "run.json")) as fh:
        ref = json.load(fh)
    assert port["sweep"] == ref["sweep"]
    assert port["counters"] == ref["counters"]
    assert port["sweep"]["per_lane"][0]["sent"] > 0
    line = [ln for ln in port_out.splitlines() if ln.startswith("sweep:")]
    jline = [ln for ln in jax_out.splitlines() if ln.startswith("sweep:")]
    assert line and line[0].split("(amortized")[0] == \
        jline[0].split("(amortized")[0]
    assert not os.path.exists(os.path.join(port_dir, "trace.jsonl"))
    assert torch_main(["report", port_dir]) == 0
    assert "lanes" in capsys.readouterr().out


# ---- the CLI ------------------------------------------------------------

def test_cli_sweep_plan_file(tmp_path, capsys):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"axes": {"eps": [1e-4, 1e-10]}}))
    argv = ["64", "imp3D", "push-sum", "--sweep", str(plan), "--seed", "4"]
    assert torch_main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "converged: True" in out
    line = [ln for ln in out.splitlines() if ln.startswith("sweep:")][0]
    assert line.startswith("sweep: 2 lanes, 2 converged, lane rounds ")
    assert "push-sum max |s/w - mean| = " in out


@pytest.mark.parametrize("extra,needle", [
    (["--sweep-seeds", "2", "--sweep", "p.json"], "give exactly one"),
    (["--sweep-seeds", "2", "--resume", "x.npz"], "cannot resume"),
    (["--sweep", "missing.json"], "cannot read sweep plan"),
    (["--sweep-seeds", "0"], "must be >= 1"),
    (["--sweep-seeds", "2", "--fanout", "all", "--delivery", "pallas"],
     "sweeps support fanout='one' push-sum only"),
    (["--sweep-seeds", "2", "--round-budget", "auto"],
     "give sweeps an explicit integer budget"),
])
def test_cli_sweep_exit_2(extra, needle, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "p.json").write_text(json.dumps({"axes": {"seed": [0]}}))
    argv = ["64", "imp3D", "push-sum", *extra, "--device", "cpu"]
    assert torch_main(argv) == 2
    assert needle in capsys.readouterr().err


def test_cli_sweep_structural_axis_exit_2(tmp_path, capsys):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"axes": {"topology": ["line", "3D"]}}))
    assert torch_main(["64", "imp3D", "gossip", "--sweep", str(plan),
                       "--device", "cpu"]) == 2
    assert "structural axis 'topology'" in capsys.readouterr().err


def test_cli_sweep_over_budget_exit_1(capsys):
    assert torch_main(["64", "imp3D", "gossip", "--sweep-seeds", "2",
                       "--round-budget", "3", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "sweep: 2 lanes, 0 converged, lane rounds 3..3" in out
    assert "converged: False" in out
