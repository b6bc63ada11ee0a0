"""PyTorch port, the capacity planner (``obs/capacity.py``): the host
closed forms (edge estimates, host build bytes, build shard suggestions)
equal to the JAX package's; for every path the port runs, the predicted
state and delivery bytes against the summed ``nbytes`` of the tensors the
port's ``build_protocol`` and ``device_arrays`` (or the sharded engine's
plans) hold on the CPU — state and the table paths exact (tolerance 0),
the Clos-routed and sharded push plans, whose run capacities are priced
at 1.25x their mean load, within [1.0, 1.3] of the built bytes (never
below); ``plan``'s rendering, ``--json`` and exit codes 0, 1 and 2; and
the run CLI refusing an over-capacity run and sweep before any plan build
under ``$GOSSIP_TPU_HBM_BYTES`` (exit 2, the planner's message)."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from gossipprotocol_tpu.obs import capacity as jcap

from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.engine import driver as tdriver
from gossipprotocol_tpu_torch.engine.driver import (
    RunConfig, build_protocol, device_arrays,
)
from gossipprotocol_tpu_torch.obs import capacity as cap
from gossipprotocol_tpu_torch.parallel.mesh import padded_size
from gossipprotocol_tpu_torch.sweep import SweepSpec
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


def _nbytes(x, seen=None) -> int:
    """Summed bytes of every distinct tensor (or numpy array) in ``x``."""
    seen = set() if seen is None else seen
    if isinstance(x, torch.Tensor):
        if id(x) in seen:
            return 0
        seen.add(id(x))
        return x.numel() * x.element_size()
    if isinstance(x, np.ndarray):
        return x.nbytes
    if isinstance(x, dict):
        return sum(_nbytes(v, seen) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v, seen) for v in x)
    return 0


# ---- host closed forms equal to the JAX package's ------------------------

@pytest.mark.parametrize("kind", ["line", "full", "3D", "imp3D",
                                  "erdos_renyi", "power_law",
                                  "small_world"])
@pytest.mark.parametrize("n", [1000, 10**8])
def test_host_closed_forms_match_jax(kind, n):
    assert cap.edges_estimate(kind, n) == jcap.edges_estimate(kind, n)
    for kw in ({}, {"streamed": True}, {"streamed": True, "num_shards": 8},
               {"streamed": True, "store_on_disk": True,
                "memory_budget": 1 << 20, "chunk_edges": 4096}):
        assert (cap.estimate_build_host_bytes(kind, n, **kw)
                == jcap.estimate_build_host_bytes(kind, n, **kw))
    for budget in (1 << 30, 1 << 34):
        assert (cap.suggest_build_shards(kind, n, budget)
                == jcap.suggest_build_shards(kind, n, budget))


def test_byte_size_and_budget_env(monkeypatch):
    from gossipprotocol_tpu.topology.stream import parse_byte_size

    for text in ("512M", "2g", "65536", "1.5K", 4096):
        assert cap.parse_byte_size(text) == parse_byte_size(text)
    monkeypatch.setenv("GOSSIP_TPU_BUILD_RSS_BYTES", "3G")
    assert cap.build_rss_budget_bytes() == 3 << 30
    monkeypatch.setenv("GOSSIP_TPU_BUILD_RSS_BYTES", "lots")
    with pytest.raises(cap.CapacityError):
        cap.build_rss_budget_bytes()


# ---- predicted bytes against the built tensors ---------------------------

_PS = dict(algorithm="push-sum", device="cpu", plan_cache="none")
# (name, topology, config, tolerance on delivery: (low, high) of predicted
# over built; state is always exact)
_PATHS = [
    ("gossip-dense", ("imp3D", 512), dict(device="cpu"), (1.0, 1.0)),
    ("gossip-dense-card", ("imp3D", 512),
     dict(device="cuda"), (1.0, 1.0)),
    ("gossip-csr", ("power_law", 512), dict(device="cpu"), (1.0, 1.0)),
    ("gossip-full", ("full", 256), dict(device="cpu"), (1.0, 1.0)),
    ("fanout-one-scatter", ("imp3D", 512), dict(_PS), (1.0, 1.0)),
    ("fanout-one-invert", ("imp3D", 512), dict(_PS, delivery="invert"),
     (1.0, 1.0)),
    ("fanout-all-scatter", ("power_law", 512), dict(_PS, fanout="all"),
     (1.0, 1.0)),
    ("pallas", ("imp3D", 512), dict(_PS, fanout="all", delivery="pallas"),
     (1.0, 1.0)),
    ("pallas-hubs", ("power_law", 4096),
     dict(_PS, fanout="all", delivery="pallas"), (1.0, 1.0)),
    ("megakernel", ("imp3D", 512),
     dict(_PS, fanout="all", delivery="megakernel"), (1.0, 1.0)),
    ("routed", ("imp3D", 4096), dict(_PS, fanout="all", delivery="routed"),
     (1.0, 1.3)),
    ("routed-hubs", ("power_law", 4096),
     dict(_PS, fanout="all", delivery="routed"), (1.0, 1.3)),
    ("sgp-d4", ("imp3D", 512),
     dict(_PS, fanout="all", delivery="pallas", workload="sgp",
          payload_dim=4, predicate="global"), (1.0, 1.0)),
    ("sweep-4-lanes", ("imp3D", 512),
     dict(_PS, sweep=SweepSpec.from_seeds(4)), (1.0, 1.0)),
]


@pytest.mark.parametrize("name,graph,kw,tol", _PATHS,
                         ids=[p[0] for p in _PATHS])
def test_predicted_bytes_match_built(name, graph, kw, tol):
    topo = build_topology(graph[0], graph[1], seed=0)
    cfg = RunConfig(**kw)
    doc = cap.estimate_for_topology(topo, cfg, 1)
    per = doc["per_device"]
    built_cfg = dataclasses.replace(cfg, sweep=None, device="cpu")
    lanes = cfg.sweep.lanes if cfg.sweep is not None else 1
    state = _nbytes(build_protocol(topo, built_cfg)[0]) * lanes
    assert per["state_bytes"] == state
    arrays = device_arrays(topo, built_cfg)
    built = _nbytes(arrays)
    predicted = per["delivery_bytes"] + per["data_bytes"]
    if name == "gossip-dense-card":
        # the card never inverts gossip: the plain dense table
        built = _nbytes((arrays.table, arrays.degree))
        assert doc["delivery_path"] == "dense-table"
    lo, hi = tol
    assert lo * built <= predicted <= hi * built, (predicted, built)
    assert per["total_bytes"] >= predicted + per["state_bytes"]


@pytest.mark.parametrize("kind", ["imp3D", "power_law"])
def test_predicted_sharded_push_bytes(kind):
    from gossipprotocol_tpu_torch.convert import shard_push_from_numpy
    from gossipprotocol_tpu_torch.ops.plancache import (
        shard_push_deliveries_cached,
    )

    topo = build_topology(kind, 4096, seed=0)
    cfg = RunConfig(**dict(_PS, fanout="all", delivery="pallas",
                           build_workers=1))
    doc = cap.estimate_for_topology(topo, cfg, 2)
    host, _ = shard_push_deliveries_cached(
        topo, padded_size(topo.num_nodes, 2), 2, cache_dir="none",
        build_workers=1)
    built = _nbytes(shard_push_from_numpy(host, device="cpu"))
    geo = cap.layout_geometry(topo, 2)
    assert geo["shard_m_pairs"] == host.m_pairs
    assert geo["block_pairs"] == host.block_pairs
    assert geo["shard_nu"] == host.nu
    predicted = doc["per_device"]["delivery_bytes"]
    assert built <= predicted <= 1.3 * built, (predicted, built)


def test_layout_geometry_matches_built_plans():
    topo = build_topology("power_law", 4096, seed=1)
    pd = device_arrays(topo, RunConfig(**dict(_PS, fanout="all",
                                              delivery="pallas")))
    geo = cap.layout_geometry(topo)
    assert (geo["m_pairs"], geo["nu"]) == (pd.m_pairs, pd.nu)


def test_megakernel_fields_from_the_kernel_module():
    """The planner's megakernel working set is the kernel module's own
    geometry form, at or above the built delivery's (its widest class
    region priced at every pair slot); off a card the shared-memory
    field is unknown (None), and the render says so."""
    from gossipprotocol_tpu_torch.ops.megakernel import (
        megakernel_working_set_bytes, working_set_bytes,
    )

    topo = build_topology("power_law", 4096, seed=1)
    cfg = RunConfig(**dict(_PS, fanout="all", delivery="megakernel"))
    per = cap.estimate_for_topology(topo, cfg, 1)["per_device"]
    pd = device_arrays(topo, dataclasses.replace(cfg, delivery="pallas"))
    built = megakernel_working_set_bytes(pd)
    widest = max(reg_rows for *_c, reg_rows, _cap in pd.classes)
    assert working_set_bytes(pd.n, pd.m_pairs, pd.nu, widest) == built
    assert per["megakernel_working_set_bytes"] == working_set_bytes(
        pd.n, pd.m_pairs, pd.nu, -(-2 * pd.m_pairs // 128))
    assert per["megakernel_working_set_bytes"] >= built
    assert per["megakernel_state_in_shared_memory"] is None


@pytest.mark.parametrize("graph,kw,path", [
    (("imp3D", 512), dict(device="cpu"), "dense-table+inversion"),
    (("imp3D", 512), dict(device="cuda"), "dense-table"),
    (("imp3D", 512), dict(device="cpu", drop_prob=0.1), "dense-table"),
    (("imp3D", 512), dict(device="cpu", clock="poisson"), "dense-table"),
    (("power_law", 512), dict(device="cpu"), "csr"),
], ids=["cpu", "card", "loss", "poisson", "csr"])
def test_table_path_follows_the_engine_rules(graph, kw, path):
    """The planner's table path is the engine's own decision
    (``use_dense`` and ``gossip_inversion_enabled``) on the built graph."""
    from gossipprotocol_tpu_torch.engine.driver import (
        gossip_inversion_enabled,
    )
    from gossipprotocol_tpu_torch.protocols.sampling import use_dense
    from gossipprotocol_tpu_torch.utils import faults

    topo = build_topology(graph[0], graph[1], seed=0)
    drop = kw.pop("drop_prob", None)
    if drop is not None:
        kw["fault_schedule"] = faults.FaultSchedule(
            loss=(faults.LossWindow(0, 10**6, drop),))
    cfg = RunConfig(**kw)
    assert cap.estimate_for_topology(topo, cfg, 1)["delivery_path"] == path
    engine = ("csr" if not use_dense(topo)
              else "dense-table+inversion"
              if gossip_inversion_enabled(topo, cfg) else "dense-table")
    assert engine == path


def test_sweep_lanes_price_per_run_state():
    topo = build_topology("imp3D", 512, seed=0)
    base = RunConfig(algorithm="push-sum", chunk_rounds=32)
    one = cap.estimate_for_topology(topo, base, 1)
    eight = cap.estimate_for_topology(
        topo, dataclasses.replace(base, sweep=SweepSpec.from_seeds(8)), 1)
    assert eight["lanes"] == 8
    assert (eight["per_device"]["state_bytes"]
            == 8 * one["per_device"]["state_bytes"])
    # the hash's node ids and clamped degrees are shared by the lanes
    assert (4 * one["per_device"]["temp_bytes"]
            < eight["per_device"]["temp_bytes"]
            < 8 * one["per_device"]["temp_bytes"])
    # the counter rows a lane, beside one stats tensor
    assert (eight["per_device"]["telemetry_bytes"] - 4096
            == 8 * (one["per_device"]["telemetry_bytes"] - 4096))
    assert (eight["per_device"]["delivery_bytes"]
            == one["per_device"]["delivery_bytes"])


def test_device_capacity_source(monkeypatch):
    monkeypatch.delenv("GOSSIP_TPU_HBM_BYTES", raising=False)
    assert cap.device_capacity_bytes() == (None, "unknown")
    monkeypatch.setenv("GOSSIP_TPU_HBM_BYTES", "8e9")
    assert cap.device_capacity_bytes() == (8 * 10**9,
                                           "$GOSSIP_TPU_HBM_BYTES")
    monkeypatch.setenv("GOSSIP_TPU_HBM_BYTES", "big")
    with pytest.raises(cap.CapacityError):
        cap.device_capacity_bytes()


# ---- plan ------------------------------------------------------------------

def test_plan_fits(capsys):
    code = torch_main(["plan", "100000", "line", "push-sum",
                       "--hbm-bytes", str(16 * 2**30)])
    out = capsys.readouterr().out
    assert code == 0
    for needle in ("capacity plan: push-sum on line-100000",
                   "state:", "delivery:", "total:",
                   "max feasible n", "verdict: fits"):
        assert needle in out, needle


def test_plan_over_capacity_exits_1(capsys):
    code = torch_main(["plan", "100000000", "erdos_renyi", "push-sum",
                       "--devices", "4", "--hbm-bytes", str(2**30)])
    out = capsys.readouterr().out
    assert code == 1
    assert "OVER CAPACITY" in out and "max feasible n" in out


@pytest.mark.parametrize("argv", [
    ["plan", "1000", "not_a_topology"],
    ["plan", "0", "line", "--hbm-bytes", "1"],
    ["plan", "1000", "imp3D", "--delivery", "megakernel", "--devices", "2"],
    ["plan", "1000", "imp3D", "--payload-wire", "bf16"],
    ["plan", "1000", "imp3D", "wiretap"],
])
def test_plan_bad_input_exits_2(argv, capsys):
    assert torch_main(argv) == 2
    assert capsys.readouterr().err


def test_plan_json_and_unknown_capacity(capsys, monkeypatch):
    monkeypatch.delenv("GOSSIP_TPU_HBM_BYTES", raising=False)
    code = torch_main(["plan", "4096", "3D", "push-sum", "--fanout", "all",
                       "--delivery", "scatter", "--hbm-bytes", str(2**30),
                       "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert code == 0
    assert doc["kind"] == "3D" and doc["verdict"] == "fits"
    assert doc["per_device"]["total_bytes"] > 0
    assert doc["capacity_source"] == "--hbm-bytes"
    assert doc["max_feasible_nodes"] > 4096
    assert set(doc["build_host_bytes"]) == {"materialized", "streamed"}
    assert torch_main(["plan", "512000", "imp3D", "--delivery",
                       "megakernel"]) == 0
    out = capsys.readouterr().out
    assert "capacity:     unknown" in out and "fused set:" in out
    assert "state placement unknown off a card" in out
    assert "vmem" not in out
    assert torch_main(["plan", "4096", "imp3D", "--fanout", "all",
                       "--devices", "2", "--payload-wire", "int8"]) == 0
    assert "int8 wire" in capsys.readouterr().out


# ---- the run preflight -----------------------------------------------------

def test_run_cli_refuses_over_capacity(capsys, monkeypatch):
    """An over-budget run is refused before any plan build, exit 2, with
    the planner's message; a run under the budget still runs."""
    calls = []
    real = tdriver.device_arrays
    monkeypatch.setattr(tdriver, "device_arrays",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("GOSSIP_TPU_HBM_BYTES", "1000000")
    assert torch_main(["100000", "line", "push-sum", "--max-rounds", "5",
                       "--quiet", "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "exceeds" in err and "max feasible n" in err
    assert "sweep" not in err
    assert not calls
    monkeypatch.setenv("GOSSIP_TPU_HBM_BYTES", str(16 * 2**30))
    assert torch_main(["32", "line", "push-sum", "--max-rounds", "400",
                       "--quiet", "--device", "cpu"]) == 0
    assert calls


@pytest.mark.parametrize("argv", [
    ["2000", "line", "gossip", "--seed-node", "1500"],
    ["2000", "line", "push-sum", "--semantics", "reference",
     "--seed-node", "1500"],
    ["2000", "line", "gossip", "--fault-plan", "{plan}"],
], ids=["gossip-seed-node", "walk-seed-node", "gossip-kill-ids"])
def test_preflight_probe_ignores_node_ids(argv, capsys, monkeypatch,
                                          tmp_path):
    """The state probe is a 512-row build: node ids of the real graph
    past its rows (the start node, a strike's ids) do not reach it, so a
    run whose preflight is on runs as it does with the preflight off."""
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"kill": [{"round": 2,
                                          "ids": [700, 1999]}]}))
    argv = [a.replace("{plan}", str(plan)) for a in argv] + [
        "--max-rounds", "6", "--quiet", "--device", "cpu"]
    monkeypatch.delenv("GOSSIP_TPU_HBM_BYTES", raising=False)
    off = torch_main(argv)
    capsys.readouterr()
    monkeypatch.setenv("GOSSIP_TPU_HBM_BYTES", str(16 * 2**30))
    assert torch_main(argv) == off
    assert "Traceback" not in capsys.readouterr().err


def test_run_cli_refuses_over_capacity_sweep(capsys, monkeypatch,
                                             tmp_path):
    topo = build_topology("imp3D", 512, seed=0)
    one = cap.estimate_for_topology(
        topo, RunConfig(algorithm="push-sum", device="cpu"), 1)
    monkeypatch.setenv("GOSSIP_TPU_HBM_BYTES",
                       str(one["per_device"]["total_bytes"] * 2))
    argv = ["512", "imp3D", "push-sum", "--device", "cpu", "--max-rounds",
            "50", "--telemetry-dir", str(tmp_path / "t")]
    assert torch_main(argv) in (0, 1)   # one run fits
    capsys.readouterr()
    assert torch_main(argv + ["--sweep-seeds", "64"]) == 2
    err = capsys.readouterr().err
    assert "64-lane sweep" in err and "shrink the sweep" in err
    assert "max feasible n" in err


def test_preflight_notes_the_plan(monkeypatch, tmp_path):
    from gossipprotocol_tpu_torch.obs import Telemetry

    monkeypatch.setenv("GOSSIP_TPU_HBM_BYTES", str(2**30))
    topo = build_topology("imp3D", 512, seed=0)
    with Telemetry(str(tmp_path / "t")) as tel:
        doc = cap.preflight(topo, RunConfig(device="cpu"), 1, tel)
    assert doc["capacity_source"] == "$GOSSIP_TPU_HBM_BYTES"
    assert 0 < doc["capacity_fraction"] < 1
    with open(tmp_path / "t" / "resources.json") as fh:
        res = json.load(fh)
    assert res["notes"]["capacity_plan"]["num_nodes"] == 512
    monkeypatch.setenv("GOSSIP_TPU_BUILD_RSS_BYTES", "1K")
    monkeypatch.delenv("GOSSIP_TPU_HBM_BYTES")
    assert cap.preflight(topo, RunConfig(device="cpu"), 1) is None
