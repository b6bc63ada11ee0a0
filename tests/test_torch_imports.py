"""The PyTorch port stands alone: no module of gossipprotocol_tpu_torch,
and not chip_smoke.py, imports jax or the JAX package (checked on the
source with ast, so an import hidden inside a function counts too)."""

from __future__ import annotations

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
_FILES = sorted((ROOT / "gossipprotocol_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
_FORBIDDEN = ("jax", "jaxlib", "gossipprotocol_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _FILES,
                         ids=[str(p.relative_to(ROOT)) for p in _FILES])
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_walk_finds_the_package():
    names = {p.name for p in _FILES}
    assert {"classops.py", "pallasdelivery.py", "driver.py",
            "chip_smoke.py", "exec.py", "clos.py", "plan.py", "native.py",
            "delivery.py", "mesh.py", "sharded.py",
            "sharddelivery.py", "sampling.py", "gossip.py", "walk.py",
            "probes.py", "slab_probe.py", "route_probe.py",
            "tile_perm_probe.py", "curves.py", "oracle_curves.py",
            "faults.py", "repair.py", "engine.py", "checkpoint.py"} <= names
    assert (ROOT / "gossipprotocol_tpu_torch" / "ops" / "walk.py"
            in _FILES)
    assert (ROOT / "gossipprotocol_tpu_torch" / "probes" / "__init__.py"
            in _FILES)


def test_walk_finds_the_workload_modules():
    """The modules of the workloads (clocks, learners, acceleration) are
    walked by the check above."""
    pkg = ROOT / "gossipprotocol_tpu_torch"
    for rel in ("async_/__init__.py", "async_/clock.py", "learn/__init__.py",
                "learn/data.py", "learn/sgp.py", "learn/gala.py",
                "protocols/accel.py"):
        assert pkg / rel in _FILES, rel


def test_walk_finds_the_obs_modules():
    """The run-side observability modules (telemetry, counters, traces,
    the manifest, the prediction, the anomaly rules, the report and the
    resource samples) are walked by the check above."""
    pkg = ROOT / "gossipprotocol_tpu_torch"
    for rel in ("obs/__init__.py", "obs/telemetry.py", "obs/counters.py",
                "obs/trace.py", "obs/manifest.py", "obs/predict.py",
                "obs/anomaly.py", "obs/report.py", "obs/resources.py",
                "utils/metrics.py", "utils/profiling.py"):
        assert pkg / rel in _FILES, rel


def test_walk_finds_the_sweep_serve_and_planner_modules():
    """The batched sweeps, the serve daemon's host-side readers and the
    offline tools (the capacity planner, watch, history, the SLOs) are
    walked by the check above."""
    pkg = ROOT / "gossipprotocol_tpu_torch"
    for rel in ("sweep/__init__.py", "sweep/spec.py", "sweep/engine.py",
                "serve/__init__.py", "serve/journal.py",
                "serve/lifecycle.py", "obs/capacity.py", "obs/watch.py",
                "obs/history.py", "obs/slo.py"):
        assert pkg / rel in _FILES, rel
