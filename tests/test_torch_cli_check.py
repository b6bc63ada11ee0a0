"""PyTorch port, the CLI's ``--check`` and ``--backend`` against the JAX
package's CLI on the CPU: ``--check`` prints the same lines and exits
with the same code for the seven families and the reference population;
``--backend`` maps onto ``--device`` and refuses what the port or the
machine lacks."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gossipprotocol_tpu.cli import main as jax_main

from gossipprotocol_tpu_torch import cli as tcli
from gossipprotocol_tpu_torch.cli import main as torch_main


@pytest.fixture(scope="module", autouse=True)
def _one_openmp_thread():
    """This module's OpenMP code (torch's CPU kernels) runs on one
    thread, restored afterwards: once a process has run a parallel region
    on several threads, GNU OpenMP waits forever in a child forked from
    it, and the JAX package's shard builds fork their workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_CHECKS = [
    ["200", "line", "gossip"], ["200", "full", "gossip"],
    ["200", "3D", "gossip"], ["200", "imp3D", "push-sum", "--seed", "3"],
    ["500", "erdos_renyi", "gossip", "--avg-degree", "4", "--seed", "5"],
    ["500", "power_law", "push-sum", "--attach", "3", "--seed", "2"],
    ["500", "small_world", "gossip", "--ws-k", "4", "--ws-beta", "0.3"],
    ["100", "imp3D", "push-sum", "--semantics", "reference"],
    ["100", "line", "gossip", "--semantics", "reference"],
    ["64", "3D", "gossip", "--semantics", "reference", "--quiet"],
]


@pytest.mark.parametrize("argv", _CHECKS, ids=" ".join)
def test_check_lines_equal_jax(argv, capsys):
    assert jax_main(argv + ["--check", "--compile-cache", ""]) == 0
    j = capsys.readouterr()
    assert torch_main(argv + ["--check", "--device", "cpu"]) == 0
    t = capsys.readouterr()
    assert t.out == j.out
    assert t.out.splitlines()[-1].startswith("topology ok: kind=")


def test_check_reports_an_invalid_topology(monkeypatch, capsys):
    """A topology that fails ``validate`` prints ``topology invalid: ...``
    and exits 2, as in the JAX CLI."""
    from gossipprotocol_tpu_torch.topology.base import Topology

    bad = Topology(kind="line", num_nodes=3,
                   offsets=np.array([0, 1, 2, 3], np.int32),
                   indices=np.array([1, 1, 0], np.int32))
    monkeypatch.setattr(tcli, "_build_run_topology", lambda args: (bad, None))
    assert torch_main(["3", "line", "gossip", "--check", "--device",
                       "cpu"]) == 2
    err = capsys.readouterr().err
    assert err.strip() == "topology invalid: self-loop present"


def test_check_simulates_nothing(monkeypatch, capsys):
    from gossipprotocol_tpu_torch.engine import driver

    def refuse(*a, **k):
        raise AssertionError("--check ran the simulation")

    monkeypatch.setattr(driver, "run_simulation", refuse)
    assert torch_main(["64", "imp3D", "gossip", "--check", "--device",
                       "cpu"]) == 0
    assert "Convergence Time" not in capsys.readouterr().out


def _masked(text):
    return [line for line in text.splitlines()
            if not line.startswith(("Convergence Time", "rounds:"))] + [
        line.split("compile:")[0] for line in text.splitlines()
        if line.startswith("rounds:")]


@pytest.mark.parametrize("argv", [["100", "imp3D", "gossip"],
                                  ["64", "full", "push-sum"],
                                  ["100", "line", "push-sum", "--semantics",
                                   "reference"]], ids=" ".join)
def test_backend_cpu_runs_the_device_cpu_lines(argv, capsys):
    assert torch_main(argv + ["--backend", "cpu"]) == 0
    a = capsys.readouterr().out
    assert torch_main(argv + ["--device", "cpu"]) == 0
    b = capsys.readouterr().out
    assert _masked(a) == _masked(b)
    assert "device: cpu" in a
    assert torch_main(argv + ["--backend", "cpu", "--device", "cpu"]) == 0


def test_backend_auto_follows_device(capsys):
    assert torch_main(["27", "3D", "gossip", "--backend", "auto",
                       "--device", "cpu"]) == 0
    assert "device: cpu" in capsys.readouterr().out


@pytest.mark.parametrize("backend", ["tpu", "metal"])
def test_backend_unavailable_exits_2(backend, capsys):
    """A backend the port lacks prints the JAX CLI's first words."""
    assert torch_main(["27", "3D", "gossip", "--backend", backend]) == 2
    assert capsys.readouterr().err.startswith(
        f"backend '{backend}' unavailable: ")
    assert jax_main(["27", "3D", "gossip", "--backend", "tpu",
                     "--compile-cache", ""]) == 2
    assert capsys.readouterr().err.startswith("backend 'tpu' unavailable: ")


@pytest.mark.parametrize("backend", ["gpu", "cuda"])
def test_backend_contradicting_device_exits_2(backend, capsys):
    assert torch_main(["27", "3D", "gossip", "--backend", backend,
                       "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert f"--backend {backend} contradicts --device cpu" in err
    assert torch_main(["27", "3D", "gossip", "--backend", "cpu",
                       "--device", "cuda"]) == 2
    assert "contradicts --device cuda" in capsys.readouterr().err


@pytest.mark.parametrize("backend", ["gpu", "cuda"])
def test_backend_cuda_without_card_exits_2(backend, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert torch_main(["27", "3D", "gossip", "--backend", backend]) == 2
    assert capsys.readouterr().err.startswith(
        f"backend '{backend}' unavailable: torch.cuda.is_available()")


@pytest.mark.parametrize("backend,device,want", [
    ("auto", None, "cuda"), ("auto", "cpu", "cpu"), ("cpu", None, "cpu"),
    ("cpu", "cpu", "cpu")])
def test_resolve_backend(backend, device, want):
    assert tcli.resolve_backend(backend, device) == want


def test_check_and_backend_are_no_longer_refused():
    assert "--check" not in tcli.UNPORTED_FLAGS
    assert "--backend" not in tcli.UNPORTED_FLAGS
