"""PyTorch port, the K-round megakernel path (``--delivery megakernel``,
``--rounds-per-kernel K``), on the grid of tests/test_megakernel.py: line
130, imp3D 216 and a power-law graph with a hub-split class.

The port's plain megakernel (the CPU body of ``ops/megakernel.py``) is
held bitwise against the JAX package's ``--delivery megakernel`` run in
interpret mode for K in {1, 4, 16}: a fixed 48-round budget with the
predicate disabled, and runs to convergence under the delta and the
global predicate, final state and round counts included. K = 16, K = 1
and the per-round ``--delivery pallas`` path agree bitwise, and the
eligibility and config refusals are the JAX package's."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.ops.delivery import (
    RoutedConfigError as JaxRoutedConfigError,
)
from gossipprotocol_tpu.ops.megakernel import (
    build_megakernel_delivery as jax_build_mk, megakernel_vmem_bytes,
)
from gossipprotocol_tpu.ops.pallasdelivery import (
    build_pallas_delivery as jax_build_pd,
)

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.convert import megakernel_delivery_from_numpy
from gossipprotocol_tpu_torch.engine.driver import use_megakernel
from gossipprotocol_tpu_torch.ops.delivery import RoutedConfigError
from gossipprotocol_tpu_torch.ops.megakernel import (
    megakernel_working_set_bytes,
)
from gossipprotocol_tpu_torch.ops.pallasdelivery import (
    build_pallas_delivery as torch_build_pd,
)


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


_GRAPHS = {
    "line": ("line", 130, {}),
    "imp3D": ("imp3D", 216, {"seed": 4}),
    "powerlaw": ("powerlaw", 400, {"seed": 3, "m": 3}),   # hub split
}
# fixed budget with the predicate disabled (tests/test_megakernel.py's
# _BASE), and runs to convergence under each predicate
_CONFIGS = {
    "budget": dict(predicate="global", tol=1e-4, streak_target=2**30,
                   max_rounds=48),
    "delta": dict(predicate="delta", eps=1e-5, streak_target=2,
                  max_rounds=48),
    "global": dict(predicate="global", tol=1e-3, streak_target=2,
                   max_rounds=48),
}
_FIELDS = ("s", "w", "ratio", "streak", "converged", "alive")
# fanout-all push-sum over the fused gather delivery
_DIFFUSION = dict(algorithm="push-sum", fanout="all", delivery="pallas")
_jax_runs: dict = {}
_torch_runs: dict = {}


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_states_equal(ts, js, fields=_FIELDS):
    for f in fields:
        a, b = _bits(getattr(ts, f)), _bits(getattr(js, f))
        assert a.shape == b.shape and np.array_equal(a, b), f
    assert int(ts.round) == int(np.asarray(js.round))


def _jax_run(graph, config, **kw):
    key = (graph, config, tuple(sorted(kw.items())))
    if key not in _jax_runs:
        name, n, tkw = _GRAPHS[graph]
        _jax_runs[key] = jx.run_simulation(
            jx.build_topology(name, n, **tkw),
            jx.RunConfig(algorithm="push-sum", fanout="all",
                         plan_cache="none", chunk_rounds=16,
                         **_CONFIGS[config], **kw))
    return _jax_runs[key]


def _torch_run(graph, config, **kw):
    key = (graph, config, tuple(sorted(kw.items())))
    if key not in _torch_runs:
        name, n, tkw = _GRAPHS[graph]
        _torch_runs[key] = tx.run_simulation(
            tx.build_topology(name, n, **tkw),
            tx.RunConfig(device="cpu", plan_cache="none", chunk_rounds=16,
                         **_CONFIGS[config], **{**_DIFFUSION, **kw}))
    return _torch_runs[key]


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("config", list(_CONFIGS))
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_megakernel_bitwise_vs_jax(graph, config, k):
    kw = dict(delivery="megakernel", rounds_per_kernel=k)
    rj, rt = _jax_run(graph, config, **kw), _torch_run(graph, config, **kw)
    assert rt.rounds == rj.rounds
    assert rt.converged == rj.converged
    if config == "budget":
        assert rt.rounds == 48
        _assert_states_equal(rt.final_state, rj.final_state, ("s", "w"))
    else:
        _assert_states_equal(rt.final_state, rj.final_state)


@pytest.mark.parametrize("config", list(_CONFIGS))
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_k16_equals_k1_equals_pallas(graph, config):
    runs = [_torch_run(graph, config, delivery="megakernel",
                       rounds_per_kernel=16),
            _torch_run(graph, config, delivery="megakernel"),
            _torch_run(graph, config, delivery="pallas")]
    assert runs[0].rounds == runs[1].rounds == runs[2].rounds
    for r in runs[1:]:
        _assert_states_equal(r.final_state, runs[0].final_state)
    # the megakernel counts only the rounds it ran
    assert runs[0].rounds_executed == runs[0].rounds
    assert runs[2].rounds_executed >= runs[2].rounds


def test_pallas_with_k_is_the_megakernel_engine():
    cfg = tx.RunConfig(device="cpu", **_DIFFUSION, rounds_per_kernel=4)
    assert use_megakernel(cfg)
    assert not use_megakernel(tx.RunConfig(device="cpu", **_DIFFUSION))
    assert cfg.chunk == 16
    assert tx.RunConfig(device="cpu", **_DIFFUSION,
                        rounds_per_kernel=64).chunk == 64
    a = _torch_run("imp3D", "delta", delivery="pallas", rounds_per_kernel=4)
    b = _torch_run("imp3D", "delta", delivery="megakernel",
                   rounds_per_kernel=4)
    assert a.rounds == b.rounds
    _assert_states_equal(a.final_state, b.final_state)


def test_bucket_plans_refused_in_both(monkeypatch):
    monkeypatch.setenv("GOSSIP_TPU_PALLAS_RESIDENT_ROWS", "1")
    name, n, kw = _GRAPHS["imp3D"]
    with pytest.raises(JaxRoutedConfigError, match="resident"):
        jax_build_mk(jax_build_pd(jx.build_topology(name, n, **kw),
                                  device=False))
    with pytest.raises(RoutedConfigError,
                       match="GOSSIP_TPU_PALLAS_RESIDENT_ROWS"):
        tx.run_simulation(tx.build_topology(name, n, **kw),
                          tx.RunConfig(device="cpu", plan_cache="none",
                                       algorithm="push-sum", fanout="all",
                                       delivery="megakernel"))


@pytest.mark.parametrize("kw,match", [
    (dict(delivery="megakernel", rounds_per_kernel=4, chunk_rounds=6),
     "multiple"),
    (dict(delivery="routed", rounds_per_kernel=4), "rounds_per_kernel"),
    (dict(delivery="megakernel", rounds_per_kernel=0), "rounds_per_kernel"),
])
def test_config_gates_as_in_jax(kw, match):
    base = dict(algorithm="push-sum", fanout="all", predicate="global")
    with pytest.raises(ValueError, match=match):
        jx.RunConfig(**base, **kw)
    with pytest.raises(ValueError, match=match):
        tx.RunConfig(device="cpu", **base, **kw)


def test_birth_exclusions_refused_in_both():
    """A sparse Erdős–Rényi graph has nodes outside its largest
    component: the run carries dead rows, which the all-alive kernel
    cannot run."""
    jt, tt = (pkg.build_topology("er", 700, seed=5, avg_degree=3.0)
              for pkg in (jx, tx))
    assert tt.birth_alive() is not None
    cfg = dict(algorithm="push-sum", fanout="all", delivery="megakernel",
               plan_cache="none", max_rounds=16)
    with pytest.raises(ValueError, match="all-alive"):
        jx.run_simulation(jt, jx.RunConfig(**cfg))
    with pytest.raises(ValueError, match="all-alive"):
        tx.run_simulation(tt, tx.RunConfig(device="cpu", **cfg))


def test_initial_dead_set_refused():
    topo = tx.build_topology("imp3D", 216, seed=4)
    st = tx.pushsum_init(216, device="cpu")
    st = st._replace(alive=torch.arange(216) != 7)
    with pytest.raises(RoutedConfigError, match="all-alive"):
        tx.run_simulation(topo, tx.RunConfig(
            device="cpu", plan_cache="none", algorithm="push-sum",
            fanout="all", delivery="megakernel"),
            initial_state=st)


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_working_set_equals_jax_vmem_bytes(graph):
    name, n, kw = _GRAPHS[graph]
    jpd = jax_build_pd(jx.build_topology(name, n, **kw), device=False)
    tpd = torch_build_pd(tx.build_topology(name, n, **kw), device="cpu")
    assert megakernel_working_set_bytes(tpd) == megakernel_vmem_bytes(jpd)


def test_delivery_carried_across_from_jax():
    name, n, kw = _GRAPHS["powerlaw"]
    jpd = jax_build_pd(jx.build_topology(name, n, **kw), device=False)
    mk = megakernel_delivery_from_numpy(jpd, device="cpu")
    own = torch_build_pd(tx.build_topology(name, n, **kw), device="cpu")
    assert mk.pd.classes == own.classes
    assert torch.equal(mk.pd.gather_pre.idx, own.gather_pre.idx)
    assert torch.equal(mk.pd.gather_out.idx, own.gather_out.idx)
    assert torch.equal(mk.deg_f, own.degree.float())


_CLI = ["push-sum", "--fanout", "all", "--device", "cpu",
        "--plan-cache", "none"]


@pytest.mark.parametrize("extra", [["--delivery", "megakernel"],
                                   ["--delivery", "megakernel",
                                    "--rounds-per-kernel", "16"],
                                   ["--delivery", "pallas",
                                    "--rounds-per-kernel", "4"]])
def test_cli_megakernel_converges(extra, capsys):
    rc = torch_main(["216", "imp3D", *_CLI, *extra, "--predicate",
                     "global"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "converged: True" in out
    rounds = out.split("rounds: ")[1].split(" ")[0]
    assert f"rounds: {rounds} ({rounds} executed)" in out


@pytest.mark.parametrize("argv,needle", [
    (["64", "full", *_CLI, "--delivery", "megakernel"], "explicit edge list"),
    (["700", "er", *_CLI, "--delivery", "megakernel", "--avg-degree",
      "3"], "all-alive"),
    (["216", "imp3D", *_CLI, "--delivery", "megakernel",
      "--rounds-per-kernel", "4", "--chunk-rounds", "6"], "multiple"),
    (["216", "imp3D", *_CLI, "--delivery", "megakernel",
      "--rounds-per-kernel", "0"], "rounds-per-kernel"),
    (["216", "imp3D", *_CLI, "--delivery", "routed",
      "--rounds-per-kernel", "4"], "--delivery routed"),
])
def test_cli_megakernel_exit_2(argv, needle, capsys):
    assert torch_main(argv) == 2
    assert needle in capsys.readouterr().err


def test_cli_megakernel_without_card_exit_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = torch_main(["216", "imp3D", "push-sum", "--fanout", "all",
                     "--delivery", "megakernel"])
    assert rc == 2
    assert "cuda" in capsys.readouterr().err
