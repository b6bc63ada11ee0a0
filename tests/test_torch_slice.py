"""PyTorch port, the slice end to end: fanout-all push-sum over the fused
gather delivery. Both packages run the same topology and config for a
capped number of rounds (the JAX side in interpret mode), and the final
state and round counts must be bitwise equal; the port's CLI keeps the
exit-code contract (0 converged, 1 not, 2 bad or unported input).

The one arithmetic step where the JAX package's program and its XLA CPU
build disagree — ``s - share*deg`` contracted into a fused multiply-add —
is replayed by the port (protocols/diffusion.py ``_keep``; ROADMAP.md
Queue 3); the trajectories below would drift by an ulp in round 1
without it."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.ops.pallasdelivery import build_pallas_delivery
from gossipprotocol_tpu.protocols.diffusion import (
    pushsum_diffusion_round_routed as jax_round,
)
from gossipprotocol_tpu.protocols.state import pushsum_init as jax_init

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.convert import state_from_numpy
from gossipprotocol_tpu_torch.engine.driver import NotPortedError
from gossipprotocol_tpu_torch.ops.pallasdelivery import (
    build_pallas_delivery as torch_build_delivery,
)
from gossipprotocol_tpu_torch.protocols.diffusion import (
    pushsum_diffusion_round_routed as torch_round,
)
from gossipprotocol_tpu_torch.protocols.state import (
    pushsum_init as torch_init,
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
    "imp3D": ("imp3D", 216, {"seed": 4}),
    "powerlaw": ("powerlaw", 400, {"seed": 3, "m": 3}),   # hub split
    "er": ("er", 700, {"seed": 5}),      # birth exclusions: masked path
}
_FIELDS = ("s", "w", "ratio", "streak", "converged", "alive")
# fanout-all push-sum over the fused gather delivery (the slice)
_DIFFUSION = dict(algorithm="push-sum", fanout="all", delivery="pallas")
_jax_runs: dict = {}


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_states_equal(tstate, jstate):
    for f in _FIELDS:
        a, b = _bits(getattr(tstate, f)), _bits(getattr(jstate, f))
        assert a.shape == b.shape and np.array_equal(a, b), f
    assert int(tstate.round) == int(np.asarray(jstate.round))


def _run_both(graph, **kw):
    name, n, tkw = _GRAPHS[graph]
    key = (graph, tuple(sorted(kw.items())))
    base = dict(_DIFFUSION, chunk_rounds=8, max_rounds=16, **kw)
    if key not in _jax_runs:
        _jax_runs[key] = jx.run_simulation(
            jx.build_topology(name, n, **tkw),
            jx.RunConfig(plan_cache="none", **base))
    rt = tx.run_simulation(tx.build_topology(name, n, **tkw),
                           tx.RunConfig(device="cpu", **base))
    return _jax_runs[key], rt


@pytest.mark.parametrize("predicate", ["delta", "global"])
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_run_simulation_bitwise(graph, predicate):
    rj, rt = _run_both(graph, predicate=predicate)
    assert rt.rounds == rj.rounds == 16
    assert rt.converged == rj.converged
    _assert_states_equal(rt.final_state, rj.final_state)


def test_index_value_mode_bitwise():
    rj, rt = _run_both("imp3D", value_mode="index")
    _assert_states_equal(rt.final_state, rj.final_state)


def test_round_counts_equal_at_convergence():
    # a loose global tolerance converges inside the budget: the stop
    # round must match the JAX engine's while_loop exactly, including a
    # chunk that ends mid-way (chunk 8, convergence at a non-multiple)
    rj, rt = _run_both("imp3D", predicate="global", tol=0.05,
                       streak_target=2)
    assert rj.converged and rt.converged
    assert rt.rounds == rj.rounds and rt.rounds % 8 != 0
    assert rt.rounds_executed >= rt.rounds
    _assert_states_equal(rt.final_state, rj.final_state)


@pytest.mark.parametrize("value_mode", ["scaled", "index"])
@pytest.mark.parametrize("n", [216, 1000])
def test_init_state_carried_across(n, value_mode):
    js = jax.device_get(jax_init(n, value_mode=value_mode))
    carried = state_from_numpy(*[np.asarray(getattr(js, f))
                                 for f in _FIELDS + ("round",)],
                               device="cpu")
    _assert_states_equal(carried, js)
    _assert_states_equal(torch_init(n, value_mode=value_mode,
                                    device="cpu"), js)


def test_general_dead_set_round_bitwise():
    """The live-degree path (an arbitrary dead set, one extra
    matvec(alive, alive) per round), four rounds from a state carried
    across from the JAX package."""
    topo_j = jx.build_topology("powerlaw", 400, seed=3, m=3)
    topo_t = tx.build_topology("powerlaw", 400, seed=3, m=3)
    dead = np.random.default_rng(9).random(400) < 0.1
    js = jax_init(400)._replace(alive=jax.numpy.asarray(~dead))
    ts = state_from_numpy(*[np.asarray(getattr(js, f))
                            for f in _FIELDS + ("round",)],
                          device="cpu")
    jd = build_pallas_delivery(topo_j)
    td = torch_build_delivery(topo_t, device="cpu")
    for _ in range(4):
        js = jax_round(js, jd, jax.random.key(0), n=400, all_alive=False,
                       targets_alive=False, interpret=True)
        ts = torch_round(ts, td, all_alive=False, targets_alive=False)
        _assert_states_equal(ts, jax.device_get(js))


def test_continue_from_jax_state():
    """A JAX run's 8-round state, carried across, continues in the port
    exactly as the JAX package continues it."""
    name, n, kw = _GRAPHS["imp3D"]
    topo_j = jx.build_topology(name, n, **kw)
    cfg = dict(_DIFFUSION, chunk_rounds=8, predicate="global")
    mid = jx.run_simulation(topo_j, jx.RunConfig(
        plan_cache="none", max_rounds=8, **cfg)).final_state
    rj = jx.run_simulation(topo_j, jx.RunConfig(
        plan_cache="none", max_rounds=16, **cfg), initial_state=mid)
    carried = state_from_numpy(*[np.asarray(getattr(mid, f))
                                 for f in _FIELDS + ("round",)],
                               device="cpu")
    rt = tx.run_simulation(tx.build_topology(name, n, **kw),
                           tx.RunConfig(device="cpu", max_rounds=16, **cfg),
                           initial_state=carried)
    assert rt.rounds == rj.rounds == 16
    _assert_states_equal(rt.final_state, rj.final_state)


@pytest.mark.parametrize("graph", ["powerlaw", "er"])
def test_run_from_arbitrary_dead_set_bitwise(graph):
    """A start state whose dead set is not the birth exclusions: both
    engines take the general live-degree path for the whole run."""
    name, n, kw = _GRAPHS[graph]
    topo_j = jx.build_topology(name, n, **kw)
    dead = np.random.default_rng(3).random(n) < 0.1
    birth = topo_j.birth_alive()
    alive = ~dead if birth is None else (np.asarray(birth) & ~dead)
    js = jax.device_get(jax_init(n)._replace(alive=jax.numpy.asarray(alive)))
    cfg = dict(_DIFFUSION, chunk_rounds=8, max_rounds=16,
               predicate="global")
    rj = jx.run_simulation(topo_j, jx.RunConfig(
        plan_cache="none", **cfg), initial_state=js)
    carried = state_from_numpy(*[np.asarray(getattr(js, f))
                                 for f in _FIELDS + ("round",)],
                               device="cpu")
    rt = tx.run_simulation(tx.build_topology(name, n, **kw),
                           tx.RunConfig(device="cpu", **cfg),
                           initial_state=carried)
    assert rt.rounds == rj.rounds
    _assert_states_equal(rt.final_state, rj.final_state)


def test_mass_conserved():
    """Σw stays n and Σs stays Σ i/n over a run (diffusion ships every
    share it keeps track of), up to float32 summation error."""
    from gossipprotocol_tpu_torch.protocols.pushsum import mass

    _, rt = _run_both("imp3D", predicate="delta")
    st0 = torch_init(rt.num_nodes, device="cpu")
    s0, w0 = mass(st0)
    s1, w1 = mass(rt.final_state)
    assert abs(float(w1) - float(w0)) <= 1e-6 * float(w0)
    assert abs(float(s1) - float(s0)) <= 1e-6 * float(s0)


def test_estimate_error_matches():
    rj, rt = _run_both("er", predicate="delta")
    assert rt.estimate_error == rj.estimate_error


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tx.run_simulation(tx.build_topology("line", 20),
                          tx.RunConfig(device="cuda"))


def _default_device_calls():
    """Each entry point that places tensors, called without ``device``;
    each returns one of the tensors it placed."""
    from gossipprotocol_tpu_torch import convert
    from gossipprotocol_tpu_torch.ops import pallasdelivery as tpd
    from gossipprotocol_tpu_torch.ops.sharddelivery import (
        build_shard_push_deliveries,
    )
    from gossipprotocol_tpu_torch.parallel import (
        make_mesh, run_simulation_sharded,
    )

    topo = tx.build_topology("line", 20)
    n, nu, m_pairs, classes, pre, out, degree = \
        tpd.build_pallas_delivery_np(topo)
    st = jax.device_get(jax_init(20))
    return {
        "pushsum_init": lambda: torch_init(20).s,
        "build_gather_plan": lambda: tpd.build_gather_plan(
            np.arange(10), 10).idx,
        "build_pallas_delivery": lambda: torch_build_delivery(topo).degree,
        "state_from_numpy": lambda: convert.state_from_numpy(
            *[np.asarray(getattr(st, f)) for f in _FIELDS + ("round",)]).w,
        "gather_plan_from_numpy": lambda: convert.gather_plan_from_numpy(
            *pre).idx,
        "delivery_from_numpy": lambda: convert.delivery_from_numpy(
            n, nu, m_pairs, classes, pre, out, degree).degree,
        "make_mesh": lambda: torch.zeros(1, device=make_mesh(2)[0]),
        "shard_push_from_numpy": lambda: convert.shard_push_from_numpy(
            build_shard_push_deliveries(topo, 20, 2,
                                        build_workers=1)).degree,
        "run_simulation_sharded": lambda: run_simulation_sharded(
            topo, tx.RunConfig(max_rounds=1, plan_cache="none",
                               **_DIFFUSION),
            num_devices=2).final_state.s,
    }


@pytest.mark.parametrize("entry", ["pushsum_init", "build_gather_plan",
                                   "build_pallas_delivery",
                                   "state_from_numpy",
                                   "gather_plan_from_numpy",
                                   "delivery_from_numpy", "make_mesh",
                                   "shard_push_from_numpy",
                                   "run_simulation_sharded"])
def test_entry_point_defaults_to_cuda(entry):
    """Left without ``device``, an entry point places its tensors on the
    card, and raises where there is none: it never runs on the CPU
    unasked."""
    call = _default_device_calls()[entry]
    if torch.cuda.is_available():
        assert call().is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


@pytest.mark.parametrize("kw", [dict(delivery="routed",
                                     routed_design="pull"),
                                dict(fanout="one", delivery="invert"),
                                dict(delivery="scatter")])
def test_unported_config_raises(kw):
    """The pull design is refused by the config; fanout-one push-sum and
    the fanout-all scatter run on one card and are refused by the sharded
    engine."""
    from gossipprotocol_tpu_torch.parallel import run_simulation_sharded

    with pytest.raises(NotPortedError):
        cfg = dataclasses.replace(tx.RunConfig(device="cpu", **_DIFFUSION),
                                  **kw)
        run_simulation_sharded(tx.build_topology("imp3D", 64), cfg,
                               num_devices=2)


# ------------------------------------------------------------------ CLI

_CLI = ["push-sum", "--fanout", "all", "--delivery", "pallas",
        "--device", "cpu"]


def test_cli_converges(capsys):
    rc = torch_main(["216", "imp3D", *_CLI, "--predicate", "global"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Push Sum Starts" in out
    assert "Convergence Time: " in out and " ms" in out
    assert "converged: True" in out
    assert "push-sum max |s/w - mean|" in out


def test_cli_not_converged_exit_1(capsys):
    rc = torch_main(["216", "imp3D", *_CLI, "--max-rounds", "2"])
    assert rc == 1
    assert "converged: False" in capsys.readouterr().out


@pytest.mark.parametrize("argv,needle", [
    (["64", "imp3D", "push-sum", "--fanout", "all", "--delivery",
      "megakernel", "--device", "cpu", "--devices", "2"], "--devices"),
    (["64", "imp3D", "gossip", "--semantics", "reference", "--devices",
      "2", "--device", "cpu"], "gossip"),
    (["64", "imp3D", "push-sum", "--fanout", "one", "--delivery", "scatter",
      "--device", "cpu", "--devices", "2"], "--fanout one"),
    (["64", "imp3D", "push-sum", "--fanout", "all", "--delivery", "scatter",
      "--device", "cpu", "--devices", "2"], "--delivery scatter"),
    (["64", "imp3D", *_CLI, "--fail-fraction=1.5"], "--fail-fraction"),
    (["serve", "/tmp/x"], "serve"),
    (["64", "torus", *_CLI], "unknown topology"),
    (["64", "full", *_CLI], "complete graph"),
    (["64", "imp3D", "wiretap", "--device", "cpu"], "option invalid"),
    (["64", "line", "gossip", "--repair", "prune", "--semantics",
      "reference", "--device", "cpu"], "repair applies to faulted runs"),
])
def test_cli_exit_2(argv, needle, capsys):
    assert torch_main(argv) == 2
    assert needle in capsys.readouterr().err


def test_cli_cuda_without_card_exit_2(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = torch_main(["64", "imp3D", "push-sum", "--fanout", "all",
                     "--delivery", "pallas"])
    assert rc == 2
    assert "cuda" in capsys.readouterr().err
