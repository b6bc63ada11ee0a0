"""PyTorch port, gossip (protocols/gossip.py and the engine's gossip
branch): the integer state and the counter-based draws make every round
bitwise the JAX package's. Held here: the inversion tables, the
gather-inverted histogram against the scatter's, 40-round trajectories
against ``gossip_round`` on six graph families (keep-alive on and off,
birth exclusions), the engine's per-chunk choice of the inverted branch
against the JAX engine's per-round ``lax.cond``, the stall stop, the
golden round counts, and the reference surface of the CLI."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.engine import driver as jdriver
from gossipprotocol_tpu.protocols import gossip as jg
from gossipprotocol_tpu.protocols.state import gossip_init as jax_gossip_init

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.convert import (
    gossip_state_from_numpy, neighbors_from_numpy,
)
from gossipprotocol_tpu_torch.engine import driver as tdriver
from gossipprotocol_tpu_torch.protocols import gossip as tg
from gossipprotocol_tpu_torch.protocols import sampling as ts
from gossipprotocol_tpu_torch.protocols.state import gossip_init


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


# (topology, n, builder kwargs): the four reference topologies, the
# Erdős–Rényi graph with birth exclusions (isolated nodes and small
# components: the masked round) and a power-law graph (CSR branch)
_GRAPHS = {
    "line": ("line", 200, {}),
    "full": ("full", 300, {}),
    "3D": ("3D", 343, {}),
    "imp3D": ("imp3D", 512, {"seed": 2}),
    "er": ("erdos_renyi", 700, {"seed": 5, "avg_degree": 3.0}),
    "powerlaw": ("power_law", 400, {"seed": 3}),
}
_FIELDS = ("counts", "converged", "alive")


def _topos(graph):
    name, n, kw = _GRAPHS[graph]
    return jx.build_topology(name, n, **kw), tx.build_topology(name, n, **kw)


def _assert_states_equal(tstate, jstate, where=""):
    for f in _FIELDS:
        a, b = getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), (f, where)
    assert int(tstate.round) == int(np.asarray(jstate.round)), where


def _carry(jstate):
    return gossip_state_from_numpy(
        *[np.asarray(getattr(jstate, f)) for f in _FIELDS + ("round",)],
        device="cpu")


@pytest.mark.parametrize("graph", ["line", "3D", "imp3D", "er"])
def test_reverse_slot_table_byte_equal(graph):
    tj, tt = _topos(graph)
    a = tg.reverse_slot_table(tt)
    b, _deg_nbr = jg.reverse_slot_table(tj)
    assert a.dtype == b.dtype == np.int8
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("graph", ["line", "3D", "imp3D"])
def test_hits_by_inversion_equals_scatter_when_saturated(graph):
    """Every node has heard (and keep-alive holds): the receiver-side
    histogram is the scatter's, and the JAX package's, round after
    round."""
    tj, tt = _topos(graph)
    nt = tg.inverted_dense(tt, device="cpu")
    nj = jg.inverted_dense(tj)
    n = tt.num_nodes
    state = gossip_init(n, 0, device="cpu")
    state = state._replace(counts=torch.ones(n, dtype=torch.int32))
    assert bool(tg.inversion_legal(state, nt, keep_alive=True,
                                   all_alive=True))
    base = ts.key_data(5, device="cpu")
    for r in range(6):
        key = ts.fold_in(base, r)
        targets, valid = ts.sample_neighbors(nt, n, key)
        scatter = torch.zeros(n, dtype=torch.int32).index_add_(
            0, targets, valid.to(torch.int32))
        inv = tg.hits_by_inversion(nt, key)
        assert torch.equal(inv, scatter)
        want = np.asarray(jg.hits_by_inversion(
            nj, jax.random.fold_in(jax.random.key(5), r)))
        assert np.array_equal(inv.numpy(), want)


def _jax_setup(graph, seed, keep_alive):
    tj, tt = _topos(graph)
    cfg_j = jx.RunConfig(algorithm="gossip", seed=seed,
                         keep_alive=keep_alive)
    state_j, core_j, _, _, _ = jdriver.build_protocol(tj, cfg_j)
    nbrs_j = jdriver.device_arrays(tj, cfg_j)
    return tj, tt, state_j, core_j, nbrs_j


@pytest.mark.parametrize("keep_alive", [True, False],
                         ids=["keep_alive", "no_keep_alive"])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_trajectory_bitwise_40_rounds(graph, seed, keep_alive):
    """40 rounds of the port's round against the JAX package's, state
    compared after every round. The port takes the inverted branch
    exactly on the rounds where it is legal (read on the host here); the
    JAX round picks it with its on-device ``lax.cond``."""
    tj, tt, state_j, core_j, nbrs_j = _jax_setup(graph, seed, keep_alive)
    cfg_t = tx.RunConfig(algorithm="gossip", seed=seed,
                         keep_alive=keep_alive, device="cpu")
    state_t, core_t, _, _ = tdriver.build_protocol(tt, cfg_t)
    nbrs_t = tdriver.device_arrays(tt, cfg_t)
    _assert_states_equal(state_t, state_j, "init")
    base_j = jax.random.key(seed)
    base_t = ts.key_data(seed, device="cpu")
    taken = 0
    for r in range(40):
        legal = core_t.invertible and bool(tg.inversion_legal(
            state_t, nbrs_t, keep_alive=keep_alive,
            all_alive=core_t.opts["all_alive"]))
        core_t.inverted = legal
        taken += legal
        state_t = core_t(state_t, nbrs_t, ts.fold_in(base_t, state_t.round))
        state_j = core_j(state_j, nbrs_j, base_j)
        _assert_states_equal(state_t, state_j, f"round {r + 1}")
    if graph in ("3D", "imp3D") and keep_alive:
        assert taken > 0        # the inverted branch ran


@pytest.mark.parametrize("keep_alive", [True, False],
                         ids=["keep_alive", "no_keep_alive"])
@pytest.mark.parametrize("graph", ["3D", "imp3D", "er", "line"])
def test_engine_branch_rule_matches_jax_run(graph, keep_alive):
    """The engine's rule (the inverted branch for a whole chunk when the
    chunk starts legal under keep-alive, never without it) against the
    JAX engine's per-round choice: same rounds, same final state, also
    for a run that stalls."""
    tj, tt = _topos(graph)
    base = dict(algorithm="gossip", seed=3, keep_alive=keep_alive,
                chunk_rounds=8, max_rounds=160)
    rj = jx.run_simulation(tj, jx.RunConfig(**base))
    rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", **base))
    assert rt.rounds == rj.rounds
    assert rt.converged == rj.converged
    _assert_states_equal(rt.final_state, rj.final_state)


def test_inverted_chunks_are_taken_and_exact():
    """From a saturated start every chunk takes the inverted branch; the
    run equals the JAX run from the same state."""
    tj, tt = _topos("imp3D")
    start_j = jax_gossip_init(tj.num_nodes, 0)._replace(
        counts=jax.numpy.ones(tj.num_nodes, jax.numpy.int32))
    base = dict(algorithm="gossip", seed=1, chunk_rounds=4, max_rounds=12)
    rj = jx.run_simulation(tj, jx.RunConfig(**base), initial_state=start_j)
    seen = []
    orig = tdriver.GossipCore.__call__

    def spy(self, state, nbrs, key):
        seen.append(self.inverted)
        return orig(self, state, nbrs, key)

    tdriver.GossipCore.__call__ = spy
    try:
        rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", **base),
                               initial_state=_carry(start_j))
    finally:
        tdriver.GossipCore.__call__ = orig
    assert rt.rounds == rj.rounds
    _assert_states_equal(rt.final_state, rj.final_state)
    assert seen and all(seen[1:])   # all but the warm-up round


def test_stall_stops_like_jax():
    """``keep_alive=False`` with threshold 2 on a line: every node that
    heard converges and falls silent before the rumor reaches the ends, no
    spreader is left, and both engines stop at the chunk that finds it,
    unconverged."""
    tj, tt = _topos("line")
    base = dict(algorithm="gossip", seed=0, keep_alive=False, threshold=2,
                chunk_rounds=16, max_rounds=100_000)
    rj = jx.run_simulation(tj, jx.RunConfig(**base))
    rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", **base))
    assert not rj.converged and not rt.converged
    assert rt.rounds == rj.rounds < 100_000
    _assert_states_equal(rt.final_state, rj.final_state)
    assert int(tdriver.gossip_spreading_count(rt.final_state, False)) == 0


@pytest.mark.parametrize("seed", [0, 5, 42])
def test_pick_seed_node_matches(seed):
    tj, tt = _topos("er")
    alive = tt.birth_alive()
    assert alive is not None
    for n in (700, 1000):
        assert tdriver.pick_seed_node(n, seed, alive=None) == \
            jdriver.pick_seed_node(n, seed, alive=None)
    assert tdriver.pick_seed_node(700, seed, alive=alive) == \
        jdriver.pick_seed_node(700, seed, alive=tj.birth_alive())


def test_inversion_enabled_matches():
    for graph in _GRAPHS:
        tj, tt = _topos(graph)
        for ka in (True, False):
            cj = jx.RunConfig(algorithm="gossip", keep_alive=ka)
            ct = tx.RunConfig(algorithm="gossip", keep_alive=ka,
                              device="cpu")
            assert tdriver.gossip_inversion_enabled(tt, ct) == \
                jdriver.gossip_inversion_enabled(tj, cj)
            assert tdriver.effective_keep_alive(tt, ct) == \
                jdriver.effective_keep_alive(tj, cj)


def test_card_runs_the_scatter_branch():
    """On the card the engine carries no inversion table (the inverted
    branch did not pay there end to end); the CPU follows the JAX rule."""
    for graph in ("imp3D", "3D", "er"):
        _, tt = _topos(graph)
        cpu = tx.RunConfig(algorithm="gossip", device="cpu")
        card = dataclasses.replace(cpu, device="cuda")
        assert tdriver.gossip_inversion_enabled(tt, cpu)
        assert not tdriver.gossip_inversion_enabled(tt, card)


def test_carried_neighbors_run_the_same_round():
    tj, tt = _topos("imp3D")
    nj = jg.inverted_dense(tj)
    nt = neighbors_from_numpy(
        **{f: np.asarray(getattr(nj, f)) for f in ts.InvertedDense._fields},
        device="cpu")
    assert isinstance(nt, ts.InvertedDense)
    sj = jax_gossip_init(tj.num_nodes, 3)
    st = _carry(sj)
    for _ in range(5):
        sj = jg.gossip_round(sj, nj, jax.random.key(2), n=tj.num_nodes,
                             all_alive=True, inverted=True)
        st = tg.gossip_round(st, nt, ts.key_data(2, "cpu"), n=tt.num_nodes,
                             all_alive=True)
        _assert_states_equal(st, sj)


# copied from tests/test_golden.py (GOLDEN_GOSSIP: exact on every backend)
GOLDEN_GOSSIP = {
    ("line", 64): 113,
    ("full", 128): 28,
    ("3D", 64): 29,
    ("imp3D", 64): 25,
    ("erdos_renyi", 128): 49,
    ("power_law", 128): 575,
}


@pytest.mark.parametrize("key", sorted(GOLDEN_GOSSIP),
                         ids=lambda k: f"{k[0]}-{k[1]}")
def test_golden_gossip_rounds(key):
    name, n = key
    res = tx.run_simulation(tx.build_topology(name, n, seed=11),
                            tx.RunConfig(algorithm="gossip", seed=42,
                                         device="cpu"))
    assert res.converged
    assert res.rounds == GOLDEN_GOSSIP[key]
    assert res.estimate_error is None


def test_config_resolves_the_reference_surface():
    """The defaults are the JAX package's: gossip, fanout one, scatter."""
    fields = ("algorithm", "fanout", "delivery", "threshold", "keep_alive",
              "semantics", "seed", "predicate", "value_mode")
    want = tuple(getattr(jx.RunConfig(), f) for f in fields)
    assert want[:3] == ("gossip", "one", "scatter")
    assert tuple(getattr(tx.RunConfig(device="cpu"), f)
                 for f in fields) == want
    cfg = tx.RunConfig(algorithm="push-sum", device="cpu")
    assert (cfg.fanout, cfg.delivery) == ("one", "scatter")
    with pytest.raises(ValueError, match="fanout-all"):
        tx.RunConfig(algorithm="gossip", delivery="pallas", device="cpu")


@pytest.mark.parametrize("entry", ["gossip_init", "device_topology",
                                   "inverted_dense", "key_data",
                                   "gossip_state_from_numpy",
                                   "neighbors_from_numpy"])
def test_entry_point_defaults_to_cuda(entry):
    topo = tx.build_topology("line", 20)
    calls = {
        "gossip_init": lambda: gossip_init(20, 0).counts,
        "device_topology": lambda: ts.device_topology(topo).degree,
        "inverted_dense": lambda: tg.inverted_dense(topo).rev,
        "key_data": lambda: ts.key_data(0),
        "gossip_state_from_numpy": lambda: gossip_state_from_numpy(
            np.zeros(4, np.int32), np.zeros(4, bool), np.ones(4, bool),
            0).counts,
        "neighbors_from_numpy": lambda: neighbors_from_numpy(
            table=np.zeros((2, 1), np.int32), degree=np.ones(2)).table,
    }
    if torch.cuda.is_available():
        assert calls[entry]().is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            calls[entry]()


# ------------------------------------------------------------------ CLI

def test_cli_lines_match_jax_cli(capsys):
    from gossipprotocol_tpu.cli import main as jax_main

    argv = ["216", "imp3D", "gossip", "--seed", "4"]
    assert jax_main(argv + ["--compile-cache", ""]) == 0
    jout = capsys.readouterr().out.splitlines()
    assert torch_main(argv + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out.splitlines()
    assert tout[0] == jout[0] == "Gossip Starts"
    assert tout[1].startswith("Convergence Time: ")
    assert tout[1].endswith(" ms") and jout[1].startswith("Convergence Time: ")
    jr = [w for w in jout[2].split() if w.isdigit()][0]
    assert tout[2].startswith(f"rounds: {jr} ")


@pytest.mark.parametrize("argv,banner", [
    (["1000", "3D", "gossip"], "Gossip Starts"),
    (["300", "full", "gossip", "--threshold", "3", "--seed-node", "5"],
     "Gossip Starts"),
    (["1000", "imp3D", "push-sum"], "Push Sum Starts"),
    (["300", "full", "push-sum", "--predicate", "global", "--value-mode",
      "index", "--tol", "0.01"], "Push Sum Starts"),
])
def test_cli_reference_surface_exit_0(argv, banner, capsys):
    assert torch_main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(banner + "\n")
    assert "Convergence Time: " in out and "converged: True" in out
    assert ("push-sum max |s/w - mean|" in out) == (banner != "Gossip Starts")


def test_cli_stall_exit_1(capsys):
    rc = torch_main(["200", "line", "gossip", "--no-keep-alive",
                     "--threshold", "2", "--device", "cpu"])
    assert rc == 1
    assert "converged: False" in capsys.readouterr().out


@pytest.mark.parametrize("argv,needle", [
    (["64", "imp3D", "push-sum", "--semantics", "reference", "--predicate",
      "global"], "semantics='reference'"),
    (["64", "imp3D", "push-sum", "--delivery", "invert", "--devices", "2"],
     "delivery='invert' is single-chip only"),
    (["64", "imp3D", "push-sum", "--fanout", "all", "--delivery", "scatter",
      "--devices", "2"], "--delivery scatter"),
    (["64", "imp3D", "gossip", "--devices", "2"], "--devices"),
    (["64", "imp3D", "gossip", "--clock", "poisson", "--devices", "2"],
     "--clock"),
    (["64", "imp3D", "gossip", "--drop-prob", "1.5"], "--drop-prob"),
    (["64", "imp3D", "gossip", "--fail-fraction", "0.1", "--devices", "2"],
     "--fail-fraction"),
    (["64", "imp3D", "push-sum", "--x64", "--devices", "2"], "--x64"),
    (["64", "imp3D", "gossip", "--compile-cache", "c"], "--compile-cache"),
    (["64", "imp3D", "gossip", "--checkpoint-dir", "ck", "--devices", "2"],
     "--checkpoint-dir"),
    (["64", "imp3D", "gossip", "--build", "streamed"], "--build"),
    (["64", "imp3D", "gossip", "--request-id", "r1"], "--request-id"),
    (["64", "imp3D", "gossip", "--sweep-seeds", "2", "--devices", "2"],
     "--devices"),
    (["64", "imp3D", "push-sum", "--payload-dim", "4", "--devices", "2"],
     "--payload-dim"),
    (["64", "imp3D", "gossip", "--delivery", "pallas"], "fanout-all"),
    (["64", "imp3D", "gossip", "--seed-node", "64"], "--seed-node"),
    (["64", "imp3D", "gossip", "--threshold", "0"], "threshold"),
])
def test_cli_exit_2_names_itself(argv, needle, capsys):
    assert torch_main(argv + ["--device", "cpu"]) == 2
    assert needle in capsys.readouterr().err
