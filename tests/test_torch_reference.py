"""PyTorch port, the reference semantics (``--semantics reference``)
against the JAX package on the CPU: the quirk builders byte for byte,
the scalar ``jax.random.randint`` bit for bit under both
``jax_threefry_partitionable`` settings, the single-token push-sum walk
hop by hop and to convergence, reference gossip (threshold + 1, the
quorum supervisor, keep-alive off on the full topology), and the CLI's
lines and exit codes for the reference argv and each rejected
combination."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.cli import main as jax_main
from gossipprotocol_tpu.engine import driver as jdriver
from gossipprotocol_tpu.protocols import sampling as js
from gossipprotocol_tpu.protocols import walk as jw
from gossipprotocol_tpu.topology import builders as jb

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.convert import (
    neighbors_from_numpy, walk_state_from_numpy,
)
from gossipprotocol_tpu_torch.engine import driver as tdriver
from gossipprotocol_tpu_torch.protocols import sampling as ts
from gossipprotocol_tpu_torch.protocols import walk as tw
from gossipprotocol_tpu_torch.topology import builders as tb


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


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_states_equal(tstate, jstate, where=""):
    assert tstate._fields == jstate._fields
    for f in tstate._fields:
        a, b = getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f))
        assert a.dtype == b.dtype, (f, where)
        assert np.array_equal(_bits(a), _bits(b)), (f, where)


# ---- the quirk builders -----------------------------------------------------

def _topos_equal(t, j):
    assert (t.kind, t.num_nodes, t.asymmetric, t.implicit_full) == (
        j.kind, j.num_nodes, j.asymmetric, j.implicit_full)
    for f in ("offsets", "indices"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    ta, ja = t.birth_alive(), j.birth_alive()
    assert (ta is None) == (ja is None)
    if ta is not None:
        assert np.array_equal(ta, ja)


@pytest.mark.parametrize("n,seed", [(8, 0), (27, 3), (100, 1), (1000, 7),
                                    (4096, 11)])
def test_imp3d_reference_quirks_byte_equal(n, seed):
    _topos_equal(tb.build_imp3d_reference_quirks(n, seed=seed),
                 jb.build_imp3d_reference_quirks(n, seed=seed))


@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("base", ["3D", "imp3D_quirks", "line", "er"])
def test_add_isolated_rows_byte_equal(base, count):
    def make(builders, registry):
        if base == "3D":
            return builders.build_grid3d(100)
        if base == "imp3D_quirks":
            return builders.build_imp3d_reference_quirks(64, seed=2)
        if base == "line":
            return builders.build_line(30)
        return registry("erdos_renyi", 200, seed=5, avg_degree=2.0)

    t = tb.add_isolated_rows(make(tb, tx.build_topology), count)
    j = jb.add_isolated_rows(make(jb, jx.build_topology), count)
    _topos_equal(t, j)
    assert not t.birth_alive()[-count:].any()


def test_add_isolated_rows_refuses_implicit_full():
    with pytest.raises(ValueError, match="explicit"):
        tb.add_isolated_rows(tb.build_full(10))


# ---- the scalar randint ------------------------------------------------------

@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def partitionable(request):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


_SPANS = [1, 2, 3, 7, 100, 255, 65_535, 65_536, 65_537, 100_000, 999_999,
          2**24 + 1, 2**31 - 1, 0, -5]


def test_randint_bitwise_under_either_setting(partitionable):
    """Many round keys (``fold_in`` of several seeds) times spans that
    hit the multiplier's uint32 wrap (span above 2**16) and the
    ``maxval <= minval`` rule; the port's draws come out of one
    vectorized pass."""
    rounds = jnp.arange(0, 600, 11)
    for seed in (0, 1, 42, 2**31 - 1):
        keys = jax.vmap(lambda r, s=seed: jax.random.fold_in(
            jax.random.key(s), r))(rounds)
        kd = torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(
            np.int64))
        for span in _SPANS:
            want = np.asarray(jax.vmap(
                lambda k, m=span: jax.random.randint(k, (), 0, m))(keys))
            got = ts.randint(kd, span, partitionable).numpy()
            assert got.dtype == np.int32
            assert np.array_equal(got, want), (seed, span)


def test_randint_per_key_spans(partitionable):
    """A tensor ``maxval`` broadcast against the keys (the walk draws
    under its holder's degree)."""
    rng = np.random.default_rng(5)
    spans = rng.integers(1, 5000, 64).astype(np.int32)
    keys = jax.vmap(lambda r: jax.random.fold_in(jax.random.key(9), r))(
        jnp.arange(64))
    want = np.asarray(jax.vmap(lambda k, m: jax.random.randint(k, (), 0, m))(
        keys, jnp.asarray(spans)))
    kd = torch.from_numpy(np.asarray(jax.random.key_data(keys)).astype(
        np.int64))
    got = ts.randint(kd, torch.from_numpy(spans), partitionable).numpy()
    assert np.array_equal(got, want)


def test_split_bitwise_under_either_setting(partitionable):
    key = jax.random.fold_in(jax.random.key(3), 17)
    want = np.asarray(jax.random.key_data(jax.random.split(key)))
    kd = torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(
        np.int64))
    assert np.array_equal(ts.split2(kd, partitionable).numpy(),
                          want.astype(np.int64))


# ---- the walk, hop by hop ------------------------------------------------------

# (name, builder): graphs of 50-200 nodes covering every branch of the
# draw — the implicit complete graph, the dense table (line; the imp3D
# quirk graph with its self/duplicate entries and isolated row) and CSR
_WALK_GRAPHS = {
    "full": lambda b: b.build_full(50),
    "line": lambda b: b.build_line(60),
    "imp3D": lambda b: b.add_isolated_rows(
        b.build_imp3d_reference_quirks(125, seed=4)),
    "power_law": lambda b: b.build_power_law(150, seed=2),
}


def _pair(graph):
    return _WALK_GRAPHS[graph](tb), _WALK_GRAPHS[graph](jb)


def _port_nbrs(jnbrs):
    if jnbrs is None:
        return None
    if isinstance(jnbrs, js.CSRNeighbors):
        return neighbors_from_numpy(
            degree=np.asarray(jnbrs.degree), starts=np.asarray(jnbrs.starts),
            indices=np.asarray(jnbrs.indices), device="cpu")
    return neighbors_from_numpy(degree=np.asarray(jnbrs.degree),
                                table=np.asarray(jnbrs.table), device="cpu")


@pytest.mark.parametrize("graph", list(_WALK_GRAPHS))
def test_walk_trajectory_bitwise_200_hops(graph):
    ttopo, jtopo = _pair(graph)
    n = jtopo.num_nodes
    start = jdriver.pick_seed_node(n, 3, alive=jtopo.birth_alive())
    jnbrs = js.device_topology(jtopo)
    tnbrs = _port_nbrs(jnbrs)
    if jnbrs is not None and graph == "power_law":
        assert isinstance(tnbrs, ts.CSRNeighbors)
    base = jax.random.key(3)
    jst = jw.pushsum_walk_init(n, start)
    tst = tw.pushsum_walk_init(n, start, device="cpu")
    _assert_states_equal(tst, jst, "init")
    kd = ts.key_data(3, "cpu")
    for hop in range(200):
        jst = jw.pushsum_walk_round(jst, jnbrs, base, n=n, streak_target=3)
        tst = tw.pushsum_walk_round(tst, tnbrs, kd, n=n, streak_target=3)
        _assert_states_equal(tst, jst, f"hop {hop}")
    # the engine's chunk runner lands on the JAX engine's state after 200
    # hops (the engines also mark birth-excluded rows not alive)
    cfg = dict(algorithm="push-sum", semantics="reference", seed=3,
               max_rounds=200, chunk_rounds=64)
    run = tx.run_simulation(ttopo, tx.RunConfig(**cfg, device="cpu"))
    jrun = jx.run_simulation(jtopo, jx.RunConfig(**cfg))
    _assert_states_equal(run.final_state, jrun.final_state,
                         "engine, 200 hops")
    _assert_states_equal(run.final_state._replace(alive=tst.alive), jst,
                         "engine against the hops")


@pytest.mark.parametrize("graph", list(_WALK_GRAPHS))
def test_walk_to_convergence_equals_jax(graph):
    ttopo, jtopo = _pair(graph)
    cfg = dict(algorithm="push-sum", semantics="reference", seed=1)
    rj = jx.run_simulation(jtopo, jx.RunConfig(**cfg))
    rt = tx.run_simulation(ttopo, tx.RunConfig(**cfg, device="cpu"))
    assert rj.converged and rt.converged
    assert rt.rounds == int(rj.rounds)
    assert rt.rounds_executed >= rt.rounds
    _assert_states_equal(rt.final_state, rj.final_state)
    assert rt.estimate_error == pytest.approx(rj.estimate_error, abs=0)


def _hand_state(n, cur, **over):
    st = jw.pushsum_walk_init(n, cur)
    return st._replace(**{k: jnp.asarray(v) for k, v in over.items()})


def _carry(jst):
    return walk_state_from_numpy(*[np.asarray(x) for x in jst],
                                 device="cpu")


@pytest.mark.parametrize("case", ["halve_forward", "converge", "relay",
                                  "trapped"])
def test_walk_hop_rules(case):
    """One hop on a 3-node graph where the draw is forced: node 0's only
    neighbour is 1; node 2 has none (a trapped token)."""
    jtopo = jx.topology.base.Topology(
        kind="line", num_nodes=3, offsets=np.array([0, 1, 2, 2], np.int32),
        indices=np.array([1, 0], np.int32))
    jnbrs = js.device_topology(jtopo)
    tnbrs = _port_nbrs(jnbrs)
    cur = 2 if case == "trapped" else 0
    over = {}
    if case == "converge":
        over["streak"] = np.array([1, 2, 1], np.int32)
    if case == "relay":
        over["converged"] = np.array([False, True, False])
    jst = _hand_state(3, cur, **over)
    tst = _carry(jst)
    base = jax.random.key(0)
    jnext = jw.pushsum_walk_round(jst, jnbrs, base, n=3, streak_target=3)
    tnext = tw.pushsum_walk_round(tst, tnbrs, ts.key_data(0, "cpu"), n=3,
                                  streak_target=3)
    _assert_states_equal(tnext, jnext, case)
    s0, w0 = tst.s.clone(), tst.w.clone()
    assert int(tnext.round) == 1
    if case == "trapped":
        assert int(tnext.cur) == 2
        for f in ("s", "w", "ratio", "streak", "converged", "msg_s",
                  "msg_w"):
            assert torch.equal(getattr(tnext, f), getattr(tst, f)), f
        return
    assert int(tnext.cur) == 1
    if case == "relay":
        assert torch.equal(tnext.s, s0) and torch.equal(tnext.w, w0)
        assert float(tnext.msg_s) == float(tst.msg_s)
        return
    half = (s0[1] + tst.msg_s) * 0.5
    assert float(tnext.s[1]) == float(half) == float(tnext.msg_s)
    assert bool(tnext.converged[1]) == (case == "converge")
    assert int(tnext.streak[1]) == (3 if case == "converge" else 2)


def test_walk_trapped_run_equals_jax():
    """A run whose token starts on an edge-less row never moves: every
    hop changes nothing but the hop count, in both engines."""
    jtopo = jb.add_isolated_rows(jb.build_line(20))
    ttopo = tb.add_isolated_rows(tb.build_line(20))
    jst = jw.pushsum_walk_init(21, 20)
    cfg = dict(algorithm="push-sum", semantics="reference", max_rounds=40)
    rj = jx.run_simulation(jtopo, jx.RunConfig(**cfg), initial_state=jst)
    rt = tx.run_simulation(ttopo, tx.RunConfig(**cfg, device="cpu"),
                           initial_state=_carry(jst))
    assert not rt.converged and rt.rounds == int(rj.rounds) == 40
    _assert_states_equal(rt.final_state, rj.final_state)


def test_walk_refuses_a_trapped_seed_node():
    topo = tb.add_isolated_rows(tb.build_line(20))
    with pytest.raises(ValueError, match="trapped"):
        tx.run_simulation(topo, tx.RunConfig(
            algorithm="push-sum", semantics="reference", seed_node=20,
            device="cpu"))


# ---- reference gossip, the quorum, keep-alive --------------------------------

def _ref_population(b, name, n):
    """The CLI's reference population: ``(topology, alert_quorum)``."""
    if name in ("line", "full"):
        return getattr(b, f"build_{name}")(n + 1), n
    if name == "imp3D":
        return b.add_isolated_rows(
            b.build_imp3d_reference_quirks(n, seed=0)), None
    return b.add_isolated_rows(b.build_grid3d(n)), None


@pytest.mark.parametrize("name,n", [("line", 64), ("full", 128),
                                    ("3D", 64), ("imp3D", 100),
                                    ("imp3D", 343)])
def test_reference_gossip_equals_jax(name, n):
    jtopo, q = _ref_population(jb, name, n)
    ttopo, _ = _ref_population(tb, name, n)
    cfg = dict(algorithm="gossip", semantics="reference", seed=7,
               alert_quorum=q)
    rj = jx.run_simulation(jtopo, jx.RunConfig(**cfg))
    rt = tx.run_simulation(ttopo, tx.RunConfig(**cfg, device="cpu"))
    assert rj.converged and rt.converged
    assert rt.rounds == int(rj.rounds)
    _assert_states_equal(rt.final_state, rj.final_state)


def test_reference_gossip_hears_eleven_times():
    """Threshold + 1: every converged node heard the rumor 11 times."""
    topo = tb.build_grid3d(27)
    rt = tx.run_simulation(topo, tx.RunConfig(
        algorithm="gossip", semantics="reference", device="cpu"))
    st = rt.final_state
    assert rt.converged and int(st.counts[st.converged].min()) >= 11
    ri = tx.run_simulation(topo, tx.RunConfig(algorithm="gossip",
                                              device="cpu"))
    assert ri.rounds < rt.rounds


def test_quorum_stops_one_short():
    """Line of N+1 with quorum N: the run stops as soon as N rows are
    settled — earlier than waiting for all N+1 — in both engines."""
    jtopo, q = _ref_population(jb, "line", 40)
    ttopo, _ = _ref_population(tb, "line", 40)
    base = dict(algorithm="gossip", semantics="reference", seed=2)
    rq = tx.run_simulation(ttopo, tx.RunConfig(**base, alert_quorum=q,
                                               device="cpu"))
    rj = jx.run_simulation(jtopo, jx.RunConfig(**base, alert_quorum=q))
    rall = tx.run_simulation(ttopo, tx.RunConfig(**base, device="cpu"))
    settled = int(rq.final_state.converged.sum())
    assert rq.converged and q <= settled <= q + 1
    assert rq.rounds == int(rj.rounds) <= rall.rounds
    before = tx.run_simulation(ttopo, tx.RunConfig(
        **base, alert_quorum=q, max_rounds=rq.rounds - 1, device="cpu"))
    assert not before.converged
    assert int(before.final_state.converged.sum()) < q


@pytest.mark.parametrize("name", ["full", "line", "3D", "imp3D"])
@pytest.mark.parametrize("semantics", ["intended", "reference"])
def test_keep_alive_rule_equals_jax(name, semantics):
    """Reference mode turns keep-alive off on the full topology only."""
    topo = tx.build_topology(name, 27)
    jtopo = jx.build_topology(name, 27)
    cfg = dict(algorithm="gossip", semantics=semantics)
    want = jdriver.effective_keep_alive(jtopo, jx.RunConfig(**cfg))
    assert tdriver.effective_keep_alive(
        topo, tx.RunConfig(**cfg, device="cpu")) == want
    assert want == (not (semantics == "reference" and name == "full"))


@pytest.mark.parametrize("kw,match", [
    (dict(algorithm="push-sum", predicate="global"), "predicate='global'"),
    (dict(algorithm="push-sum", fanout="all", delivery="pallas"),
     "fanout='all'"),
    (dict(algorithm="push-sum", delivery="invert"), "single-token walk"),
    (dict(alert_quorum=0), "alert_quorum"),
])
def test_reference_config_rejections(kw, match):
    with pytest.raises(ValueError, match=re.escape(match)):
        tx.RunConfig(semantics="reference", device="cpu", **kw)


# ---- the CLI ------------------------------------------------------------------

_CLI_RUNS = [
    ["100", "line", "gossip"], ["100", "full", "gossip"],
    ["100", "3D", "gossip"], ["100", "imp3D", "gossip"],
    ["30", "line", "push-sum"], ["50", "full", "push-sum"],
    ["64", "3D", "push-sum"], ["100", "imp3D", "push-sum"],
]


def _masked(text):
    """Lines with the convergence time masked; the rounds line reduced to
    its round count, converged flag and node count (the two CLIs print
    different engine details after them)."""
    out = []
    for line in text.splitlines():
        if line.startswith("Convergence Time: "):
            line = re.sub(r"[0-9.]+ ms", "<t> ms", line)
        elif line.startswith("rounds: "):
            m = re.match(r"rounds: (\d+) .*converged: (\w+)\s+nodes: (\d+)",
                         line)
            line = m.groups()
        out.append(line)
    return out


@pytest.mark.parametrize("argv", _CLI_RUNS, ids=" ".join)
def test_cli_reference_lines_equal_jax(argv, capsys):
    argv = argv + ["--semantics", "reference"]
    assert jax_main(argv + ["--compile-cache", ""]) == 0
    jout = capsys.readouterr().out
    assert torch_main(argv + ["--device", "cpu"]) == 0
    tout = capsys.readouterr().out
    assert _masked(tout) == _masked(jout)
    assert tout.splitlines()[0].startswith("note: reference population is")


@pytest.mark.parametrize("argv", [
    ["64", "imp3D", "push-sum", "--predicate", "global"],
    ["64", "imp3D", "push-sum", "--fanout", "all"],
    ["64", "line", "gossip", "--repair", "rewire"],
    ["64", "full", "push-sum", "--repair", "prune"],
    ["64", "imp3D", "push-sum", "--devices", "2"],
    ["64", "full", "push-sum", "--devices", "2"],
], ids=" ".join)
def test_cli_reference_rejections_equal_jax(argv, capsys):
    argv = argv + ["--semantics", "reference"]
    assert jax_main(argv + ["--compile-cache", ""]) == 2
    j = capsys.readouterr()
    assert torch_main(argv + ["--device", "cpu"]) == 2
    t = capsys.readouterr()
    assert t.out == j.out
    assert t.err.strip() == j.err.strip()
