"""PyTorch port, the sharded push-design slice (``--devices S`` with
``--delivery pallas|routed``, ``--exchange-overlap``, ``--payload-wire``):
the per-shard push compiler, the edge-share exchange and the sharded
engine, held against the JAX package on the CPU (inputs made from a seed
with numpy; the port runs every kernel's plain version).

The contract is the JAX package's own: the S-shard trajectory equals the
single-chip routed trajectory bitwise at every S and for every transport
under the f32 wire (``tests/test_pushdelivery.py`` pins it for the JAX
sharded engine), so the engine cases compare the port's sharded run with
the JAX package's single-chip routed run, cached per graph — no
``shard_map`` program is compiled for them. The lossy wires (bf16, int8)
are held bitwise to the JAX package's own 2-shard run. No tolerance is
needed anywhere.

Two guards keep this module from stalling other tests that share its
test worker. Torch's CPU kernels and the routing libraries of both
packages run on one OpenMP thread here (restored afterwards): GNU OpenMP
is not fork-safe once a parallel region has run on several threads, and
the JAX package's shard builds fork their workers, so a later forked
build in this process would wait forever.
The JAX builds here take ``build_workers=1`` for the same reason. And the
port's plans cache in a directory of this module's own, so no build here
waits on another test's single-flight lock of a shared cache entry."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import gossipprotocol_tpu as jx
from gossipprotocol_tpu import native as jnative
from gossipprotocol_tpu.ops import plancache as jpc
from gossipprotocol_tpu.ops import sharddelivery as jsd
from gossipprotocol_tpu.parallel import (
    padded_size as jax_padded_size,
    run_simulation_sharded as jax_run_sharded,
)

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch import native as tnative
from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.convert import (
    shard_push_from_numpy, state_from_numpy,
)
from gossipprotocol_tpu_torch.ops import exec as ex
from gossipprotocol_tpu_torch.ops import pallasdelivery as pdm
from gossipprotocol_tpu_torch.ops import plancache as tpc
from gossipprotocol_tpu_torch.ops import sharddelivery as tsd
from gossipprotocol_tpu_torch.ops.delivery import RoutedConfigError
from gossipprotocol_tpu_torch.parallel import (
    make_mesh, padded_size, placement_line, run_simulation_sharded,
)

# tests/test_pushdelivery.py's grid and its fixed round budget (early
# stop disabled: line mixes in O(n^2) rounds)
_GRAPHS = {
    "line": ("line", 130, {}),
    "imp3D": ("imp3D", 216, {"seed": 4}),
    "powerlaw": ("powerlaw", 400, {"seed": 3, "m": 3}),
}
_BASE = dict(algorithm="push-sum", fanout="all", predicate="global",
             tol=1e-4, seed=11, delivery="routed", chunk_rounds=8,
             max_rounds=24, streak_target=2**30)
# the port builds serially here (build_workers=1): a pool's workers each
# start a fresh interpreter, seconds at these sizes; the pool has its own
# test below
_TORCH_BASE = dict(_BASE, build_workers=1)
_FIELDS = ("s", "w", "ratio", "streak", "converged", "alive")
# a sparse Erdős–Rényi graph: isolated nodes and minority components are
# birth exclusions (the masked round)
_ER = dict(seed=9, avg_degree=2.0)

_jax_runs: dict = {}
_jax_plans: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _one_openmp_thread():
    """This module's OpenMP code (torch's CPU kernels, the routing
    libraries) runs on one thread, restored afterwards (see the module
    docstring)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jnative.set_native_threads(1)
    tnative.set_native_threads(1)
    yield
    torch.set_num_threads(threads)
    jnative.set_native_threads(os.cpu_count() or 1)
    tnative.set_native_threads(os.cpu_count() or 1)
    tnative._THREADS = None


@pytest.fixture(scope="module")
def plan_cache(tmp_path_factory):
    """This module's own plan cache directory."""
    return str(tmp_path_factory.mktemp("sharded_plan_cache"))


def _topos(graph):
    name, n, kw = _GRAPHS[graph]
    return jx.build_topology(name, n, **kw), tx.build_topology(name, n, **kw)


def _jax_single(graph):
    """One JAX single-chip routed reference run per graph."""
    if graph not in _jax_runs:
        topo, _ = _topos(graph)
        _jax_runs[graph] = jx.run_simulation(topo, jx.RunConfig(
            plan_cache="none", **_BASE))
    return _jax_runs[graph]


def _jax_stacked(graph, shards):
    if (graph, shards) not in _jax_plans:
        topo, _ = _topos(graph)
        _jax_plans[(graph, shards)] = jsd.build_shard_push_deliveries(
            topo, jax_padded_size(topo.num_nodes, shards), shards,
            build_workers=1)
    return _jax_plans[(graph, shards)]


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_fields_equal(tstate, jstate, fields=_FIELDS):
    for f in fields:
        a, b = _bits(getattr(tstate, f)), _bits(getattr(jstate, f))
        assert a.shape == b.shape and np.array_equal(a, b), f


def _assert_stacked_equal(t, j):
    """Two stacked host-form push deliveries, byte for byte."""
    for f in ("n", "local_n", "num_shards", "nu", "m_pairs", "block_pairs"):
        assert int(getattr(t, f)) == int(getattr(j, f)), f
    assert tuple(map(tuple, t.classes)) == tuple(map(tuple, j.classes))
    for g in ("plan_in", "plan_send", "plan_recv", "plan_out"):
        tp, jp = getattr(t, g), getattr(j, g)
        assert len(tp) == len(jp)
        for a, b in zip(tp, jp):
            assert (a.unit, a.nt_in, a.nt_out) == (b.unit, b.nt_in, b.nt_out)
            assert [tuple(s)[:6] for s in a.stages] == \
                [tuple(s)[:6] for s in b.stages]
            assert a.final.k == b.final.k
            for x, y in zip(
                    [s.idx for s in a.stages] + [a.final.idx, a.final.mask],
                    [s.idx for s in b.stages] + [b.final.idx, b.final.mask]):
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and np.array_equal(x, y), g
    for f in ("realmask", "degree"):
        x, y = np.asarray(getattr(t, f)), np.asarray(getattr(j, f))
        assert x.dtype == y.dtype and np.array_equal(_bits(x), _bits(y)), f


# ---- the host compiler ---------------------------------------------------

@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_push_tables_byte_equal(graph, shards):
    """Every shard's push tables are the JAX package's, byte for byte."""
    _, topo = _topos(graph)
    t = tsd.build_shard_push_deliveries(
        topo, padded_size(topo.num_nodes, shards), shards, build_workers=1)
    _assert_stacked_equal(t, _jax_stacked(graph, shards))


def test_push_shards_compile_identical_geometry():
    """The forcing erases every per-shard difference from the program
    geometry, even where shard 0 owns all the hubs (JAX's test)."""
    topo = tx.build_topology("powerlaw", 500, seed=7, m=3)
    shards = tsd._build_push_shards(topo, padded_size(500, 8), 8,
                                    build_workers=1)
    g0 = tsd.push_program_geometry(shards[0])
    for k, sd in enumerate(shards[1:], 1):
        assert tsd.push_program_geometry(sd) == g0, f"shard {k} diverged"


def test_push_tables_guard_rejects_pathological():
    with pytest.raises(RoutedConfigError) as e:
        tsd.assert_push_tables_linear(m_pairs=10_000_000, num_shards=8,
                                      block_pairs=64, e_max=1000,
                                      local=128, n_classes=3)
    assert "--routed-design pull" in str(e.value)
    assert "--delivery scatter" in str(e.value)


def test_push_compiler_rejects_as_jax_does():
    """Where the JAX package's push compiler refuses a partition (power
    law 100,000 on 8 shards: its plan_in routing concentrates), the
    port's refuses it with the same message."""
    topo_j = jx.build_topology("power_law", 100_000, seed=0, m=4)
    topo_t = tx.build_topology("power_law", 100_000, seed=0, m=4)
    with pytest.raises(Exception) as ej:
        jsd.build_shard_push_deliveries(topo_j, 100_000, 8, build_workers=1)
    with pytest.raises(RoutedConfigError) as et:
        tsd.build_shard_push_deliveries(topo_t, 100_000, 8, build_workers=1)
    assert str(et.value) == str(ej.value)
    assert "concentrated" in str(et.value)


def test_build_workers_do_not_change_tables():
    """Four forked build workers give the serial build's tables, byte for
    byte (the workers run numpy and the routing library only)."""
    _, topo = _topos("powerlaw")
    n_padded = padded_size(topo.num_nodes, 4)
    serial = tsd.build_shard_push_deliveries(topo, n_padded, 4,
                                             build_workers=1)
    pooled = tsd.build_shard_push_deliveries(topo, n_padded, 4,
                                             build_workers=4)
    _assert_stacked_equal(pooled, serial)


def test_exchange_bytes():
    j = _jax_stacked("imp3D", 2)
    for wire in ("f32", "bf16", "int8"):
        assert tsd.push_exchange_wire_bytes_per_round(j, wire) == \
            jsd.push_exchange_wire_bytes_per_round(j, wire)
    assert tsd.push_exchange_bytes_per_round(j) == \
        jsd.push_exchange_bytes_per_round(j)
    assert tsd.table_bytes(j) == jsd.table_bytes(j)


# ---- the exchange ----------------------------------------------------------

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _slabs(shards, block, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        return [torch.from_numpy(rng.integers(-127, 128, (shards, block))
                                 .astype(np.int8)) for _ in range(shards)]
    return [torch.from_numpy(rng.standard_normal((shards, block))
                             .astype(np.float32)).to(dtype)
            for _ in range(shards)]


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("wire", list(_DTYPES))
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_exchange_is_the_permutation(shards, wire, overlap):
    """``out[d][s] = slab[s][d]`` — both spellings, every dtype, rows of
    odd length and the [S, 1] scale sidecar, both schedules."""
    for block in (37, 1):
        slabs = _slabs(shards, block, _DTYPES[wire], 10 * shards + block)
        want = np.stack([t.view(torch.int8).numpy() if t.dtype ==
                         torch.bfloat16 else t.numpy() for t in slabs])
        want = want.transpose(1, 0, 2)   # [d, s, ...]
        for got in (pdm.pallas_exchange(slabs, overlap=overlap),
                    pdm.exchange_plain(slabs)):
            assert len(got) == shards
            for d, t in enumerate(got):
                assert t.dtype == slabs[0].dtype and t.shape == (shards,
                                                                 block)
                a = t.view(torch.int8) if t.dtype == torch.bfloat16 else t
                assert np.array_equal(a.numpy(), want[d])


def test_exchange_rejects_ragged_slabs():
    with pytest.raises(ValueError, match="slabs"):
        pdm.pallas_exchange([torch.zeros(2, 4), torch.zeros(2, 5)])


# ---- the engine, bitwise ---------------------------------------------------

_TRANSPORTS = {
    "routed": dict(delivery="routed"),
    "pallas": dict(delivery="pallas"),
    "routed_overlap": dict(delivery="routed", exchange_overlap=True),
    "pallas_overlap": dict(delivery="pallas", exchange_overlap=True),
}


@pytest.mark.parametrize("transport", list(_TRANSPORTS))
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_sharded_engine_bitwise_matches_single_chip(graph, shards,
                                                    transport, plan_cache):
    """The port's S-shard run equals the JAX package's single-chip routed
    run in s, w, ratio and rounds over 24 rounds."""
    rj = _jax_single(graph)
    _, topo = _topos(graph)
    rt = run_simulation_sharded(topo, tx.RunConfig(
        device="cpu", plan_cache=plan_cache,
        **dict(_TORCH_BASE, **_TRANSPORTS[transport])),
        num_devices=shards)
    assert rt.rounds == rj.rounds == 24
    _assert_fields_equal(rt.final_state, rj.final_state,
                         ("s", "w", "ratio", "alive"))


def test_birth_exclusions_masked_path(plan_cache):
    """An Erdős–Rényi graph with birth exclusions (the masked round) on 2
    shards against the JAX single-chip routed run."""
    topo_j = jx.build_topology("er", 500, **_ER)
    assert topo_j.birth_alive() is not None
    rj = jx.run_simulation(topo_j, jx.RunConfig(plan_cache="none", **_BASE))
    rt = run_simulation_sharded(
        tx.build_topology("er", 500, **_ER),
        tx.RunConfig(device="cpu", plan_cache=plan_cache, **_TORCH_BASE),
        num_devices=2)
    assert rt.rounds == rj.rounds
    _assert_fields_equal(rt.final_state, rj.final_state)


def test_arbitrary_dead_set_live_degree_path(plan_cache):
    """A start state whose dead set is not the birth exclusions: the
    live-degree pass (one extra matvec through the exchange per round)
    on 2 shards against the JAX single-chip run from the same state."""
    topo_j = jx.build_topology("er", 500, **_ER)
    dead = np.random.default_rng(3).random(500) < 0.1
    alive = np.asarray(topo_j.birth_alive()) & ~dead
    js = jax.device_get(jx.pushsum_init(500)._replace(
        alive=jax.numpy.asarray(alive)))
    cfg = dict(_BASE, max_rounds=16)
    rj = jx.run_simulation(topo_j, jx.RunConfig(plan_cache="none", **cfg),
                           initial_state=js)
    carried = state_from_numpy(*[np.asarray(getattr(js, f))
                                 for f in _FIELDS + ("round",)],
                               device="cpu")
    tcfg = dict(cfg, build_workers=1)
    rt = run_simulation_sharded(
        tx.build_topology("er", 500, **_ER),
        tx.RunConfig(device="cpu", exchange_overlap=True,
                     plan_cache=plan_cache, **tcfg),
        num_devices=2, initial_state=carried)
    assert rt.rounds == rj.rounds == 16
    _assert_fields_equal(rt.final_state, rj.final_state)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_lossy_wire_matches_jax_sharded(cpu_devices, wire, plan_cache):
    """The lossy wires round on the wire exactly as the JAX package's
    2-shard run does (imp3D 216, 8 rounds)."""
    topo_j, topo_t = _topos("imp3D")
    cfg = dict(_BASE, max_rounds=8, payload_wire=wire)
    rj = jax_run_sharded(topo_j, jx.RunConfig(plan_cache="none",
                                              build_workers=1, **cfg),
                         num_devices=2, backend="cpu")
    rt = run_simulation_sharded(topo_t, tx.RunConfig(
        device="cpu", build_workers=1, plan_cache=plan_cache,
        **cfg),
        num_devices=2)
    assert rt.rounds == rj.rounds == 8
    _assert_fields_equal(rt.final_state, rj.final_state,
                         ("s", "w", "ratio"))
    # the wire really rounds: the f32 trajectory differs
    assert not np.array_equal(_bits(rt.final_state.s),
                              _bits(_jax_single_8("imp3D").final_state.s))


def _jax_single_8(graph):
    key = (graph, 8)
    if key not in _jax_runs:
        topo, _ = _topos(graph)
        _jax_runs[key] = jx.run_simulation(topo, jx.RunConfig(
            plan_cache="none", **dict(_BASE, max_rounds=8)))
    return _jax_runs[key]


def test_unwritten_buffers_never_read():
    """Every ``torch.empty`` buffer of the path filled with NaN, and the
    routing stages' unwritten slab rows (left unwritten by the card's
    kernel) set to NaN: no output bit moves, under the f32 and the int8
    wire (whose scale reads the whole block, padding included)."""
    _, topo = _topos("powerlaw")
    plans = shard_push_from_numpy(
        tsd.build_shard_push_deliveries(topo, padded_size(400, 4), 4,
                                        build_workers=1), device="cpu")
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.random(plans.num_shards * plans.local_n)
                          .astype(np.float32))
    xw = torch.from_numpy(rng.random(xs.numel()).astype(np.float32))
    want = {w: plans.matvec(xs, xw, exchange="pallas", wire=w)
            for w in ("f32", "int8")}
    real_empty, real_stage = torch.empty, ex.stage_call_plain

    def nan_empty(*a, **kw):
        t = real_empty(*a, **kw)
        if t.is_floating_point():
            t.fill_(float("nan"))
        elif t.dtype == torch.int8:
            t.fill_(-128)
        return t

    def nan_stage(st, cur, unit):
        out = real_stage(st, cur, unit)
        out.view(st.p, st.b, st.tau_slab, st.cr, ex.LANES)[
            :, :, st.tau_in:] = float("nan")
        return out

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch, "empty", nan_empty)
        mp.setattr(ex, "stage_call_plain", nan_stage)
        for wire, (ws, ww) in want.items():
            for exchange in ("pallas", "overlap", "all_to_all"):
                gs, gw = plans.matvec(xs, xw, exchange=exchange, wire=wire)
                assert np.array_equal(_bits(gs), _bits(ws)), (wire, exchange)
                assert np.array_equal(_bits(gw), _bits(ww)), (wire, exchange)
    finally:
        mp.undo()


# ---- tables carried across -------------------------------------------------

def test_jax_plans_carried_across():
    """The JAX package's stacked plans, placed by ``shard_push_from_numpy``,
    give the port's own plans' sharded matvec, bitwise; and that matvec
    equals the port's single-card routed matvec."""
    from gossipprotocol_tpu_torch.ops.delivery import build_routed_delivery

    _, topo = _topos("powerlaw")
    theirs = shard_push_from_numpy(_jax_stacked("powerlaw", 4), device="cpu")
    ours = shard_push_from_numpy(tsd.build_shard_push_deliveries(
        topo, padded_size(400, 4), 4, build_workers=1), device="cpu")
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.random(400).astype(np.float32))
    xw = torch.from_numpy(rng.random(400).astype(np.float32))
    a = theirs.matvec(xs, xw)
    b = ours.matvec(xs, xw)
    c = build_routed_delivery(topo, device="cpu").matvec(xs, xw)
    for u, v, r in zip(a, b, c):
        assert np.array_equal(_bits(u), _bits(v))
        assert np.array_equal(_bits(u), _bits(r))


def test_shard_push_from_numpy_rejects_bad_tables():
    j = _jax_stacked("imp3D", 2)
    with pytest.raises(ValueError, match="realmask"):
        shard_push_from_numpy(j._replace(realmask=np.asarray(
            j.realmask)[:1]), device="cpu")
    with pytest.raises(ValueError, match="classes"):
        shard_push_from_numpy(j._replace(m_pairs=int(j.m_pairs) + 64),
                              device="cpu")


# ---- the plan cache, both ways -------------------------------------------

def test_push_cache_jax_entry_loads_in_port(tmp_path):
    topo_j, topo_t = _topos("imp3D")
    stacked, prov = jpc.shard_push_deliveries_cached(
        topo_j, 216, 4, cache_dir=str(tmp_path), build_workers=1)
    assert prov == "miss"
    host, prov_t = tpc.shard_push_deliveries_cached(
        topo_t, 216, 4, cache_dir=str(tmp_path), build_workers=1)
    assert prov_t == "hit"
    _assert_stacked_equal(host, stacked)
    _assert_stacked_equal(host, _jax_stacked("imp3D", 4))


def test_push_cache_port_entry_loads_in_jax(tmp_path):
    topo_j, topo_t = _topos("powerlaw")
    host, prov = tpc.shard_push_deliveries_cached(
        topo_t, 400, 2, cache_dir=str(tmp_path), build_workers=1)
    assert prov == "miss"
    assert tpc.push_entry_path(str(tmp_path), tpc.cache_key(topo_t), 400,
                               2) == jpc.push_entry_path(
        str(tmp_path), topo_j.adjacency_digest(), 400, 2)
    stacked, prov_j = jpc.shard_push_deliveries_cached(
        topo_j, 400, 2, cache_dir=str(tmp_path), build_workers=1)
    assert prov_j == "hit"
    _assert_stacked_equal(host, stacked)


# ---- mesh and CLI ----------------------------------------------------------

def test_mesh_places_every_shard_on_one_device():
    mesh = make_mesh(4, "cpu")
    assert mesh == [torch.device("cpu")] * 4
    assert placement_line(mesh) == "4 shards on 1 host CPU (cpu)"
    assert padded_size(130, 4) == 132 and padded_size(128, 4) == 128
    with pytest.raises(ValueError):
        make_mesh(0, "cpu")


_CLI = ["push-sum", "--fanout", "all", "--device", "cpu",
        "--build-workers", "1"]


def test_cli_sharded_matches_single(capsys, plan_cache):
    """``--devices 4`` prints the rounds line and the estimate of
    ``--devices 1``, and names the placement on stderr."""
    argv = ["216", "imp3D", *_CLI, "--delivery", "pallas", "--predicate",
            "global", "--plan-cache", plan_cache]
    assert torch_main(argv) == 0
    one = capsys.readouterr().out
    assert torch_main(argv + ["--devices", "4"]) == 0
    cap = capsys.readouterr()
    assert "4 shards on 1 host CPU (cpu)" in cap.err

    def lines(text):
        return [ln.split("  compile:")[0] for ln in text.splitlines()
                if ln.startswith(("rounds:", "push-sum max"))]

    assert lines(cap.out) == lines(one) and len(lines(one)) == 2
    assert "converged: True" in cap.out


@pytest.mark.parametrize("argv,needle", [
    (["--delivery", "routed", "--devices", "2", "--routed-design", "pull"],
     "not yet ported"),
    (["--delivery", "routed", "--exchange-overlap"],
     "--exchange-overlap rewrites the sharded exchange"),
    (["--delivery", "pallas", "--payload-wire", "bf16"],
     "--payload-wire compresses the sharded edge-share exchange"),
    (["--delivery", "megakernel", "--devices", "2"],
     "the round-loop megakernel is single-chip only"),
    (["--delivery", "pallas", "--routed-design", "push"],
     "--routed-design selects between the sharded routed"),
])
def test_cli_sharding_rejections(argv, needle, capsys):
    assert torch_main(["64", "imp3D", *_CLI, *argv]) == 2
    assert needle in capsys.readouterr().err


def test_config_rejections():
    base = tx.RunConfig(device="cpu", algorithm="push-sum", fanout="all",
                        delivery="pallas")
    with pytest.raises(ValueError, match="payload_wire"):
        dataclasses.replace(base, delivery="megakernel", payload_wire="bf16")
    with pytest.raises(ValueError, match="push design only"):
        dataclasses.replace(base, routed_design="pull")
    with pytest.raises(ValueError, match="not yet ported"):
        dataclasses.replace(base, delivery="routed", routed_design="pull")
    with pytest.raises(ValueError, match="megakernel"):
        run_simulation_sharded(tx.build_topology("imp3D", 64),
                               dataclasses.replace(base,
                                                   delivery="megakernel"),
                               num_devices=2)
