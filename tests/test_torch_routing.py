"""PyTorch port, the routed slice (``--delivery routed``): the Clos
decoding, the routing-plan compiler, the plan executor's passes, the two
expand kernels and the routed delivery, each held bitwise against the JAX
package on the CPU (inputs made from a seed with numpy). The path only
moves values, and its folds are the fused gather delivery's, so no
tolerance is needed anywhere: the routed matvec equals the JAX package's
routed matvec (interpret mode) and the port's own fused gather matvec,
and 16-round trajectories over the two deliveries are equal.

The JAX references that run the Pallas interpreter (5-7 s per routed
matvec here) are computed once per module."""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gossipprotocol_tpu import build_topology as jax_topology
from gossipprotocol_tpu.ops import classops as jco
from gossipprotocol_tpu.ops import clos as jclos
from gossipprotocol_tpu.ops import delivery as jdl
from gossipprotocol_tpu.ops import exec as jex
from gossipprotocol_tpu.ops import plan as jplan
from gossipprotocol_tpu.topology import csr_from_edges as jax_csr

from gossipprotocol_tpu_torch import native
from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.convert import (
    plan_from_numpy, routed_delivery_from_numpy,
)
from gossipprotocol_tpu_torch.engine import RunConfig, run_simulation
from gossipprotocol_tpu_torch.engine import driver as tdriver
from gossipprotocol_tpu_torch.ops import classops as co
from gossipprotocol_tpu_torch.ops import clos
from gossipprotocol_tpu_torch.ops import exec as ex
from gossipprotocol_tpu_torch.ops import plan as tplan
from gossipprotocol_tpu_torch.ops.delivery import (
    RoutedConfigError, build_routed_delivery, build_routed_delivery_np,
    hub_split_counts, routed_streamed_bytes_per_round, split_pad_pairs_of,
)
from gossipprotocol_tpu_torch.ops.pallasdelivery import build_pallas_delivery
from gossipprotocol_tpu_torch.topology import build_topology
from gossipprotocol_tpu_torch.topology.base import csr_from_edges


@pytest.fixture(scope="module", autouse=True)
def _one_openmp_thread():
    """This module's OpenMP code (torch's CPU kernels, the routing
    libraries) runs on one thread, restored afterwards: once a process
    has run a parallel region on several threads, GNU OpenMP waits
    forever in a child forked from it, and the JAX package's shard builds
    fork their workers, so a later test of that kind in this test worker
    would hang."""
    import os

    from gossipprotocol_tpu import native as jnative
    from gossipprotocol_tpu_torch import native as tnative

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jnative.set_native_threads(1)
    tnative.set_native_threads(1)
    yield
    torch.set_num_threads(threads)
    jnative.set_native_threads(os.cpu_count() or 1)
    tnative.set_native_threads(os.cpu_count() or 1)
    tnative._THREADS = None


ROOT = pathlib.Path(__file__).resolve().parent.parent


def _star_edges(n):
    return np.stack([np.zeros(n - 1, np.int64),
                     np.arange(1, n, dtype=np.int64)], axis=1)


# (builder name, n, kwargs); "star4096" is the degree-4095 hub of
# tests/test_hubsplit.py, "er_isolated" has degree-0 nodes
_GRAPHS = {
    "imp3D": ("imp3D", 1000, {"seed": 4}),
    "powerlaw": ("powerlaw", 3000, {"seed": 3, "m": 3}),  # c = 2048 hub
    "star4096": ("star", 4096, {}),
    "er_isolated": ("er", 500, {"seed": 9, "avg_degree": 2.0}),
}


def _topos(graph):
    name, n, kw = _GRAPHS[graph]
    if name == "star":
        return (jax_csr(n, _star_edges(n), kind="star"),
                csr_from_edges(n, _star_edges(n), kind="star"))
    return jax_topology(name, n, **kw), build_topology(name, n, **kw)


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_plans_equal(tp, jp):
    assert (tp.unit, tp.nt_in, tp.nt_out) == (jp.unit, jp.nt_in, jp.nt_out)
    assert len(tp.stages) == len(jp.stages)
    for a, b in zip(tp.stages, jp.stages):
        assert tuple(a)[:6] == tuple(b)[:6]
        x, y = np.asarray(a.idx), np.asarray(b.idx)
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert tp.final.k == jp.final.k
    for f in ("idx", "mask"):
        x, y = np.asarray(getattr(tp.final, f)), np.asarray(
            getattr(jp.final, f))
        assert x.dtype == y.dtype and np.array_equal(x, y)


def _assert_deliveries_equal(t, j):
    assert (t.n, t.nu, t.m_pairs) == (j.n, j.nu, j.m_pairs)
    assert tuple(map(tuple, t.classes)) == tuple(map(tuple, j.classes))
    for g in ("plan_in", "plan_m", "plan_out"):
        assert len(getattr(t, g)) == len(getattr(j, g))
        for a, b in zip(getattr(t, g), getattr(j, g)):
            _assert_plans_equal(a, b)
    assert np.array_equal(_bits(np.asarray(t.realmask)),
                          _bits(np.asarray(j.realmask)))
    assert np.array_equal(np.asarray(t.degree), np.asarray(j.degree))


# ---- the host library ------------------------------------------------

def test_routecolor_copy_is_byte_identical():
    """The two packages' colorings cannot drift apart: the port compiles
    the JAX package's routecolor.cpp, byte for byte."""
    assert native.SOURCE.read_bytes() == (
        ROOT / "native" / "routecolor.cpp").read_bytes()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that refuses the source raises (both the OpenMP and
    the single-threaded attempt), never a quiet numpy fallback."""
    monkeypatch.setattr(native, "_LIB", native._Lib())
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(native.NativeBuildError, match="-fopenmp"):
        native.route_tiles_full(np.full((1, 8192), -1, np.int64), 2)


def test_native_builds_without_openmp(monkeypatch, tmp_path):
    """A compiler without OpenMP builds the same source single-threaded
    (the tiles then spread over threads), and its tables are byte-equal
    to the OpenMP build's."""
    rng = np.random.default_rng(5)
    perm = np.stack([rng.permutation(8192) for _ in range(40)])
    perm[:, ::3] = -1
    want = native.route_tiles_full(perm, 2)
    wrapper = tmp_path / "cxx"
    wrapper.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] '
                       '&& exit 1; done\nexec g++ "$@"\n')
    wrapper.chmod(0o755)
    monkeypatch.setattr(native, "_LIB", native._Lib())
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("CXX", str(wrapper))
    got = native.route_tiles_full(perm, 2)
    assert native.threads_note().startswith("single-threaded")
    assert np.array_equal(got, want)


def test_numpy_mirror_only_on_request(monkeypatch):
    """``GOSSIP_TPU_NATIVE=0`` takes the numpy mirror, whose plan routes
    exactly; otherwise the native library runs."""
    assert native.backend() == "native"
    assert native.route_tiles_full(np.full((1, 8192), -1, np.int64),
                                   2) is not None
    monkeypatch.setenv("GOSSIP_TPU_NATIVE", "0")
    assert native.backend() == "numpy"
    assert native.route_tiles_full(np.full((1, 8192), -1, np.int64),
                                   2) is None
    rng = np.random.default_rng(11)
    perm = rng.permutation(8192).astype(np.int64)
    perm[rng.random(8192) < 0.3] = -1
    dp = plan_from_numpy(ex.device_plan(tplan.build_route_plan(
        perm, m_in=8192, unit=2)), "cpu")
    x = torch.from_numpy(rng.standard_normal(16384).astype(np.float32))
    y = ex.apply_plan(dp, x).view(-1, 2)
    real = np.flatnonzero(perm >= 0)
    assert torch.equal(y[real], x.view(-1, 2)[perm[real]])


# ---- Clos decoding -----------------------------------------------------

@pytest.mark.parametrize("unit", [1, 2])
def test_clos_decoding(unit):
    """``route_tile_perms`` byte-equal to the JAX package's; the stored
    planes decoded by ``widen_idx`` route like ``apply_route_np``, and the
    composed one-gather index (the kernels' decoding) does too."""
    rng = np.random.default_rng(unit)
    u = clos.TILE // unit
    perms = np.stack([rng.permutation(u) for _ in range(3)])
    got = clos.route_tile_perms(perms, unit=unit)
    want = jclos.route_tile_perms(perms, unit=unit)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    plan = tplan.RoutePlan(unit, u, 3, 3, (), tplan.FinalPass(
        1, np.stack(got, axis=1)[:, None], np.ones((3, 1, 128, 128),
                                                   np.uint8)))
    planes = torch.from_numpy(ex.device_plan(plan).final.idx[:, 0])
    x = rng.standard_normal((3, 128, 128)).astype(np.float32)
    y = ex.route_plain(torch.from_numpy(x), planes, unit).numpy()
    ci = ex.composed_route_index(planes, unit).numpy()
    for t in range(3):
        ref = jclos.apply_route_np(x[t], got[0][t], got[1][t], got[2][t])
        assert np.array_equal(y[t], ref)
        assert np.array_equal(x[t].reshape(-1)[ci[t]].reshape(128, 128),
                              ref)
        flat = np.empty(clos.TILE, np.float32)
        for j in range(unit):
            flat[np.arange(u) * unit + j] = x[t].reshape(-1)[
                perms[t] * unit + j]
        assert np.array_equal(ref.reshape(-1), flat)


# ---- the plan compiler and executor --------------------------------------

_PLANS = {
    # name: (unit, nt, fraction of don't-care output slots)
    "u2_nt1": (2, 1, 0.0),
    "u2_nt3": (2, 3, 0.0),
    "u2_nt5_dc": (2, 5, 0.3),
    "u1_nt2_dc": (1, 2, 0.4),
    # 130 output tiles: two radix stages, tau_slab > tau_in
    "u2_nt130": (2, 130, 0.0),
}


def _perm(name):
    unit, nt, dc = _PLANS[name]
    rng = np.random.default_rng(nt * 10 + unit)
    m = nt * (clos.TILE // unit)
    perm = rng.permutation(m).astype(np.int64)
    if dc:
        perm[rng.random(m) < dc] = -1
    x = rng.standard_normal(nt * clos.TILE).astype(np.float32)
    return unit, m, perm, x


@pytest.fixture(scope="module")
def jax_plan_outputs():
    """The JAX executor in interpret mode on two of the plans."""
    out = {}
    for name in ("u2_nt3", "u1_nt2_dc"):
        unit, m, perm, x = _perm(name)
        jp = jex.device_plan(jplan.build_route_plan(perm, m_in=m, unit=unit))
        out[name] = np.asarray(jex.apply_plan(jp, jnp.asarray(x),
                                              interpret=True))
    return out


@pytest.mark.parametrize("name", list(_PLANS))
def test_route_plan_tables_and_apply(name, jax_plan_outputs):
    unit, m, perm, x = _perm(name)
    plan = tplan.build_route_plan(perm, m_in=m, unit=unit)
    dp = ex.device_plan(plan)
    _assert_plans_equal(dp, jex.device_plan(
        jplan.build_route_plan(perm, m_in=m, unit=unit)))
    if name == "u2_nt130":
        assert len(dp.stages) == 2
        assert dp.stages[0].tau_slab > dp.stages[0].tau_in
    placed = plan_from_numpy(dp, "cpu")
    y = ex.apply_plan(placed, torch.from_numpy(x)).numpy()
    assert np.array_equal(_bits(y), _bits(tplan.apply_plan_np(plan, x)))
    real = np.flatnonzero(perm >= 0)
    for j in range(unit):
        assert np.array_equal(y[real * unit + j], x[perm[real] * unit + j])
    assert (y.reshape(-1, unit)[perm < 0] == 0).all()
    if name in jax_plan_outputs:
        assert np.array_equal(_bits(y), _bits(jax_plan_outputs[name]))


def test_stage_leaves_padding_rows_and_final_ignores_them():
    """The stage writes ``staging[p][bucket][i]`` for i < tau_in only; the
    final pass reads nothing else (NaN in the unwritten rows changes no
    output bit)."""
    unit, m, perm, x = _perm("u2_nt130")
    dp = plan_from_numpy(ex.device_plan(
        tplan.build_route_plan(perm, m_in=m, unit=unit)), "cpu")
    cur = torch.from_numpy(x).view(-1, 128, 128)
    st0 = dp.stages[0]
    s1 = ex.stage_call(st0, cur, unit)
    s1_nan = torch.full_like(s1, float("nan"))
    ex.stage_rows_written(st0, s1_nan)[:] = ex.stage_rows_written(st0, s1)
    outs = []
    for s in (s1, s1_nan):
        c = s
        for st in dp.stages[1:]:
            c = ex.stage_call(st, c, unit)
        outs.append(ex.final_call(dp.final, dp.nt_out, c, unit))
    assert torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32))


# ---- the expand kernels ----------------------------------------------------

def _values(rng, n):
    x = (rng.standard_normal(n) * 1e3).astype(np.float32)
    x[rng.random(n) < 0.05] = -0.0
    return x


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16, 32, 64])
def test_expand_small_matches_jax(c):
    x = _values(np.random.default_rng(c), 2 * co.BLK * 128 // c)
    got = co.class_expand_small(torch.from_numpy(x), c)
    want = jco.class_expand_small(jnp.asarray(x), c, interpret=True)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("c,cap", [(128, 8), (512, 16), (2048, 256)])
def test_expand_split_matches_jax(c, cap):
    x = _values(np.random.default_rng(c + cap), 2 * cap)
    got = co.class_expand_split(torch.from_numpy(x), c)
    want = jco.class_expand_split(jnp.asarray(x), c, interpret=True)
    assert np.array_equal(_bits(got), _bits(want))


def test_cpu_wrappers_launch_nothing():
    before = {**co.LAUNCHES, **ex.LAUNCHES}
    co.class_expand_small(torch.zeros(co.BLK * 128 // 4), 4)
    co.class_expand_split(torch.zeros(16), 256)
    unit, m, perm, x = _perm("u2_nt1")
    dp = plan_from_numpy(ex.device_plan(
        tplan.build_route_plan(perm, m_in=m, unit=unit)), "cpu")
    ex.apply_plan(dp, torch.from_numpy(x))
    assert {**co.LAUNCHES, **ex.LAUNCHES} == before


# ---- the routed delivery -------------------------------------------------

@pytest.fixture(scope="module")
def deliveries():
    """Per graph: (JAX host delivery, port host delivery)."""
    out = {}
    for graph in _GRAPHS:
        jt, tt = _topos(graph)
        out[graph] = (jdl.build_routed_delivery(jt, device=False),
                      build_routed_delivery_np(tt), tt)
    return out


@pytest.fixture(scope="module")
def jax_matvecs(deliveries):
    """The JAX routed matvec in interpret mode, on imp3D and the hub-split
    power-law graph, with two engine padding rows."""
    out = {}
    for graph in ("imp3D", "powerlaw"):
        jr, _, tt = deliveries[graph]
        xs, xw = _inputs(tt.num_nodes + 2)
        jd = jdl.to_device(jr)
        out[graph] = jd.matvec(jnp.asarray(xs), jnp.asarray(xw),
                               interpret=True)
    return out


def _inputs(rows):
    rng = np.random.default_rng(rows)
    return (rng.standard_normal(rows).astype(np.float32),
            rng.random(rows).astype(np.float32))


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_delivery_fields_equal(graph, deliveries):
    jr, tr, _ = deliveries[graph]
    _assert_deliveries_equal(tr, jr)
    assert hub_split_counts(tr.classes) == jdl.hub_split_counts(jr.classes)
    assert split_pad_pairs_of(tr.classes) == jdl.split_pad_pairs_of(
        jr.classes)
    assert routed_streamed_bytes_per_round(tr) == \
        jdl.routed_streamed_bytes_per_round(jr)
    if graph == "powerlaw":
        assert hub_split_counts(tr.classes)[2] == 2048
    if graph == "star4096":
        assert hub_split_counts(tr.classes) == (1, 64, 4096)


@pytest.mark.parametrize("graph", ["imp3D", "powerlaw"])
def test_routed_matvec_matches_jax(graph, deliveries, jax_matvecs):
    _, tr, tt = deliveries[graph]
    rd = routed_delivery_from_numpy(tr, "cpu")
    xs, xw = _inputs(tt.num_nodes + 2)
    got = rd.matvec(torch.from_numpy(xs), torch.from_numpy(xw))
    for a, b in zip(got, jax_matvecs[graph]):
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_routed_matvec_equals_pallas(graph, deliveries):
    """The routed and fused gather deliveries move the same values into
    the same folds: bitwise equal, isolated nodes and padding rows read
    +0.0."""
    _, tr, tt = deliveries[graph]
    n = tt.num_nodes
    rd = routed_delivery_from_numpy(tr, "cpu")
    pd = build_pallas_delivery(tt, device="cpu")
    xs, xw = _inputs(n + 37)
    a = rd.matvec(torch.from_numpy(xs), torch.from_numpy(xw))
    b = pd.matvec(torch.from_numpy(xs[:n]), torch.from_numpy(xw[:n]))
    deg = np.diff(tt.offsets)
    for u, v in zip(a, b):
        assert u.shape[0] == n + 37
        assert np.array_equal(_bits(u[:n]), _bits(v))
        assert (_bits(u[n:]) == 0).all()
        assert (_bits(u[:n][torch.from_numpy(deg == 0)]) == 0).all()
    if graph == "er_isolated":
        assert (deg == 0).any()


def test_jax_delivery_carried_across(deliveries):
    """A JAX-built host delivery, placed by the converter, is the port's."""
    jr, tr, tt = deliveries["powerlaw"]
    xs, xw = _inputs(tt.num_nodes)
    a = routed_delivery_from_numpy(jr, "cpu").matvec(
        torch.from_numpy(xs), torch.from_numpy(xw))
    b = routed_delivery_from_numpy(tr, "cpu").matvec(
        torch.from_numpy(xs), torch.from_numpy(xw))
    for u, v in zip(a, b):
        assert np.array_equal(_bits(u), _bits(v))


def _corrupt(tr, group, fn):
    plans = list(getattr(tr, group))
    plans[0] = fn(plans[0])
    return tr._replace(**{group: tuple(plans)})


def _with_stage_idx(dp, value, component):
    idx = dp.stages[0].idx.copy()
    idx[0, 0, component, 0, 0] = value
    return dp._replace(stages=(dp.stages[0]._replace(idx=idx),)
                       + dp.stages[1:])


@pytest.mark.parametrize("case", [
    "negative_index", "lane_index_127", "mask_shape", "final_k",
    "realmask_len", "realmask_value", "class_geometry", "degree_shape",
    "stage_geometry"])
def test_converter_rejects_bad_tables(case, deliveries):
    _, tr, _ = deliveries["imp3D"]
    bad = {
        "negative_index": lambda: _corrupt(
            tr, "plan_m", lambda p: _with_stage_idx(p, -1, 1)),
        # unit-2 lane planes hold even lanes <= 126: 127 + 1 is out
        "lane_index_127": lambda: _corrupt(
            tr, "plan_m", lambda p: _with_stage_idx(p, 127, 0)),
        "mask_shape": lambda: _corrupt(tr, "plan_out", lambda p: p._replace(
            final=p.final._replace(mask=p.final.mask[:, :, :8]))),
        "final_k": lambda: _corrupt(tr, "plan_in", lambda p: p._replace(
            final=p.final._replace(k=p.final.k + 1))),
        "realmask_len": lambda: tr._replace(realmask=tr.realmask[:-2]),
        "realmask_value": lambda: tr._replace(
            realmask=np.where(np.arange(tr.realmask.size) == 5, 0.5,
                              tr.realmask).astype(np.float32)),
        "class_geometry": lambda: tr._replace(m_pairs=tr.m_pairs + 64),
        "degree_shape": lambda: tr._replace(degree=tr.degree[:-1]),
        "stage_geometry": lambda: _corrupt(tr, "plan_m", lambda p: p._replace(
            stages=(p.stages[0]._replace(cr=3),) + p.stages[1:])),
    }[case]()
    with pytest.raises(ValueError):
        routed_delivery_from_numpy(bad, "cpu")


# ---- the engine and the CLI ------------------------------------------------

_TRAJ = {"imp3D": ("imp3D", 1000, {"seed": 4}),
         "powerlaw": ("powerlaw", 3000, {"seed": 3, "m": 3})}


@pytest.mark.parametrize("predicate", ["delta", "global"])
@pytest.mark.parametrize("graph", list(_TRAJ))
def test_routed_trajectory_equals_pallas(graph, predicate):
    name, n, kw = _TRAJ[graph]
    topo = build_topology(name, n, **kw)
    res = {d: run_simulation(topo, RunConfig(
        device="cpu", algorithm="push-sum", fanout="all", delivery=d,
        predicate=predicate, max_rounds=16,
        chunk_rounds=8, plan_cache="none")) for d in ("routed", "pallas")}
    a, b = res["routed"], res["pallas"]
    assert a.rounds == b.rounds == 16
    for x, y in zip(a.final_state, b.final_state):
        assert np.array_equal(_bits(x), _bits(y))


@pytest.mark.parametrize("graph", [("imp3D", 4096, {"seed": 0}),
                                   ("powerlaw", 3000, {"seed": 3, "m": 3})])
def test_converged_run_equals_pallas(graph):
    """The CLI's configuration (global predicate, default budget): the
    same round count and the same final state, bitwise, on imp3D and on a
    power-law graph with a hub-split class."""
    name, n, kw = graph
    topo = build_topology(name, n, **kw)
    res = {d: run_simulation(topo, RunConfig(
        device="cpu", algorithm="push-sum", fanout="all", delivery=d,
        predicate="global", plan_cache="none"))
        for d in ("routed", "pallas")}
    a, b = res["routed"], res["pallas"]
    assert a.converged and b.converged and a.rounds == b.rounds
    assert a.estimate_error == b.estimate_error
    for x, y in zip(a.final_state, b.final_state):
        assert np.array_equal(_bits(x), _bits(y))


def test_config_gates():
    assert "routed" in tdriver.DELIVERIES
    assert "routed" not in tdriver.FUSED_DELIVERIES
    with pytest.raises(ValueError, match="rounds_per_kernel"):
        RunConfig(device="cpu", algorithm="push-sum", fanout="all",
                  delivery="routed", rounds_per_kernel=4)
    assert not tdriver.use_megakernel(RunConfig(
        device="cpu", algorithm="push-sum", fanout="all",
        delivery="routed"))
    with pytest.raises(RoutedConfigError):
        build_routed_delivery_np(build_topology("full", 64))
    jt, tt = _topos("imp3D")
    with pytest.raises(RoutedConfigError):
        build_routed_delivery_np(tt.__class__(**{
            **{f: getattr(tt, f) for f in tt.__dataclass_fields__},
            "asymmetric": True}))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_routed_delivery(tt, device="cuda")


@pytest.mark.parametrize("argv,rc", [
    (["4096", "imp3D", "push-sum", "--fanout", "all", "--delivery",
      "routed", "--rounds-per-kernel", "4", "--device", "cpu"], 2),
    (["64", "full", "push-sum", "--fanout", "all", "--delivery", "routed",
      "--device", "cpu"], 2),
    (["216", "imp3D", "push-sum", "--fanout", "all", "--delivery",
      "routed", "--device", "cpu", "--predicate", "global",
      "--plan-cache", "none"], 0),
])
def test_cli_exit_codes(argv, rc, capsys):
    assert torch_main(argv) == rc
    if rc == 0:
        out = capsys.readouterr().out
        assert "Convergence Time:" in out and "converged: True" in out
