"""PyTorch port, the plan cache of the fused gather delivery
(ops/plancache.py): the on-disk format is the JAX package's, so an entry
written by either package loads in the other with equal tables; the cache
key is the same digest; hit, miss and off provenance, and a stale-format
entry rebuilds. Every cache lives under ``tmp_path``."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from gossipprotocol_tpu.ops import pallasdelivery as jpd
from gossipprotocol_tpu.ops import plancache as jpc
from gossipprotocol_tpu.topology import build_topology as jax_build
from gossipprotocol_tpu_torch.ops import pallasdelivery as tpd
from gossipprotocol_tpu_torch.ops import plancache as tpc
from gossipprotocol_tpu_torch.topology import build_topology as torch_build


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


_GRAPHS = {
    "imp3D": ("imp3D", 216, {"seed": 4}),
    "powerlaw": ("powerlaw", 400, {"seed": 3, "m": 3}),   # hub split
}
# None = the default threshold (resident here); "2" forces bucket mode
_MODES = {"resident": None, "bucket": "2"}
_PLAN = ("mode", "src_rows", "out_len", "idx", "rows", "lidx")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_same_tables(a, b):
    """Two deliveries (either package, host or device) hold the same
    geometry and byte-equal tables."""
    assert (int(a.n), int(a.nu), int(a.m_pairs)) == \
        (int(b.n), int(b.nu), int(b.m_pairs))
    assert tuple(map(tuple, a.classes)) == tuple(map(tuple, b.classes))
    assert np.array_equal(_np(a.degree), _np(b.degree))
    for g in ("gather_pre", "gather_out"):
        ga, gb = getattr(a, g), getattr(b, g)
        for f in _PLAN:
            x, y = getattr(ga, f), getattr(gb, f)
            if f in ("mode", "src_rows", "out_len"):
                assert x == y, (g, f)
            else:
                x, y = _np(x), _np(y)
                assert x.dtype == y.dtype and x.shape == y.shape, (g, f)
                assert np.array_equal(x, y), (g, f)


@pytest.fixture(params=list(_MODES))
def mode(request, monkeypatch):
    if _MODES[request.param] is not None:
        monkeypatch.setenv("GOSSIP_TPU_PALLAS_RESIDENT_ROWS",
                           _MODES[request.param])
    return request.param


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_jax_entry_loads_in_port(graph, mode, tmp_path):
    name, n, kw = _GRAPHS[graph]
    jtopo, ttopo = jax_build(name, n, **kw), torch_build(name, n, **kw)
    path = jpc.pallas_entry_path(str(tmp_path), jpc.cache_key(jtopo))
    jpc.save_pallas(jpd.build_pallas_delivery(jtopo, device=False), path)
    loaded = tpc.load_pallas(path)
    assert loaded is not None and loaded.gather_pre.mode == (
        "bucket" if mode == "bucket" else "resident")
    _assert_same_tables(loaded, tpd.build_pallas_delivery_np(ttopo))


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_port_entry_loads_in_jax(graph, mode, tmp_path):
    name, n, kw = _GRAPHS[graph]
    jtopo, ttopo = jax_build(name, n, **kw), torch_build(name, n, **kw)
    path = tpc.pallas_entry_path(str(tmp_path), tpc.cache_key(ttopo))
    tpc.save_pallas(tpd.build_pallas_delivery_np(ttopo), path)
    loaded = jpc.load_pallas(path)
    assert loaded is not None
    _assert_same_tables(loaded, jpd.build_pallas_delivery(jtopo,
                                                          device=False))
    # and the JAX package's cache front end takes it as a hit
    _, prov = jpc.pallas_delivery_cached(jtopo, cache_dir=str(tmp_path),
                                         device=False)
    assert prov == "hit"


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_cache_key_and_paths_equal(graph, tmp_path):
    name, n, kw = _GRAPHS[graph]
    key = tpc.cache_key(torch_build(name, n, **kw))
    assert key == jpc.cache_key(jax_build(name, n, **kw))
    assert tpc.pallas_entry_path(str(tmp_path), key) == \
        jpc.pallas_entry_path(str(tmp_path), key)
    assert tpc.FORMAT_VERSION == jpc.FORMAT_VERSION == 2
    assert os.path.basename(tpc.pallas_entry_path("d", key)) == \
        f"routedpl_v2_{key}.npz"


def test_default_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("GOSSIP_TPU_PLAN_CACHE", str(tmp_path))
    assert tpc.default_cache_dir() == jpc.default_cache_dir() == \
        str(tmp_path)


def test_provenance_miss_hit_off(tmp_path):
    topo = torch_build("powerlaw", 400, seed=3, m=3)
    d = str(tmp_path)
    notes = []
    pd_miss, p1 = tpc.pallas_delivery_cached(topo, cache_dir=d,
                                             progress=notes.append,
                                             device="cpu")
    pd_hit, p2 = tpc.pallas_delivery_cached(topo, cache_dir=d,
                                            progress=notes.append,
                                            device="cpu")
    pd_off, p3 = tpc.pallas_delivery_cached(topo, cache_dir="none",
                                            device="cpu")
    assert (p1, p2, p3) == ("miss", "hit", "off")
    assert "plan cached" in notes[0] and "cache hit" in notes[1]
    path = tpc.pallas_entry_path(d, tpc.cache_key(topo))
    prov = tpc.entry_provenance(path)
    assert prov["builder"] == tpc.BUILDER_VERSION and prov["build_s"] >= 0
    for other in (pd_hit, pd_off):
        _assert_same_tables(other, pd_miss)
    assert not [f for f in os.listdir(d) if ".tmp" in f]


def test_stale_format_rebuilds(tmp_path):
    topo = torch_build("imp3D", 216, seed=4)
    d = str(tmp_path)
    path = tpc.pallas_entry_path(d, tpc.cache_key(topo))
    host = tpd.build_pallas_delivery_np(topo)
    tpc.save_pallas(host, path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays.pop("__meta__")))
    meta["format"] = 1
    with open(path, "wb") as fh:
        np.savez(fh, __meta__=json.dumps(meta), **arrays)
    assert tpc.load_pallas(path) is None
    pd, prov = tpc.pallas_delivery_cached(topo, cache_dir=d, device="cpu")
    assert prov == "miss"
    assert json.loads(str(np.load(path)["__meta__"]))["format"] == 2
    _assert_same_tables(pd, host)


def test_eviction_keeps_newest(tmp_path, monkeypatch):
    d = str(tmp_path)
    topos = [torch_build("imp3D", 216, seed=s) for s in (4, 5)]
    paths = [tpc.pallas_entry_path(d, tpc.cache_key(t)) for t in topos]
    tpc.save_pallas(tpd.build_pallas_delivery_np(topos[0]), paths[0])
    monkeypatch.setenv("GOSSIP_TPU_PLAN_CACHE_GB", "1e-9")
    tpc.pallas_delivery_cached(topos[1], cache_dir=d, device="cpu")
    assert not os.path.exists(paths[0]) and os.path.exists(paths[1])


def test_run_uses_cache(tmp_path):
    """The engine goes through the cache for both deliveries; a cached
    run is bitwise the uncached one."""
    import gossipprotocol_tpu_torch as tx

    topo = torch_build("imp3D", 216, seed=4)
    d = str(tmp_path)
    runs = [tx.run_simulation(topo, tx.RunConfig(
        device="cpu", plan_cache=cache, algorithm="push-sum", fanout="all",
        delivery=dl, max_rounds=16))
        for cache, dl in ((d, "megakernel"), (d, "pallas"),
                          ("none", "pallas"))]
    assert os.listdir(d) and any(f.startswith("routedpl_v2_")
                                 for f in os.listdir(d))
    for r in runs[1:]:
        for a, b in zip(r.final_state, runs[0].final_state):
            assert torch.equal(a, b)


# ---- routed entries (routed_v2_<key>.npz) ----------------------------------

def _routed_matvec(host, n):
    from gossipprotocol_tpu_torch.convert import routed_delivery_from_numpy

    rng = np.random.default_rng(n)
    xs = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    xw = torch.from_numpy(rng.random(n).astype(np.float32))
    rd = routed_delivery_from_numpy(host, "cpu")
    return [t.view(torch.int32) for t in rd.matvec(xs, xw)]


def _assert_same_routed(a, b):
    assert (int(a.n), int(a.nu), int(a.m_pairs)) == \
        (int(b.n), int(b.nu), int(b.m_pairs))
    assert tuple(map(tuple, a.classes)) == tuple(map(tuple, b.classes))
    for g in ("plan_in", "plan_m", "plan_out"):
        for pa, pb in zip(getattr(a, g), getattr(b, g), strict=True):
            assert (pa.unit, pa.nt_in, pa.nt_out, pa.final.k) == \
                (pb.unit, pb.nt_in, pb.nt_out, pb.final.k)
            for sa, sb in zip(pa.stages, pb.stages, strict=True):
                assert tuple(sa)[:6] == tuple(sb)[:6]
                assert np.array_equal(_np(sa.idx), _np(sb.idx))
            assert np.array_equal(_np(pa.final.idx), _np(pb.final.idx))
            assert np.array_equal(_np(pa.final.mask), _np(pb.final.mask))
    assert np.array_equal(_np(a.realmask), _np(b.realmask))
    assert np.array_equal(_np(a.degree), _np(b.degree))


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_routed_entries_cross_read(graph, tmp_path):
    """An entry the port writes, the JAX package's ``load`` reads, and the
    reverse; matvecs from both entries are bitwise equal."""
    from gossipprotocol_tpu_torch.ops.delivery import build_routed_delivery_np

    name, n, kw = _GRAPHS[graph]
    jtopo, ttopo = jax_build(name, n, **kw), torch_build(name, n, **kw)
    key = tpc.cache_key(ttopo)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tpc.entry_path(a, key) == jpc.entry_path(a, jpc.cache_key(jtopo))
    assert os.path.basename(tpc.entry_path(a, key)) == f"routed_v2_{key}.npz"
    # the port writes, the JAX package reads
    _, prov = tpc.routed_delivery_cached(ttopo, cache_dir=a, device="cpu")
    assert prov == "miss"
    from_port = jpc.load(jpc.entry_path(a, key))
    assert from_port is not None
    _, jprov = jpc.routed_delivery_cached(jtopo, cache_dir=a, device=False)
    assert jprov == "hit"
    # the JAX package writes, the port reads
    jpc.routed_delivery_cached(jtopo, cache_dir=b, device=False)
    from_jax = tpc.load(tpc.entry_path(b, key))
    assert from_jax is not None
    _, tprov = tpc.routed_delivery_cached(ttopo, cache_dir=b, device="cpu")
    assert tprov == "hit"
    _assert_same_routed(from_port, from_jax)
    _assert_same_routed(from_jax, build_routed_delivery_np(ttopo))
    for u, v in zip(_routed_matvec(from_port, n), _routed_matvec(from_jax, n)):
        assert torch.equal(u, v)


def test_routed_provenance_and_run(tmp_path):
    """miss, hit, off for the routed family; the engine's routed run goes
    through the cache and equals the uncached run bitwise."""
    import gossipprotocol_tpu_torch as tx

    topo = torch_build("powerlaw", 400, seed=3, m=3)
    d = str(tmp_path)
    notes = []
    provs = [tpc.routed_delivery_cached(topo, cache_dir=c, device="cpu",
                                        progress=notes.append)[1]
             for c in (d, d, "none")]
    assert provs == ["miss", "hit", "off"]
    assert any("plan cached" in s for s in notes)
    assert any("plan cache hit" in s for s in notes)
    path = tpc.entry_path(d, tpc.cache_key(topo))
    assert tpc.entry_provenance(path)["builder"] == tpc.BUILDER_VERSION
    runs = [tx.run_simulation(topo, tx.RunConfig(
        device="cpu", plan_cache=cache, algorithm="push-sum", fanout="all",
        delivery="routed", max_rounds=16))
        for cache in (d, "none")]
    for x, y in zip(*(r.final_state for r in runs)):
        assert torch.equal(x, y)
