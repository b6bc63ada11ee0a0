"""PyTorch port, the host libraries' graph-builder and oracle halves
(``native.py``: ``csrc/host/graphgen.cpp``, ``asyncsim.cpp``) and
``Topology.validate`` against the JAX package on the CPU: the C++ copies
byte for byte, the native and numpy CSRs byte-equal to each other and to
the JAX package's builders, the oracle's event and hop counts equal to
the JAX package's oracle, and the port's walk inside the oracle's band."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.topology import builders as jb

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch import native
from gossipprotocol_tpu_torch.topology import builders as tb
from gossipprotocol_tpu_torch.topology.base import Topology, csr_from_edges

ROOT = Path(__file__).resolve().parent.parent


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


def _numpy_path(monkeypatch):
    monkeypatch.setenv("GOSSIP_TPU_NATIVE", "0")
    assert native.backend() == "numpy" and not native.available()


def _same_csr(a, b, where=""):
    assert (a.kind, a.num_nodes, a.implicit_full, a.asymmetric) == (
        b.kind, b.num_nodes, b.implicit_full, b.asymmetric), where
    if a.implicit_full:
        return
    for f in ("offsets", "indices"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (f, where)


@pytest.mark.parametrize("name", ["graphgen.cpp", "asyncsim.cpp"])
def test_host_sources_are_byte_copies(name):
    """The port compiles the JAX package's C++ sources, byte for byte."""
    assert (ROOT / "gossipprotocol_tpu_torch" / "csrc" / "host" /
            name).read_bytes() == (ROOT / "native" / name).read_bytes()


_FAMILIES = [("line", {}), ("full", {}), ("3D", {}), ("imp3D", {}),
             ("erdos_renyi", {"avg_degree": 6.0}), ("power_law", {"m": 3}),
             ("small_world", {"k": 4, "beta": 0.2})]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n", [30, 300])
@pytest.mark.parametrize("name,kw", _FAMILIES, ids=[f[0] for f in _FAMILIES])
def test_builders_native_numpy_and_jax_byte_equal(name, kw, n, seed,
                                                  monkeypatch):
    """Each family at small n and two seeds: the native build, the numpy
    build and the JAX package's build are the same bytes."""
    got = tx.build_topology(name, n, seed=seed, **kw)
    want = jx.build_topology(name, n, seed=seed, **kw)
    _same_csr(got, want, "native vs JAX")
    with monkeypatch.context() as m:
        _numpy_path(m)
        plain = tx.build_topology(name, n, seed=seed, **kw)
    _same_csr(got, plain, "native vs numpy")


@pytest.mark.parametrize("seed", [0, 3])
def test_csr_build_matches_numpy_on_a_multigraph(seed, monkeypatch):
    """Random edges with duplicates and self-loops: the same canonical
    CSR from the library and from numpy."""
    edges = np.random.default_rng(seed).integers(0, 500, size=(5000, 2))
    got = csr_from_edges(500, edges, kind="t")
    with monkeypatch.context() as m:
        _numpy_path(m)
        want = csr_from_edges(500, edges, kind="t")
    _same_csr(got, want)
    offsets, indices = native.csr_build(500, edges[:, 0], edges[:, 1])
    assert offsets.dtype == np.int64 and indices.dtype == np.int32
    assert np.array_equal(offsets, want.offsets)


def test_ba_edges_match_the_numpy_draws(monkeypatch):
    """The native Barabási–Albert list draws the numpy builder's stream:
    the same power-law graph at a size with several chunks."""
    got = tb.build_power_law(5000, m=4, seed=11)
    with monkeypatch.context() as m:
        _numpy_path(m)
        assert native.ba_edges(5000, 4, 11) is None
        want = tb.build_power_law(5000, m=4, seed=11)
    _same_csr(got, want)
    edges = native.ba_edges(5000, 4, 11)
    assert edges.shape == ((5 * 4) // 2 + (5000 - 5) * 4, 2)


@pytest.mark.parametrize("src,dst", [([0, 9], [1, 2]), ([-1, 0], [1, 2]),
                                     ([0, 1], [1, 4])])
def test_csr_build_refuses_out_of_range_edges(src, dst):
    with pytest.raises(ValueError, match="out of range"):
        native.csr_build(4, np.array(src), np.array(dst))


def test_ba_edges_refuses_a_bad_size():
    with pytest.raises(ValueError, match="invalid"):
        native.ba_edges(3, 4, 0)


def test_graphgen_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that refuses graphgen.cpp raises with its output, never
    a quiet numpy build."""
    monkeypatch.setattr(native, "_GRAPHGEN", native._Lib())
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(native.NativeBuildError, match="graphgen.cpp"):
        tx.build_topology("erdos_renyi", 50, seed=1)


def test_oracle_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_ASYNC", native._Lib())
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(native.NativeBuildError, match="asyncsim.cpp"):
        native.async_pushsum_hops(tx.build_topology("full", 8), seed=1)


def test_native_zero_reports_every_half_unavailable(monkeypatch):
    _numpy_path(monkeypatch)
    topo = tx.build_topology("line", 10)
    assert not native.async_available()
    assert native.async_pushsum_hops(topo, seed=1) is None
    assert native.async_gossip_events(topo, seed=1) is None
    assert native.csr_build(3, np.array([0]), np.array([1])) is None


def test_oracle_refuses_a_large_implicit_full_graph():
    with pytest.raises(ValueError, match="too large"):
        native.async_pushsum_hops(tx.build_topology("full", 20_001), seed=1)


# ---- the oracle against the JAX package's -----------------------------------

@pytest.mark.parametrize("n", [100, 343, 1000])
@pytest.mark.parametrize("name", ["line", "full", "3D", "imp3D"])
def test_oracle_counts_equal_jax(name, n, native_oracle):
    """Events, dispatcher cost and walk hops of the port's oracle equal
    the JAX package's, seeds 17-18, on the four reference topologies."""
    jtopo = jx.build_topology(name, n, seed=1)
    ttopo = tx.build_topology(name, n, seed=1)
    for seed in (17, 18):
        assert native.async_pushsum_hops(ttopo, seed=seed) == \
            native_oracle.async_pushsum_hops(jtopo, seed=seed)
        assert native.async_gossip_events(ttopo, seed=seed) == \
            native_oracle.async_gossip_events(jtopo, seed=seed)
        assert native.async_gossip_dispatch_cost(ttopo, seed=seed) == \
            native_oracle.async_gossip_dispatch_cost(jtopo, seed=seed)


@pytest.mark.parametrize("name,n,start", [("full", 32, 0), ("line", 48, 24),
                                          ("imp3D", 125, 0)])
def test_port_walk_hops_within_oracle_band(name, n, start, native_oracle):
    """The port's walk (``--device cpu``) draws with threefry and the
    oracle with splitmix64, so the check is distributional: each of three
    seeds inside the oracle's 25-seed min-max band, widened 2x (the JAX
    package's own test of its walk)."""
    topo = tx.build_topology(name, n, seed=1)
    oracle = [native.async_pushsum_hops(topo, seed=s, start_node=start)
              for s in range(25)]
    lo, hi = min(oracle) / 2, max(oracle) * 2
    for seed in range(3):
        res = tx.run_simulation(topo, tx.RunConfig(
            algorithm="push-sum", semantics="reference", seed=seed,
            seed_node=start, device="cpu"))
        assert res.converged
        assert lo <= res.rounds <= hi, (res.rounds, (lo, hi))


# ---- Topology.validate ------------------------------------------------------

def test_validate_accepts_every_family_and_the_quirk_graph():
    for name, kw in _FAMILIES:
        tx.build_topology(name, 64, seed=2, **kw).validate()
    tb.add_isolated_rows(tb.build_imp3d_reference_quirks(
        100, seed=0)).validate()


@pytest.mark.parametrize("offsets,indices,asym,match", [
    ([0, 2, 1, 3], [1, 2, 0], False, "monotone"),
    ([0, 1, 2, 3], [1, 5, 0], False, "out of range"),
    ([0, 1, 2, 3], [1, 1, 0], False, "self-loop"),
])
def test_validate_refuses_as_jax_does(offsets, indices, asym, match):
    """The same bad CSR fails both packages' ``validate`` with the same
    message."""
    off = np.array(offsets, np.int32)
    idx = np.array(indices, np.int32)
    t = Topology(kind="t", num_nodes=3, offsets=off, indices=idx,
                 asymmetric=asym)
    j = jx.Topology(kind="t", num_nodes=3, offsets=off, indices=idx,
                    asymmetric=asym)
    with pytest.raises(AssertionError, match=match):
        t.validate()
    with pytest.raises(AssertionError, match=match):
        j.validate()


def test_validate_exempts_quirk_self_loops():
    """An asymmetric (reference-quirk) build may hold self-loops."""
    off = np.array([0, 1, 2, 3], np.int32)
    idx = np.array([1, 1, 0], np.int32)
    Topology(kind="imp3D", num_nodes=3, offsets=off, indices=idx,
             asymmetric=True).validate()
    jb_topo = jb.build_imp3d_reference_quirks(27, seed=0)
    tb_topo = tb.build_imp3d_reference_quirks(27, seed=0)
    jb_topo.validate()
    tb_topo.validate()
