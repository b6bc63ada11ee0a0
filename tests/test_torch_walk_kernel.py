"""PyTorch port, the host side of the walk kernel (``ops/walk.py``,
``csrc/walk.cu``) on the CPU: the kernel cannot run here, so what it
computes is replayed on the host and held to the plain chunk
(``protocols/walk.py`` ``walk_chunk_plain``) — the per-hop words under
both ``jax_threefry_partitionable`` settings, the draw, the layouts it is
given, and the walker itself on dense, CSR and complete graphs, for
chunks that converge, stop at a quorum and start trapped. The kernel
against the plain chunk on the card: ``tests/test_torch_kernels_cuda.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.engine import driver as tdriver
from gossipprotocol_tpu_torch.ops import walk as ow
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


@pytest.mark.parametrize("partitionable", [True, False],
                         ids=["partitionable", "original"])
@pytest.mark.parametrize("seed,first", [(0, 0), (7, 5), (123456789, 4093),
                                        (2**32 - 1, 2**31 - 3000)])
def test_hop_words_equal_randint_words(seed, first, partitionable):
    """The kernel's words for a run of hops across tile borders equal
    ``randint_words(round_keys(...))``, the plain chunk's."""
    key = ts.key_data(seed, "cpu")
    hi, lo = ts.randint_words(
        ts.round_keys(key, torch.tensor(first, dtype=torch.int32), 2500),
        partitionable)
    khi, klo = ow.hop_words((0, seed), first + np.arange(2500),
                            partitionable)
    assert khi.dtype == np.uint32 and klo.dtype == np.uint32
    assert np.array_equal(hi.numpy(), khi.astype(np.int64))
    assert np.array_equal(lo.numpy(), klo.astype(np.int64))


def test_draw_in_equals_randint_from_words():
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    spans = np.concatenate([
        [1, 2, 3, 7, 65536, 65537, 2**31 - 1, 2**24, 999_999],
        rng.integers(1, 2**31, 20000 - 9)])
    want = ts.randint_from_words(torch.from_numpy(hi.astype(np.int64)),
                                 torch.from_numpy(lo.astype(np.int64)),
                                 torch.from_numpy(spans))
    got = ow.draw_in(hi, lo, spans)
    assert np.array_equal(want.numpy(), got.astype(np.int64))


def _nbrs(layout, topo):
    if layout == "full":
        return None
    return ts.device_topology(topo, dense=(layout == "dense"), device="cpu")


def test_walk_layout_flattens_each_table():
    topo = tx.build_topology("imp3D", 125, seed=1)
    dense = ts.device_topology(topo, dense=True, device="cpu")
    lay = ow.walk_layout(dense, 125)
    assert lay.layout == ow.LAYOUT_DENSE and lay.starts is None
    assert lay.row_width == dense.table.shape[1]
    assert torch.equal(lay.flat, dense.table.reshape(-1))
    csr = ts.device_topology(topo, dense=False, device="cpu")
    lay = ow.walk_layout(csr, 125)
    assert lay.layout == ow.LAYOUT_CSR
    assert torch.equal(lay.flat, csr.indices)
    assert torch.equal(lay.starts, csr.starts)
    from gossipprotocol_tpu_torch.protocols.gossip import inverted_dense

    inv = inverted_dense(topo, device="cpu")
    assert ow.walk_layout(inv, 125).layout == ow.LAYOUT_DENSE
    full = ow.walk_layout(None, 50)
    assert full.layout == ow.LAYOUT_FULL and full.flat is None


@pytest.mark.parametrize("bad,match", [
    (lambda d: d._replace(degree=d.degree.long()), "degree"),
    (lambda d: d._replace(table=d.table.long()), "table"),
    (lambda d: d._replace(degree=d.degree[:-1]), "degree"),
    (lambda d: ts.CSRNeighbors(starts=d.degree, degree=d.degree,
                               indices=d.table.reshape(-1)), "starts"),
])
def test_walk_layout_refuses_what_the_kernel_cannot_take(bad, match):
    topo = tx.build_topology("3D", 27)
    dense = ts.device_topology(topo, dense=True, device="cpu")
    with pytest.raises(ValueError, match=match):
        ow.walk_layout(bad(dense), 27)
    with pytest.raises(ValueError, match="n >= 2"):
        ow.walk_layout(None, 1)


def test_walk_chunk_refuses_cpu_tensors():
    """The kernel's wrapper never runs a CPU tensor (the plain chunk is
    the CPU path), and raises instead."""
    st = tw.pushsum_walk_init(27, 0, device="cpu")
    lay = ow.walk_layout(None, 27)
    with pytest.raises(ValueError, match="CUDA"):
        ow.walk_chunk(lay, st, ts.key_data(0, "cpu"), 10, 27, 3)


def _replay(topo, layout, hops, seed, start=0, quorum=None, streak=3):
    n = topo.num_nodes
    nbrs = _nbrs(layout, topo)
    key = ts.key_data(seed, "cpu")
    st = tw.pushsum_walk_init(n, start, device="cpu")
    q = n if quorum is None else quorum
    plain = tw.walk_chunk_plain(tw.WalkDraws(nbrs, n, key.device), st, key,
                                hops, q, streak)
    lay = ow.walk_layout(nbrs, n)

    def arr(t):
        return None if t is None else t.numpy()

    got = {f: getattr(st, f).numpy().copy() for f in st._fields}
    settled = ow.walk_chunk_replay(lay.layout, arr(lay.degree),
                                   arr(lay.starts), arr(lay.flat),
                                   lay.row_width, n, got, (0, seed), hops, q,
                                   streak)
    return plain, got, settled


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


_CASES = {
    # converging chunks on each layout (several tiles of 1,024 hops)
    "dense imp3D": (lambda: tx.build_topology("imp3D", 125, seed=1),
                    "dense", 3000, 3, {}),
    "csr imp3D": (lambda: tx.build_topology("imp3D", 125, seed=1), "csr",
                  3000, 3, {}),
    "csr power_law": (lambda: tx.build_topology("power_law", 200, seed=2),
                      "csr", 2500, 5, {}),
    "full": (lambda: tx.build_topology("full", 60), "full", 3000, 4, {}),
    "dense line, streak 4": (lambda: tx.build_topology("line", 16), "dense",
                             2100, 6, {"streak": 4}),
    # stops at a quorum short of every node
    "dense line quorum": (lambda: tx.build_topology("line", 30), "dense",
                          2500, 5, {"quorum": 29}),
    "full quorum": (lambda: tx.build_topology("full", 41), "full", 2000, 1,
                    {"quorum": 40}),
    # the reference population: quirk graph plus an isolated row
    "quirk graph": (lambda: tb.add_isolated_rows(
        tb.build_imp3d_reference_quirks(100, seed=0)), "dense", 2500, 2, {}),
    # starts trapped on an edge-less row: hops counted, nothing moves
    "trapped dense": (lambda: tb.add_isolated_rows(tx.build_topology(
        "line", 20)), "dense", 1500, 2, {"start": 20}),
    "trapped csr": (lambda: tb.add_isolated_rows(tx.build_topology(
        "line", 20)), "csr", 50, 2, {"start": 20}),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_kernel_replay_equals_plain_chunk(case):
    """``csrc/walk.cu``'s walker, replayed on the host, ends in the plain
    chunk's state bit for bit: every node array, the hop count, the
    token's position and message, the settled count."""
    build, layout, hops, seed, kw = _CASES[case]
    topo = build()
    plain, got, settled = _replay(topo, layout, hops, seed, **kw)
    for f in ("s", "w", "ratio", "streak", "converged"):
        a, b = getattr(plain, f).numpy(), got[f]
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b)), f
    assert int(plain.round) == got["round"]
    assert int(plain.cur) == got["cur"]
    assert _bits(np.float32(plain.msg_s)) == _bits(np.float32(got["msg_s"]))
    assert _bits(np.float32(plain.msg_w)) == _bits(np.float32(got["msg_w"]))
    assert settled == int(torch.sum(plain.converged | ~plain.alive))
    if case.startswith("trapped"):
        assert got["round"] == hops and got["cur"] == kw["start"]
    elif "quorum" in case:
        assert settled == kw["quorum"] and got["round"] < hops


def test_cpu_runs_launch_no_kernel():
    """On the CPU the engine's walk runs the plain chunk: the kernel's
    count stays where it was."""
    before = ow.LAUNCHES["walk_chunk"]
    res = tx.run_simulation(tx.build_topology("imp3D", 64, seed=1),
                            tx.RunConfig(algorithm="push-sum",
                                         semantics="reference",
                                         device="cpu"))
    assert res.converged and ow.LAUNCHES["walk_chunk"] == before


@pytest.mark.parametrize("name,n", [("imp3D", 125), ("line", 20),
                                    ("full", 40)])
def test_chunk_size_changes_no_run(name, n):
    """The walk's result is the same for every chunk size — the hops
    freeze once the quorum is met — so the default chunk
    (``WALK_CHUNK_HOPS``) prints the same rounds as any other."""
    topo = tx.build_topology(name, n, seed=1)
    runs = [tx.run_simulation(topo, tx.RunConfig(
        algorithm="push-sum", semantics="reference", seed=3,
        chunk_rounds=c, device="cpu"))
        for c in (1, 97, None, tdriver.WALK_CHUNK_HOPS * 3)]
    for r in runs[1:]:
        assert r.converged and r.rounds == runs[0].rounds
        for f in r.final_state._fields:
            assert torch.equal(getattr(r.final_state, f),
                               getattr(runs[0].final_state, f)), f
