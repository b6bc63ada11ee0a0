"""PyTorch port, the device RNG and the neighbour pick
(protocols/sampling.py): threefry-2x32, ``key``, ``fold_in`` and the
per-node draw are bitwise the JAX package's (``jax.extend.random``,
``jax.random``, ``protocols/sampling.py``), and so are the three branches
of ``sample_neighbors`` (dense table, implicit complete graph, CSR) and
the host tables they read."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.extend.random as jexr
import jax.numpy as jnp

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.protocols import gossip as jg
from gossipprotocol_tpu.protocols import sampling as js

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.convert import neighbors_from_numpy
from gossipprotocol_tpu_torch.protocols import gossip as tg
from gossipprotocol_tpu_torch.protocols import sampling as ts


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


SEEDS = [0, 1, 42, 2**31 - 1]


def _u32(rng, n):
    return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _key(seed):
    return np.asarray(jax.random.key_data(jax.random.key(seed))).astype(
        np.int64)


def _threefry(k, c):
    """``jax.extend.random.threefry_2x32``'s layout over the port's block
    function: an even count's halves hash against each other."""
    half = c.numel() // 2
    y0, y1 = ts.threefry2x32_words(k[0], k[1], c[:half], c[half:])
    return torch.cat([y0, y1])


@pytest.mark.parametrize("length", [2, 1000, 4096])
@pytest.mark.parametrize("trial", range(3))
def test_threefry_bitwise(trial, length):
    rng = np.random.default_rng(trial * 100 + length)
    k, c = _u32(rng, 2), _u32(rng, length)
    want = np.asarray(jexr.threefry_2x32(jnp.asarray(k), jnp.asarray(c)))
    got = _threefry(_t(k), _t(c)).numpy()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_bitwise(seed):
    assert np.array_equal(ts.key_data(seed, device="cpu").numpy(),
                          _key(seed))


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def partitionable(request):
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_bitwise_under_either_setting(seed, partitionable):
    """``jax_threefry_partitionable`` (True on this jax) reaches ``split``
    and ``random_bits``, not the hash or ``fold_in``: both settings give
    the port's keys."""
    k = jax.random.key(seed)
    kt = ts.key_data(seed, device="cpu")
    for data in (0, 1, 7, 1000, 2**31 - 1):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(
            k, jnp.int32(data)))).astype(np.int64)
        assert np.array_equal(ts.fold_in(kt, data).numpy(), want)
    rng = np.random.default_rng(seed % 1000)
    c = _u32(rng, 64)
    want = np.asarray(jexr.threefry_2x32(jax.random.key_data(k),
                                         jnp.asarray(c)))
    assert np.array_equal(_threefry(kt, _t(c)).numpy(),
                          want.astype(np.int64))


def test_partitionable_setting_is_live():
    """The fixture's switch does change what it governs (``split``), so
    the test above compares two real settings."""
    k = jax.random.key(3)
    old = jax.config.jax_threefry_partitionable
    try:
        out = []
        for flag in (True, False):
            jax.config.update("jax_threefry_partitionable", flag)
            out.append(np.asarray(jax.random.key_data(
                jax.random.split(k, 4))))
    finally:
        jax.config.update("jax_threefry_partitionable", old)
    assert not np.array_equal(out[0], out[1])


@pytest.mark.parametrize("seed", SEEDS)
def test_round_keys_are_fold_ins(seed):
    kt = ts.key_data(seed, device="cpu")
    keys = ts.round_keys(kt, torch.tensor(5, dtype=torch.int32), 6)
    for i in range(6):
        assert torch.equal(keys[i], ts.fold_in(kt, 5 + i))


@pytest.mark.parametrize("seed", SEEDS)
def test_per_node_randint_bitwise(seed):
    rng = np.random.default_rng(seed % 997)
    gids = rng.integers(0, 2**31 - 1, 5000).astype(np.int32)
    maxval = rng.integers(1, 2**31 - 1, 5000).astype(np.int32)
    maxval[::3] = rng.integers(1, 40, maxval[::3].size)
    rk = jax.random.fold_in(jax.random.key(seed), 11)
    want = np.asarray(js._per_node_randint(rk, jnp.asarray(gids),
                                           jnp.asarray(maxval)))
    got = ts.per_node_randint(ts.fold_in(ts.key_data(seed, "cpu"), 11),
                              torch.from_numpy(gids),
                              torch.from_numpy(maxval))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


_GRAPHS = {
    "line": ("line", 300, {}),
    "3D": ("3D", 343, {}),
    "imp3D": ("imp3D", 512, {"seed": 2}),
    "er": ("erdos_renyi", 600, {"seed": 5}),
    "powerlaw": ("power_law", 500, {"seed": 3}),
}


def _topos(graph):
    name, n, kw = _GRAPHS[graph]
    return jx.build_topology(name, n, **kw), tx.build_topology(name, n, **kw)


def _nbrs_np(jn):
    return {f: np.asarray(getattr(jn, f)) for f in jn._fields}


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_host_tables_equal(graph):
    tj, tt = _topos(graph)
    assert ts.use_dense(tt) == js.use_dense(tj)
    for a, b in zip(ts.dense_table(tt), js.dense_table(tj)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for dense in (True, False):
        got = ts.device_topology(tt, dense=dense, device="cpu")
        want = js.device_topology(tj, dense=dense)
        assert got._fields == want._fields
        for f in got._fields:
            assert np.array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f)))


def _picks_equal(nt, nj, n, seed):
    for r in (0, 3, 17):
        rk = jax.random.fold_in(jax.random.key(seed), r)
        tj, vj = js.sample_neighbors(nj, n, rk)
        tt, vt = ts.sample_neighbors(
            nt, n, ts.fold_in(ts.key_data(seed, "cpu"), r))
        assert tt.dtype == torch.int32
        assert np.array_equal(tt.numpy(), np.asarray(tj))
        assert np.array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "csr"])
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_sample_neighbors_bitwise(graph, dense, seed):
    tj, tt = _topos(graph)
    nj = js.device_topology(tj, dense=dense)
    # the port's arrays carried across from the JAX package's, and its
    # own build, pick alike
    for nt in (neighbors_from_numpy(**_nbrs_np(nj), device="cpu"),
               ts.device_topology(tt, dense=dense, device="cpu")):
        _picks_equal(nt, nj, tt.num_nodes, seed)


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("n", [2, 300, 4096])
def test_sample_implicit_full_bitwise(n, seed):
    topo = tx.build_topology("full", n)
    assert ts.device_topology(topo, device="cpu") is None
    _picks_equal(None, None, n, seed)
    t, _ = ts.sample_neighbors(None, n, ts.fold_in(ts.key_data(seed, "cpu"),
                                                   1))
    assert not torch.any(t == torch.arange(n))   # never itself


@pytest.mark.parametrize("graph", ["line", "3D", "imp3D", "er"])
def test_recomputed_hits_bitwise(graph):
    tj, tt = _topos(graph)
    nj = jg.inverted_dense(tj)
    nt = tg.inverted_dense(tt, device="cpu")
    for f in nt._fields:
        assert np.array_equal(getattr(nt, f).numpy(),
                              np.asarray(getattr(nj, f)))
    for r in (0, 9):
        rk = jax.random.fold_in(jax.random.key(7), r)
        want = np.asarray(js.recomputed_hits(nj, rk))
        got = ts.recomputed_hits(nt, ts.fold_in(ts.key_data(7, "cpu"), r))
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("graph", ["er", "powerlaw"])
def test_send_valid_mask(graph):
    tj, tt = _topos(graph)
    nt = ts.device_topology(tt, device="cpu")
    want = np.asarray(js.send_valid_mask(js.device_topology(tj),
                                         tj.num_nodes))
    assert np.array_equal(ts.send_valid_mask(nt, tt.num_nodes).numpy(), want)
    assert ts.send_valid_mask(None, 10) is None


def test_neighbors_from_numpy_checks_bounds():
    bad = dict(table=np.array([[1], [5]]), degree=np.array([1, 1]))
    with pytest.raises(ValueError, match="outside"):
        neighbors_from_numpy(**bad, device="cpu")
    with pytest.raises(ValueError, match="index pool"):
        neighbors_from_numpy(starts=np.array([0, 2]), degree=np.array([1, 1]),
                             indices=np.array([1, 0]), device="cpu")
