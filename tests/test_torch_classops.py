"""PyTorch port, degree-class folds (ops/classops.py): the plain PyTorch
bodies the port runs on the CPU are bitwise equal to the JAX package's
Pallas kernels (run in interpret mode, as its own tests run them).

Inputs are normal floats of mixed magnitude (exponents 2^-40..2^40, signed
zeros). Subnormal sums are the one recorded divergence (ROADMAP.md
Queue 3): this XLA CPU build flushes them to zero, the port keeps them as
IEEE arithmetic does — pinned here against a numpy replay of the tree."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gossipprotocol_tpu.ops import classops as jco
from gossipprotocol_tpu_torch.ops import classops as tco


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


def _mixed(rng, n):
    mant = rng.standard_normal(n).astype(np.float32)
    x = (mant * np.exp2(rng.integers(-40, 40, n))).astype(np.float32)
    x[rng.random(n) < 0.05] = 0.0
    x[rng.random(n) < 0.05] = -0.0
    return x


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                 b.view(np.uint32))


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16, 32, 64])
def test_reduce_small_bitwise_vs_jax(c):
    x = _mixed(np.random.default_rng(c), tco.BLK * tco.LANES)
    want = jco.class_reduce_small(jnp.asarray(x), c, interpret=True)
    got = tco.class_reduce_small(torch.from_numpy(x), c)
    assert got.shape == (tco.BLK * tco.LANES // c,)
    assert _bits_equal(got.numpy(), want)


# q = 33 and 257: the card's split kernel packs whole slots into a block
# (q < 64) or spreads one over several (q > 64), with ragged ends
@pytest.mark.parametrize("q,cap", [(2, 8), (2, 256), (8, 8), (8, 256),
                                   (33, 8), (257, 16)])
def test_reduce_split_bitwise_vs_jax(q, cap):
    c = 64 * q
    x = _mixed(np.random.default_rng(q * 1000 + cap), q * cap * tco.LANES)
    want = jco.class_reduce_split(jnp.asarray(x), c, interpret=True)
    got = tco.class_reduce_split(torch.from_numpy(x), c)
    assert got.shape == (2 * cap,)
    assert _bits_equal(got.numpy(), want)


def _numpy_tree(x, c):
    """The roll tree replayed in numpy float32 (IEEE, subnormals kept)."""
    acc = x.reshape(-1, 128).copy()
    sh = 2
    while sh < 2 * c:
        acc = acc + np.roll(acc, -sh, axis=1)
        sh *= 2
    col = np.arange(128)
    idx = ((col // 2) * 2 * c + col % 2) % 128
    return np.take_along_axis(acc, np.broadcast_to(idx, acc.shape),
                              axis=1)[:, : 128 // c].reshape(-1)


@pytest.mark.parametrize("c", [2, 4, 8])
def test_reduce_small_keeps_subnormals(c):
    x = np.zeros(tco.BLK * tco.LANES, np.float32)
    x[::7] = np.float32(3e-39)
    x[1::5] = np.float32(-1.5e-39)
    x[2::11] = 1.0
    got = tco.class_reduce_small(torch.from_numpy(x), c).numpy()
    assert _bits_equal(got, _numpy_tree(x, c))
    assert np.any((got != 0) & (np.abs(got) < np.finfo(np.float32).tiny))


def test_split_left_fold_order():
    # partials that differ in magnitude make the j order observable:
    # ((big + 1) + -big) is 0 in f32, (big + (1 + -big)) is not
    q, cap = 3, 8
    x = np.zeros((q, cap, 128), np.float32)
    x[0, :, 0] = 2.0 ** 30
    x[1, :, 0] = 1.0
    x[2, :, 0] = -(2.0 ** 30)
    got = tco.class_reduce_split(torch.from_numpy(x.reshape(-1)), 64 * q)
    want = jco.class_reduce_split(jnp.asarray(x.reshape(-1)), 64 * q,
                                  interpret=True)
    assert _bits_equal(got.numpy(), want)
    assert float(got[0]) == 0.0


@pytest.mark.parametrize("c", [128, 1024, 65_536, 131_072])
def test_reduce_big_bitwise_vs_jax(c):
    """q = 2 .. 2048 rows per node: one block of rows, and two (q = 2048);
    the rows of a block summed in XLA CPU's windowed order."""
    q = 2 * c // tco.LANES
    n_c = max(1, min(5, 4096 // q))
    x = np.random.default_rng(c).standard_normal(
        n_c * q * tco.LANES).astype(np.float32)
    want = jco.class_reduce_big(jnp.asarray(x), c, interpret=True)
    got = tco.class_reduce_big(torch.from_numpy(x), c)
    assert got.shape == (2 * n_c,)
    assert _bits_equal(got.numpy(), want)


@pytest.mark.parametrize("q", [3, 48, 300])
def test_reduce_big_window_padding_vs_jax(q):
    """Row counts that are no whole number of 32-row windows: XLA pads
    the rows on both sides, which shifts every window's bounds."""
    x = _mixed(np.random.default_rng(q), 2 * q * tco.LANES)
    want = jco.class_reduce_big(jnp.asarray(x), 64 * q, interpret=True)
    got = tco.class_reduce_big(torch.from_numpy(x), 64 * q)
    assert _bits_equal(got.numpy(), want)


def test_reduce_big_order_is_not_a_left_fold():
    """The windowed order is observable: a plain left fold over the rows
    of a 1024-row block differs from the JAX package's result."""
    q = 1024
    x = np.random.default_rng(0).standard_normal(q * tco.LANES).astype(
        np.float32)
    want = np.asarray(jco.class_reduce_big(jnp.asarray(x), 64 * q,
                                           interpret=True))
    rows = tco._roll_fold_rows(torch.from_numpy(x).reshape(-1, tco.LANES))
    left = rows[0]
    for r in range(1, q):
        left = left + rows[r]
    assert not _bits_equal(left.numpy(), want)


@pytest.mark.parametrize("c", [128, 1024, 65_536, 131_072])
def test_expand_big_bitwise_vs_jax(c):
    n_c = 3
    p = _mixed(np.random.default_rng(c + 1), 2 * n_c)
    want = jco.class_expand_big(jnp.asarray(p), c, interpret=True)
    got = tco.class_expand_big(torch.from_numpy(p), c)
    assert got.shape == (n_c * 2 * c,)
    assert _bits_equal(got.numpy(), want)


# ---- class_expand_big's launch geometry (expand_big_kernel) ------------

H100_SMS = 132


def _expand_big_walk(n_c, q, blocks):
    """``(output float4, node)`` of every store of ``expand_big_kernel``:
    thread i of the grid stores float4 i, i + step, ...; its node is
    ``o >> log2(32q)`` where q is a power of two, else carried by the
    launcher's increments after one 32-bit division (the kernel's
    arithmetic, replayed)."""
    span = 32 * q
    n4 = n_c * span
    step = blocks * tco.EXPAND_BIG_THREADS
    first = np.arange(step, dtype=np.int64)
    pow2 = q & (q - 1) == 0
    span32 = min(span, 2**31)
    node, rem = first // span32, first % span32
    outs, nodes = [], []
    o = first
    while (o < n4).any():
        live = o < n4
        outs.append(o[live])
        nodes.append((o >> (span.bit_length() - 1) if pow2 else node)[live])
        o = o + step
        node, rem = node + step // span, rem + step % span
        node, rem = (np.where(rem >= span, node + 1, node),
                     np.where(rem >= span, rem - span, rem))
    return np.concatenate(outs), np.concatenate(nodes)


# c = 512 at power_law 1M's cap (1,024 nodes, q 8) and its 776 real nodes,
# c = 131,072 (cap 8, q 2,048), q 1, q 3 (not a power of two), one node,
# and more float4 than one wave of blocks covers (q 4,096 over 10 nodes,
# and q 3 over 3,000: the grid walks on)
@pytest.mark.parametrize("q,n_c", [(8, 1024), (8, 776), (2048, 8), (1, 200),
                                   (3, 50), (8, 1), (4096, 10), (3, 3000)])
def test_expand_big_geometry_covers_every_output_once(q, n_c):
    n4 = n_c * q * 32
    blocks = tco.expand_big_geometry(n4, H100_SMS)
    assert blocks <= tco.EXPAND_BIG_BLOCKS_PER_SM * H100_SMS   # one wave
    assert blocks * tco.EXPAND_BIG_THREADS >= min(
        n4, tco.EXPAND_BIG_BLOCKS_PER_SM * H100_SMS * tco.EXPAND_BIG_THREADS)
    out, node = _expand_big_walk(n_c, q, blocks)
    assert out.size == n4
    assert np.array_equal(np.sort(out), np.arange(n4))
    assert np.array_equal(node, out // (32 * q))


@pytest.mark.parametrize("q,n_c", [(8, 40), (3, 7), (1, 9), (16, 1)])
def test_expand_big_walk_replays_the_plain_version(q, n_c):
    """The kernel's store, the pair of the walked node as (s, w, s, w),
    equals the plain version bitwise."""
    p = _mixed(np.random.default_rng(q * n_c), 2 * n_c)
    out, node = _expand_big_walk(n_c, q,
                                 tco.expand_big_geometry(n_c * q * 32,
                                                         H100_SMS))
    got = np.empty((n_c * q * 32, 4), np.float32)
    pairs = p.reshape(-1, 2)
    got[out] = pairs[node][:, [0, 1, 0, 1]]
    want = tco.class_expand_big_plain(torch.from_numpy(p), 64 * q)
    assert _bits_equal(got.reshape(-1), want.numpy())


@pytest.mark.parametrize("sms", [1, 8, 16, 132])
def test_expand_big_geometry_on_other_cards(sms):
    for q, n_c in ((8, 1024), (2048, 8), (3, 50)):
        n4 = n_c * q * 32
        blocks = tco.expand_big_geometry(n4, sms)
        assert 1 <= blocks <= tco.EXPAND_BIG_BLOCKS_PER_SM * sms
        out, node = _expand_big_walk(n_c, q, blocks)
        assert np.array_equal(np.sort(out), np.arange(n4))
        assert np.array_equal(node, out // (32 * q))


@pytest.mark.parametrize("fn,arg", [
    (tco.class_reduce_small, 3),          # 2c does not divide 128
    (tco.class_reduce_split, 32),         # 2c < 128 is not a hub class
])
def test_bad_geometry_raises(fn, arg):
    with pytest.raises(ValueError):
        fn(torch.zeros(tco.BLK * tco.LANES), arg)


def test_cpu_path_launches_nothing_and_other_devices_raise():
    before = dict(tco.LAUNCHES)
    tco.class_reduce_small(torch.zeros(tco.BLK * tco.LANES), 4)
    tco.class_reduce_split(torch.zeros(2 * 8 * tco.LANES), 128)
    tco.class_reduce_big(torch.zeros(2 * 2 * tco.LANES), 128)
    tco.class_expand_big(torch.zeros(4), 128)
    assert tco.LAUNCHES == before
    for fn, arg in ((tco.class_reduce_big, torch.empty(2 * tco.LANES,
                                                       device="meta")),
                    (tco.class_expand_big, torch.empty(2, device="meta"))):
        with pytest.raises(ValueError, match="no kernel"):
            fn(arg, 128)
    meta = torch.empty(tco.BLK * tco.LANES, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tco.class_reduce_small(meta, 4)
    with pytest.raises(ValueError, match="no kernel"):
        tco.class_reduce_split(torch.empty(2 * 8 * tco.LANES, device="meta"),
                               128)


# ---- class_reduce_split on the values where a fold's start and order
# show: all -0.0, +-inf, NaN ----------------------------------------------

def _special_region(kind, q, cap):
    rng = np.random.default_rng(q + cap)
    if kind == "negzero":
        return np.full(q * cap * tco.LANES, -0.0, np.float32)
    x = rng.standard_normal((q, cap, tco.LANES)).astype(np.float32)
    x[rng.integers(0, q), 0, 4] = np.inf           # slot 0: +inf in s
    x[rng.integers(0, q), 1, 5] = -np.inf          # slot 1: -inf in w
    x[rng.integers(0, q), 2, 6] = np.inf           # slot 2: +inf - inf
    x[rng.integers(0, q), 2, 8] = -np.inf          #   = NaN in s
    x[rng.integers(0, q), 3, 9] = np.nan           # slot 3: NaN in w
    return x.reshape(-1)


@pytest.mark.parametrize("kind", ["negzero", "inf_nan"])
@pytest.mark.parametrize("q,cap", [(2, 8), (33, 8)])
def test_reduce_split_special_values_vs_jax(kind, q, cap):
    x = _special_region(kind, q, cap)
    want = np.asarray(jco.class_reduce_split(jnp.asarray(x), 64 * q,
                                             interpret=True))
    got = tco.class_reduce_split(torch.from_numpy(x), 64 * q).numpy()
    assert _bits_equal(got, want)
    if kind == "negzero":
        # the left fold starts at p_0 = -0.0: every sum stays -0.0
        assert np.all(got == 0) and np.all(np.signbit(got))
    else:
        assert got[0] == np.inf and got[3] == -np.inf
        assert np.isnan(got[4]) and np.isnan(got[7])
