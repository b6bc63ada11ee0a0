"""PyTorch port, the measurement probes (ops/probes.py and the probes/
entry points) against the JAX package's probe scripts on the CPU.

The JAX probes' kernels run in Pallas interpret mode: ``make_kernel`` of
``experiments/tile_perm_probe.py`` imported by path, and the slab,
contig, ``g0``, ``g1`` and ``grid_call`` bodies, which the scripts define
inside ``main()``, copied here verbatim from the probe text. The port's
plain versions (what its wrappers run for a CPU tensor, and what
``chip_smoke.py`` holds each CUDA kernel to on the card) must equal them
bitwise: every kernel only copies, doubles or gathers. The host routing of
the tile permutation (a verbatim copy in the port) must give the JAX
probe's planes; one tile takes ~10 s to route per side, so it is routed
once in a module fixture."""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gossipprotocol_tpu_torch.ops import probes as pr
from gossipprotocol_tpu_torch.probes import (
    ProbeMismatch, check_plain, route_probe, slab_probe, tile_perm_probe,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent


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


def _jax_probe(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(port: torch.Tensor, jax_out) -> bool:
    j = np.asarray(jax_out)
    return port.shape == j.shape and np.array_equal(_bits(port.numpy()),
                                                    _bits(j))


def _bits_equal_torch(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---- slab_probe.py: slab_kernel (:73), contig_kernel (:94) --------------

@pytest.mark.parametrize("t,b,cr", [(3, 102, 1), (2, 16, 8), (1, 1, 128)])
def test_slab_plain_equals_jax_interpret(t, b, cr):
    T, B, CR = t, b, cr
    x_np = _randn(t, T, 128, 128)

    # verbatim from experiments/slab_probe.py:main
    def slab_kernel(x_ref, o_ref):
        tile = x_ref[0] * 2.0
        # write the tile's rows as B runs of CR rows (first B*CR rows are
        # real content here; the layout cost is what we measure)
        o_ref[:, 0] = tile[: B * CR].reshape(B, 1, CR, 128)[:, 0]

    slab = pl.pallas_call(
        slab_kernel,
        grid=(T,),
        out_shape=jax.ShapeDtypeStruct((B, T, CR, 128), jnp.float32),
        in_specs=[pl.BlockSpec((1, 128, 128), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((B, 1, CR, 128), lambda i: (0, i, 0, 0)),
        interpret=True,
    )

    def contig_kernel(x_ref, o_ref):
        o_ref[0] = (x_ref[0] * 2.0)[: B * CR].reshape(B, CR, 128)

    contig = pl.pallas_call(
        contig_kernel,
        grid=(T,),
        out_shape=jax.ShapeDtypeStruct((T, B, CR, 128), jnp.float32),
        in_specs=[pl.BlockSpec((1, 128, 128), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, B, CR, 128), lambda i: (i, 0, 0, 0)),
        interpret=True,
    )
    x = torch.from_numpy(x_np)
    assert _same(pr.probe_slab(x, b, cr, True), slab(jnp.asarray(x_np)))
    assert _same(pr.probe_slab(x, b, cr, False), contig(jnp.asarray(x_np)))


# ---- route_probe.py: copy_kernel (:158, :240), g0 (:180), g1 (:202),
# ---- grid_call (:216) ----------------------------------------------------

def copy_kernel(x_ref, o_ref):
    o_ref[:] = x_ref[:] * 2.0


@pytest.mark.parametrize("rows", [8, 64])
def test_resident_copy_plain_equals_jax_interpret(rows):
    x_np = _randn(rows, rows, 128)
    x_np[0, :3] = [-0.0, np.inf, 3e38]
    xb = jnp.asarray(x_np)
    y = pl.pallas_call(
        copy_kernel,
        out_shape=jax.ShapeDtypeStruct(xb.shape, xb.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(xb)
    assert _same(pr.probe_scale2(torch.from_numpy(x_np)), y)


def test_stream_copy_plain_equals_jax_interpret():
    big_rows = 4 * 1024
    x_np = _randn(5, big_rows, 128)
    stream_call = pl.pallas_call(
        copy_kernel,
        grid=(big_rows // 1024,),
        out_shape=jax.ShapeDtypeStruct((big_rows, 128), jnp.float32),
        in_specs=[pl.BlockSpec((1024, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1024, 128), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )
    assert _same(pr.probe_scale2(torch.from_numpy(x_np), 1024),
                 stream_call(jnp.asarray(x_np)))


@pytest.mark.parametrize("rows", [8, 256])
def test_dim0_gather_plain_equals_jax_interpret(rows):
    rng = np.random.default_rng(rows)
    x_np = _randn(rows + 1, rows, 128)
    i_np = rng.integers(0, rows, size=(rows, 128)).astype(np.int32)
    xg, ig = jnp.asarray(x_np), jnp.asarray(i_np)

    def g0(x_ref, i_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=0)

    y = pl.pallas_call(
        g0,
        out_shape=jax.ShapeDtypeStruct((rows, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(xg, ig)
    assert _same(pr.probe_gather_rows(torch.from_numpy(x_np),
                                      torch.from_numpy(i_np)), y)


# ---- the launch geometry of rows 15, 16 and 19 (csrc/probes.cu) --------
#
# The wrappers pick the kernels' grids by size on the host; the index walks
# below replay the kernels' own arithmetic, so the CPU can check that every
# output is written exactly once at the default shapes and at the edges.

H100_SMS, H100_L2 = 132, 50 * 2**20
MIB = 2**20


def _scale2_walk(n4, blocks):
    """Float4 indices ``scale2_kernel``'s threads visit (grid-stride)."""
    step = blocks * pr.SCALE2_THREADS
    first = np.arange(step, dtype=np.int64)
    walk = np.concatenate([first + k * step
                           for k in range(max(1, -(-n4 // step)))])
    return walk[walk < n4]


@pytest.mark.parametrize("rows,stream", [
    (1, False), (7, False), (3000, False),
    (2 * MIB // 512, False), (4 * MIB // 512, False), (8 * MIB // 512, False),
    (12 * MIB // 512, False), (16 * MIB // 512, False),
    (64 * MIB // 512, True), (64 * MIB // 512 + 1, True)])
def test_scale2_geometry_covers_every_float4_once(rows, stream):
    n4 = rows * 128 // 4
    blocks, streamed = pr.scale2_geometry(n4, H100_SMS, H100_L2)
    assert streamed == stream
    # streamed: one float4 a thread, no stride; resident: one wave at most
    cover = -(-n4 // pr.SCALE2_THREADS)
    assert blocks == (cover if stream else
                      min(cover, pr.SCALE2_BLOCKS_PER_SM * H100_SMS))
    walk = _scale2_walk(n4, blocks)
    assert walk.size == n4
    assert np.array_equal(np.sort(walk), np.arange(n4))


def _gather_rows_walk(rows, chunk_rows):
    """Output float4 indices ``gather_rows_kernel``'s blocks write."""
    parts = []
    for b in range(-(-rows // chunk_rows) * pr.GATHER_BANDS):
        band4 = (b % pr.GATHER_BANDS) * 4
        r0 = (b // pr.GATHER_BANDS) * chunk_rows
        e = np.arange((min(rows, r0 + chunk_rows) - r0) * 4)
        parts.append((r0 + e // 4) * 32 + band4 + e % 4)
    return np.concatenate(parts)


@pytest.mark.parametrize("rows", [1, 7, 8, 100, 256, 1000, 1024, 4096,
                                  5000])
def test_gather_rows_geometry_covers_every_output_once(rows):
    chunk = pr.gather_rows_geometry(rows, H100_SMS)
    blocks = -(-rows // chunk) * pr.GATHER_BANDS
    assert blocks <= H100_SMS          # one wave, one block an SM
    walk = _gather_rows_walk(rows, chunk)
    assert walk.size == rows * 32
    assert np.array_equal(np.sort(walk), np.arange(rows * 32))


@pytest.mark.parametrize("rows", [1, 7, 1000, 4096])
def test_gather_rows_walk_replays_the_plain_version(rows):
    """The kernel's arithmetic (column ``o % 32 * 4 + j`` of source row
    ``idx``), replayed over its walk, equals ``torch.gather`` bitwise."""
    x = _randn(rows, rows, 128)
    idx = np.random.default_rng(rows + 1).integers(
        0, rows, (rows, 128)).astype(np.int32)
    o = _gather_rows_walk(rows, pr.gather_rows_geometry(rows, H100_SMS))
    out = np.empty(rows * 128, np.float32)
    for j in range(4):
        flat = o * 4 + j
        out[flat] = x.reshape(-1)[(o % 32) * 4 + j
                                  + idx.reshape(-1)[flat].astype(np.int64)
                                  * 128]
    want = pr.probe_gather_rows_plain(torch.from_numpy(x),
                                      torch.from_numpy(idx))
    assert _bits_equal_torch(torch.from_numpy(out.reshape(rows, 128)), want)


@pytest.mark.parametrize("sms", [1, 8, 16, 132])
def test_gather_rows_geometry_on_other_cards(sms):
    for rows in (1, 4096):
        chunk = pr.gather_rows_geometry(rows, sms)
        assert chunk >= 1
        assert -(-rows // chunk) <= max(1, sms // pr.GATHER_BANDS)


# ---- the launch geometry of rows 17 and 18 (gather_lanes_kernel) -------

H100_SMEM = 232_448       # shared memory an H100 block may opt into


def _gather_lanes_walk(rows, cols, rpb, threads):
    """``(output float4, source row)`` of every float4 that
    ``gather_lanes_kernel``'s threads write: thread t of block b starts at
    float4 t of the block's rows, steps by ``threads``, and carries its row
    by the kernel's increments (no division after the first)."""
    c4 = cols // 4
    blocks = -(-rows // rpb)
    b = np.arange(blocks)[:, None]
    t = np.arange(threads)[None, :]
    n = np.minimum(rpb, rows - b * rpb) * c4
    r, c = t // c4, t % c4
    dr, dc = threads // c4, threads % c4
    outs, srcs = [], []
    for step in range(-(-rpb * c4 // threads)):
        e = t + step * threads
        live = np.broadcast_to(e < n, (blocks, threads))
        outs.append((b * rpb * c4 + e)[live])
        srcs.append(np.broadcast_to(b * rpb + r, live.shape)[live])
        r, c = r + dr, c + dc
        r, c = np.where(c >= c4, r + 1, r), np.where(c >= c4, c - c4, c)
    return np.concatenate(outs), np.concatenate(srcs)


# rows 17 ([128, 128 / 512 / 4,096]) and 18 ([15 * 4,096, 128]), and the
# edges: 4, 132 and 4,100 lanes, 1 and 7 rows, a last group of rows cut
# short (1,001 rows in groups of 4, 7 rows of 132 lanes in groups of 3), a
# row beyond the shared memory
@pytest.mark.parametrize("rows,cols", [
    (128, 128), (128, 512), (128, 4096), (61440, 128), (1, 4), (7, 4),
    (7, 132), (1, 4100), (7, 4100), (1, 128), (1001, 128), (2, 60000)])
def test_gather_lanes_geometry_covers_every_output_once(rows, cols):
    rpb, threads, staged = pr.gather_lanes_geometry(rows, cols, H100_SMS,
                                                    H100_SMEM)
    fits = cols * 4 <= H100_SMEM
    assert staged == (fits and cols > 128)
    assert threads % 32 == 0 and 32 <= threads <= 1024
    if fits:
        assert rpb * cols * 4 <= H100_SMEM
    else:
        assert rpb == 1
    out, src = _gather_lanes_walk(rows, cols, rpb, threads)
    assert out.size == rows * cols // 4
    assert np.array_equal(np.sort(out), np.arange(out.size))
    # the carried row is the output's own row
    assert np.array_equal(src, out // (cols // 4))


def test_gather_lanes_geometry_at_the_timed_shapes():
    """What the kernel runs at the probe's shapes: 4 rows of 128 lanes a
    block read in place, one staged row of 512 (one float4 a thread), one
    staged row of 4,096 on 256 threads (four float4 each), 8 rows of the
    tiled call's 128 lanes read in place (more than a wave of outputs)."""
    g = lambda r, c: pr.gather_lanes_geometry(r, c, H100_SMS, H100_SMEM)  # noqa: E731
    assert g(128, 128) == (4, 128, False)
    assert g(128, 512) == (1, 128, True)
    assert g(128, 4096) == (1, 256, True)
    assert g(15 * 4096, 128) == (8, 256, False)
    assert g(2, 60000) == (1, 1024, False)


@pytest.mark.parametrize("rows,cols", [(128, 128), (7, 132), (1, 4100),
                                       (1001, 128), (3, 60000)])
def test_gather_lanes_walk_replays_the_plain_version(rows, cols):
    """The kernel's arithmetic (lane ``idx`` of the carried row), replayed
    over its walk, equals ``torch.gather`` bitwise."""
    x = _randn(rows + cols, rows, cols)
    idx = np.random.default_rng(cols).integers(
        0, cols, (rows, cols)).astype(np.int32)
    rpb, threads, _ = pr.gather_lanes_geometry(rows, cols, H100_SMS,
                                               H100_SMEM)
    o, r = _gather_lanes_walk(rows, cols, rpb, threads)
    out = np.empty(rows * cols, np.float32)
    for j in range(4):
        flat = o * 4 + j
        out[flat] = x[r, idx.reshape(-1)[flat]]
    want = pr.probe_gather_lanes_plain(torch.from_numpy(x),
                                       torch.from_numpy(idx))
    assert _bits_equal_torch(torch.from_numpy(out.reshape(rows, cols)),
                             want)


@pytest.mark.parametrize("sms", [1, 8, 16, 132])
def test_gather_lanes_geometry_on_other_cards(sms):
    """Rows read in place are grouped twice as wide only where the output
    fills more than a wave of the card; every output is still written
    once."""
    for rows, cols in ((128, 128), (61440, 128), (7, 132)):
        rpb, threads, staged = pr.gather_lanes_geometry(rows, cols, sms,
                                                        H100_SMEM)
        wide = not staged and rows * cols // 4 > 2048 * sms
        assert rpb == max(1, pr.LANES_BLOCK4 * (2 if wide else 1)
                          // (cols // 4))
        out, src = _gather_lanes_walk(rows, cols, rpb, threads)
        assert np.array_equal(np.sort(out), np.arange(rows * cols // 4))
        assert np.array_equal(src, out // (cols // 4))


def test_lane_gather_wavefront_replay():
    """Pins the replay of the staged gather: every lane of a row on one
    index is a broadcast (one wavefront a request); the identity reads
    words 4 apart, 8 banks four deep (four); uniformly random lanes cost
    about 3.5 at 4,096."""
    rpb, threads, staged = pr.gather_lanes_geometry(128, 512, H100_SMS,
                                                    H100_SMEM)
    assert staged
    same = np.full((128, 512), 5)
    ident = np.tile(np.arange(512), (128, 1))
    for idx, ways in ((same, 1), (ident, 4)):
        w = route_probe.lane_gather_wavefronts(idx, rpb, threads)
        assert w == {"requests": 2048, "wavefronts": 2048 * ways}
    idx = np.random.default_rng(0).integers(0, 4096, (128, 4096))
    rpb, threads, _ = pr.gather_lanes_geometry(128, 4096, H100_SMS,
                                               H100_SMEM)
    w = route_probe.lane_gather_wavefronts(idx, rpb, threads)
    assert w["requests"] == 128 * 4096 // 32
    assert 3.3 < w["wavefronts"] / w["requests"] < 3.7


@pytest.mark.parametrize("cols", [128, 512])
def test_dim1_gather_plain_equals_jax_interpret(cols):
    rng = np.random.default_rng(cols)
    x_np = _randn(cols + 1, 128, cols)
    i_np = rng.integers(0, cols, size=(128, cols)).astype(np.int32)
    xg, ig = jnp.asarray(x_np), jnp.asarray(i_np)

    def g1(x_ref, i_ref, o_ref):
        o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=1)

    y = pl.pallas_call(
        g1,
        out_shape=jax.ShapeDtypeStruct((128, cols), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(xg, ig)
    assert _same(pr.probe_gather_lanes(torch.from_numpy(x_np),
                                       torch.from_numpy(i_np)), y)


def test_tiled_lane_gather_plain_equals_jax_interpret():
    T, rows = 2, 256
    rng = np.random.default_rng(7)
    x_np = _randn(8, T, rows, 128)
    i_np = rng.integers(0, 128, size=(T, rows, 128)).astype(np.int32)
    grid_call = pl.pallas_call(
        lambda x_ref, i_ref, o_ref: o_ref.__setitem__(
            0, jnp.take_along_axis(x_ref[0], i_ref[0], axis=1)),
        grid=(T,),
        out_shape=jax.ShapeDtypeStruct((T, rows, 128), jnp.float32),
        in_specs=[
            pl.BlockSpec((1, rows, 128), lambda i: (i, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, rows, 128), lambda i: (i, 0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, rows, 128), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )
    assert _same(pr.probe_gather_lanes(torch.from_numpy(x_np),
                                       torch.from_numpy(i_np)),
                 grid_call(jnp.asarray(x_np), jnp.asarray(i_np)))


# ---- tile_perm_probe.py: route_tile_perm, make_kernel (:141) -----------

@pytest.fixture(scope="module")
def routed():
    """One seeded permutation routed by both copies of the host routing
    (``main``'s permutation: the first draw of ``default_rng(0)``)."""
    jprobe = _jax_probe("tile_perm_probe")
    perm = np.random.default_rng(0).permutation(128 * 128)
    port_planes, _ = tile_perm_probe.route_tile_perm_cached(perm)
    return perm, port_planes, jprobe.route_tile_perm(perm), jprobe


def test_route_tile_perm_planes_equal_jax(routed):
    perm, port_planes, jax_planes, _ = routed
    for a, b in zip(port_planes, jax_planes):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    x = _randn(1, 128, 128)
    y = tile_perm_probe.apply_route_np(x, *port_planes)
    assert np.array_equal(y, x.reshape(-1)[perm].reshape(128, 128))


def test_tile_perm_plain_equals_jax_interpret(routed):
    perm, planes, _, jprobe = routed
    T = 2
    x_np = _randn(3, T, 128, 128)
    mk = lambda a: np.ascontiguousarray(np.broadcast_to(  # noqa: E731
        a.astype(np.int8), (T, 128, 128)))
    i8 = [mk(a) for a in planes]
    y = jprobe.make_kernel(T, True)(jnp.asarray(x_np),
                                    *[jnp.asarray(a) for a in i8])
    got = pr.probe_tile_perm(torch.from_numpy(x_np),
                             *[torch.from_numpy(a) for a in i8])
    assert _same(got, y)
    assert torch.equal(got, torch.from_numpy(
        x_np.reshape(T, -1)[:, perm].reshape(T, 128, 128)))


def test_tile_perm_plain_reads_index_127_as_a_lane():
    """int8 planes hold 0..127: the top lane must read as 127, not -1."""
    x = torch.from_numpy(_randn(4, 1, 128, 128))
    full = torch.full((1, 128, 128), 127, dtype=torch.int8)
    got = pr.probe_tile_perm(x, full, full, full)
    # Y[r, c] = X[idx2[k, r], idx1[., k]] with every index 127
    assert torch.equal(got, torch.full_like(x, float(x[0, 127, 127])))


def _composed_through_transposed(x, idx1, idx2, idx3):
    """The CUDA kernel's one read per output, spelled in PyTorch: idx2
    staged transposed (``idx2T[r, k] = idx2[k, r]``), then with
    ``k = idx3[r, c]`` and ``r2 = idx2T[r, k]``,
    ``Y[r, c] = X[r2, idx1[r2, k]]``."""
    t = x.shape[0]
    k = idx3.long()
    r2 = torch.gather(idx2.transpose(1, 2).long(), 2, k)
    c1 = torch.gather(idx1.reshape(t, -1).long(), 1,
                      (r2 * 128 + k).reshape(t, -1))
    src = r2.reshape(t, -1) * 128 + c1
    return torch.gather(x.reshape(t, -1), 1, src).reshape(x.shape)


def _arbitrary_planes(t, seed):
    """Index planes that need not compose to a permutation, a different
    set per tile, with 127 (the top lane) in row and column 0 of each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        p = rng.integers(0, 128, (t, 128, 128)).astype(np.int8)
        p[:, 0, :] = 127
        p[:, :, 0] = 127
        out.append(p)
    return out


@pytest.mark.parametrize("planes", ["routed", "arbitrary"])
def test_tile_perm_composed_through_transposed_plane(routed, planes):
    """The kernel's composed formula through the transposed idx2 equals
    the plain version and the JAX probe's chain in interpret mode,
    bitwise: on the routed permutation and on arbitrary planes."""
    perm, routed_planes, _, jprobe = routed
    T = 2
    x_np = _randn(11, T, 128, 128)
    x_np[0, 0, :3] = [-0.0, np.inf, 1e-40]
    if planes == "routed":
        i8 = [np.ascontiguousarray(np.broadcast_to(a.astype(np.int8),
                                                   (T, 128, 128)))
              for a in routed_planes]
    else:
        i8 = _arbitrary_planes(T, 3)
    x, it = torch.from_numpy(x_np), [torch.from_numpy(a) for a in i8]
    got = _composed_through_transposed(x, *it)
    assert _bits_equal_torch(got, pr.probe_tile_perm_plain(x, *it))
    y = jprobe.make_kernel(T, True)(jnp.asarray(x_np),
                                    *[jnp.asarray(a) for a in i8])
    assert _same(got, y)
    if planes == "routed":
        assert torch.equal(got, torch.from_numpy(
            x_np.reshape(T, -1)[:, perm].reshape(T, 128, 128)))


def test_tile_perm_wavefront_replay(routed):
    """The replay of the pick's shared-memory reads on the probe's routed
    tile: idx2 row-major puts a warp's 32 reads in one bank (32
    wavefronts each, 16,384 a tile); staged transposed, one each (512).
    The idx2 transpose is conflict-free (8 requests of 32 warps)."""
    _, (i1, i2, i3), _, _ = routed
    row = tile_perm_probe.pick_wavefronts(i1, i2, i3, transposed=False)
    tr = tile_perm_probe.pick_wavefronts(i1, i2, i3, transposed=True)
    assert row == {"s2": 16384, "s1": 1467, "xs": 1839, "total": 19690}
    assert tr == {"s2": 512, "s1": 1467, "xs": 1839, "total": 3818}
    assert tile_perm_probe.transpose_wavefronts() == 8 * 32
    # every lane on one word: one wavefront a request
    zero = np.zeros((128, 128), np.int8)
    assert tile_perm_probe.pick_wavefronts(zero, zero, zero)["total"] == \
        3 * 512


# ---- the wrappers on the CPU, and the entry points --------------------------

def test_cpu_wrappers_launch_nothing():
    before = dict(pr.LAUNCHES)
    x = torch.from_numpy(_randn(9, 2, 128, 128))
    pr.probe_slab(x, 102, 1, True)
    pr.probe_scale2(x[0])
    pr.probe_gather_rows(x[0], torch.zeros(128, 128, dtype=torch.int32))
    pr.probe_gather_lanes(x, torch.zeros(2, 128, 128, dtype=torch.int32))
    i8 = torch.zeros(2, 128, 128, dtype=torch.int8)
    pr.probe_tile_perm(x, i8, i8, i8)
    assert pr.LAUNCHES == before


@pytest.mark.parametrize("call", [
    lambda: pr.probe_slab(torch.zeros(2, 128, 64), 1, 1, True),
    lambda: pr.probe_slab(torch.zeros(2, 128, 128), 65, 2, True),
    lambda: pr.probe_scale2(torch.zeros(4, 64)),
    lambda: pr.probe_gather_rows(torch.zeros(4, 128),
                                 torch.zeros(4, 64, dtype=torch.int32)),
    lambda: pr.probe_gather_lanes(torch.zeros(4, 6),
                                  torch.zeros(4, 6, dtype=torch.int32)),
    lambda: pr.probe_tile_perm(torch.zeros(1, 128, 128),
                               *[torch.zeros(1, 128, 64,
                                             dtype=torch.int8)] * 3),
])
def test_wrappers_refuse_bad_shapes(call):
    with pytest.raises(ValueError):
        call()


def test_check_plain_raises_on_a_flipped_bit():
    a = torch.ones(4)
    b = a.clone()
    b[2] = -1.0
    with pytest.raises(ProbeMismatch):
        check_plain("x", a, b)


@pytest.mark.parametrize("module,argv", [
    (slab_probe, ["--tiles", "3", "--sum-elems", "4096"]),
    (route_probe, ["--e", "100000", "--n", "1000", "--stream-rows", "1024"]),
    (tile_perm_probe, ["--tiles", "2"]),
], ids=["slab_probe", "route_probe", "tile_perm_probe"])
def test_probe_main_on_cpu_exit_0(module, argv, routed, capsys):
    assert module.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    assert "GB/s" in out and "plain version on the cpu" in out


def test_probe_main_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        slab_probe.main(["--tiles", "1"])
