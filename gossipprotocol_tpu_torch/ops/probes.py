"""The measurement probes' kernels (``csrc/probes.cu``) and their plain
versions.

The JAX package measured the TPU with three scripts
(``experiments/slab_probe.py``, ``route_probe.py``,
``tile_perm_probe.py``); their eight ``pallas_call`` sites are five CUDA
kernels here. No simulation path of either package runs them: the
entry points are ``python -m gossipprotocol_tpu_torch.probes.<name>``.

Each function has two bodies, as in :mod:`~gossipprotocol_tpu_torch.ops.
classops`: the CUDA kernel for a tensor on a CUDA device (it launches or
raises), and the plain PyTorch version (``*_plain``) for a tensor on the
CPU. All five only copy, double or gather, so the kernel is bitwise equal
to its plain version, and the plain versions bitwise equal to the JAX
kernels run in Pallas interpret mode.
"""

from __future__ import annotations

import functools

import torch

from gossipprotocol_tpu_torch.ops import build

LANES = 128

# kernel launches since the last reset (counted where each wrapper
# launches its kernel; the CPU path launches nothing)
LAUNCHES = {"probe_slab": 0, "probe_scale2": 0, "probe_gather_rows": 0,
            "probe_gather_lanes": 0, "probe_tile_perm": 0}


# launch geometry of scale2_kernel, gather_rows_kernel and
# gather_lanes_kernel (csrc/probes.cu), chosen by size: pure functions of
# the shape and the card, so that the CPU tests hold them at every edge
SCALE2_THREADS = 256
SCALE2_BLOCKS_PER_SM = 2048 // SCALE2_THREADS   # one full wave
GATHER_BANDS = 8                                 # bands of 16 columns
LANES_UNROLL = 4           # float4 a thread holds of a long row (csrc)
LANES_WARP4 = 32           # float4 of the rows read in place (one warp)
LANES_BLOCK4 = 128         # float4 of short rows grouped into a block
LANES_WIDE4 = 256          # float4 of a row from which threads take more
LANES_MAX_THREADS = 1024


def scale2_geometry(n4: int, sms: int, l2_bytes: int) -> tuple[int, bool]:
    """``(blocks, stream)`` of ``scale2_kernel`` over ``n4`` float4 on a
    card of ``sms`` SMs and ``l2_bytes`` of L2. ``stream``: x and y do not
    fit in L2 together, so the copy streams from device memory, one block
    per 256 float4 with evict-first loads; else at most one full wave of
    blocks walks the L2-resident array grid-stride."""
    cover = -(-n4 // SCALE2_THREADS)
    stream = 2 * 16 * n4 > l2_bytes
    return (cover if stream else min(cover, SCALE2_BLOCKS_PER_SM * sms),
            stream)


def gather_rows_geometry(rows: int, sms: int) -> int:
    """Output rows a block of ``gather_rows_kernel`` walks: the
    ``GATHER_BANDS`` column bands times the chunks fill the ``sms`` SMs in
    one wave (8 x 16 = 128 blocks on an H100's 132), whatever ``rows``."""
    chunks = max(1, sms // GATHER_BANDS)
    return max(1, -(-rows // chunks))


def gather_lanes_geometry(rows: int, cols: int, sms: int,
                          smem_bytes: int) -> tuple[int, int, bool]:
    """``(rows_per_block, threads, staged)`` of ``gather_lanes_kernel``
    over ``rows`` rows of ``cols`` lanes on a card of ``sms`` SMs whose
    blocks may opt into ``smem_bytes`` of shared memory. A block owns
    whole rows. A row of more than ``LANES_WARP4`` float4 that fits the
    shared memory is staged there, one row a block or as many as fill
    ``LANES_BLOCK4`` float4; a row of at most ``LANES_WARP4`` float4 (one
    warp's outputs) is read in place, rows grouped ``LANES_BLOCK4`` float4
    a block (twice that where the output fills more than one wave of the
    card, 2,048 threads an SM), and so is a row longer than the shared
    memory holds, one a block. A thread takes one float4 of a row under
    ``LANES_WIDE4`` float4 and ``LANES_UNROLL`` of a longer one (whole
    warps, at most ``LANES_MAX_THREADS``)."""
    c4 = cols // 4
    fits = cols * 4 <= smem_bytes
    staged = fits and c4 > LANES_WARP4
    block4 = LANES_BLOCK4 * (2 if not staged and rows * c4 > 2048 * sms
                             else 1)
    rpb = max(1, block4 // c4) if fits else 1
    per = LANES_UNROLL if c4 >= LANES_WIDE4 else 1
    warps = -(-rpb * c4 // (per * 32))
    return rpb, min(LANES_MAX_THREADS, 32 * warps), staged


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple[int, int]:
    """SM count and L2 bytes of CUDA device ``index``."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.L2_cache_size


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    """Shared memory a block of CUDA device ``index`` may opt into."""
    return torch.cuda.get_device_properties(
        index).shared_memory_per_block_optin


def _require(x: torch.Tensor, dtype, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: data pointer not 16-byte aligned")


def _same_device(what: str, *ts: torch.Tensor) -> None:
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{what}: tensors on different devices")


# ---- slab_probe.py: slab_kernel (:73) and contig_kernel (:94) ----------

def probe_slab_plain(x: torch.Tensor, buckets: int, cr: int,
                     bucket_major: bool) -> torch.Tensor:
    """Plain PyTorch body: ``x * 2``, each tile's first ``buckets * cr``
    rows viewed ``[T, B, CR, 128]``, bucket-major when asked."""
    t = x.shape[0]
    y = (x * 2)[:, : buckets * cr].reshape(t, buckets, cr, LANES)
    return y.transpose(0, 1).contiguous() if bucket_major else y


def probe_slab(x: torch.Tensor, buckets: int, cr: int,
               bucket_major: bool) -> torch.Tensor:
    """Write ``2 * x[t][:B*CR]`` of every ``[128, 128]`` tile of ``x``
    (f32 ``[T, 128, 128]``) as B runs of CR rows: bucket-major
    ``[B, T, CR, 128]`` or tile-major ``[T, B, CR, 128]``.

    On CUDA: ``csrc/probes.cu`` ``slab_kernel``, replacing the Pallas
    kernels at ``experiments/slab_probe.py:73`` (bucket-major) and ``:94``
    (tile-major). Bound by bytes; one thread per output float4, in output
    order."""
    if x.dim() != 3 or x.shape[1:] != (LANES, LANES):
        raise ValueError("probe_slab: x must be [tiles, 128, 128]")
    if buckets < 1 or cr < 1 or buckets * cr > LANES:
        raise ValueError(f"probe_slab: B*CR = {buckets}*{cr} must lie in "
                         f"1..{LANES}")
    if x.device.type == "cpu":
        return probe_slab_plain(x, buckets, cr, bucket_major)
    _require(x, torch.float32, "probe_slab")
    t = x.shape[0]
    shape = (buckets, t, cr, LANES) if bucket_major else (t, buckets, cr,
                                                           LANES)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    lib = build.library("probes")
    rc = lib.gossip_probe_slab(x.data_ptr(), out.data_ptr(), t, buckets, cr,
                               int(bucket_major),
                               build.stream_handle(x.device))
    build.check(lib, rc, "probe_slab")
    LAUNCHES["probe_slab"] += 1
    return out


# ---- route_probe.py: copy_kernel (:158 resident, :240 streamed) --------

def probe_scale2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch body: ``x * 2``."""
    return x * 2


def probe_scale2(x: torch.Tensor, tile_rows: int | None = None
                 ) -> torch.Tensor:
    """``2 * x`` over an f32 ``[rows, 128]`` array, walked in tiles of
    ``tile_rows`` rows (None: the whole array as one tile).

    On CUDA: ``csrc/probes.cu`` ``scale2_kernel``, replacing the Pallas
    kernel at ``experiments/route_probe.py:158`` (one VMEM-resident block;
    ``tile_rows=None``) and its grid form at ``:240`` (1,024-row blocks).
    The tile was the TPU's VMEM block: it is validated, and the card walks
    the array flat (``scale2_geometry``). Bound by bytes: up to 16 MB the
    array stays in L2, 64 MiB streams from device memory."""
    if x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError("probe_scale2: x must be [rows, 128]")
    rows = x.shape[0]
    tile_rows = rows if tile_rows is None else tile_rows
    if tile_rows < 1:
        raise ValueError("probe_scale2: tile_rows must be >= 1")
    if x.device.type == "cpu":
        return probe_scale2_plain(x)
    _require(x, torch.float32, "probe_scale2")
    out = torch.empty_like(x)
    blocks, stream = scale2_geometry(x.numel() // 4, *_card(x.device.index))
    lib = build.library("probes")
    rc = lib.gossip_probe_scale2(x.data_ptr(), out.data_ptr(), x.numel(),
                                 blocks, int(stream),
                                 build.stream_handle(x.device))
    build.check(lib, rc, "probe_scale2")
    LAUNCHES["probe_scale2"] += 1
    return out


# ---- route_probe.py: g0 (:180) ------------------------------------------

def probe_gather_rows_plain(x: torch.Tensor, idx: torch.Tensor
                            ) -> torch.Tensor:
    """Plain PyTorch body: ``torch.gather`` on dim 0."""
    return torch.gather(x, 0, idx.long())


def probe_gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r, c] = x[idx[r, c], c]`` over f32 ``[rows, 128]`` with int32
    indices in ``[0, rows)`` (``take_along_axis`` on axis 0).

    On CUDA: ``csrc/probes.cu`` ``gather_rows_kernel``, replacing the
    Pallas kernel at ``experiments/route_probe.py:180``: blocks of a
    16-column band and ``gather_rows_geometry`` output rows. Bound in
    practice by random L2 reads (the source stays in L2)."""
    if x.dim() != 2 or x.shape[1] != LANES or idx.shape != x.shape:
        raise ValueError("probe_gather_rows: x and idx must be [rows, 128]")
    _same_device("probe_gather_rows", x, idx)
    if x.device.type == "cpu":
        return probe_gather_rows_plain(x, idx)
    _require(x, torch.float32, "probe_gather_rows")
    _require(idx, torch.int32, "probe_gather_rows")
    out = torch.empty_like(x)
    lib = build.library("probes")
    rows = x.shape[0]
    chunk_rows = gather_rows_geometry(rows, _card(x.device.index)[0])
    rc = lib.gossip_probe_gather_rows(x.data_ptr(), idx.data_ptr(),
                                      out.data_ptr(), rows, chunk_rows,
                                      build.stream_handle(x.device))
    build.check(lib, rc, "probe_gather_rows")
    LAUNCHES["probe_gather_rows"] += 1
    return out


# ---- route_probe.py: g1 (:202) and grid_call (:216) ---------------------

def probe_gather_lanes_plain(x: torch.Tensor, idx: torch.Tensor
                             ) -> torch.Tensor:
    """Plain PyTorch body: ``torch.gather`` on the last dim."""
    return torch.gather(x, -1, idx.long())


def probe_gather_lanes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[..., r, c] = x[..., r, idx[..., r, c]]`` (``take_along_axis``
    on the last axis) for f32 ``x`` and int32 ``idx`` of one shape, the
    last dim a multiple of 4, indices in ``[0, cols)``.

    On CUDA: ``csrc/probes.cu`` ``gather_lanes_kernel``, replacing the
    Pallas kernels at ``experiments/route_probe.py:202`` (``[128, cols]``)
    and ``:216`` (per tile of ``[T, 4096, 128]``). Bound by bytes: each
    block owns whole rows (``gather_lanes_geometry``), staged in shared
    memory and gathered there where a row is longer than a warp's 32
    float4, read in place where it is that short or too long for the
    shared memory."""
    if x.dim() < 2 or idx.shape != x.shape or x.shape[-1] % 4:
        raise ValueError("probe_gather_lanes: x and idx must share a "
                         "shape whose last dim is a multiple of 4")
    _same_device("probe_gather_lanes", x, idx)
    if x.device.type == "cpu":
        return probe_gather_lanes_plain(x, idx)
    _require(x, torch.float32, "probe_gather_lanes")
    _require(idx, torch.int32, "probe_gather_lanes")
    out = torch.empty_like(x)
    cols = x.shape[-1]
    rows = x.numel() // cols
    index = x.device.index
    rpb, threads, staged = gather_lanes_geometry(
        rows, cols, _card(index)[0], _smem_optin(index))
    lib = build.library("probes")
    rc = lib.gossip_probe_gather_lanes(x.data_ptr(), idx.data_ptr(),
                                       out.data_ptr(), rows, cols, rpb,
                                       threads, int(staged), index,
                                       build.stream_handle(x.device))
    build.check(lib, rc, "probe_gather_lanes")
    LAUNCHES["probe_gather_lanes"] += 1
    return out


# ---- tile_perm_probe.py: kern (:141) -------------------------------------

def probe_tile_perm_plain(x: torch.Tensor, idx1: torch.Tensor,
                          idx2: torch.Tensor, idx3: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch body: the JAX kernel's chain, per tile — lane gather
    by ``idx1``, transpose, lane gather by ``idx2``, transpose, lane gather
    by ``idx3``."""
    a = torch.gather(x, 2, idx1.long())
    b = torch.gather(a.transpose(1, 2), 2, idx2.long())
    return torch.gather(b.transpose(1, 2), 2, idx3.long())


def probe_tile_perm(x: torch.Tensor, idx1: torch.Tensor, idx2: torch.Tensor,
                    idx3: torch.Tensor) -> torch.Tensor:
    """Apply a routed permutation to every f32 ``[128, 128]`` tile of
    ``x`` (``[T, 128, 128]``); ``idx1..3`` are int8 planes of the same
    shape, values in 0..127 (the host routing's ``route_tile_perm``).

    On CUDA: ``csrc/probes.cu`` ``tile_perm_kernel``, replacing the Pallas
    kernel at ``experiments/tile_perm_probe.py:141``. Bound by bytes: the
    three gathers and two transposes compose into one read per output
    from the tile staged in shared memory."""
    if x.dim() != 3 or x.shape[1:] != (LANES, LANES):
        raise ValueError("probe_tile_perm: x must be [tiles, 128, 128]")
    for i in (idx1, idx2, idx3):
        if i.shape != x.shape:
            raise ValueError("probe_tile_perm: index planes must match x")
    _same_device("probe_tile_perm", x, idx1, idx2, idx3)
    if x.device.type == "cpu":
        return probe_tile_perm_plain(x, idx1, idx2, idx3)
    _require(x, torch.float32, "probe_tile_perm")
    for i in (idx1, idx2, idx3):
        _require(i, torch.int8, "probe_tile_perm")
    out = torch.empty_like(x)
    lib = build.library("probes")
    rc = lib.gossip_probe_tile_perm(
        x.data_ptr(), idx1.data_ptr(), idx2.data_ptr(), idx3.data_ptr(),
        out.data_ptr(), x.shape[0], build.stream_handle(x.device))
    build.check(lib, rc, "probe_tile_perm")
    LAUNCHES["probe_tile_perm"] += 1
    return out
