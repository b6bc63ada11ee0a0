"""Degree-class folds and expands over the class-padded delivery layout.

Port of ``gossipprotocol_tpu/ops/classops.py``: the two reduce kernels
every fanout-all delivery runs, the two expand kernels of the routed
delivery, and the two node-major hub kernels (``class_reduce_big``,
``class_expand_big``) that no delivery of either package emits — they
stand as functions with plain versions, as in the JAX package. Layout
contract (``ops/delivery.py``):
every class region covers whole 128-f32 rows; small classes (2c <= 128)
hold 128/(2c) node runs per row, hub classes (2c > 128) split each node
into q = 2c/128 one-row sub-classes stored sub-class-major (row
``j*cap + r`` is node slot r's j-th chunk).

Each function has two bodies:

* the CUDA kernel (``csrc/classops.cu``), launched for a tensor on a
  CUDA device — it either launches or raises;
* the plain PyTorch version (``*_plain``), the same arithmetic as the JAX
  kernel body (``torch.roll`` fold stages, ``take_along_dim``), taken only
  for a tensor on the CPU. The CPU tests hold it bitwise against JAX, and
  ``chip_smoke.py`` holds the kernel bitwise against it on the card.
"""

from __future__ import annotations

import functools

import torch

from gossipprotocol_tpu_torch.ops import build

LANES = 128
BLK = 256          # row alignment of small-class regions (layout contract)
BIGQ = 1024        # rows per block of the node-major hub reduce
WINDOW = 32        # XLA CPU's reduction window (see class_reduce_big)
# expand_big_kernel's launch geometry (csrc/classops.cu)
EXPAND_BIG_THREADS = 128
EXPAND_BIG_BLOCKS_PER_SM = 2048 // EXPAND_BIG_THREADS   # one full wave

# kernel launches since the last reset (counted where each wrapper
# launches its kernel; the CPU path launches nothing)
LAUNCHES = {"class_reduce_small": 0, "class_reduce_split": 0,
            "class_expand_small": 0, "class_expand_split": 0,
            "class_reduce_big": 0, "class_expand_big": 0}


def _require_cuda_f32(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: expected float32, got {x.dtype}")
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous 1-D tensor")


def require_aligned(x: torch.Tensor, what: str) -> None:
    """16-byte loads need a 16-byte-aligned base."""
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: data pointer not 16-byte aligned")


# ---- class_reduce_small ------------------------------------------------

def _fold_gather_idx(rows: int, two_c: int, device) -> torch.Tensor:
    """Lane gather packing run-start (s, w) lanes left (the JAX kernel's
    ``_fold_gather_idx``)."""
    col = torch.arange(LANES, device=device)
    idx = ((col // 2) * two_c + (col % 2)) % LANES
    return idx.expand(rows, LANES)


def class_reduce_small_plain(region: torch.Tensor, c: int) -> torch.Tensor:
    """Plain PyTorch body: stride-2 lane-roll fold, then a lane gather."""
    two_c = 2 * c
    view = region.reshape(-1, LANES)
    acc = view
    sh = 2
    while sh < two_c:
        acc = acc + torch.roll(acc, -sh, dims=1)
        sh *= 2
    packed = torch.take_along_dim(
        acc, _fold_gather_idx(view.shape[0], two_c, region.device), dim=1)
    return packed[:, : LANES // c].reshape(-1)


def class_reduce_small(region: torch.Tensor, c: int) -> torch.Tensor:
    """Per-run (s, w) sums of a small-class region.

    ``region``: f32 [rows * 128], rows % BLK == 0, runs of 2c lanes.
    Returns f32 [rows * 128 // c] (packed pair sums, row-major).

    On CUDA: ``csrc/classops.cu`` ``reduce_small_kernel``, replacing the
    Pallas kernel at ``gossipprotocol_tpu/ops/classops.py:96``. Bound by
    bytes (each value read once); one thread per output folds its run in
    registers, in the roll tree's order.
    """
    if c < 1 or LANES % (2 * c):
        raise ValueError(f"class_reduce_small: c={c} must divide 64")
    if region.numel() % (BLK * LANES):
        raise ValueError(
            f"class_reduce_small: {region.numel()} values is not a whole "
            f"number of {BLK}-row blocks")
    if region.device.type == "cpu":
        return class_reduce_small_plain(region, c)
    _require_cuda_f32(region, "class_reduce_small")
    rows = region.numel() // LANES
    out = torch.empty(rows * LANES // c, dtype=torch.float32,
                      device=region.device)
    lib = build.library("classops")
    rc = lib.gossip_class_reduce_small(
        region.data_ptr(), out.data_ptr(), rows, c,
        build.stream_handle(region.device))
    build.check(lib, rc, "class_reduce_small")
    LAUNCHES["class_reduce_small"] += 1
    return out


# ---- class_reduce_split ------------------------------------------------

def _split_geometry(numel: int, c: int):
    q = (2 * c) // LANES
    if q * LANES != 2 * c or q < 1:
        raise ValueError(f"class_reduce_split: 2c={2 * c} is not a "
                         f"multiple of {LANES}")
    rows = numel // LANES
    cap = rows // q
    if rows * LANES != numel or cap * q != rows:
        raise ValueError(f"class_reduce_split: {numel} values is not "
                         f"q={q} sub-class regions of whole rows")
    return q, cap


def class_reduce_split_plain(region: torch.Tensor, c: int) -> torch.Tensor:
    """Plain PyTorch body: full-row roll fold to (s, w) per row, then the
    ascending-j left fold of the q sub-class partials."""
    q, cap = _split_geometry(region.numel(), c)
    acc = region.reshape(-1, LANES)
    sh = 2
    while sh < LANES:
        acc = acc + torch.roll(acc, -sh, dims=1)
        sh *= 2
    partial = acc[:, :2].reshape(q, cap, 2)
    out = partial[0]
    for j in range(1, q):
        out = out + partial[j]
    return out.reshape(-1)


# the scratch of the spread folds (class_reduce_split, class_reduce_big)
# per (device, stream, nodes, q): the row partials (float2 [nodes, q]) and
# the per-node arrival counters, zeroed once here; every launch leaves the
# counters at zero again. Launches on one stream run in order, so they
# may share it, both kernels alike; another stream gets its own. A CUDA
# graph's launches use the scratch of the stream it was captured on (so
# it is not replayed while a fold runs there), made by an eager call
# there first: made during the capture, the zeroing would run only at
# replay and an eager call before it would read uninitialised counters,
# so that raises.
_FOLD_SCRATCH: dict = {}


def _fold_scratch(device: torch.device, stream: int, nodes: int, q: int):
    key = (torch.device(device), stream, nodes, q)
    if key not in _FOLD_SCRATCH:
        if key[0].type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "class fold: no scratch for this stream yet; call the fold "
                "once on the capture stream before capturing it")
        _FOLD_SCRATCH[key] = (
            torch.empty(2 * nodes * q, dtype=torch.float32, device=device),
            torch.zeros(nodes, dtype=torch.int32, device=device))
    return _FOLD_SCRATCH[key]


def class_reduce_split(region: torch.Tensor, c: int) -> torch.Tensor:
    """Reduce a hub-split class region: q = 2c/128 sub-classes of one
    64-pair row per node, sub-class-major (row j*cap + r = node slot r's
    j-th chunk). ``region``: f32 [q * cap * 128]. Returns f32 [2 * cap]
    packed (s, w) per node slot.

    On CUDA: ``csrc/classops.cu`` ``reduce_split_kernel``, replacing the
    Pallas kernel at ``gossipprotocol_tpu/ops/classops.py:183``. Bound by
    bytes. One launch: the row folds spread over blocks of 64 rows, their
    partials written to a ``[cap, q]`` scratch, and each node slot
    left-folded in ascending j by the last block to finish its rows (a
    per-slot arrival counter, which that block resets). The scratch is
    cached per stream (:func:`_fold_scratch`)."""
    q, cap = _split_geometry(region.numel(), c)
    if region.device.type == "cpu":
        return class_reduce_split_plain(region, c)
    _require_cuda_f32(region, "class_reduce_split")
    require_aligned(region, "class_reduce_split")
    out = torch.empty(2 * cap, dtype=torch.float32, device=region.device)
    stream = build.stream_handle(region.device)
    part, arrived = _fold_scratch(region.device, stream, cap, q)
    lib = build.library("classops")
    rc = lib.gossip_class_reduce_split(
        region.data_ptr(), out.data_ptr(), part.data_ptr(),
        arrived.data_ptr(), cap, q, stream)
    build.check(lib, rc, "class_reduce_split")
    LAUNCHES["class_reduce_split"] += 1
    return out


# ---- class_expand_small ------------------------------------------------

def class_expand_small_plain(packed: torch.Tensor, c: int) -> torch.Tensor:
    """Plain PyTorch body: widen the packed row to 128 lanes with zeros,
    then the lane gather ``2*(j // 2c) + j % 2``."""
    in_lanes = LANES // c
    view = packed.reshape(-1, in_lanes)
    if in_lanes == LANES:      # c == 1: runs are already pair-wide
        wide = view
    else:
        wide = torch.cat([view, torch.zeros(
            (view.shape[0], LANES - in_lanes), dtype=view.dtype,
            device=view.device)], dim=1)
    col = torch.arange(LANES, device=packed.device)
    idx = (2 * (col // (2 * c)) + col % 2).expand(view.shape[0], LANES)
    return torch.take_along_dim(wide, idx, dim=1).reshape(-1)


def class_expand_small(packed: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse packing: replicate each packed (s, w) pair across its
    2c-lane run. ``packed``: f32 [rows * 128 // c], rows % BLK == 0;
    returns f32 [rows * 128].

    On CUDA: ``csrc/classops.cu`` ``expand_small_kernel``, replacing the
    Pallas kernel at ``gossipprotocol_tpu/ops/classops.py:129``. Bound by
    bytes (each packed value read once, each output written once); one
    thread per four output lanes, loads served from L1."""
    if c < 1 or LANES % (2 * c):
        raise ValueError(f"class_expand_small: c={c} must divide 64")
    if packed.numel() % (BLK * LANES // c):
        raise ValueError(
            f"class_expand_small: {packed.numel()} values is not a whole "
            f"number of {BLK}-row blocks")
    if packed.device.type == "cpu":
        return class_expand_small_plain(packed, c)
    _require_cuda_f32(packed, "class_expand_small")
    rows = packed.numel() * c // LANES
    out = torch.empty(rows * LANES, dtype=torch.float32,
                      device=packed.device)
    lib = build.library("classops")
    rc = lib.gossip_class_expand_small(
        packed.data_ptr(), out.data_ptr(), rows, c,
        build.stream_handle(packed.device))
    build.check(lib, rc, "class_expand_small")
    LAUNCHES["class_expand_small"] += 1
    return out


# ---- class_expand_split ------------------------------------------------

def _expand_split_geometry(numel: int, c: int):
    q = (2 * c) // LANES
    if q * LANES != 2 * c or q < 1:
        raise ValueError(f"class_expand_split: 2c={2 * c} is not a "
                         f"multiple of {LANES}")
    if numel % 2:
        raise ValueError("class_expand_split: packed (s, w) pairs expected")
    return q, numel // 2


def class_expand_split_plain(packed: torch.Tensor, c: int) -> torch.Tensor:
    """Plain PyTorch body: each node slot's row carries s on even lanes
    and w on odd lanes; the q sub-class regions repeat it."""
    q, cap = _expand_split_geometry(packed.numel(), c)
    x = packed.reshape(cap, 2)
    col = torch.arange(LANES, device=packed.device)
    row = torch.where(col % 2 == 0, x[:, 0:1], x[:, 1:2])   # [cap, 128]
    return row.repeat(q, 1).reshape(-1)


def class_expand_split(packed: torch.Tensor, c: int) -> torch.Tensor:
    """Replicate each node pair across its q = 2c/128 sub-class rows (the
    inverse of :func:`class_reduce_split`'s layout). ``packed``: f32
    [2 * cap]; returns f32 [q * cap * 128], row j*cap + r carrying node
    slot r's pair on every lane run.

    On CUDA: ``csrc/classops.cu`` ``expand_split_kernel``, replacing the
    Pallas kernel at ``gossipprotocol_tpu/ops/classops.py:216``. Bound by
    bytes (the output is q*64 times the input); one thread per four
    output lanes."""
    q, cap = _expand_split_geometry(packed.numel(), c)
    if packed.device.type == "cpu":
        return class_expand_split_plain(packed, c)
    _require_cuda_f32(packed, "class_expand_split")
    require_aligned(packed, "class_expand_split")
    out = torch.empty(q * cap * LANES, dtype=torch.float32,
                      device=packed.device)
    lib = build.library("classops")
    rc = lib.gossip_class_expand_split(
        packed.data_ptr(), out.data_ptr(), cap, q,
        build.stream_handle(packed.device))
    build.check(lib, rc, "class_expand_split")
    LAUNCHES["class_expand_split"] += 1
    return out


# ---- class_reduce_big / class_expand_big (node-major hub layout) --------

def _big_geometry(c: int, what: str):
    q = (2 * c) // LANES
    if q * LANES != 2 * c or q < 1:
        raise ValueError(f"{what}: 2c={2 * c} is not a multiple of {LANES}")
    qb = min(q, BIGQ)
    if q % qb:
        raise ValueError(f"{what}: q={q} rows per node is not a whole "
                         f"number of {BIGQ}-row blocks")
    return q, qb


def _roll_fold_rows(view: torch.Tensor) -> torch.Tensor:
    """The full 128-lane roll fold of every row: ``[rows, 2]`` (s, w)."""
    acc = view
    sh = 2
    while sh < LANES:
        acc = acc + torch.roll(acc, -sh, dims=1)
        sh *= 2
    return acc[:, :2]


def _windows(qb: int):
    """``(windows, leading pad)`` of XLA CPU's rewrite of a reduction over
    ``qb`` rows: none past 32 rows; else windows of 32, the padding to
    whole windows split low (half, rounded down) and high."""
    if qb <= WINDOW:
        return 1, 0
    nwin = -(-qb // WINDOW)
    return nwin, (nwin * WINDOW - qb) // 2


def class_reduce_big_plain(region: torch.Tensor, c: int) -> torch.Tensor:
    """Plain PyTorch body: the roll fold of every row, then per node and
    block of ``qb = min(q, 1024)`` rows the sum of the row partials in
    XLA CPU's order (past 32 rows: windows of 32, each a left fold from
    0, the window sums a left fold from 0, the rows padded with zeros to
    whole windows on both sides), then the blocks added in ascending
    order."""
    q, qb = _big_geometry(c, "class_reduce_big")
    view = region.reshape(-1, LANES)
    n_c = view.shape[0] // q
    steps = q // qb
    nwin, lo = _windows(qb)
    width = WINDOW if nwin > 1 else qb
    part = _roll_fold_rows(view).reshape(n_c, steps, qb, 2)
    part = torch.nn.functional.pad(part, (0, 0, lo, nwin * width - qb - lo))
    part = part.reshape(n_c, steps, nwin, width, 2)
    win = torch.zeros((n_c, steps, nwin, 2), dtype=region.dtype,
                      device=region.device)
    for r in range(width):
        win = win + part[:, :, :, r]
    blk = torch.zeros((n_c, steps, 2), dtype=region.dtype,
                      device=region.device)
    for b in range(nwin):
        blk = blk + win[:, :, b]
    out = blk[:, 0]
    for j in range(1, steps):
        out = out + blk[:, j]
    return out.reshape(-1)


def class_reduce_big(region: torch.Tensor, c: int) -> torch.Tensor:
    """Reduce a node-major hub region: node i owns the q = 2c/128 rows
    ``i*q .. i*q+q-1`` (its c pairs, 64 per row). ``region``: f32
    ``[n_c * q * 128]``; returns f32 ``[2 * n_c]`` packed (s, w).

    On CUDA: ``csrc/classops.cu`` ``reduce_big_kernel``, replacing the
    Pallas kernel at ``gossipprotocol_tpu/ops/classops.py:265``. Bound by
    bytes. One launch, the split design of :func:`class_reduce_split` in
    node-major order: the row folds spread over blocks of 64 rows into a
    ``[n_c, q]`` scratch, and the last block to finish a node folds its
    partials in the order above (one thread per window, then per row
    block, then per node). The scratch is cached per stream
    (:func:`_fold_scratch`)."""
    q, _ = _big_geometry(c, "class_reduce_big")
    if region.numel() % (q * LANES):
        raise ValueError(f"class_reduce_big: {region.numel()} values is "
                         f"not whole nodes of q={q} rows")
    if region.device.type == "cpu":
        return class_reduce_big_plain(region, c)
    _require_cuda_f32(region, "class_reduce_big")
    require_aligned(region, "class_reduce_big")
    n_c = region.numel() // (q * LANES)
    out = torch.empty(2 * n_c, dtype=torch.float32, device=region.device)
    stream = build.stream_handle(region.device)
    part, arrived = _fold_scratch(region.device, stream, n_c, q)
    lib = build.library("classops")
    rc = lib.gossip_class_reduce_big(
        region.data_ptr(), out.data_ptr(), part.data_ptr(),
        arrived.data_ptr(), n_c, q, stream)
    build.check(lib, rc, "class_reduce_big")
    LAUNCHES["class_reduce_big"] += 1
    return out


def expand_big_geometry(n4: int, sms: int) -> int:
    """Blocks of ``expand_big_kernel`` over ``n4`` output float4 on a
    card of ``sms`` SMs: one float4 a thread where that is at most one
    full wave, else one full wave walking the output grid-stride."""
    return max(1, min(-(-n4 // EXPAND_BIG_THREADS),
                      EXPAND_BIG_BLOCKS_PER_SM * sms))


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def class_expand_big_plain(pairs: torch.Tensor, c: int) -> torch.Tensor:
    """Plain PyTorch body: each node's row carries s on even and w on odd
    lanes, repeated over its q rows."""
    q, _ = _big_geometry(c, "class_expand_big")
    x = pairs.reshape(-1, 2)
    col = torch.arange(LANES, device=pairs.device)
    row = torch.where(col % 2 == 0, x[:, 0:1], x[:, 1:2])   # [n_c, 128]
    return row.repeat_interleave(q, dim=0).reshape(-1)


def class_expand_big(pairs: torch.Tensor, c: int) -> torch.Tensor:
    """Replicate each node pair across its q = 2c/128 rows (the inverse
    of :func:`class_reduce_big`'s layout). ``pairs``: f32 ``[2 * n_c]``;
    returns f32 ``[n_c * q * 128]``.

    On CUDA: ``csrc/classops.cu`` ``expand_big_kernel``, replacing the
    Pallas kernel at ``gossipprotocol_tpu/ops/classops.py:302``. Bound by
    bytes written (the output is 64q times the input): at most one wave
    of blocks (``expand_big_geometry``) walks the output, one evict-first
    16-byte store a thread a step, no division per store."""
    q, _ = _big_geometry(c, "class_expand_big")
    if pairs.numel() % 2:
        raise ValueError("class_expand_big: packed (s, w) pairs expected")
    if pairs.device.type == "cpu":
        return class_expand_big_plain(pairs, c)
    _require_cuda_f32(pairs, "class_expand_big")
    require_aligned(pairs, "class_expand_big")
    n_c = pairs.numel() // 2
    out = torch.empty(n_c * q * LANES, dtype=torch.float32,
                      device=pairs.device)
    blocks = expand_big_geometry(out.numel() // 4, _sms(pairs.device.index))
    lib = build.library("classops")
    rc = lib.gossip_class_expand_big(
        pairs.data_ptr(), out.data_ptr(), n_c, q, blocks,
        build.stream_handle(pairs.device))
    build.check(lib, rc, "class_expand_big")
    LAUNCHES["class_expand_big"] += 1
    return out
