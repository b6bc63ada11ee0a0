"""Degree-class folds over the class-padded delivery layout.

Port of ``gossipprotocol_tpu/ops/classops.py`` (the two reduce kernels
the fused gather delivery runs). Layout contract (``ops/delivery.py``):
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

import torch

from gossipprotocol_tpu_torch.ops import build

LANES = 128
BLK = 256          # row alignment of small-class regions (layout contract)

# kernel launches since the last reset (counted where each wrapper
# launches its kernel; the CPU path launches nothing)
LAUNCHES = {"class_reduce_small": 0, "class_reduce_split": 0}


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


def class_reduce_split(region: torch.Tensor, c: int) -> torch.Tensor:
    """Reduce a hub-split class region: q = 2c/128 sub-classes of one
    64-pair row per node, sub-class-major (row j*cap + r = node slot r's
    j-th chunk). ``region``: f32 [q * cap * 128]. Returns f32 [2 * cap]
    packed (s, w) per node slot.

    On CUDA: ``csrc/classops.cu`` ``reduce_split_kernel``, replacing the
    Pallas kernel at ``gossipprotocol_tpu/ops/classops.py:183``. Bound by
    bytes; one block per node slot keeps the ascending-j fold inside the
    block (GPU blocks run in no order, so the TPU's cross-step carry has
    no counterpart)."""
    q, cap = _split_geometry(region.numel(), c)
    if region.device.type == "cpu":
        return class_reduce_split_plain(region, c)
    _require_cuda_f32(region, "class_reduce_split")
    require_aligned(region, "class_reduce_split")
    out = torch.empty(2 * cap, dtype=torch.float32, device=region.device)
    lib = build.library("classops")
    rc = lib.gossip_class_reduce_split(
        region.data_ptr(), out.data_ptr(), cap, q,
        build.stream_handle(region.device))
    build.check(lib, rc, "class_reduce_split")
    LAUNCHES["class_reduce_split"] += 1
    return out
