"""Fused gather delivery (``--delivery pallas``): the routed pipeline's
copy chain composed into two gathers around the class folds.

Port of ``gossipprotocol_tpu/ops/pallasdelivery.py``. Per matvec:

  1. gather : ``pre[j] = [xs|xw|0][src_pre[j]]`` — the fold input;
  2. fold   : per degree class, :mod:`~gossipprotocol_tpu_torch.ops.classops`
              (the only arithmetic, a fixed pairwise tree);
  3. gather : ``nat[i] = y_pad[src_out[i]]`` — class order back to natural
              order, degree-0 nodes reading the zero slot.

The plan tables are built on the host exactly as the JAX package builds
them (byte-equal; ``tests/test_torch_pallasdelivery.py``), including the
per-gather mode:

  * ``resident`` — global indices ``idx`` [tiles, 8, 128];
  * ``bucket``   — per destination tile the sorted distinct source rows
    ``rows`` [tiles, R] and slab-local indices ``lidx`` [tiles, 8, 128].

The gathers run as CUDA kernels on the card (``csrc/gather.cu``) and as
their plain PyTorch versions on the CPU. The name of the option and of
this module stay the JAX package's, so each module has one counterpart.

The sharded push design's edge-share exchange lives here too, as in the
JAX package: :func:`pallas_exchange` (``csrc/exchange.cu`` on the card)
and :func:`exchange_plain`, the one-permutation spelling.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gossipprotocol_tpu_torch.ops import build, classops
from gossipprotocol_tpu_torch.ops import plan as plan_mod
from gossipprotocol_tpu_torch.ops.delivery import (
    RoutedConfigError, class_layout, class_order, degree_classes,
    edge_pair_slot,
)
from gossipprotocol_tpu_torch.topology.base import Topology

LANES = 128
TILE_ROWS = 8
TILE = TILE_ROWS * LANES

# Sources at or under this many 128-lane rows take the resident mode.
# 8192 rows (4 MB of f32) is the TPU's VMEM figure, kept so the plan
# tables stay byte-equal with the JAX package's. On this card "resident"
# means "the source sits in L2"; re-deriving the threshold for H100's L2
# and shared memory is queued in ROADMAP.md.
RESIDENT_ROWS_DEFAULT = 8192

# kernel launches since the last reset (counted where each wrapper
# launches its kernel; the CPU path launches nothing)
LAUNCHES = {"gather_resident": 0, "gather_bucket": 0, "pallas_exchange": 0}


def _resident_rows() -> int:
    # same override variable as the JAX package, so one setting forces
    # the same mode in both
    return int(os.environ.get("GOSSIP_TPU_PALLAS_RESIDENT_ROWS",
                              RESIDENT_ROWS_DEFAULT))


def _ceil_to(x: int, q: int) -> int:
    return -(-int(x) // q) * q


# ---- gather kernels ------------------------------------------------------

def _require_gather_args(x: torch.Tensor, tables, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"{what}: source must be float32 [rows, {LANES}]")
    for t in (x, *tables):
        if t.device != x.device:
            raise ValueError(f"{what}: tables and source on other devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
        classops.require_aligned(t, what)
    for t in tables:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: index tables must be int32")


def gather_resident_plain(x2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch body: ``out[t] = x_flat[idx[t]]``."""
    return x2d.reshape(-1)[idx.long()]


def gather_resident(x2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[T, 8, 128]`` gather from a padded ``[src_rows, 128]`` source.

    On CUDA: ``csrc/gather.cu`` ``gather_resident_kernel``, replacing the
    Pallas kernel at ``gossipprotocol_tpu/ops/pallasdelivery.py:115``.
    Bound by bytes (indices in, values out); the source stays in L2."""
    if idx.dim() != 3 or idx.shape[1:] != (TILE_ROWS, LANES):
        raise ValueError("gather_resident: idx must be [tiles, 8, 128]")
    if x2d.device.type == "cpu":
        return gather_resident_plain(x2d, idx)
    _require_gather_args(x2d, (idx,), "gather_resident")
    out = torch.empty(idx.shape, dtype=torch.float32, device=x2d.device)
    lib = build.library("gather")
    rc = lib.gossip_gather_resident(
        x2d.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
        build.stream_handle(x2d.device))
    build.check(lib, rc, "gather_resident")
    LAUNCHES["gather_resident"] += 1
    return out


def gather_bucket_plain(x2d: torch.Tensor, rows: torch.Tensor,
                        lidx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch body: each output reads lane ``lidx % 128`` of its
    tile's staged row ``rows[t, lidx // 128]`` (indexing through the two
    tables directly; materializing every ``[R, 128]`` slab would take
    gigabytes at 1M nodes)."""
    tiles = rows.shape[0]
    li = lidx.reshape(tiles, TILE).long()
    src_row = torch.gather(rows.long(), 1, li // LANES)
    return x2d.reshape(-1)[src_row * LANES + li % LANES].reshape(
        tiles, TILE_ROWS, LANES)


@functools.lru_cache(maxsize=None)
def _l2_bytes(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).L2_cache_size


def _stream_hints(lidx: torch.Tensor, rows: torch.Tensor) -> bool:
    """Whether a bucket gather streams its lidx, table and output
    evict-first: when they come to more than half the card's L2
    (gather_pre at 1M nodes, ~240 MB, against an H100's 50 MB), they
    cannot stay there and would push the source out; a smaller stream
    (gather_out, ~24 MB) keeps the normal policy, so that its output
    stays in L2 for the kernel that reads it next."""
    return (2 * lidx.numel() + rows.numel()) * 4 > _l2_bytes(lidx.device) // 2


def gather_bucket(x2d: torch.Tensor, rows: torch.Tensor,
                  lidx: torch.Tensor) -> torch.Tensor:
    """Bucketed gather. ``rows``: int32 [tiles, R] per-tile source-row
    table (R <= 1024: a tile has 1024 outputs); ``lidx``: int32
    [tiles, 8, 128] slab-local indices.

    On CUDA: ``csrc/gather.cu`` ``gather_bucket_kernel``, replacing the
    Pallas kernel at ``gossipprotocol_tpu/ops/pallasdelivery.py:153``.
    Bound by bytes. One block per tile stages only the tile's row table
    in shared memory (cp.async) and reads every output once from the
    L2-resident source; the stream is read and written evict-first as
    :func:`_stream_hints` decides."""
    if (rows.dim() != 2 or lidx.dim() != 3
            or lidx.shape != (rows.shape[0], TILE_ROWS, LANES)):
        raise ValueError("gather_bucket: rows [tiles, R] and lidx "
                         "[tiles, 8, 128] disagree")
    if rows.shape[1] > TILE or rows.shape[1] % 4:
        raise ValueError(f"gather_bucket: row table width {rows.shape[1]} "
                         f"is not a multiple of 4 up to {TILE}")
    if x2d.device.type == "cpu":
        return gather_bucket_plain(x2d, rows, lidx)
    _require_gather_args(x2d, (rows, lidx), "gather_bucket")
    out = torch.empty(lidx.shape, dtype=torch.float32, device=x2d.device)
    lib = build.library("gather")
    rc = lib.gossip_gather_bucket(
        x2d.data_ptr(), rows.data_ptr(), lidx.data_ptr(), out.data_ptr(),
        rows.shape[0], rows.shape[1], int(_stream_hints(lidx, rows)),
        build.stream_handle(x2d.device))
    build.check(lib, rc, "gather_bucket")
    LAUNCHES["gather_bucket"] += 1
    return out


class GatherPlan(NamedTuple):
    """One composed copy-chain as a tile gather.

    ``mode == 'resident'`` carries global indices (``idx``); ``'bucket'``
    carries the per-tile source-row table plus slab-local indices. The
    unused tables are empty int32 tensors."""

    mode: str                 # 'resident' | 'bucket'
    src_rows: int             # rows of the padded 2-D source view
    out_len: int              # valid f32 prefix of the gathered stream
    idx: torch.Tensor         # int32 [tiles, 8, 128] (resident) or [0]
    rows: torch.Tensor        # int32 [tiles, R] (bucket) or [0]
    lidx: torch.Tensor        # int32 [tiles, 8, 128] (bucket) or [0]

    def padded_source(self, flat: torch.Tensor) -> torch.Tensor:
        """``[src_rows, 128]`` view of ``flat`` with its zero tail."""
        x = torch.zeros(self.src_rows * LANES, dtype=flat.dtype,
                        device=flat.device)
        x[: flat.shape[0]] = flat
        return x.reshape(self.src_rows, LANES)

    def gather_padded(self, x2d: torch.Tensor,
                      plain: bool = False) -> torch.Tensor:
        """Every tile of the gather (``[tiles * 1024]``) from a padded
        source (the kernels index it unchecked, so its size is checked).
        ``plain`` runs the plain PyTorch bodies on any device (the
        counterpart of the JAX package's ``interpret``)."""
        if x2d.shape != (self.src_rows, LANES):
            raise ValueError(f"padded source {tuple(x2d.shape)} != "
                             f"({self.src_rows}, {LANES})")
        if self.mode == "resident":
            out = (gather_resident_plain if plain else gather_resident)(
                x2d, self.idx)
        else:
            out = (gather_bucket_plain if plain else gather_bucket)(
                x2d, self.rows, self.lidx)
        return out.reshape(-1)

    def gather(self, flat: torch.Tensor) -> torch.Tensor:
        """``out[j] = flat_padded[src[j]]``; input is the unpadded source
        stream, output the valid prefix."""
        return self.gather_padded(self.padded_source(flat))[: self.out_len]


class HostGatherPlan(NamedTuple):
    """A :class:`GatherPlan`'s fields as host values (numpy tables) — the
    form the plan cache stores, with the field names of the JAX package's
    host-side ``GatherPlan``."""

    mode: str
    src_rows: int
    out_len: int
    idx: np.ndarray
    rows: np.ndarray
    lidx: np.ndarray


def build_gather_plan_np(src: np.ndarray, src_len: int,
                         resident_rows: Optional[int] = None
                         ) -> HostGatherPlan:
    """The plan tables as numpy: ``(mode, src_rows, out_len, idx, rows,
    lidx)``, byte-equal to the JAX package's ``build_gather_plan``.

    ``src[j] in [0, src_len]`` — index ``src_len`` (and anything past it
    up to the row padding) reads an exact ``+0.0`` zero slot.
    """
    out_len = len(src)
    resident = _resident_rows() if resident_rows is None else resident_rows
    src_rows = _ceil_to(src_len + 1, TILE_ROWS * LANES) // LANES
    tiles = _ceil_to(out_len, TILE) // TILE
    idx = np.full(tiles * TILE, src_len, np.int64)
    idx[:out_len] = src
    idx3 = idx.reshape(tiles, TILE_ROWS, LANES).astype(np.int32)
    empty = np.zeros(0, np.int32)
    if src_rows <= resident:
        return HostGatherPlan("resident", src_rows, out_len, idx3, empty,
                              empty)
    # bucket mode: per destination tile, the sorted distinct source rows
    # and slab-local indices into them
    r = (idx // LANES).reshape(tiles, TILE)
    order = np.argsort(r, axis=1, kind="stable")
    sr = np.take_along_axis(r, order, axis=1)
    new = np.concatenate(
        [np.ones((tiles, 1), bool), sr[:, 1:] != sr[:, :-1]], axis=1)
    pos_sorted = np.cumsum(new, axis=1) - 1
    r_cap = max(TILE_ROWS, _ceil_to(int(new.sum(axis=1).max()), TILE_ROWS))
    rows_tab = np.zeros((tiles, r_cap), np.int64)
    t_ids = np.repeat(np.arange(tiles), TILE)
    rows_tab[t_ids, pos_sorted.reshape(-1)] = sr.reshape(-1)
    pos = np.empty_like(pos_sorted)
    np.put_along_axis(pos, order, pos_sorted, axis=1)
    lidx = (pos * LANES + (idx % LANES).reshape(tiles, TILE)).reshape(
        tiles, TILE_ROWS, LANES)
    return HostGatherPlan("bucket", src_rows, out_len, empty,
                          rows_tab.astype(np.int32), lidx.astype(np.int32))


def build_gather_plan(src: np.ndarray, src_len: int,
                      resident_rows: Optional[int] = None,
                      device="cuda") -> GatherPlan:
    """Compile a composed int64 source map into a :class:`GatherPlan` on
    ``device`` (``cuda`` unless asked for ``cpu``)."""
    from gossipprotocol_tpu_torch.convert import gather_plan_from_numpy

    build.resolve_device(device)  # fail before the host build
    return gather_plan_from_numpy(
        *build_gather_plan_np(src, src_len, resident_rows), device=device)


# ---- the delivery --------------------------------------------------------

class PallasDelivery(NamedTuple):
    """Fused gather delivery for one topology: two gather plans around
    the class folds, plus the per-node degree."""

    n: int                        # real nodes
    nu: int                       # nodes with degree > 0
    m_pairs: int                  # class-layout pair slots (aligned)
    # (c, n_c, start_pair, region_rows, node_capacity) per class
    classes: Tuple[Tuple[int, int, int, int, int], ...]
    gather_pre: GatherPlan        # [xs|xw|0] -> fold input
    gather_out: GatherPlan        # packed class outputs -> [s|w] natural
    degree: torch.Tensor          # int32 [n]

    def matvec(self, xs: torch.Tensor, xw: torch.Tensor,
               plain: bool = False):
        """(in_s, in_w)[i] = sum over neighbors j of (xs, xw)[j], bitwise
        equal to the JAX package's ``PallasDelivery.matvec`` (same fold
        trees over the same f32 values). ``plain`` runs the gathers' and
        folds' plain PyTorch bodies on any device."""
        n = self.n
        # the padded source is built in one buffer (no concatenate + pad)
        x = torch.zeros(self.gather_pre.src_rows * LANES,
                        dtype=torch.float32, device=xs.device)
        x[:n] = xs[:n]
        x[n: 2 * n] = xw[:n]
        f = self.gather_pre.gather_padded(x.view(-1, LANES), plain)
        y = torch.zeros(self.gather_out.src_rows * LANES,
                        dtype=torch.float32, device=xs.device)
        at = 0
        for c, n_c, start, reg_rows, _cap in self.classes:
            region = f[2 * start: 2 * start + reg_rows * LANES]
            if 2 * c <= LANES:
                fold = (classops.class_reduce_small_plain if plain
                        else classops.class_reduce_small)
            else:
                fold = (classops.class_reduce_split_plain if plain
                        else classops.class_reduce_split)
            y[at: at + 2 * n_c] = fold(region, c)[: 2 * n_c]
            at += 2 * n_c
        nat = self.gather_out.gather_padded(y.view(-1, LANES), plain)
        return nat[:n], nat[n: 2 * n]


def pallas_streamed_bytes_per_round(pd: PallasDelivery) -> int:
    """Device-memory bytes one matvec streams through the gather tiles:
    int32 indices in, f32 fold input out, f32 packed outputs re-gathered,
    plus in bucket mode each tile's row table and its staged 512-byte
    rows (the table's width R per tile — the JAX package's figure)."""
    per_slot = 4 + 4                     # idx read + gathered f32 write
    pre = 2 * int(pd.m_pairs) * per_slot
    out = 2 * int(pd.n) * per_slot
    if pd.gather_pre.mode == "bucket":
        pre += int(pd.gather_pre.rows.numel()) * (4 + LANES * 4)
    if pd.gather_out.mode == "bucket":
        out += int(pd.gather_out.rows.numel()) * (4 + LANES * 4)
    return pre + out


class HostPallasDelivery(NamedTuple):
    """A :class:`PallasDelivery`'s fields as host values — the form the
    plan cache stores (``ops/plancache.py``), with the field names of the
    JAX package's host-side ``PallasDelivery``."""

    n: int
    nu: int
    m_pairs: int
    classes: Tuple[Tuple[int, int, int, int, int], ...]
    gather_pre: HostGatherPlan
    gather_out: HostGatherPlan
    degree: np.ndarray            # int32 [n]


def build_pallas_delivery_np(topo: Topology,
                             resident_rows: Optional[int] = None
                             ) -> HostPallasDelivery:
    """The delivery's fields as host values, with each gather's tables
    from :func:`build_gather_plan_np`."""
    if topo.implicit_full:
        raise RoutedConfigError(
            "pallas delivery: complete graph needs no edges "
            "(diffusion mixes in one round via reductions)")
    if topo.asymmetric:
        raise RoutedConfigError(
            "pallas delivery: the edge-permutation pairing needs a "
            "symmetric simple graph")
    n = topo.num_nodes
    offsets = np.asarray(topo.offsets, np.int64)
    indices = np.asarray(topo.indices, np.int64)
    degree = np.diff(offsets)
    if len(degree) and int(degree.max()) >= 2**28:
        # the round's single-rounding update is exact in float64 only
        # below this degree (protocols/diffusion.py _keep)
        raise RoutedConfigError(
            f"pallas delivery: max degree {int(degree.max())} >= 2**28")
    cls = degree_classes(degree)
    order, rank, nu = class_order(cls, n)
    classes, node_start_pair, m_pairs, _, pair_stride = class_layout(
        cls[order])

    # fold-input slot of every directed edge u->v: position of the
    # reverse edge v->u in v's run (canonical CSR rows required)
    src_nodes = np.repeat(np.arange(n, dtype=np.int64), degree)
    if len(indices) and not bool(
            (np.diff(src_nodes * np.int64(n) + indices) > 0).all()):
        raise ValueError(
            "pallas delivery requires canonical CSR rows (sorted, "
            "deduplicated neighbors) — build the topology via "
            "csr_from_edges")
    rev = plan_mod.argsort_pairs(indices, src_nodes, n)
    reverse_of = np.empty(len(indices), np.int64)
    reverse_of[np.arange(len(indices), dtype=np.int64)] = rev
    in_rank = np.empty(len(indices), np.int64)
    in_rank[reverse_of] = np.arange(len(indices)) - offsets[src_nodes]
    f_slot = edge_pair_slot(node_start_pair, pair_stride,
                            rank[indices], in_rank)

    # the composed pre-fold map: fold pair slot f_slot[e] holds the share
    # of edge source u — lane 0 reads xs[u] (flat slot u), lane 1 xw[u]
    # (flat slot n + u); every other slot reads the zero slot
    owner = np.full(m_pairs, -1, np.int64)
    owner[f_slot] = src_nodes
    zero_slot = 2 * n
    src_pre = np.empty(2 * m_pairs, np.int64)
    real = owner >= 0
    src_pre[0::2] = np.where(real, owner, zero_slot)
    src_pre[1::2] = np.where(real, n + owner, zero_slot)

    # the composed output map: dense class-ordered node r packs to
    # (2r, 2r+1) in the concatenated fold outputs; degree-0 nodes read
    # the zero slot
    zero_y = 2 * nu
    src_out = np.full(2 * n, zero_y, np.int64)
    has = degree > 0
    src_out[:n][has] = 2 * rank[has]
    src_out[n:][has] = 2 * rank[has] + 1

    return HostPallasDelivery(
        n, nu, m_pairs, classes,
        build_gather_plan_np(src_pre, 2 * n, resident_rows),
        build_gather_plan_np(src_out, 2 * nu, resident_rows),
        np.asarray(degree, np.int32))


def build_pallas_delivery(topo: Topology, device="cuda",
                          resident_rows: Optional[int] = None
                          ) -> PallasDelivery:
    """Compose the routed pipeline's copy chain into the two gather maps
    (O(E) numpy off the canonical CSR) and place the tables on
    ``device`` (``cuda`` unless asked for ``cpu``)."""
    from gossipprotocol_tpu_torch.convert import delivery_from_numpy

    build.resolve_device(device)  # fail before the host build
    (n, nu, m_pairs, classes, pre, out, degree) = build_pallas_delivery_np(
        topo, resident_rows)
    return delivery_from_numpy(n, nu, m_pairs, classes, pre, out, degree,
                               device=device)


# ---- sharded edge-share exchange ----------------------------------------

MAX_EXCHANGE_SHARDS = 64   # csrc/exchange.cu's pointer table


def _check_slabs(slabs, what: str):
    """S slabs, each ``[S, block]``, of one dtype, shape and device."""
    slabs = list(slabs)
    if not slabs:
        raise ValueError(f"{what}: no slabs")
    ns, s0 = len(slabs), slabs[0]
    for t in slabs:
        if t.dim() != 2 or t.shape[0] != ns:
            raise ValueError(f"{what}: each of the {ns} slabs must be "
                             f"[{ns}, block], got {tuple(t.shape)}")
        if t.shape != s0.shape or t.dtype != s0.dtype \
                or t.device != s0.device:
            raise ValueError(f"{what}: slabs differ in shape, dtype or "
                             "device")
    return slabs, ns, int(s0.shape[1])


def exchange_plain(slabs):
    """``out_d[s] = slab_s[d]`` as one PyTorch permutation of the stacked
    ``[S, S, block]`` slabs — the counterpart of the JAX package's
    ``jax.lax.all_to_all`` (``--delivery routed`` without
    ``--exchange-overlap``), and the kernel's reference. Returns the S
    outputs ``[S, block]``."""
    slabs, _, _ = _check_slabs(slabs, "exchange_plain")
    return list(torch.stack(slabs).transpose(0, 1).contiguous().unbind(0))


def pallas_exchange_plain(slabs, overlap: bool = False):
    """Plain PyTorch body of :func:`pallas_exchange`: the TPU kernel's
    row copies in its order — every ``(me, d)`` copy, or the ring steps
    ``o = 0 .. S-1`` (row ``me`` to shard ``(me + o) % S``)."""
    slabs, ns, block = _check_slabs(slabs, "pallas_exchange")
    out = torch.empty((ns, ns, block), dtype=slabs[0].dtype,
                      device=slabs[0].device)
    if overlap:
        for o in range(ns):
            for me in range(ns):
                d = (me + o) % ns
                out[d, me] = slabs[me][d]
    else:
        for me in range(ns):
            for d in range(ns):
                out[d, me] = slabs[me][d]
    return list(out.unbind(0))


def pallas_exchange(slabs, overlap: bool = False):
    """The push design's edge-share exchange: shard ``s``'s ``slabs[s]``
    (``[S, block]``, f32, bf16 or int8 — any dtype, the copy moves bytes)
    to the S outputs, ``out[d][s] = slabs[s][d]``.

    On CUDA: ``csrc/exchange.cu`` ``exchange_kernel``, replacing the
    Pallas kernel at ``gossipprotocol_tpu/ops/pallasdelivery.py:491``
    (``pallas_call`` at :542). The slabs need not be one tensor: the
    kernel takes their base pointers. One launch on either schedule:
    ``overlap=False`` copies the ``(s, d)`` rows in that order,
    ``overlap=True`` (``--exchange-overlap``) in the JAX ring's step
    order, step ``o`` moving row ``s`` to shard ``(s + o) % S``. Bound by
    bytes. A CPU tensor takes :func:`pallas_exchange_plain`."""
    slabs, ns, block = _check_slabs(slabs, "pallas_exchange")
    dev = slabs[0].device
    if dev.type == "cpu":
        return pallas_exchange_plain(slabs, overlap)
    if dev.type != "cuda":
        raise ValueError(f"pallas_exchange: no kernel for device {dev}")
    if ns > MAX_EXCHANGE_SHARDS:
        raise ValueError(f"pallas_exchange: {ns} shards, the kernel's "
                         f"table holds {MAX_EXCHANGE_SHARDS}")
    for t in slabs:
        if not t.is_contiguous():
            raise ValueError("pallas_exchange: expected contiguous slabs")
    out = torch.empty((ns, ns, block), dtype=slabs[0].dtype, device=dev)
    outs = list(out.unbind(0))
    src = (ctypes.c_void_p * ns)(*[t.data_ptr() for t in slabs])
    dst = (ctypes.c_void_p * ns)(*[t.data_ptr() for t in outs])
    lib = build.library("exchange")
    rc = lib.gossip_exchange(src, dst, ns, block * slabs[0].element_size(),
                             int(overlap), build.stream_handle(dev))
    build.check(lib, rc, "pallas_exchange")
    LAUNCHES["pallas_exchange"] += 1
    return outs
