"""Routed message delivery (``--delivery routed``) and the degree-class
geometry every fanout-all delivery shares (port of
``gossipprotocol_tpu/ops/delivery.py``).

The host half is copied: degree classes, the class-major node order with
its load-bearing ``0xC105`` within-class shuffle, the aligned class
layout (small classes padded to BLK-row multiples; hub classes split into
one-row sub-classes, sub-class-major), the pair-slot addressing of each
edge, and the three chained routing plans. The fused gather delivery
(``ops/pallasdelivery.py``) builds its tables from the same geometry, so
both deliveries' fold regions are the JAX package's byte for byte.

Pipeline per round (all f32, (s, w) routed together as lane pairs):

  1. plan_in   : ``[xs | xw]`` in natural order -> interleaved pairs in
                 class order (two chained unit-1 plans)
  2. expand    : per class c, broadcast each node pair to its c slots
                 (:func:`~gossipprotocol_tpu_torch.ops.classops.
                 class_expand_small` / ``class_expand_split``), then
                 ``* realmask`` (exactly 0.0 or 1.0)
  3. plan_m    : the edge permutation — out-slot (u, k) of edge u->v
                 lands in in-slot (v, rank of v->u) (two chained unit-2
                 plans)
  4. reduce    : per class, the fold kernels of ``ops/classops.py``
  5. plan_out  : class order -> ``[s | w]`` in natural order; degree-0
                 nodes (and state padding rows) read exact zeros

Every pass only moves values but the folds, so the matvec equals the JAX
package's bitwise, and equals the fused gather delivery's bitwise too.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gossipprotocol_tpu_torch.ops import classops as co
from gossipprotocol_tpu_torch.ops import plan as plan_mod
from gossipprotocol_tpu_torch.ops.classops import BLK
from gossipprotocol_tpu_torch.ops.exec import (
    DevicePlan, apply_plan, device_plan,
)


class RoutedConfigError(ValueError):
    """Routed-delivery build rejected the configuration (user-facing)."""


def _ceil_pow2(x: np.ndarray) -> np.ndarray:
    x = np.maximum(x, 1)
    return (1 << np.ceil(np.log2(x)).astype(np.int64)).astype(np.int64)


def degree_classes(degree: np.ndarray) -> np.ndarray:
    """Per-node delivery class: ceil-pow2 of degree, with the 128/256
    band merged up to 512 (between the lane kernels' and the row
    kernels' operating ranges — see the class-merge comment in
    :func:`build_routed_delivery`); degree-0 nodes get class 0."""
    cls = _ceil_pow2(degree)
    cls[(cls > 64) & (cls < 512)] = 512
    cls[np.asarray(degree) == 0] = 0
    return cls


def class_order(cls: np.ndarray, n: int, shuffle_seed: int = 0xC105):
    """(order, rank, nu): class-major node order with the load-bearing
    within-class shuffle (see the build comment: sorted orders make the
    delivery permutations near block-diagonal and blow up the radix
    capacities; the shuffle spreads them)."""
    order = np.argsort(np.where(cls == 0, np.iinfo(np.int64).max, cls),
                       kind="stable")
    nu = int((cls > 0).sum())
    order = order[:nu]
    rng = np.random.default_rng(shuffle_seed)
    c_tmp = cls[order]
    bounds = np.r_[0, np.flatnonzero(np.diff(c_tmp)) + 1, nu]
    for i, j in zip(bounds[:-1], bounds[1:]):
        order[i:j] = order[i + rng.permutation(j - i)]
    rank = np.full(n, -1, np.int64)
    rank[order] = np.arange(nu)
    return order, rank, nu


def class_layout(c_sorted: np.ndarray, caps: dict | None = None):
    """(classes, node_start_pair, m_pairs, cap_node_pos, pair_stride)
    from the sorted class vector.

    Pallas-aligned regions (see ops/classops): small classes pad to
    BLK-row multiples with phantom node slots; hub classes (2c > 128)
    use the two-level hub-splitting layout — the class splits into
    q = 2c/128 sub-classes of 64 pairs (one whole row) per node,
    stored sub-class-major: region row j*cap + r is node r's j-th
    64-pair chunk, with the node capacity ``cap`` aligned (8 node
    slots, or BLK past BLK). A node's k-th pair slot is therefore not
    node-contiguous; address it through :func:`edge_pair_slot`.

    ``pair_stride``: int64 [nu] — the pair distance between a node's
    consecutive sub-class chunks (``cap * 64`` for split-class nodes;
    64 for small-class nodes, where it is never exercised because
    k < c <= 64 keeps every slot in chunk 0).

    ``caps``: optional forced per-class node-capacity minima
    (``{class: n_c_min}``) — the geometry-uniformization hook of the
    per-shard plans (``ops/sharddelivery.py``), which run one program
    geometry on every shard; classes present in ``caps`` but absent
    from this shard's data are injected with ``n_c = 0``.

    ``cap_node_pos``: int64 [nu] — each dense-ordered node's position in
    the capacity-padded node-slot sequence (classes occupy ``cap`` node
    slots each); the shard deliveries address that sequence.
    """
    nu = len(c_sorted)
    if nu:
        cb = np.r_[0, np.flatnonzero(np.diff(c_sorted)) + 1, nu]
        present = {int(c_sorted[i]): (int(i), int(j))
                   for i, j in zip(cb[:-1], cb[1:])}
    else:
        present = {}
    all_cls = sorted(set(present) | set(caps or {}))
    classes = []
    node_start_pair = np.zeros(nu, np.int64)
    cap_node_pos = np.zeros(nu, np.int64)
    pair_stride = np.full(nu, 64, np.int64)
    cursor = 0
    cap_nodes = 0
    for c in all_cls:
        i, j = present.get(c, (0, 0))
        n_c = j - i
        n_eff = max(n_c, (caps or {}).get(c, 0))
        if n_eff == 0:
            continue
        if 2 * c <= 128:
            rows = -(-(n_eff * 2 * c) // 128)
            rows = -(-rows // BLK) * BLK
            cap = rows * 128 // (2 * c)
            node_start_pair[i:j] = (cursor
                                    + np.arange(n_c, dtype=np.int64) * c)
        else:
            # hub split: q sub-classes of 64 pairs, sub-class-major; the
            # alignment is idempotent under forced caps
            q = (2 * c) // 128
            align = 8 if n_eff <= BLK else BLK
            cap = -(-n_eff // align) * align
            rows = q * cap
            node_start_pair[i:j] = (cursor
                                    + np.arange(n_c, dtype=np.int64) * 64)
            pair_stride[i:j] = cap * 64
        cap_node_pos[i:j] = cap_nodes + np.arange(n_c, dtype=np.int64)
        classes.append((c, n_c, int(cursor), int(rows), int(cap)))
        cursor += cap * c
        cap_nodes += cap
    return (tuple(classes), node_start_pair, int(cursor), cap_node_pos,
            pair_stride)


def edge_pair_slot(node_start_pair: np.ndarray, pair_stride: np.ndarray,
                   ranks: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Pair slot of the ``k``-th edge of the dense-rank-``ranks`` node
    under the (possibly hub-split) class layout: chunk k // 64 at
    in-chunk position k % 64. Small-class nodes (k < c <= 64) stay in
    chunk 0, so the formula degenerates to the pre-split
    ``node_start_pair + k`` byte-for-byte — layouts without hub
    classes produce identical tables."""
    return (node_start_pair[ranks] + (k >> 6) * pair_stride[ranks]
            + (k & 63))


def hub_split_counts(classes) -> Tuple[int, int, int]:
    """(split classes, total sub-classes, widest class) of a layout's
    classes tuple. Zero split classes means the layout is byte-identical
    to the pre-split flat layout."""
    split = [c for c, n_c, *_ in classes if 2 * c > 128]
    return (len(split), sum((2 * c) // 128 for c in split),
            max(split, default=0))


def split_pad_pairs_of(classes) -> int:
    """Pair slots a layout spends on split-class node-capacity padding
    (``(cap - n_eff) * c`` per hub class)."""
    return sum((cap - n_c) * c
               for c, n_c, _, _, cap in classes if 2 * c > 128)


def _apply_chain(plans, x: torch.Tensor, take_f32=None) -> torch.Tensor:
    """Run ``x`` through consecutive plans, then slice to ``take_f32``."""
    for p in plans:
        pad = p.m_in_f32 - x.shape[0]
        if pad < 0:
            x = x[: p.m_in_f32]
        elif pad:
            x = F.pad(x, (0, pad))
        x = apply_plan(p, x)
    return x if take_f32 is None else x[:take_f32]


class RoutedDelivery(NamedTuple):
    """The routed delivery of one topology. Host form (numpy leaves, from
    :func:`build_routed_delivery_np` or the plan cache) or placed
    (torch tensors, from ``convert.routed_delivery_from_numpy``); only
    the placed form has a working :meth:`matvec`."""

    n: int                       # real nodes
    nu: int                      # nodes with degree > 0
    m_pairs: int                 # class-layout pair slots (aligned)
    # (c, n_c, start_pair, region_rows, node_capacity) per class
    classes: Tuple[Tuple[int, int, int, int, int], ...]
    plan_in: Tuple[DevicePlan, ...]   # natural -> class order (chained)
    plan_m: Tuple[DevicePlan, ...]    # the edge permutation
    plan_out: Tuple[DevicePlan, ...]  # class -> natural order (chained)
    realmask: object             # f32 [2 * m_pairs] 1.0 on real slots
    degree: object               # int32 [n]

    def matvec(self, xs: torch.Tensor, xw: torch.Tensor):
        """(in_s, in_w)[i] = sum over neighbors j of (xs, xw)[j].

        Inputs may carry engine padding rows beyond ``n`` (ignored — pad
        rows have no edges); outputs are zero there."""
        rows = xs.shape[0]
        flat = torch.cat([xs[: self.n], xw[: self.n]])
        cls = _apply_chain(self.plan_in, flat, take_f32=self.nu * 2)
        segs = []
        off = 0
        for c, n_c, _start, _reg_rows, cap in self.classes:
            node_pairs = F.pad(cls[2 * off: 2 * (off + n_c)],
                               (0, 2 * (cap - n_c)))
            if 2 * c <= 128:
                segs.append(co.class_expand_small(node_pairs, c))
            else:
                segs.append(co.class_expand_split(node_pairs, c))
            off += n_c
        # a multiply by exactly 0.0 or 1.0, as in the JAX package (-0.0
        # for a negative value and NaN for a NaN where the mask is 0)
        e1 = torch.cat(segs) * self.realmask
        f = _apply_chain(self.plan_m, e1, take_f32=self.m_pairs * 2)
        ys = []
        for c, n_c, start, reg_rows, _cap in self.classes:
            region = f[2 * start: 2 * start + reg_rows * 128]
            if 2 * c <= 128:
                packed = co.class_reduce_small(region, c)
            else:
                packed = co.class_reduce_split(region, c)
            ys.append(packed[: 2 * n_c])
        yf = torch.cat(ys)
        nat = _apply_chain(self.plan_out, yf, take_f32=2 * self.n)
        out_s = F.pad(nat[: self.n], (0, rows - self.n))
        out_w = F.pad(nat[self.n:], (0, rows - self.n))
        return out_s, out_w


def matvec_payload(matvec, xs: torch.Tensor, xw: torch.Tensor):
    """Route a vector payload through an unchanged two-stream matvec (the
    JAX package's ``matvec_payload``).

    Every fused or routed delivery moves exactly two f32 streams a call.
    An ``[rows, d]`` payload plus the weight stream is ``d + 1`` streams,
    routed pairwise through ``ceil((d + 1) / 2)`` calls against the same
    plans: columns (0, 1), (2, 3), ..., ``xw`` last, an odd leftover
    paired with zeros. A 1-D ``xs`` is one direct call. Returns ``(in_s,
    in_w)`` with ``in_s`` shaped like ``xs``."""
    if xs.dim() == 1:
        return matvec(xs, xw)
    cols = [xs[:, k] for k in range(xs.shape[1])] + [xw]
    outs = []
    for i in range(0, len(cols) - 1, 2):
        a, b = matvec(cols[i], cols[i + 1])
        outs += [a, b]
    if len(cols) % 2:
        a, _ = matvec(cols[-1], torch.zeros_like(cols[-1]))
        outs.append(a)
    return torch.stack(outs[:-1], dim=1), outs[-1]


def mask_sender_rows(share_s: torch.Tensor, share_w: torch.Tensor,
                     round_key: torch.Tensor, clock: tuple,
                     gids: torch.Tensor):
    """Zero the outgoing shares of rows whose activation clock did not
    tick (``async_/clock.py``). The plans are static linear operators, so
    an idle sender is a zeroed input row: the plan, the ``share · deg``
    accounting and mass conservation compose unchanged. ``gids`` are
    global row ids."""
    from gossipprotocol_tpu_torch.async_.clock import activation_mask

    active = activation_mask(round_key, clock, gids)
    row = active if share_s.dim() == 1 else active[:, None]
    return (torch.where(row, share_s, torch.zeros_like(share_s)),
            torch.where(active, share_w, torch.zeros_like(share_w)))


def routed_streamed_bytes_per_round(rd: RoutedDelivery) -> int:
    """Edge-stream f32 bytes one matvec moves through the class layout:
    the interleaved ``[2 * m_pairs]`` slab (both expand output and reduce
    input)."""
    return 2 * int(rd.m_pairs) * 4


def build_routed_delivery_np(topo, progress=None) -> RoutedDelivery:
    """Compile the three routing plans for a topology (host, one-time):
    the JAX package's ``build_routed_delivery(topo, device=False)``, with
    numpy leaves — the form the plan cache serializes."""
    if topo.implicit_full:
        raise RoutedConfigError(
            "routed delivery: complete graph needs no edges "
            "(diffusion mixes in one round via reductions)")
    if topo.asymmetric:
        raise RoutedConfigError(
            "routed delivery: the edge-permutation pairing needs a "
            "symmetric simple graph; this reference-quirks topology "
            "carries directed/self/duplicate entries — use "
            "delivery='scatter'")
    n = topo.num_nodes
    offsets = np.asarray(topo.offsets, np.int64)
    indices = np.asarray(topo.indices, np.int64)
    degree = np.diff(offsets)
    # classes 128/256 (runs of 2-4 whole rows) sit between the lane
    # kernels (runs within one row) and the row kernels (runs of >= 8
    # rows, the Mosaic sublane-block minimum) — degree_classes merges
    # them up to 512. Cost: <= 8x slot padding on the degree-65..256
    # band, ~0.4% of a BA graph's nodes; ER never has such degrees.
    cls = degree_classes(degree)

    # class-major node order; WITHIN each class the order is shuffled
    # (seeded, deterministic). This is load-bearing, not cosmetic: the
    # radix plans use uniform per-(tile, bucket) run capacities sized by
    # the MAX cell count, which assumes flows spread randomly. A sorted
    # within-class order makes the delivery permutations near
    # block-diagonal (a line graph is the worst case: perfectly
    # diagonal), concentrating whole tiles into single buckets — CR blew
    # up to 64 rows and the final merge to K=39 stacked tiles before
    # this shuffle (measured at 60K BA m=4).
    order, rank, nu = class_order(cls, n)

    # class segment table with Pallas-aligned regions (see ops/classops):
    # small classes (2c <= 128 lanes) pad their region to BLK-row
    # multiples with phantom node slots; hub classes (2c > 128) take the
    # sub-class-major hub-splitting layout, with aligned node capacity.
    # Phantom/class-pad slots are -1 (never routed) and read as exact
    # zeros out of the final pass.
    classes, node_start_pair, m_pairs, _, pair_stride = class_layout(
        cls[order])

    if progress:
        progress(f"routed delivery: n={n} nu={nu} m_pairs={m_pairs} "
                 f"classes={[(c, k) for c, k, *_ in classes]}")

    # ---- plan_in: [xs | xw] concat -> interleaved class order -----------
    # unit=1 f32 routing: out slot 2r takes s of the r-th class node
    # (input slot order[r]), slot 2r+1 its w (slot n + order[r]) — the
    # plan absorbs the pair interleaving, which has no other
    # layout-safe spelling on TPU (a [n, 2] stack pads 2 -> 128 lanes,
    # and Mosaic rejects the lane<->sublane shape casts a kernel
    # spelling needs). Chained through a stride scramble: node ids
    # correlate with degree (BA growth order), so the class permutation
    # clusters sources into narrow tile bands — built directly, its
    # radix cells concentrate (measured K=62 final merge at 1M, a VMEM
    # OOM). rho(i) = i*P mod m spreads every contiguous band uniformly
    # and the composition inherits the spread.
    src_in = np.empty(2 * nu, np.int64)
    src_in[0::2] = order
    src_in[1::2] = n + order
    plans_in = _chained_plans(src_in, m_in=2 * n, progress=progress,
                              unit=1)

    # ---- plan_m: edge permutation on the class layout -------------------
    # directed edge e (row u, slot k): E1 slot = node_start_pair[rank[u]] + k
    # its value lands at (v, rank of reverse edge v->u in v's row)
    src_nodes = np.repeat(np.arange(n, dtype=np.int64), degree)
    e1_slot = edge_pair_slot(
        node_start_pair, pair_stride, rank[src_nodes],
        np.arange(len(indices), dtype=np.int64) - offsets[src_nodes])
    # reverse-edge rank: position of (v, u) in v's row, via sort pairing.
    # The canonical CSR is (u, v)-lexicographic already (csr_from_edges
    # sorts every row), so the forward order is free — RECHECKED cheaply
    # because a hand-built Topology with an unsorted row would otherwise
    # silently pair edges with the wrong reverse slots (same invariant
    # pattern as gossip.reverse_slot_table). The reverse order is one
    # combined-key argsort.
    if len(indices) and not bool(
            (np.diff(src_nodes * np.int64(n) + indices) > 0).all()):
        raise ValueError(
            "routed delivery requires canonical CSR rows (sorted, "
            "deduplicated neighbors) — build the topology via "
            "csr_from_edges")
    fwd = np.arange(len(indices), dtype=np.int64)
    rev = plan_mod.argsort_pairs(indices, src_nodes, n)
    # edge (u->v) pairs with edge (v->u): the i-th entry of fwd-sorted
    # (u,v) equals the i-th entry of rev-sorted (v,u) swapped
    reverse_of = np.empty(len(indices), np.int64)
    reverse_of[fwd] = rev
    in_rank = np.empty(len(indices), np.int64)
    in_rank[reverse_of] = np.arange(len(indices)) - offsets[src_nodes]
    f_slot = edge_pair_slot(node_start_pair, pair_stride,
                            rank[indices], in_rank)
    src_of_m = np.full(m_pairs, -1, np.int64)
    src_of_m[f_slot] = e1_slot
    # every non-real slot (class pad, phantom, alignment) stays -1: the
    # final routing pass emits exact zeros for don't-care slots, which
    # is precisely what pads must deliver — no pad flows to route at all
    realmask_pairs = np.zeros(m_pairs, bool)
    realmask_pairs[e1_slot] = True
    realmask = np.repeat(realmask_pairs, 2).astype(np.float32)
    # Chained like the N-plans: even with the within-class shuffle, a
    # hub's out-slot tiles target single class regions (its neighbors'
    # classes aren't uniform), skewing bucket loads ~7x on power-law
    # graphs (measured: max cell 463 pairs vs avg 64 at 1M BA, O=8).
    # The stride chain makes cell loads uniform for ANY permutation at
    # the price of one extra routed pass; per-bucket capacities would
    # recover that pass and are the noted follow-up.
    plans_m = _chained_plans(src_of_m, m_in=m_pairs, progress=progress)

    # ---- plan_out: interleaved class order -> [s | w] concat ------------
    # degree-0 nodes receive nothing: -1 slots read as exact zeros (the
    # final pass accumulates from zero under an all-false mask)
    src_out = np.full(2 * n, -1, np.int64)
    has = degree > 0
    src_out[:n][has] = 2 * rank[has]
    src_out[n:][has] = 2 * rank[has] + 1
    plans_out = _chained_plans(src_out, m_in=2 * nu, progress=progress,
                               unit=1)

    return RoutedDelivery(
        n=n, nu=nu, m_pairs=m_pairs, classes=classes,
        plan_in=tuple(device_plan(p) for p in plans_in),
        plan_m=tuple(device_plan(p) for p in plans_m),
        plan_out=tuple(device_plan(p) for p in plans_out),
        realmask=realmask,
        degree=np.asarray(degree, np.int32),
    )


def build_routed_delivery(topo, progress=None, device="cuda"
                          ) -> RoutedDelivery:
    """:func:`build_routed_delivery_np`, placed on ``device`` (``cuda``
    unless the caller asks for ``cpu``)."""
    from gossipprotocol_tpu_torch.convert import routed_delivery_from_numpy
    from gossipprotocol_tpu_torch.ops.build import resolve_device

    dev = resolve_device(device)  # fail before the host build
    return routed_delivery_from_numpy(
        build_routed_delivery_np(topo, progress=progress), device=dev)


def _check_geometry(name: str, p) -> None:
    """Loud failure if a plan's capacities concentrated (SURVEY §5.6).

    The radix scheme sizes runs by the max per-(tile, bucket) cell; the
    within-class shuffle and random pad pairing are supposed to keep the
    edge permutation spread. If a topology still concentrates cells, the
    kernels would compile huge merges (or OOM VMEM) — fail at build time
    with the knob to turn instead.
    """
    worst_o = max((st.o for st in p.stages), default=1)
    if worst_o > 4 or p.final.k > 6:
        raise RoutedConfigError(
            f"routed delivery: {name} routing concentrated (stacked "
            f"tiles O={worst_o}, final merge K={p.final.k}) — this "
            "topology defeats the class-shuffle spreading; use "
            "delivery='scatter' and report the config"
        )


def _chained_plans(src_of: np.ndarray, m_in: int, progress=None,
                   unit: int = 2, cr_floors=None,
                   geometry_only: bool = False):
    """Two well-spread plans implementing one structured permutation.

    rho(i) = i * P mod m (P coprime to m): every contiguous input band
    spreads uniformly over output tiles, so BOTH rho and
    (src_of o rho^-1) route with minimal capacities regardless of how
    clustered ``src_of`` is.  Returns plans applied left-to-right.

    ``cr_floors``: pair of per-stage capacity-floor tuples (one per
    chained plan) and ``geometry_only`` — both forwarded to
    :func:`~gossipprotocol_tpu_torch.ops.plan.build_route_plan` for the
    cross-shard geometry uniformization (see ops/sharddelivery.py).
    """
    m = int(m_in)
    p_stride = _coprime_stride(m)
    k = np.arange(m, dtype=np.int64)
    rho = (k * p_stride) % m                 # out slot j <- in slot rho[j]
    rho_inv = np.empty(m, np.int64)
    rho_inv[rho] = k
    f1, f2 = cr_floors if cr_floors is not None else (None, None)
    plan1 = plan_mod.build_route_plan(rho, m_in=m, unit=unit,
                                      progress=progress, cr_floors=f1,
                                      geometry_only=geometry_only)
    src2 = np.where(src_of >= 0, rho_inv[np.clip(src_of, 0, m - 1)], -1)
    plan2 = plan_mod.build_route_plan(src2, m_in=m, unit=unit,
                                      progress=progress, cr_floors=f2,
                                      geometry_only=geometry_only)
    _check_geometry("stride plan", plan1)
    _check_geometry("descrambled plan", plan2)
    return (plan1, plan2)


def _coprime_stride(m: int) -> int:
    """A large multiplier coprime to m (golden-ratio-ish spread)."""
    import math

    if m <= 2:
        return 1
    p = int(m * 0.6180339887) | 1
    while math.gcd(p, m) != 1:
        p += 2
    return p
