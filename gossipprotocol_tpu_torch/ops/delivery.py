"""Degree-class geometry of the fanout-all deliveries (host side, numpy).

The host half of ``gossipprotocol_tpu/ops/delivery.py``, copied: degree
classes, the class-major node order with its load-bearing ``0xC105``
within-class shuffle, the Pallas-aligned class layout (small classes
padded to BLK-row multiples; hub classes split into one-row sub-classes,
sub-class-major) and the pair-slot addressing of each edge. The fused
gather delivery (``ops/pallasdelivery.py``) builds its tables from these,
so its fold regions are the JAX package's byte for byte. The routed
delivery itself (plans, expand kernels, the Clos executor) is not yet
ported.
"""

from __future__ import annotations

import numpy as np

from gossipprotocol_tpu_torch.ops.classops import BLK


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


def class_layout(c_sorted: np.ndarray):
    """(classes, node_start_pair, m_pairs, pair_stride) from the sorted
    class vector (the single-chip form of the JAX package's
    ``class_layout``: no forced per-shard capacities).

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
    """
    nu = len(c_sorted)
    cb = np.r_[0, np.flatnonzero(np.diff(c_sorted)) + 1, nu] if nu else []
    classes = []
    node_start_pair = np.zeros(nu, np.int64)
    pair_stride = np.full(nu, 64, np.int64)
    cursor = 0
    for i, j in zip(cb[:-1], cb[1:]):
        c, n_c = int(c_sorted[i]), int(j - i)
        if 2 * c <= 128:
            rows = -(-(n_c * 2 * c) // 128)
            rows = -(-rows // BLK) * BLK
            cap = rows * 128 // (2 * c)
            node_start_pair[i:j] = (cursor
                                    + np.arange(n_c, dtype=np.int64) * c)
        else:
            # hub split: q sub-classes of 64 pairs, sub-class-major
            q = (2 * c) // 128
            align = 8 if n_c <= BLK else BLK
            cap = -(-n_c // align) * align
            rows = q * cap
            node_start_pair[i:j] = (cursor
                                    + np.arange(n_c, dtype=np.int64) * 64)
            pair_stride[i:j] = cap * 64
        classes.append((c, n_c, int(cursor), int(rows), int(cap)))
        cursor += cap * c
    return tuple(classes), node_start_pair, int(cursor), pair_stride


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
