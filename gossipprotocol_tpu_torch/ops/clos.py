"""Tile-level Clos routing: arbitrary [128,128] permutations from three
lane gathers and two transposes (port of ``gossipprotocol_tpu/ops/
clos.py``, host side, copied).

Any permutation of a [128, 128] tile factors as

    Y = G3( T( G2( T( G1(X) ) ) ) )

(G* = ``take_along_axis(.., axis=1)``, T = transpose) -- the 3-stage
Clos construction: stage 1 places each element into its assigned
*middle lane* within its source row, stage 2 is a within-column
permutation realized as T.G.T, stage 3 parks the element at its final
lane. The middle-lane assignment is a proper n-edge-coloring of the
bipartite multigraph src_row -> dst_row (Koenig), computed by Euler
splitting in ``csrc/host/routecolor.cpp`` (``native.py``) or, under
``GOSSIP_TPU_NATIVE=0``, by the numpy/python mirror below.

Elements are routed at ``unit`` granularity (``unit=2`` keeps (s, w)
pairs in adjacent f32 lanes moving together), so the coloring works on
the n=128-row, (128/unit)-regular multigraph and index arrays are
expanded back to f32 lanes. On the card the three gathers compose into
one gather per output element (``ops/exec.py``).
"""

from __future__ import annotations

import numpy as np

from gossipprotocol_tpu_torch import native

ROWS = 128          # tile rows (sublanes x 16)
LANES = 128         # tile lanes
TILE = ROWS * LANES  # f32 slots per tile


def euler_color_numpy(src_rows: np.ndarray, dst_rows: np.ndarray,
                      deg: int) -> np.ndarray:
    """Pure-python Euler-split coloring — mirror of routecolor.cpp.

    ``src_rows``/``dst_rows``: int ``[T, 128*deg]``; returns int32 colors
    of the same shape, each tile properly ``deg``-edge-colored.  Slow
    (python Hierholzer) — used for tests and under
    ``GOSSIP_TPU_NATIVE=0``.
    """
    src_rows = np.asarray(src_rows)
    dst_rows = np.asarray(dst_rows)
    squeeze = src_rows.ndim == 1
    if squeeze:
        src_rows = src_rows[None]
        dst_rows = dst_rows[None]
    T, E = src_rows.shape
    assert E == ROWS * deg and deg & (deg - 1) == 0
    out = np.empty((T, E), np.int32)

    def split(ids, s, d, c0, nc, color):
        if d == 1:
            color[ids] = c0
            return
        # incidence lists over 2*ROWS vertices; entry 2k / 2k+1 = edge
        # ids[k] seen from its left / right endpoint.  Built vectorized:
        # a stable argsort groups entries by vertex in ascending entry
        # order, so each group's chain (head = last entry, nxt = the
        # previous one) reproduces the sequential scatter loop exactly —
        # same traversal, bitwise-same coloring (the python spelling was
        # ~60% of fallback build time at 1M pairs)
        ne = 2 * len(ids)
        vtx = np.empty(ne, np.int64)
        vtx[0::2] = s[0][ids]
        vtx[1::2] = ROWS + s[1][ids]
        by_v = np.argsort(vtx, kind="stable")
        vs = vtx[by_v]
        first = np.r_[True, vs[1:] != vs[:-1]]
        nxt = np.empty(ne, np.int64)
        nxt[by_v] = np.where(first, -1, np.r_[-1, by_v[:-1]])
        head = np.full(2 * ROWS, -1, np.int64)
        last = np.r_[first[1:], True] if ne else first
        head[vs[last]] = by_v[last]
        used = np.zeros(len(ids), bool)
        halves = ([], [])
        for start in range(2 * ROWS):
            if head[start] < 0:
                continue
            stack = [start]
            while stack:
                vtx = stack[-1]
                ent = head[vtx]
                while ent >= 0 and used[ent >> 1]:
                    ent = nxt[ent]
                head[vtx] = ent
                if ent < 0:
                    stack.pop()
                    continue
                k = ent >> 1
                used[k] = True
                from_left = (ent & 1) == 0
                halves[0 if from_left else 1].append(ids[k])
                e = ids[k]
                stack.append(ROWS + s[1][e] if from_left else s[0][e])
        split(np.asarray(halves[0]), s, d // 2, c0, nc // 2, color)
        split(np.asarray(halves[1]), s, d // 2, c0 + nc // 2, nc // 2, color)

    for t in range(T):
        split(np.arange(E, dtype=np.int64), (src_rows[t], dst_rows[t]),
              deg, 0, deg, out[t])
    return out[0] if squeeze else out


def color_tiles(src_rows: np.ndarray, dst_rows: np.ndarray,
                deg: int) -> np.ndarray:
    """Proper deg-edge-coloring: native unless ``GOSSIP_TPU_NATIVE=0``."""
    got = native.route_color_tiles(src_rows, dst_rows, ROWS, deg)
    if got is not None:
        return got
    return euler_color_numpy(src_rows, dst_rows, deg)


def route_tile_perms(perms: np.ndarray, unit: int = 2):
    """Compile per-tile unit permutations into lane-gather index triples.

    ``perms``: int ``[T, U]`` with ``U = TILE // unit``; row t is a
    *bijection* of ``[0, U)`` giving, for each output unit slot, its
    source unit slot within the same tile.  Returns
    ``(idx1, idx2, idx3)`` int8 ``[T, 128, 128]`` such that

        a = np.take_along_axis(x,   idx1, axis=1)
        b = np.take_along_axis(a.T, idx2, axis=1)
        y = np.take_along_axis(b.T, idx3, axis=1)

    applies the f32-level permutation (units of ``unit`` adjacent lanes
    move together) to each [128, 128] tile.
    """
    perms = np.asarray(perms, np.int64)
    squeeze = perms.ndim == 1
    if squeeze:
        perms = perms[None]
    T, U = perms.shape
    upr = LANES // unit            # units per row
    assert U == ROWS * upr, (U, upr)

    if T > 512:
        # tile batches bound the [T, U] int64 temporaries below (~tens of
        # MB per batch instead of GBs at 10M-scale plans); slices land in
        # preallocated outputs so the idx triples are never held twice
        i1 = np.empty((T, ROWS, LANES), np.int8)
        i2 = np.empty((T, ROWS, LANES), np.int8)
        i3 = np.empty((T, ROWS, LANES), np.int8)
        for lo in range(0, T, 512):
            a, b, c = route_tile_perms(perms[lo: lo + 512], unit=unit)
            i1[lo: lo + 512], i2[lo: lo + 512], i3[lo: lo + 512] = a, b, c
        return i1, i2, i3

    src_row = (perms // upr).astype(np.int32)
    src_col = (perms % upr).astype(np.int32)
    k = np.arange(U, dtype=np.int64)
    dst_row = np.broadcast_to(k // upr, perms.shape).astype(np.int32)
    dst_col = np.broadcast_to(k % upr, perms.shape).astype(np.int32)

    color = color_tiles(src_row, dst_row, upr)

    i1 = np.zeros((T, ROWS, upr), np.int8)
    i2 = np.zeros((T, LANES, ROWS), np.int8)
    i3 = np.zeros((T, ROWS, upr), np.int8)
    trow = np.repeat(np.arange(T, dtype=np.int64)[:, None], U, 1)
    i1[trow, src_row, color] = src_col
    i3[trow, dst_row, dst_col] = color
    # stage 2 runs at f32 granularity on A.T: every f32 lane of a unit
    # column carries the same row move
    u_off = np.arange(unit, dtype=np.int64)
    f32col = (color.astype(np.int64) * unit)[..., None] + u_off  # [T,U,unit]
    i2[trow[..., None], f32col, dst_row[..., None]] = (
        src_row[..., None].astype(np.int8))

    # expand stage 1/3 to f32 lanes: idx[r, c*unit + j] = idxu[r, c]*unit + j
    def expand(iu):
        f = (iu.astype(np.int16) * unit)[..., None] + np.arange(
            unit, dtype=np.int16)
        out = f.reshape(T, ROWS, LANES).astype(np.int8)
        return out

    idx1, idx3 = expand(i1), expand(i3)
    idx2 = i2
    if squeeze:
        return idx1[0], idx2[0], idx3[0]
    return idx1, idx2, idx3


def apply_route_np(x: np.ndarray, idx1, idx2, idx3) -> np.ndarray:
    """Host reference of the kernel's 3-gather pipeline (one tile)."""
    a = np.take_along_axis(x, idx1.astype(np.int64), axis=1)
    b = np.take_along_axis(a.T, idx2.astype(np.int64), axis=1)
    return np.take_along_axis(b.T, idx3.astype(np.int64), axis=1)
