"""Routing-plan compiler: a static permutation as a radix pipeline (port
of ``gossipprotocol_tpu/ops/plan.py``, host side, copied).

Given a build-time-known permutation of M value units (unit = 1 f32 or a
2-lane (s, w) pair), produce a plan of stream-speed passes the executor
(``ops/exec.py``) runs every round:

    stage 1..L   each input [128,128] tile applies one Clos tile
                 permutation (``ops/clos.py``) that groups its units by
                 the next radix digit of their destination tile, then
                 writes per-bucket runs into a strided staging slab.
                 After stage l every unit sits in a contiguous staging
                 *region* shared only with units whose final tile agrees
                 on the first l digits.
    final pass   each final tile's region (K stacked tiles, capacity
                 padding included) is merged by K masked Clos perms into
                 the exact output tile.

All capacities are computed from the **actual** per-(tile, bucket)
counts: CR (rows per run) is the exact max, rounded up to a power-of-two
divisor of 128 so regions stay 128-row aligned.

Conventions
-----------
``src_of``: int64 ``[M_out]`` (unit granularity).  ``src_of[k] = s`` means
output unit slot ``k`` receives input unit ``s``; ``-1`` marks an output
slot whose value is never read downstream (tile-padding tail).  Real
entries must be distinct (injective).  Slots that *are* read but should
be zero (class padding in the delivery layouts) must instead map to
zero-valued input slots — the router moves values, it never makes them.

The tables come out byte-equal to the JAX package's: the same numpy code
and the same native library source (``native.py``) build them.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

from gossipprotocol_tpu_torch.ops import clos

TILE = clos.TILE  # 16384 f32 slots


class StagePass(NamedTuple):
    """One radix-distribution pass (geometry + routing tables)."""

    p: int            # regions at this stage's input
    tau_in: int       # input tiles per region
    b: int            # buckets (radix) per region
    cr: int           # rows per (input tile, bucket) run — pow2, | 128
    o: int            # stacked output tiles routed per input tile
    tau_slab: int     # slab Tin-axis length (tau_in padded for alignment)
    idx: np.ndarray   # int8 [p*tau_in, o, 3, 128, 128]


class FinalPass(NamedTuple):
    k: int            # stacked input tiles per final region
    idx: np.ndarray   # int8 [nt_out, k, 3, 128, 128]
    mask: np.ndarray  # uint8 [nt_out, k, 128, 128] — source-k selector


class RoutePlan(NamedTuple):
    unit: int
    u: int            # units per tile
    nt_in: int
    nt_out: int
    stages: Tuple[StagePass, ...]
    final: FinalPass

    @property
    def m_in(self) -> int:
        return self.nt_in * self.u

    @property
    def m_out(self) -> int:
        return self.nt_out * self.u


def argsort_pairs(primary: np.ndarray, secondary: np.ndarray,
                  bound: int) -> np.ndarray:
    """``np.lexsort((secondary, primary))`` as one combined-key argsort.

    ``bound``: exclusive upper bound of ``secondary`` (checked: the
    packed key must fit int64). Ties broken stably.
    """
    primary = np.asarray(primary, np.int64)
    secondary = np.asarray(secondary, np.int64)
    if primary.size and int(primary.max()) >= (1 << 63) // max(bound, 1):
        return np.lexsort((secondary, primary))  # key would overflow
    return np.argsort(primary * np.int64(bound) + secondary,
                      kind="stable")


def _pow2_cr(rows: int) -> int:
    """Round run rows up to a power of two (<= 128) so runs divide 128."""
    cr = 1
    while cr < rows:
        cr *= 2
    if cr > 128:
        raise ValueError(f"run of {rows} rows exceeds one tile")
    return cr


def _complete_bijections(perm: np.ndarray, u: int) -> np.ndarray:
    """Fill -1 slots of each row so every row is a bijection of [0, u).

    ``perm``: int64 [R, u] with real entries distinct per row.  The fill
    pairs each row's unused sources with its -1 slots in order.
    """
    r, width = perm.shape
    assert width == u
    out = perm.copy()
    ar_u = np.arange(u)
    # row chunks keep the [chunk, u] work arrays at tens of MB; the
    # unchunked version materialized several [R, u] int64 temporaries and
    # hit ~8 GB during a 1M-pair plan build (measured)
    chunk = 512
    for lo in range(0, r, chunk):
        p = out[lo: lo + chunk]
        c = p.shape[0]
        real = p >= 0
        rows_c = np.broadcast_to(np.arange(c)[:, None], (c, u))
        used = np.zeros((c, u), bool)
        used[rows_c[real], p[real]] = True
        assert (used.sum(1) == real.sum(1)).all(), "perm rows not injective"
        free_src = ~used
        slot_rank = np.cumsum(~real, axis=1) - 1   # rank among -1 slots
        src_rank = np.cumsum(free_src, axis=1) - 1  # rank among free sources
        table = np.full((c, u), -1, np.int64)      # table[row, rank] = src
        table[rows_c[free_src], src_rank[free_src]] = (
            np.broadcast_to(ar_u, (c, u))[free_src])
        p[~real] = table[rows_c[~real], slot_rank[~real]]
    return out


def _pack_stage(pos: np.ndarray, bucket: np.ndarray, u: int, b: int,
                t_grid: int):
    """Run packing for one stage: rank each flow within its
    (tile, bucket) run in ascending-``pos`` order, and measure the
    longest run (units).

    Native counting pass when available (O(F + slots), OpenMP over
    tiles); fallback is the combined-key stable argsort.  Both assign
    identical ranks — a tile's unit slots are contiguous in pos space,
    so scanning slots ascending within a tile visits its flows in
    exactly the argsort's within-run order (asserted bitwise in
    tests/test_native.py).
    """
    from gossipprotocol_tpu_torch import native

    got = native.plan_stage_pack(pos, bucket, u, b, t_grid)
    if got is not None:
        return got
    tile = pos // u
    # Combined-key argsort = the lexsort, 3.3x faster on a 1-core
    # host (measured, 16M elements: 10.8 s -> 3.3 s); ranges fit
    # int64 comfortably at every supported scale (pos < 2^36,
    # tile*b + bucket < 2^27 at 100M nodes)
    if pos.size and int(pos.max()) < (1 << 36) and (
            int(tile.max()) * b + int(b) < (1 << 27)):
        order = np.argsort(
            ((tile * b + bucket) << np.int64(36)) | pos,
            kind="stable")
    else:
        order = np.lexsort((pos, bucket, tile))
    key = tile[order] * b + bucket[order]
    run_start = np.r_[0, np.nonzero(np.diff(key))[0] + 1]
    run_len = np.diff(np.r_[run_start, key.size])
    rank = np.empty(pos.size, np.int64)
    rank[order] = np.arange(key.size) - np.repeat(run_start, run_len)
    return rank, int(run_len.max()) if key.size else 0


def _place_stage(pos: np.ndarray, bucket: np.ndarray, rank: np.ndarray,
                 u: int, unit: int, b: int, cr: int, o: int, tau_in: int,
                 tau_slab: int, perm=None) -> np.ndarray:
    """Flow placement for one stage: the staging-slab position of each
    flow, plus (when ``perm`` is given) the per-(tile, o) output-slot
    permutation scatter — native fused pass with a numpy mirror.
    """
    from gossipprotocol_tpu_torch import native

    got = native.plan_stage_place(pos, bucket, rank, u, unit, b, cr, o,
                                  tau_in, tau_slab, perm=perm)
    if got is not None:
        return got
    upr = 128 // unit
    tile = pos // u
    rr, rm = rank // upr, rank % upr
    reg = tile // tau_in
    tile_in_reg = tile - reg * tau_in
    # staging rows: ((reg*b + bucket)*tau_slab + tile_in_reg)*cr + row
    new_pos = ((((reg * b + bucket) * tau_slab + tile_in_reg) * cr + rr)
               * upr + rm)
    if perm is not None:
        out_slot = (bucket * cr + rr) * upr + rm   # unit slot in [0, o*u)
        perm.reshape(-1)[tile * (o * u) + out_slot] = pos % u
    return new_pos


_IDENTITY_IDX: dict = {}


def _identity_routed_idx(unit: int) -> np.ndarray:
    """The routed idx of an all-don't-care tile (completed to identity).

    Sharded plans route heavily padded slabs — every shard's send/recv
    tables are sized for the *largest* block, so most shards' perms are
    dominated by tiles with no real entry at all. Any proper routing of
    an empty tile is valid; this one is computed once and reused, which
    is what makes the S-shard build cost scale with real edges instead
    of padded slab size.
    """
    got = _IDENTITY_IDX.get(unit)
    if got is None:
        u = TILE // unit
        got = _routed_idx_colored(np.full((1, u), -1, np.int64), unit)[0]
        _IDENTITY_IDX[unit] = got
    return got


def _routed_idx(perm: np.ndarray, unit: int) -> np.ndarray:
    """Per-tile perms (``-1`` slots allowed) -> stacked int8 [R, 3, 128, 128].

    All-don't-care tiles short-circuit to a shared identity route; the
    rest go through the coloring backends.
    """
    perm = np.asarray(perm, np.int64)
    empty = (perm < 0).all(axis=1)
    if not empty.any():
        return _routed_idx_colored(perm, unit)
    out = np.empty((len(perm), 3, 128, 128), np.int8)
    out[empty] = _identity_routed_idx(unit)
    if not empty.all():
        out[~empty] = _routed_idx_colored(perm[~empty], unit)
    return out


def _routed_idx_colored(perm: np.ndarray, unit: int) -> np.ndarray:
    """The full completion + coloring + assembly pipeline.

    Native fused path (completion + coloring + assembly in one C++ pass,
    ~10x the numpy spelling on a 1-core host) with the original numpy
    pipeline as fallback. Either path yields a valid routing of the real
    entries; don't-care slots may route differently (same contract as the
    two coloring backends — any proper coloring routes).
    """
    from gossipprotocol_tpu_torch import native

    got = native.route_tiles_full(perm, unit)
    if got is not None:
        return got
    u = perm.shape[1]
    completed = _complete_bijections(np.asarray(perm, np.int64), u)
    i1, i2, i3 = clos.route_tile_perms(completed, unit=unit)
    return np.stack([i1, i2, i3], axis=1)


def build_route_plan(src_of: np.ndarray, m_in: int, unit: int = 2,
                     progress=None, cr_floors=None,
                     geometry_only: bool = False) -> RoutePlan:
    """Compile the permutation into a radix pipeline plan.

    ``cr_floors``: optional per-stage run-capacity minima (each a pow2
    ≤ 128) — the geometry-uniformization hook for per-shard plans under
    shard_map: every stage's ``cr`` (and everything derived: ``o``,
    ``tau_slab``, the final merge ``k``) is data-dependent, and shards
    must share ONE geometry, so callers force each to the cross-shard
    maximum. ``geometry_only=True`` skips the (expensive) tile routing
    and returns a plan whose ``idx`` arrays are None — just enough to
    *read* the geometry for computing those maxima cheaply.
    """
    src_of = np.asarray(src_of, np.int64)
    u = TILE // unit
    nt_out = max(1, -(-len(src_of) // u))
    nt_in = max(1, -(-m_in // u))
    m_out_pad = nt_out * u
    if len(src_of) < m_out_pad:
        src_of = np.concatenate(
            [src_of, np.full(m_out_pad - len(src_of), -1, np.int64)])

    real = np.nonzero(src_of >= 0)[0]          # output slots with a flow
    pos = src_of[real].copy()                  # current position of flows
    ft = real // u                             # final tile of each flow
    if real.size:
        counts = np.bincount(src_of[real], minlength=nt_in * u)
        if counts.max(initial=0) > 1:
            raise ValueError("src_of is not injective on real slots")

    stages: List[StagePass] = []
    p_regions, tau_in, span = 1, nt_in, nt_out
    stage_no = 0
    while span > 1:
        stage_no += 1
        b = min(128, span)
        span_next = -(-span // b)
        # flow coordinates at this stage
        tile = pos // u                        # global input tile
        reg = tile // tau_in                   # region (= first digits)
        ft_rel = ft - reg * span
        bucket = ft_rel // span_next
        if (bucket < 0).any() or (bucket >= b).any():
            raise AssertionError("bucket out of range (compiler bug)")
        # run packing: rank flows within their (tile, bucket) run; the
        # longest run sets the stage's capacity
        t_grid = p_regions * tau_in
        rank, max_run = _pack_stage(pos, bucket, u, b, t_grid)
        upr = 128 // unit
        max_rows = int(-(-max_run // upr)) if pos.size else 1
        cr = _pow2_cr(max_rows)
        if cr_floors is not None and stage_no - 1 < len(cr_floors):
            cr = max(cr, int(cr_floors[stage_no - 1]))
        o = -(-b * cr // 128)
        tau_slab = -(-(tau_in * cr) // 128) * (128 // cr)
        # per-(tile, o) bijections + new positions in the staging layout
        if geometry_only:
            idx = None
            new_pos = _place_stage(pos, bucket, rank, u, unit, b, cr, o,
                                   tau_in, tau_slab)
        else:
            perm = np.full((t_grid * o, u), -1, np.int64)
            new_pos = _place_stage(pos, bucket, rank, u, unit, b, cr, o,
                                   tau_in, tau_slab, perm=perm)
            if progress:
                progress(
                    f"stage {stage_no}: routing {t_grid * o} tile perms")
            idx = _routed_idx(perm, unit).reshape(t_grid, o, 3, 128, 128)
        stages.append(StagePass(p_regions, tau_in, b, cr, o, tau_slab, idx))
        pos = new_pos
        p_regions *= b
        tau_in = tau_slab * cr // 128
        span = span_next

    # final pass: region r holds exactly final tile r's flows
    k = tau_in
    tile = pos // u
    reg = tile // k
    if real.size and not (reg == ft).all():
        raise AssertionError("flows not in their final region (bug)")
    if geometry_only:
        return RoutePlan(unit, u, nt_in, nt_out, tuple(stages),
                         FinalPass(k, None, None))
    perm = np.full((nt_out * k, u), -1, np.int64)
    stacked = tile - reg * k                   # which of the K inputs
    perm[ft * k + stacked, real % u] = pos % u
    if progress:
        progress(f"final: routing {nt_out * k} tile perms")
    idx = _routed_idx(perm, unit).reshape(nt_out, k, 3, 128, 128)
    mask = np.zeros((nt_out, k, 128, 128), np.uint8)
    fr = (real % u) * unit // 128              # final slot f32 row
    fc = (real % u) * unit % 128
    for j in range(unit):
        mask[ft, stacked, fr, fc + j] = 1
    return RoutePlan(unit, u, nt_in, nt_out, tuple(stages),
                     FinalPass(k, idx, mask))


# --------------------------------------------------------------------------
# host reference executor (numpy) — the exactness oracle for the kernels
# --------------------------------------------------------------------------

def apply_plan_np(plan: RoutePlan, x: np.ndarray) -> np.ndarray:
    """Run the pipeline in numpy; returns the routed f32 array.

    ``x``: f32 [nt_in*TILE] (f32 granularity).  Output slots marked -1 at
    compile time hold unspecified values.
    """
    x = np.asarray(x, np.float32).reshape(plan.nt_in, 128, 128)
    cur = x
    for st in plan.stages:
        t_grid = st.p * st.tau_in
        slab = np.zeros((st.p * st.b * st.tau_slab * st.cr, 128), np.float32)
        for t in range(t_grid):
            parts = []
            for o_i in range(st.o):
                i1, i2, i3 = st.idx[t, o_i]
                parts.append(clos.apply_route_np(cur[t], i1, i2, i3))
            rows = np.concatenate(parts, 0)[: st.b * st.cr]
            reg, i = t // st.tau_in, t % st.tau_in
            for bb in range(st.b):
                base = ((reg * st.b + bb) * st.tau_slab + i) * st.cr
                slab[base: base + st.cr] = rows[bb * st.cr:(bb + 1) * st.cr]
        cur = slab.reshape(-1, 128, 128)
    fin = plan.final
    out = np.zeros((plan.nt_out, 128, 128), np.float32)
    for ftile in range(plan.nt_out):
        acc = np.zeros((128, 128), np.float32)
        for kk in range(fin.k):
            i1, i2, i3 = fin.idx[ftile, kk]
            y = clos.apply_route_np(cur[ftile * fin.k + kk], i1, i2, i3)
            acc = np.where(fin.mask[ftile, kk].astype(bool), y, acc)
        out[ftile] = acc
    return out.reshape(-1)
