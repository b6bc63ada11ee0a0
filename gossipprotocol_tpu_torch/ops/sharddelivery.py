"""Sharded push-design delivery: per-shard routed plans and the edge-share
exchange (port of the push half of ``gossipprotocol_tpu/ops/
sharddelivery.py``; the pull design, plan patching and the streamed build
are not yet ported).

Each shard owns a contiguous block of ``local_n`` rows. Per matvec it
expands only its owned rows, routes the expanded edge shares to
``[f_local | slab]`` — intra-shard edges straight to their reduce slots,
cross-shard edges into the block of their destination shard — then the
``[S, 2*block_pairs]`` slabs are exchanged (``out[s]`` on shard ``d`` =
``slab[d]`` on shard ``s``) and each shard routes ``[f_local | incoming]``
to its reduce slots and folds. Every table is O(E/S + local_n), checked at
build time.

The host compiler is copied (numpy and the routecolor library): per-class
node capacities, the slab block capacity and every plan stage's run
capacity are forced to the cross-shard maxima, so every shard has one
program geometry, and the stacked tables (leading shard axis) are the
JAX package's byte for byte — plan-cache entries are shared both ways.
Build workers never touch the card: they return numpy tables, and the
parent places them.

The JAX package runs one SPMD program per shard under ``shard_map``. On
one card the port runs the shards in lockstep instead: phase 1 (plan_in,
expand, realmask, plan_send) per shard, the exchange once over all
shards, phase 2 (plan_recv, fold, plan_out) per shard. Every pass moves
values only and the folds are the single-card trees, so the S-shard
matvec equals the single-card routed matvec bitwise under the f32 wire.
"""

from __future__ import annotations

import multiprocessing
import os
import time
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gossipprotocol_tpu_torch.ops import classops as co
from gossipprotocol_tpu_torch.ops.delivery import (
    RoutedConfigError,
    _apply_chain,
    _chained_plans,
    class_layout,
    class_order,
    degree_classes,
    edge_pair_slot,
    split_pad_pairs_of,
)
from gossipprotocol_tpu_torch.ops.exec import DevicePlan, device_plan
from gossipprotocol_tpu_torch.protocols.diffusion import _keep
from gossipprotocol_tpu_torch.protocols.pushsum import (
    finish_pushsum_round, rowmask, sum0,
)

EXCHANGES = ("all_to_all", "pallas", "overlap")
# float32 1/127: the int8 wire's scale factor (see quantize_int8)
_INV_127 = float(np.float32(1.0) / np.float32(127.0))
WIRES = ("f32", "bf16", "int8")


def shard_csr_slice(topo, lo: int, hi_real: int):
    """``(degree int64[hi_real-lo], neighbors int64[nnz])`` of CSR rows
    ``[lo, hi_real)`` — the one accessor through which the shard builders
    touch the adjacency."""
    if hi_real <= lo:  # a fully-padded shard owns no real rows
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    fn = getattr(topo, "csr_slice", None)
    if fn is not None:
        return fn(lo, hi_real)
    offsets = np.asarray(topo.offsets, np.int64)
    deg = np.diff(offsets[lo:hi_real + 1])
    nbr = np.asarray(topo.indices[offsets[lo]: offsets[hi_real]],
                     np.int64)
    return deg, nbr


def _row_starts(deg: np.ndarray) -> np.ndarray:
    """Local CSR row starts from the slice's degree vector alone."""
    starts = np.zeros(len(deg), np.int64)
    if len(deg) > 1:
        np.cumsum(deg[:-1], out=starts[1:])
    return starts


def _shard_class_counts(topo, bounds):
    """Per-shard class counts, reduced to the cross-shard maxima: the
    cheap pre-pass that finds the forced capacities."""
    caps: dict = {}
    n = topo.num_nodes
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        deg, _ = shard_csr_slice(topo, lo, max(lo, min(hi, n)))
        cls = degree_classes(deg)
        c_vals, counts = np.unique(cls[cls > 0], return_counts=True)
        for c, k in zip(c_vals, counts):
            caps[int(c)] = max(caps.get(int(c), 0), int(k))
    return caps


# ---- multi-process shard builds ----------------------------------------
#
# The S per-shard compiles are independent pure functions of (topology
# slice, caps, floors). Shards build in a process pool, and results merge
# in shard order, so the plans are bitwise-identical for every worker
# count — including 1, which skips the pool. The pool spawns fresh
# workers, not forks of the caller: the caller may be multithreaded
# (torch's CUDA and OpenMP threads, a JAX runtime in the tests), and a
# forked child can deadlock on a lock one of those threads held, or wait
# forever in GNU OpenMP for pool threads that were not forked. Each
# worker receives the topology once, through the pool's initializer, runs
# numpy and the routecolor library only, and returns numpy tables; it
# never touches the card.


def resolve_build_workers(build_workers: Optional[int],
                          num_shards: int) -> int:
    """``--build-workers`` policy: default ``min(S, cpu_count)``,
    clamped to [1, S]."""
    if build_workers is None:
        build_workers = min(num_shards, os.cpu_count() or 1)
    return max(1, min(int(build_workers), num_shards))


# the build's shared inputs: set in the caller for the serial path, and in
# each pool worker by _pool_initializer
_WORKER_STATE: dict = {}


def _pool_initializer(threads: int, state: dict) -> None:
    # W workers x the host's thread count would oversubscribe the host;
    # split the cores across workers (thread counts never change a table)
    from gossipprotocol_tpu_torch import native

    native.set_native_threads(threads)
    _WORKER_STATE.clear()
    _WORKER_STATE.update(state)


def _shard_build_task(task, progress=None):
    """One (mode, shard, groups, cr_floors) unit — runs in pool workers
    and inline for the serial path."""
    mode, k, groups, cr_floors = task
    st = _WORKER_STATE
    return build_shard_push_delivery(
        st["topo"], st["n_padded"], st["num_shards"], k,
        caps=st["caps"], block_pairs=st["block_pairs"],
        cr_floors=cr_floors, geometry_only=(mode == "geo"),
        groups=groups, progress=progress)


class _ShardBuildPool:
    """Runs shard-build tasks across ``workers`` spawned processes, or
    inline when ``workers == 1``. A broken pool degrades to the inline
    path loudly — never a lost build."""

    def __init__(self, workers: int, state: dict, progress=None):
        self.progress = progress
        self.pool = None
        _WORKER_STATE.clear()
        _WORKER_STATE.update(state)
        if workers > 1:
            from concurrent.futures import ProcessPoolExecutor

            from gossipprotocol_tpu_torch import native

            if native.enabled():
                # build the library once here: the workers load it
                # instead of racing each other to compile it
                native._load()
            threads = max(1, (os.cpu_count() or 1) // workers)
            try:
                self.pool = ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_pool_initializer,
                    initargs=(threads, state))
            except OSError as e:
                if progress:
                    progress(f"build pool unavailable ({e}); "
                             "building shards serially")

    def run(self, tasks):
        """Results in task order; per-task progress only when inline."""
        if self.pool is not None:
            from concurrent.futures.process import BrokenProcessPool

            try:
                futs = [self.pool.submit(_shard_build_task, t)
                        for t in tasks]
                return [f.result() for f in futs]
            except (BrokenProcessPool, OSError) as e:
                import warnings

                warnings.warn(
                    f"shard build pool died ({e}); rebuilding serially")
                self._shutdown(kill=True)
        return [_shard_build_task(t, progress=self.progress)
                for t in tasks]

    def _shutdown(self, kill: bool = False) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=not kill, cancel_futures=kill)
            self.pool = None

    def close(self) -> None:
        self._shutdown()
        _WORKER_STATE.clear()


def _uniform_cr_fixpoint(groups, num_shards: int, pool: _ShardBuildPool,
                         progress=None):
    """Cross-shard cr-floor fixpoint, re-measuring only what moved.

    A (shard, group) whose last measured per-stage run capacities equal
    the new floors would rebuild identically, so only pairs whose
    measurement differs from the floors are re-measured. Floors are
    monotone and bounded (pow2 <= 128), so this terminates at the
    fixpoint the full recomputation reaches."""
    groups = tuple(groups)
    crs: dict = {}
    floors = None  # first pass: natural geometry
    pending = [(k, groups) for k in range(num_shards)]
    rounds = 0
    while pending:
        rounds += 1
        results = pool.run([("geo", k, gs, floors) for k, gs in pending])
        for (k, gs), geo in zip(pending, results):
            for g in gs:
                crs[(k, g)] = tuple(
                    tuple(st.cr for st in plan.stages) for plan in geo[g])
        floors_now = {}
        for g in groups:
            per_shard = [crs[(k, g)] for k in range(num_shards)]
            shape0 = tuple(len(t) for t in per_shard[0])
            for ps in per_shard[1:]:
                if tuple(len(t) for t in ps) != shape0:
                    raise AssertionError(
                        "per-shard stage counts diverged (uniform m "
                        "should fix them — compiler bug)")
            floors_now[g] = tuple(
                tuple(max(ps[pi][si] for ps in per_shard)
                      for si in range(len(per_shard[0][pi])))
                for pi in range(len(per_shard[0])))
        nxt: dict = {}
        for g in groups:
            for k in range(num_shards):
                if crs[(k, g)] != floors_now[g]:
                    nxt.setdefault(k, []).append(g)
        floors = floors_now
        pending = sorted((k, tuple(gs)) for k, gs in nxt.items())
        if progress:
            progress(f"geometry fixpoint round {rounds}: "
                     f"{sum(len(gs) for _, gs in pending)} shard-group "
                     "re-measures pending")
    return floors


# ---- the push design ------------------------------------------------------
#
# One class set serves both sides: the graph is symmetric, so the rows a
# shard expands (out-edges) are exactly the rows it reduces (in-edges),
# classed by their full degree; the shard's CSR slice is read twice —
# entry (row, nbr) is the out-edge row->nbr on the expand side and the
# in-edge nbr->row on the reduce side. Node v's incoming values land at
# (v's class slots, in-CSR-row order) and the reduce tree depends only on
# the class, so every node sums the same f32 values through the same tree
# as on one card. Intra-shard edges bypass the exchange: plan_send routes
# e1 to [f_local | slab] and plan_recv routes [f_local | incoming] to f,
# each real f slot written from exactly one source.


class ShardPushDelivery(NamedTuple):
    """The push-design delivery of a sharded run.

    Host form (from the compiler, the plan cache or the JAX package's
    stacked build): numpy leaves, one shard's or all shards' stacked on a
    leading shard axis — the JAX package's layout. Placed form (from
    :func:`~gossipprotocol_tpu_torch.convert.shard_push_from_numpy`):
    each plan group holds one chain of placed plans per shard
    (``plan_in[k]`` is shard k's chain), ``realmask`` is f32 ``[S,
    2*m_pairs]`` and ``degree`` int32 ``[S, local_n]`` on the device; only
    the placed form has a working :meth:`matvec`."""

    n: int                        # global real nodes
    local_n: int                  # rows each shard owns
    num_shards: int
    nu: int                       # capacity-padded node slots
    m_pairs: int                  # class-layout pair slots (e1 == f)
    block_pairs: int              # slab capacity per (src, dst) pair
    classes: Tuple[Tuple[int, int, int, int, int], ...]
    plan_in: Any                  # [xs_l|xw_l] -> class order
    plan_send: Any                # e1 -> [f_local | slab]
    plan_recv: Any                # [f_local | incoming] -> f
    plan_out: Any                 # class order -> local natural
    realmask: Any                 # f32 [(S,) 2 * m_pairs]
    degree: Any                   # int32 [(S,) local_n] (full degree)

    def matvec(self, xs: torch.Tensor, xw: torch.Tensor, *,
               exchange: str = "all_to_all", wire: str = "f32"):
        """``(in_s, in_w)[i] = sum over neighbors j of (xs, xw)[j]`` over
        the padded row space ``[S * local_n]``, all shards in lockstep.

        ``exchange``: how the slabs move — ``"all_to_all"`` (one torch
        permutation, the JAX collective's counterpart), ``"pallas"`` (the
        exchange kernel, copies started all at once) or ``"overlap"``
        (the same kernel on the ring schedule, ``--exchange-overlap``).
        All three move the identical bytes. ``wire``: the slab's dtype on
        the wire (``--payload-wire``) — ``"f32"`` (bitwise), ``"bf16"``
        or ``"int8"`` (per-destination-block symmetric scale, the ``[S,
        1]`` f32 scales through the same exchange); accumulation stays
        f32."""
        if exchange not in EXCHANGES:
            raise ValueError(f"exchange must be one of {EXCHANGES}")
        if wire not in WIRES:
            raise ValueError(f"wire must be one of {WIRES}")
        f_locals, slabs = self.send(xs, xw)
        return self.receive(f_locals, _ship_wire(slabs, exchange, wire))

    def send(self, xs: torch.Tensor, xw: torch.Tensor):
        """Phase 1 of :meth:`matvec`, per shard: plan_in, the expands,
        realmask, plan_send. Returns each shard's ``f_local`` (f32 ``[2 *
        m_pairs]``) and its f32 slab ``[S, 2*block_pairs]`` (row d: the
        shares for shard d)."""
        ns, loc, mp = self.num_shards, self.local_n, self.m_pairs
        slab_f32 = 2 * ns * self.block_pairs
        xs2, xw2 = xs.view(ns, loc), xw.view(ns, loc)
        f_locals, slabs = [], []
        for k in range(ns):
            flat = torch.cat([xs2[k], xw2[k]])
            cls = _apply_chain(self.plan_in[k], flat, take_f32=self.nu * 2)
            segs = []
            off = 0
            for c, _n_c, _start, _reg_rows, cap in self.classes:
                node_pairs = cls[2 * off: 2 * (off + cap)]
                if 2 * c <= co.LANES:
                    segs.append(co.class_expand_small(node_pairs, c))
                else:
                    segs.append(co.class_expand_split(node_pairs, c))
                off += cap
            # a multiply by exactly 0.0 or 1.0, as in the JAX package
            e1 = torch.cat(segs) * self.realmask[k]
            out = _apply_chain(self.plan_send[k], e1,
                               take_f32=2 * mp + slab_f32)
            f_locals.append(out[: 2 * mp])
            slabs.append(out[2 * mp:].view(ns, 2 * self.block_pairs))
        return f_locals, slabs

    def receive(self, f_locals, incoming):
        """Phase 2 of :meth:`matvec`, per shard: plan_recv over ``[f_local
        | incoming]``, the folds, plan_out; returns ``(in_s, in_w)`` over
        the padded rows."""
        loc, mp = self.local_n, self.m_pairs
        nats = []
        for k in range(self.num_shards):
            f = _apply_chain(self.plan_recv[k],
                             torch.cat([f_locals[k], incoming[k].reshape(-1)]),
                             take_f32=2 * mp)
            ys = []
            for c, _n_c, start, reg_rows, cap in self.classes:
                region = f[2 * start: 2 * start + reg_rows * co.LANES]
                if 2 * c <= co.LANES:
                    packed = co.class_reduce_small(region, c)
                else:
                    packed = co.class_reduce_split(region, c)
                ys.append(packed[: 2 * cap])
            nats.append(_apply_chain(self.plan_out[k], torch.cat(ys),
                                     take_f32=2 * loc))
        return (torch.cat([nat[:loc] for nat in nats]),
                torch.cat([nat[loc:] for nat in nats]))


def _ship(slabs, exchange: str):
    from gossipprotocol_tpu_torch.ops.pallasdelivery import (
        exchange_plain, pallas_exchange,
    )

    if exchange == "all_to_all":
        return exchange_plain(slabs)
    return pallas_exchange(slabs, overlap=(exchange == "overlap"))


def _ship_wire(slabs, exchange: str, wire: str):
    """The exchange of every shard's f32 slab under the wire format;
    returns each shard's incoming f32 ``[S, 2*block_pairs]``."""
    if wire == "bf16":
        return [t.to(torch.float32) for t in _ship(
            [s.to(torch.bfloat16) for s in slabs], exchange)]
    if wire == "int8":
        qs, scales = quantize_int8(slabs)
        return [q.to(torch.float32) * sc for q, sc in
                zip(_ship(qs, exchange), _ship(scales, exchange))]
    return _ship(slabs, exchange)


def quantize_int8(slabs):
    """The int8 wire's payload: symmetric per-destination-block
    quantization, each of a shard's S outgoing blocks with its own scale
    amax/127 (f32 ``[S, 1]``, shipped through the same exchange).
    Returns ``(int8 slabs, scales)``. The JAX package's XLA build folds
    its ``/ 127.0`` into a multiply by the float32 reciprocal (ROADMAP.md
    Queue 3), replayed here; the quotient ``slab / scale`` stays an IEEE
    division by a tensor (a CUDA division by a Python scalar would
    multiply by its reciprocal)."""
    qs, scales = [], []
    for s in slabs:
        amax = torch.amax(torch.abs(s), dim=1, keepdim=True)
        scale = torch.clamp(amax, min=1e-30) * torch.full_like(
            amax, _INV_127)
        qs.append(torch.round(s / scale).to(torch.int8))
        scales.append(scale)
    return qs, scales


def build_shard_push_delivery(
    topo, n_padded: int, num_shards: int, shard: int,
    caps: dict | None = None, block_pairs: int | None = None,
    cr_floors: dict | None = None,
    geometry_only: bool = False,
    groups=None,
    progress=None,
):
    """Compile one shard's push-design delivery (owned rows only), host
    form. ``caps`` forces per-class node capacities, ``block_pairs`` the
    slab block capacity, ``cr_floors`` per-stage run capacities
    (``{"in"|"send"|"recv"|"out"}``); ``geometry_only=True`` returns the
    raw plan pairs for the cheap cross-shard maxima pre-pass, restricted
    to the ``groups`` subset when given."""
    if topo.implicit_full:
        raise RoutedConfigError(
            "push delivery needs an explicit edge list")
    if topo.asymmetric:
        raise RoutedConfigError(
            "push delivery needs a symmetric simple graph")
    if groups is None:
        groups = ("in", "send", "recv", "out")
    elif not geometry_only:
        raise ValueError("groups subsetting is geometry_only-specific")
    need_edges = "send" in groups or "recv" in groups
    n = topo.num_nodes
    local = n_padded // num_shards
    lo = shard * local
    hi_real = max(lo, min(lo + local, n))
    deg_slice, nbr_slice = shard_csr_slice(topo, lo, hi_real)
    degree = np.zeros(local, np.int64)
    degree[: hi_real - lo] = deg_slice

    # one class set for both sides (see the design note above)
    cls = degree_classes(degree)
    order, rank, _ = class_order(cls, local)
    classes, node_start_pair, m_pairs, pos, stride = class_layout(
        cls[order], caps=caps)
    nu = sum(cap for *_, cap in classes)

    if need_edges:
        # entry j = (row[j], nbr[j]); slot[j] is BOTH the e1 slot of
        # out-edge row->nbr and the f slot of in-edge nbr->row
        nbr = nbr_slice
        row = np.repeat(np.arange(lo, hi_real, dtype=np.int64), deg_slice)
        pos_in_row = (np.arange(len(nbr), dtype=np.int64)
                      - np.repeat(_row_starts(deg_slice), deg_slice))
        slot = edge_pair_slot(node_start_pair, stride, rank[row - lo],
                              pos_in_row)
        nbr_shard = nbr // local
        is_local = nbr_shard == shard

        if not geometry_only:
            realmask_pairs = np.zeros(m_pairs, bool)
            realmask_pairs[slot] = True
            realmask = np.repeat(realmask_pairs, 2).astype(np.float32)

        from gossipprotocol_tpu_torch.ops.plan import argsort_pairs

        # intra-shard edges: e1 -> f directly. The local directed edge
        # set is closed under reversal; sorted by (row, nbr) and by (nbr,
        # row) every edge pairs with its reverse at equal positions
        li = np.flatnonzero(is_local)
        p1 = li[argsort_pairs(row[li], nbr[li], n)]
        xi = np.flatnonzero(~is_local)

    if "send" in groups:
        p2 = li[argsort_pairs(nbr[li], row[li], n)]
        # cross-shard edges, outbound: entry as out-edge row->nbr goes to
        # shard nbr//local; block contents ordered by (target, source) =
        # (nbr, row), computable identically on both endpoints
        po = xi[argsort_pairs(nbr[xi], row[xi], n)]
        d_sorted = nbr_shard[po]  # non-decreasing (shard monotone)
        starts = np.r_[0, np.flatnonzero(np.diff(d_sorted)) + 1]
        lens = np.diff(np.r_[starts, len(d_sorted)])
        rank_in_block = (np.arange(len(po), dtype=np.int64)
                         - np.repeat(starts, lens))
        # symmetric graph: this census is both the outbound and the
        # inbound per-shard block census
        bmax = int(np.bincount(d_sorted, minlength=num_shards).max()) \
            if len(xi) else 0
        if block_pairs is None:
            block_pairs = max(64, -(-max(bmax, 1) // 64) * 64)
        if bmax > block_pairs:
            raise AssertionError(
                "forced block capacity below this shard's natural "
                "maximum")
    slab_pairs = (num_shards * block_pairs
                  if block_pairs is not None else None)

    if progress:
        progress(f"push shard {shard}: "
                 f"{len(nbr) if need_edges else '-'} owned directed "
                 f"edges, block {block_pairs} pairs, "
                 f"classes {[(c, k) for c, k, *_ in classes]}")

    floors = cr_floors or {}
    out: dict = {}
    if "in" in groups:
        src_in = np.full(2 * nu, -1, np.int64)
        src_in[2 * pos] = order
        src_in[2 * pos + 1] = local + order
        out["in"] = _chained_plans(src_in, m_in=2 * local,
                                   progress=progress, unit=1,
                                   cr_floors=floors.get("in"),
                                   geometry_only=geometry_only)
    if "send" in groups:
        # plan_send: e1 -> [f_local | slab]
        src_of_send = np.full(m_pairs + slab_pairs, -1, np.int64)
        src_of_send[slot[p1]] = slot[p2]
        src_of_send[m_pairs + d_sorted * block_pairs + rank_in_block] = \
            slot[po]
        out["send"] = _chained_plans(src_of_send, m_in=m_pairs,
                                     progress=progress,
                                     cr_floors=floors.get("send"),
                                     geometry_only=geometry_only)
    if "recv" in groups:
        # plan_recv: [f_local | incoming] -> f. Local-edge f slots read
        # their own position in part 1; cross-edge f slots read their
        # incoming block slot. Within a block the sender's (target,
        # source) order is this shard's (row, nbr) order — the CSR order
        # — so a stable sort by source shard reproduces the sender's
        # block layout
        pr = xi[np.argsort(nbr_shard[xi], kind="stable")]
        s_sorted = nbr_shard[pr]
        starts_r = np.r_[0, np.flatnonzero(np.diff(s_sorted)) + 1]
        lens_r = np.diff(np.r_[starts_r, len(s_sorted)])
        rank_r = (np.arange(len(pr), dtype=np.int64)
                  - np.repeat(starts_r, lens_r))
        src_of_recv = np.full(m_pairs, -1, np.int64)
        src_of_recv[slot[p1]] = slot[p1]
        src_of_recv[slot[pr]] = (m_pairs + s_sorted * block_pairs
                                 + rank_r)
        out["recv"] = _chained_plans(src_of_recv,
                                     m_in=m_pairs + slab_pairs,
                                     progress=progress,
                                     cr_floors=floors.get("recv"),
                                     geometry_only=geometry_only)
    if "out" in groups:
        src_out = np.full(2 * local, -1, np.int64)
        has = degree > 0
        pos_of_row = np.full(local, -1, np.int64)
        pos_of_row[order] = pos
        src_out[:local][has] = 2 * pos_of_row[has]
        src_out[local:][has] = 2 * pos_of_row[has] + 1
        out["out"] = _chained_plans(src_out, m_in=2 * nu,
                                    progress=progress, unit=1,
                                    cr_floors=floors.get("out"),
                                    geometry_only=geometry_only)

    if geometry_only:
        return out
    return ShardPushDelivery(
        n=n, local_n=local, num_shards=num_shards, nu=nu,
        m_pairs=m_pairs, block_pairs=block_pairs, classes=classes,
        plan_in=tuple(device_plan(p) for p in out["in"]),
        plan_send=tuple(device_plan(p) for p in out["send"]),
        plan_recv=tuple(device_plan(p) for p in out["recv"]),
        plan_out=tuple(device_plan(p) for p in out["out"]),
        realmask=realmask,
        degree=np.asarray(degree, np.int32),
    )


def assert_push_tables_linear(m_pairs: int, num_shards: int,
                              block_pairs: int, e_max: int, local: int,
                              n_classes: int,
                              split_pad_pairs: int = 0) -> int:
    """The build-time O(E/S + local_n) guard the push design promises.

    ``e_max`` is the largest per-shard owned directed edge count. Class
    capacity padding contributes at most a factor ~8 plus BLK-row
    alignment per class, and ``split_pad_pairs`` is the hub-split layout's
    node-capacity padding; anything past a 16x budget means the partition
    is too skewed for the push design — rejected loudly. Returns the
    budget (pairs)."""
    budget = (16 * (e_max + local) + (n_classes + 1) * co.BLK * 64
              + int(split_pad_pairs) + 64)
    for name, pairs in (("class-layout", m_pairs),
                        ("all_to_all slab", num_shards * block_pairs)):
        if pairs > budget:
            raise RoutedConfigError(
                f"push-design {name} table needs {pairs} pair slots, "
                f"over the O(E/S + local_n) budget of {budget} (max "
                f"shard edges {e_max}, local rows {local}): the "
                "partition is too skewed for the push design — rerun "
                "with --routed-design pull or --delivery scatter")
    return budget


_GROUPS = ("plan_in", "plan_send", "plan_recv", "plan_out")


def _plan_leaves(dp: DevicePlan):
    for st in dp.stages:
        yield st.idx
    yield dp.final.idx
    yield dp.final.mask


def push_leaves(sd: ShardPushDelivery):
    """The host form's arrays in one fixed order: every plan's stage and
    final tables (group by group, chain order), then realmask and degree
    — the order of the JAX package's pytree leaves."""
    for g in _GROUPS:
        for dp in getattr(sd, g):
            yield from _plan_leaves(dp)
    yield sd.realmask
    yield sd.degree


def push_program_geometry(sd: ShardPushDelivery):
    """Everything the matvec depends on (per-shard real counts n_c are
    advisory and may differ), of a host-form delivery."""
    def plan_geo(p):
        return (p.unit, p.nt_in, p.nt_out,
                tuple(tuple(st)[:6] for st in p.stages), p.final.k)

    return (sd.n, sd.local_n, sd.num_shards, sd.nu, sd.m_pairs,
            sd.block_pairs,
            tuple((c, start, rows, cap)
                  for c, _, start, rows, cap in sd.classes),
            tuple(tuple(plan_geo(p) for p in getattr(sd, g))
                  for g in _GROUPS),
            tuple((np.asarray(x).shape, str(np.asarray(x).dtype))
                  for x in push_leaves(sd)))


def shard_geometry(topo, n_padded: int, num_shards: int):
    """The push plans' uniformized geometry, before any tile routing:
    ``(caps, block_pairs, e_max, classes, m_pairs)`` — the per-class
    node-count maxima over the shards, the slab block (the cross-shard
    max block census, one bincount per shard, O(E) total), the most
    edges a shard owns, and the class layout every shard runs."""
    local = n_padded // num_shards
    n = topo.num_nodes
    bounds = [k * local for k in range(num_shards + 1)]
    caps = _shard_class_counts(topo, bounds)
    bmax = 0
    e_max = 0
    for k in range(num_shards):
        lo = k * local
        _, nbr = shard_csr_slice(topo, lo, max(lo, min(lo + local, n)))
        e_max = max(e_max, len(nbr))
        nbr_shard = nbr // local
        cross = nbr_shard[nbr_shard != k]
        if len(cross):
            bmax = max(bmax, int(np.bincount(
                cross, minlength=num_shards).max()))
    block_pairs = max(64, -(-max(bmax, 1) // 64) * 64)
    cls_sorted = np.repeat(
        np.array(sorted(caps), np.int64),
        np.array([caps[c] for c in sorted(caps)], np.int64),
    ) if caps else np.zeros(0, np.int64)
    classes_u, _, m_pairs_u, _, _ = class_layout(cls_sorted, caps=caps)
    return caps, block_pairs, e_max, classes_u, m_pairs_u


def _build_push_shards(topo, n_padded: int, num_shards: int,
                       progress=None,
                       build_workers: Optional[int] = None) -> list:
    """Uniformized per-shard push builds (capacity/block pre-pass +
    cr-floors fixpoint), one host-form :class:`ShardPushDelivery` per
    shard, not yet stacked."""
    local = n_padded // num_shards
    caps, block_pairs, e_max, classes_u, m_pairs_u = shard_geometry(
        topo, n_padded, num_shards)

    # the promised build-time size guard, before any tile routing
    assert_push_tables_linear(m_pairs_u, num_shards, block_pairs,
                              e_max, local, len(caps),
                              split_pad_pairs=split_pad_pairs_of(classes_u))

    workers = resolve_build_workers(build_workers, num_shards)
    pool = _ShardBuildPool(
        workers,
        {"topo": topo, "n_padded": n_padded, "num_shards": num_shards,
         "caps": caps, "block_pairs": block_pairs},
        progress=progress)
    try:
        cr_floors = _uniform_cr_fixpoint(
            ("in", "send", "recv", "out"), num_shards, pool,
            progress=progress)
        t0 = time.perf_counter()
        shards = pool.run([("full", k, None, cr_floors)
                           for k in range(num_shards)])
        if progress:
            progress(f"routed {num_shards} push shard plans in "
                     f"{time.perf_counter() - t0:.1f}s "
                     f"({workers} workers)")
    finally:
        pool.close()
    return shards


def _stack_plan(plans) -> DevicePlan:
    from gossipprotocol_tpu_torch.ops.exec import DeviceFinal, DeviceStage

    p0 = plans[0]
    stages = tuple(
        DeviceStage(*tuple(st)[:6], idx=np.stack([p.stages[i].idx
                                                  for p in plans]))
        for i, st in enumerate(p0.stages))
    fin = DeviceFinal(p0.final.k, np.stack([p.final.idx for p in plans]),
                      np.stack([p.final.mask for p in plans]))
    return DevicePlan(p0.unit, p0.nt_in, p0.nt_out, stages, fin)


def build_shard_push_deliveries(topo, n_padded: int, num_shards: int,
                                progress=None,
                                build_workers: Optional[int] = None,
                                ) -> ShardPushDelivery:
    """All shards' push deliveries, geometry-uniform, host form with the
    leaves stacked on a leading shard axis (shard k's tables at index k:
    the JAX package's ``build_shard_push_deliveries``, byte for byte).
    ``build_workers``: processes for the per-shard compiles (default
    ``min(S, cpu_count)``); the output does not depend on it."""
    shards = _build_push_shards(topo, n_padded, num_shards,
                                progress=progress,
                                build_workers=build_workers)
    g0 = push_program_geometry(shards[0])
    for k, sd in enumerate(shards[1:], 1):
        if push_program_geometry(sd) != g0:
            raise AssertionError(
                f"shard {k} push geometry diverged despite forced "
                "caps/block — capacity uniformization bug")
    s0 = shards[0]
    # per-shard n_c in the classes differ and are advisory only: the
    # matvec reads capacities, verified uniform above
    return s0._replace(
        **{g: tuple(_stack_plan([getattr(sd, g)[i] for sd in shards])
                    for i in range(len(getattr(s0, g))))
           for g in _GROUPS},
        realmask=np.stack([sd.realmask for sd in shards]),
        degree=np.stack([sd.degree for sd in shards]))


def pushsum_diffusion_round_routed_push(
    state,
    shard_rd: ShardPushDelivery,   # placed, all shards
    *,
    eps: float = 1e-10,
    streak_target: int = 3,
    predicate: str = "delta",
    tol: float = 1e-4,
    all_alive: bool = False,
    targets_alive: bool = True,
    all_sum=sum0,
    exchange: str = "all_to_all",
    wire: str = "f32",
):
    """Sharded fanout-all round, push design, over the padded state of all
    shards ``[S * local_n]``: expand owned rows, one edge-share exchange,
    reduce locally. ``exchange`` picks the transport and ``wire`` the
    opt-in slab compression (see :meth:`ShardPushDelivery.matvec`),
    applied to the payload exchange only — the live-degree pass ships
    small-integer floats the round multiplies by, so it stays f32. The
    elementwise tail runs once over all shards (elementwise, so bitwise
    what a per-shard tail gives). ``all_sum`` sums over the node axis —
    for the sharded engine the per-shard partial sums added in shard
    order, the counterpart of ``psum(jnp.sum(x_local))``. Otherwise the
    mathematics of :func:`~gossipprotocol_tpu_torch.protocols.diffusion.
    pushsum_diffusion_round_routed`, whose trajectory it equals bitwise
    under the f32 wire."""
    deg = shard_rd.degree.reshape(-1).to(torch.float32)
    inv = torch.ones_like(deg) / (deg + 1)
    share_s = state.s * rowmask(inv, state.s)
    share_w = state.w * inv
    if not all_alive:
        share_s = torch.where(rowmask(state.alive, share_s), share_s,
                              torch.zeros_like(share_s))
        share_w = torch.where(state.alive, share_w,
                              torch.zeros_like(share_w))
    in_s, in_w = shard_rd.matvec(share_s, share_w, exchange=exchange,
                                 wire=wire)
    if all_alive or targets_alive:
        sent = deg
    else:
        alive_f = state.alive.to(torch.float32)
        live_deg, _ = shard_rd.matvec(alive_f, alive_f, exchange=exchange)
        in_s = torch.where(rowmask(state.alive, in_s), in_s,
                           torch.zeros_like(in_s))
        in_w = torch.where(state.alive, in_w, torch.zeros_like(in_w))
        sent = live_deg
    return finish_pushsum_round(
        state, _keep(state.s, share_s, sent) + in_s,
        _keep(state.w, share_w, sent) + in_w,
        eps=eps, streak_target=streak_target, predicate=predicate, tol=tol,
        all_alive=all_alive, all_sum=all_sum,
    )


def shard_routed_message_counts(state, shard_rd: ShardPushDelivery, *,
                                num_shards: int, fast_alive: bool,
                                all_alive: bool, exchange: str = "all_to_all",
                                key: Optional[torch.Tensor] = None,
                                clock: tuple = ()) -> torch.Tensor:
    """Telemetry recount of one sharded push-design round: int32 ``[S,
    3]``, each shard's ``[sent, delivered, dropped]`` over the rows it
    owns (``obs/counters.py`` semantics; the JAX package's
    ``shard_routed_message_counts`` before its ``psum``).

    The push design takes no loss windows, so ``dropped`` is 0. On the
    fast paths ``sent == delivered == Σ degree`` over each shard's live
    rows (float32 per shard, saturated to int32, as the JAX package
    counts). Under an arbitrary dead set the recount repeats the round's
    live-degree matvec through the same exchange."""
    from gossipprotocol_tpu_torch.obs.counters import clip_count

    deg = shard_rd.degree.reshape(-1).to(torch.float32)
    rows = deg.shape[0]
    active = None
    if clock:
        from gossipprotocol_tpu_torch.async_.clock import activation_mask

        active = activation_mask(key, clock, torch.arange(
            rows, dtype=torch.int64, device=deg.device))
        deg = torch.where(active, deg, torch.zeros_like(deg))

    def per_shard(x):
        return clip_count(torch.sum(x.view(num_shards, -1), dim=1))

    zero = torch.zeros(num_shards, dtype=torch.int32, device=deg.device)
    if all_alive:
        sent = per_shard(deg)
        return torch.stack([sent, sent, zero], dim=1)
    sent = per_shard(torch.where(state.alive, deg, torch.zeros_like(deg)))
    if fast_alive:
        return torch.stack([sent, sent, zero], dim=1)
    alive_f = state.alive.to(torch.float32)
    live_deg, _ = shard_rd.matvec(alive_f, alive_f, exchange=exchange)
    if active is not None:
        live_deg = torch.where(active, live_deg, torch.zeros_like(live_deg))
    delivered = per_shard(torch.where(state.alive, live_deg,
                                      torch.zeros_like(live_deg)))
    return torch.stack([sent, delivered, zero], dim=1)


def push_exchange_bytes_per_round(sd: ShardPushDelivery) -> int:
    """Per-shard payload of one push-design matvec's exchange: the ``[S,
    2*block_pairs]`` f32 slab (one matvec per round on the fast paths,
    two on the live-degree path)."""
    return int(sd.num_shards) * 2 * int(sd.block_pairs) * 4


def push_exchange_wire_bytes_per_round(sd: ShardPushDelivery,
                                       wire: str = "f32") -> int:
    """Per-shard exchange bytes under ``--payload-wire``: the slab in its
    wire dtype, plus the int8 mode's ``[S, 1]`` f32 scale sidecar."""
    slots = int(sd.num_shards) * 2 * int(sd.block_pairs)
    if wire == "bf16":
        return slots * 2
    if wire == "int8":
        return slots + int(sd.num_shards) * 4
    return slots * 4


def table_bytes(sd: ShardPushDelivery) -> int:
    """Total bytes of a host-form delivery's tables (all shards)."""
    return int(sum(np.asarray(x).nbytes for x in push_leaves(sd)))
