"""Carry state and plan tables across from host arrays.

The system has no weights; what stands in for them is the protocol state
and the tables the round reads. These converters take them as numpy
arrays — for example the fields of a JAX-package ``GossipState``,
``PushSumState``, ``SGPState``, ``AccelState`` or ``WalkState``, of an
``SGPBundle``'s data, of its ``DenseNeighbors``, ``InvertedDense`` or
``CSRNeighbors``, or of a ``PallasDelivery`` or ``RoutedDelivery`` built
with ``device=False`` —
and place them on a torch device, checking shapes, types and index
bounds on the way. The device is ``cuda`` unless the caller asks for
``cpu``; asking for ``cuda`` with no card present raises.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gossipprotocol_tpu_torch.ops.build import resolve_device
from gossipprotocol_tpu_torch.ops.pallasdelivery import (
    LANES, TILE, TILE_ROWS, GatherPlan, PallasDelivery,
)
from gossipprotocol_tpu_torch.protocols.sampling import (
    CSRNeighbors, DenseNeighbors, InvertedDense,
)
from gossipprotocol_tpu_torch.protocols.state import (
    GossipState, PushSumState,
)


def state_from_numpy(s, w, ratio, streak, converged, alive, round,
                     device="cuda") -> PushSumState:
    """A :class:`PushSumState` on ``device`` from its fields as numpy:
    ``w`` float32 or float64 ``[n]``; ``s`` and ``ratio`` of ``w``'s dtype,
    ``[n]`` or an ``[n, d]`` vector payload; ``round`` a scalar."""
    dev = resolve_device(device)
    s, w, ratio = (np.ascontiguousarray(a) for a in (s, w, ratio))
    n = w.shape[0]
    if w.shape != (n,) or w.dtype not in (np.float32, np.float64):
        raise ValueError(f"state field w: expected float32 or float64 "
                         f"[{n}], got {w.dtype} {w.shape}")
    for name, a in (("s", s), ("ratio", ratio)):
        if a.dtype != w.dtype or a.shape[:1] != (n,) or a.ndim > 2 \
                or a.shape != s.shape:
            raise ValueError(f"state field {name}: expected {w.dtype} "
                             f"[{n}] or [{n}, d] like s, got {a.dtype} "
                             f"{a.shape}")
    streak = np.asarray(streak)
    converged = np.asarray(converged)
    alive = np.asarray(alive)
    if streak.shape != (n,) or converged.shape != (n,) or alive.shape != (n,):
        raise ValueError("state fields streak/converged/alive must be [n]")
    return PushSumState(
        s=torch.from_numpy(s.copy()).to(dev),
        w=torch.from_numpy(w.copy()).to(dev),
        ratio=torch.from_numpy(ratio.copy()).to(dev),
        streak=torch.from_numpy(streak.astype(np.int32)).to(dev),
        converged=torch.from_numpy(converged.astype(bool)).to(dev),
        alive=torch.from_numpy(alive.astype(bool)).to(dev),
        round=torch.tensor(int(round), dtype=torch.int32, device=dev),
    )


def sgp_state_from_numpy(s, w, ratio, streak, converged, alive, round, loss,
                         device="cuda"):
    """A :class:`~gossipprotocol_tpu_torch.protocols.state.SGPState` on
    ``device``: the push-sum fields as for :func:`state_from_numpy` (``s``
    and ``ratio`` ``[n, d]``) and the float32 scalar ``loss``."""
    from gossipprotocol_tpu_torch.protocols.state import SGPState

    node = state_from_numpy(s, w, ratio, streak, converged, alive, round,
                            device=device)
    if node.s.dim() != 2:
        raise ValueError(f"SGP state field s: expected [n, d], got "
                         f"{tuple(node.s.shape)}")
    loss = np.asarray(loss)
    if loss.shape != () or loss.dtype != np.float32:
        raise ValueError(f"SGP loss: expected a float32 scalar, got "
                         f"{loss.dtype} {loss.shape}")
    return SGPState(**node._asdict(),
                    loss=torch.tensor(float(loss), dtype=torch.float32,
                                      device=node.s.device))


def accel_state_from_numpy(s, w, ratio, streak, converged, alive, round,
                           s_prev, w_prev, omega, device="cuda"):
    """An :class:`~gossipprotocol_tpu_torch.protocols.state.AccelState` on
    ``device``: the push-sum fields as for :func:`state_from_numpy`, the
    previous iterate ``s_prev``/``w_prev`` shaped and typed like ``s``/``w``
    and the scalar ``omega`` in the state's dtype."""
    from gossipprotocol_tpu_torch.protocols.state import AccelState

    node = state_from_numpy(s, w, ratio, streak, converged, alive, round,
                            device=device)
    s_prev, w_prev = np.ascontiguousarray(s_prev), np.ascontiguousarray(w_prev)
    omega = np.asarray(omega)
    np_dt = node.w.cpu().numpy().dtype
    for name, a, like in (("s_prev", s_prev, node.s), ("w_prev", w_prev,
                                                      node.w)):
        if a.dtype != np_dt or a.shape != tuple(like.shape):
            raise ValueError(f"accel state field {name}: expected {np_dt} "
                             f"{tuple(like.shape)}, got {a.dtype} {a.shape}")
    if omega.shape != () or omega.dtype != np_dt:
        raise ValueError(f"accel omega: expected a {np_dt} scalar, got "
                         f"{omega.dtype} {omega.shape}")
    dev = node.s.device
    return AccelState(**node._asdict(),
                      s_prev=torch.from_numpy(s_prev.copy()).to(dev),
                      w_prev=torch.from_numpy(w_prev.copy()).to(dev),
                      omega=torch.from_numpy(omega.copy()).to(dev))


def sgp_bundle_from_numpy(nbrs, A, b, device="cuda"):
    """An :class:`~gossipprotocol_tpu_torch.learn.SGPBundle` on
    ``device``: ``nbrs`` the mixing core's arrays, already placed (or None
    for the implicit complete graph), and the data shards ``A`` ``[n, m,
    d]`` and ``b`` ``[n, m]`` of one float dtype."""
    from gossipprotocol_tpu_torch.learn import SGPBundle

    dev = resolve_device(device)
    A, b = np.ascontiguousarray(A), np.ascontiguousarray(b)
    if A.ndim != 3 or A.dtype not in (np.float32, np.float64):
        raise ValueError(f"SGP data A: expected float32 or float64 "
                         f"[n, m, d], got {A.dtype} {A.shape}")
    if b.shape != A.shape[:2] or b.dtype != A.dtype:
        raise ValueError(f"SGP data b: expected {A.dtype} {A.shape[:2]}, "
                         f"got {b.dtype} {b.shape}")
    return SGPBundle(nbrs=nbrs, A=torch.from_numpy(A.copy()).to(dev),
                     b=torch.from_numpy(b.copy()).to(dev))


def walk_state_from_numpy(s, w, ratio, streak, converged, alive, round,
                          cur, msg_s, msg_w, device="cuda"):
    """A :class:`~gossipprotocol_tpu_torch.protocols.walk.WalkState` on
    ``device`` from its fields as numpy: the per-node fields as for
    :func:`state_from_numpy`, and the token (``cur``, the in-flight
    ``msg_s``, ``msg_w``) as scalars."""
    from gossipprotocol_tpu_torch.protocols.walk import WalkState

    node = state_from_numpy(s, w, ratio, streak, converged, alive, round,
                            device=device)
    n = node.s.shape[0]
    cur = int(cur)
    if not 0 <= cur < n:
        raise ValueError(f"walk token position {cur} is not a node of "
                         f"the {n}-node state")
    msg = np.asarray([msg_s, msg_w])
    if msg.dtype != np.float32:
        raise ValueError(f"walk message: expected float32, got {msg.dtype}")
    dev = node.s.device
    return WalkState(
        **node._asdict(),
        cur=torch.tensor(cur, dtype=torch.int32, device=dev),
        msg_s=torch.tensor(msg[0], device=dev),
        msg_w=torch.tensor(msg[1], device=dev))


def gossip_state_from_numpy(counts, converged, alive, round,
                            device="cuda") -> GossipState:
    """A :class:`GossipState` on ``device`` from its fields as numpy."""
    dev = resolve_device(device)
    counts = np.asarray(counts)
    n = counts.shape[0]
    converged, alive = np.asarray(converged), np.asarray(alive)
    if counts.shape != (n,) or converged.shape != (n,) \
            or alive.shape != (n,):
        raise ValueError("gossip state fields counts/converged/alive must "
                         "be [n]")
    return GossipState(
        counts=torch.from_numpy(counts.astype(np.int32)).to(dev),
        converged=torch.from_numpy(converged.astype(bool)).to(dev),
        alive=torch.from_numpy(alive.astype(bool)).to(dev),
        round=torch.tensor(int(round), dtype=torch.int32, device=dev),
    )


def neighbors_from_numpy(*, degree, table=None, rev=None, starts=None,
                         indices=None, device="cuda"):
    """The neighbor arrays of the drawing rounds on ``device``, from the
    fields of a JAX-package ``DenseNeighbors`` (``table``, ``degree``),
    ``InvertedDense`` (plus ``rev``) or ``CSRNeighbors``
    (``starts``, ``degree``, ``indices``) as numpy. Neighbor ids and CSR
    offsets are checked against the node count: the draws index without
    bounds checks."""
    dev = resolve_device(device)
    degree = np.asarray(degree).astype(np.int32)
    n = degree.shape[0]
    if table is not None:
        table = np.asarray(table).astype(np.int32)
        if table.ndim != 2 or table.shape[0] != n:
            raise ValueError(f"dense table shape {table.shape}, expected "
                             f"[{n}, max_degree]")
        if table.size and (table.min() < 0 or table.max() >= n):
            raise ValueError("dense table holds ids outside [0, n)")
        if degree.size and degree.max() > table.shape[1]:
            raise ValueError("a degree exceeds the dense table's width")
        out = [torch.from_numpy(table).to(dev),
               torch.from_numpy(degree).to(dev)]
        if rev is None:
            return DenseNeighbors(*out)
        rev = np.asarray(rev).astype(np.int8)
        if rev.shape != table.shape:
            raise ValueError("the inversion table must match the dense "
                             "table")
        return InvertedDense(*out, torch.from_numpy(rev).to(dev))
    starts = np.asarray(starts).astype(np.int64)
    indices = np.asarray(indices).astype(np.int32)
    if starts.shape != (n,):
        raise ValueError(f"CSR starts shape {starts.shape} != ({n},)")
    if n and (starts.min() < 0
              or (starts + degree).max() > indices.shape[0]):
        raise ValueError("CSR rows run outside the index pool")
    if indices.size and (indices.min() < 0 or indices.max() >= n):
        raise ValueError("CSR indices hold ids outside [0, n)")
    return CSRNeighbors(starts=torch.from_numpy(starts).to(dev),
                        degree=torch.from_numpy(degree).to(dev),
                        indices=torch.from_numpy(indices).to(dev))


def gather_plan_from_numpy(mode: str, src_rows: int, out_len: int,
                            idx: np.ndarray, rows: np.ndarray,
                            lidx: np.ndarray, device="cuda") -> GatherPlan:
    """A :class:`GatherPlan` on ``device`` from its tables as numpy. The
    kernels index without bounds checks, so the bounds are checked here,
    once, on the host."""
    dev = resolve_device(device)
    if mode not in ("resident", "bucket"):
        raise ValueError(f"unknown gather mode {mode!r}")
    idx, rows, lidx = (np.ascontiguousarray(a, np.int32)
                       for a in (idx, rows, lidx))
    tiles = -(-int(out_len) // TILE)
    if mode == "resident":
        if idx.shape != (tiles, TILE_ROWS, LANES):
            raise ValueError(f"resident idx shape {idx.shape} != "
                             f"{(tiles, TILE_ROWS, LANES)}")
        if idx.size and (idx.min() < 0 or idx.max() >= src_rows * LANES):
            raise ValueError("resident idx out of the padded source")
    else:
        if rows.ndim != 2 or rows.shape[0] != tiles or \
                lidx.shape != (tiles, TILE_ROWS, LANES):
            raise ValueError("bucket tables have inconsistent shapes")
        if rows.size and (rows.min() < 0 or rows.max() >= src_rows):
            raise ValueError("bucket rows out of the padded source")
        if lidx.size and (lidx.min() < 0
                          or lidx.max() >= rows.shape[1] * LANES):
            raise ValueError("bucket lidx past the staging slab")
    return GatherPlan(mode, int(src_rows), int(out_len),
                      *(torch.from_numpy(a).to(dev)
                        for a in (idx, rows, lidx)))


def delivery_from_numpy(n: int, nu: int, m_pairs: int, classes,
                        gather_pre: Sequence, gather_out: Sequence,
                        degree, device="cuda") -> PallasDelivery:
    """A :class:`PallasDelivery` on ``device``. ``gather_pre`` and
    ``gather_out`` are ``(mode, src_rows, out_len, idx, rows, lidx)``
    sequences (a JAX-package ``GatherPlan`` of numpy arrays is one)."""
    dev = resolve_device(device)
    degree = np.asarray(degree)
    if degree.shape != (int(n),):
        raise ValueError(f"degree shape {degree.shape} != ({n},)")
    classes = tuple(tuple(int(v) for v in c) for c in classes)
    if sum(c[1] for c in classes) != int(nu):
        raise ValueError("class node counts do not sum to nu")
    return PallasDelivery(
        n=int(n), nu=int(nu), m_pairs=int(m_pairs), classes=classes,
        gather_pre=gather_plan_from_numpy(*gather_pre, device=dev),
        gather_out=gather_plan_from_numpy(*gather_out, device=dev),
        degree=torch.from_numpy(degree.astype(np.int32)).to(dev),
    )


def megakernel_delivery_from_numpy(pd_arrays, device="cuda"):
    """A :class:`~gossipprotocol_tpu_torch.ops.megakernel.
    MegakernelDelivery` on ``device`` from a host-side delivery — the
    port's :class:`~gossipprotocol_tpu_torch.ops.pallasdelivery.
    HostPallasDelivery`, or the JAX package's ``PallasDelivery`` built with
    ``device=False`` (same field names) — checked for resident gathers."""
    from gossipprotocol_tpu_torch.ops.megakernel import (
        build_megakernel_delivery,
    )

    p = pd_arrays
    return build_megakernel_delivery(delivery_from_numpy(
        p.n, p.nu, p.m_pairs, p.classes, p.gather_pre, p.gather_out,
        p.degree, device=device))


def _int8_planes(a, want, what: str, lane_max: int) -> np.ndarray:
    """Index planes as int8 ``want``; the kernels read them without
    bounds checks, so every value is checked here: 0..127, and at most
    ``lane_max`` in the pair-halved lane planes (0 and 2 of unit-2
    plans), whose widened value adds one."""
    a = np.ascontiguousarray(a)
    if a.dtype != np.int8 or a.shape != want:
        raise ValueError(f"{what}: index planes must be int8 {want}, got "
                         f"{a.dtype} {a.shape}")
    if a.size and a.min() < 0:
        raise ValueError(f"{what}: negative index")
    if a.size and lane_max < 127 and max(
            int(a[..., 0, :, :].max()), int(a[..., 2, :, :].max())) > lane_max:
        raise ValueError(f"{what}: pair-halved lane index above {lane_max}")
    return a


def plan_from_numpy(dp, device="cuda"):
    """A placed :class:`~gossipprotocol_tpu_torch.ops.exec.DevicePlan`
    from one in host form (the port's, or a JAX-package ``DevicePlan``
    with numpy leaves: same field names), with its geometry and index
    bounds checked."""
    from gossipprotocol_tpu_torch.ops.exec import (
        DeviceFinal, DevicePlan, DeviceStage,
    )

    dev = resolve_device(device)
    unit, nt_in, nt_out = int(dp.unit), int(dp.nt_in), int(dp.nt_out)
    if unit not in (1, 2):
        raise ValueError(f"routing plan: unit {unit} (1 or 2)")
    iw, lane_max = (64, 126) if unit == 2 else (LANES, 127)
    tiles = nt_in
    stages = []
    for i, st in enumerate(dp.stages):
        p, tau_in, b, cr, o, tau_slab = (int(v) for v in tuple(st)[:6])
        if min(p, tau_in, b, cr, o, tau_slab) < 1 or p * tau_in != tiles \
                or LANES % cr or o * LANES < b * cr \
                or (o - 1) * LANES >= b * cr or tau_slab < tau_in \
                or (tau_slab * cr) % LANES:
            raise ValueError(f"routing plan: stage {i} geometry "
                             f"{(p, tau_in, b, cr, o, tau_slab)} does not "
                             f"chain from {tiles} tiles")
        idx = _int8_planes(st.idx, (tiles, o, 3, iw, LANES),
                           f"routing plan stage {i}", lane_max)
        stages.append(DeviceStage(p, tau_in, b, cr, o, tau_slab,
                                  torch.from_numpy(idx).to(dev)))
        tiles = p * b * tau_slab * cr // LANES
    k = int(dp.final.k)
    if k < 1 or tiles < nt_out * k:
        raise ValueError(f"routing plan: final k={k} over {tiles} tiles "
                         f"does not give {nt_out} output tiles")
    fidx = _int8_planes(dp.final.idx, (nt_out, k, 3, iw, LANES),
                        "routing plan final", lane_max)
    mask = np.ascontiguousarray(dp.final.mask)
    if mask.dtype != np.uint8 or mask.shape != (nt_out, k, 16, LANES):
        raise ValueError(f"routing plan final: masks must be uint8 "
                         f"{(nt_out, k, 16, LANES)}, got {mask.dtype} "
                         f"{mask.shape}")
    return DevicePlan(unit, nt_in, nt_out, tuple(stages), DeviceFinal(
        k, torch.from_numpy(fidx).to(dev), torch.from_numpy(mask).to(dev)))


def routed_delivery_from_numpy(rd, device="cuda"):
    """A :class:`~gossipprotocol_tpu_torch.ops.delivery.RoutedDelivery` on
    ``device`` from one in host form — the port's
    (:func:`~gossipprotocol_tpu_torch.ops.delivery.build_routed_delivery_np`,
    the plan cache) or the JAX package's built with ``device=False`` (same
    field names). Checks the class geometry against ``m_pairs``, the
    chain of plans against the matvec's lengths, and every plan's shapes
    and index bounds."""
    from gossipprotocol_tpu_torch.ops.delivery import RoutedDelivery

    dev = resolve_device(device)
    n, nu, m_pairs = int(rd.n), int(rd.nu), int(rd.m_pairs)
    classes = tuple(tuple(int(v) for v in c) for c in rd.classes)
    degree = np.asarray(rd.degree)
    if degree.shape != (n,):
        raise ValueError(f"degree shape {degree.shape} != ({n},)")
    if sum(c[1] for c in classes) != nu:
        raise ValueError("class node counts do not sum to nu")
    cursor = 0
    for c, n_c, start, rows, cap in classes:
        if c < 1 or c & (c - 1) or start != cursor or n_c > cap \
                or rows * LANES != 2 * cap * c:
            raise ValueError(f"class {(c, n_c, start, rows, cap)} does not "
                             f"tile the layout at pair {cursor}")
        cursor += cap * c
    if cursor != m_pairs:
        raise ValueError(f"classes cover {cursor} pairs, m_pairs {m_pairs}")
    realmask = np.ascontiguousarray(rd.realmask, np.float32)
    if realmask.shape != (2 * m_pairs,) or not (
            (realmask == 0.0) | (realmask == 1.0)).all():
        raise ValueError(f"realmask must be 0/1 float32 [{2 * m_pairs}]")
    groups = {}
    for name, need_out in (("plan_in", 2 * nu), ("plan_m", 2 * m_pairs),
                           ("plan_out", 2 * n)):
        plans = tuple(plan_from_numpy(p, dev) for p in getattr(rd, name))
        if not plans or plans[-1].m_out_f32 < need_out:
            raise ValueError(f"{name} yields fewer than {need_out} values")
        groups[name] = plans
    return RoutedDelivery(
        n=n, nu=nu, m_pairs=m_pairs, classes=classes,
        realmask=torch.from_numpy(realmask.copy()).to(dev),
        degree=torch.from_numpy(degree.astype(np.int32)).to(dev), **groups)


def _unstack_plan(dp, k: int):
    """Shard ``k``'s plan of a stacked host-form plan (leading shard axis
    on every table)."""
    from gossipprotocol_tpu_torch.ops.exec import (
        DeviceFinal, DevicePlan, DeviceStage,
    )

    return DevicePlan(
        int(dp.unit), int(dp.nt_in), int(dp.nt_out),
        tuple(DeviceStage(*(int(v) for v in tuple(st)[:6]),
                          idx=np.asarray(st.idx)[k]) for st in dp.stages),
        DeviceFinal(int(dp.final.k), np.asarray(dp.final.idx)[k],
                    np.asarray(dp.final.mask)[k]))


def shard_push_from_numpy(sd, device="cuda"):
    """The placed :class:`~gossipprotocol_tpu_torch.ops.sharddelivery.
    ShardPushDelivery` on ``device`` from a stacked host form — the
    port's (``build_shard_push_deliveries``, the plan cache) or the JAX
    package's ``build_shard_push_deliveries`` (same field names, numpy
    leaves with a leading shard axis): one chain of placed plans per
    shard. Checks the class geometry, the shard axis of every table, the
    chain of plans against the matvec's lengths, and every plan's shapes
    and index bounds."""
    from gossipprotocol_tpu_torch.ops.sharddelivery import ShardPushDelivery

    dev = resolve_device(device)
    n, loc, ns = int(sd.n), int(sd.local_n), int(sd.num_shards)
    nu, m_pairs, bp = int(sd.nu), int(sd.m_pairs), int(sd.block_pairs)
    if ns < 1 or loc < 1 or n > ns * loc or ns * loc - n >= ns:
        raise ValueError(f"partition of {n} nodes into {ns} shards of "
                         f"{loc} rows is not the padded one")
    if bp < 1 or bp % 64:
        raise ValueError(f"block_pairs {bp} is not a positive multiple "
                         "of 64")
    classes = tuple(tuple(int(v) for v in c) for c in sd.classes)
    cursor = caps = 0
    for c, n_c, start, rows, cap in classes:
        if c < 1 or c & (c - 1) or start != cursor or n_c > cap \
                or rows * LANES != 2 * cap * c:
            raise ValueError(f"class {(c, n_c, start, rows, cap)} does not "
                             f"tile the layout at pair {cursor}")
        cursor += cap * c
        caps += cap
    if cursor != m_pairs or caps != nu:
        raise ValueError(f"classes cover {cursor} pairs and {caps} node "
                         f"slots; m_pairs {m_pairs}, nu {nu}")
    realmask = np.ascontiguousarray(sd.realmask, np.float32)
    if realmask.shape != (ns, 2 * m_pairs) or not (
            (realmask == 0.0) | (realmask == 1.0)).all():
        raise ValueError(f"realmask must be 0/1 float32 "
                         f"[{ns}, {2 * m_pairs}]")
    degree = np.asarray(sd.degree)
    if degree.shape != (ns, loc):
        raise ValueError(f"degree shape {degree.shape} != ({ns}, {loc})")
    slab = 2 * ns * bp
    groups = {}
    for name, need_in, need_out in (
            ("plan_in", 2 * loc, 2 * nu),
            ("plan_send", 2 * m_pairs, 2 * m_pairs + slab),
            ("plan_recv", 2 * m_pairs + slab, 2 * m_pairs),
            ("plan_out", 2 * nu, 2 * loc)):
        stacked = getattr(sd, name)
        for dp in stacked:
            for a in ([st.idx for st in dp.stages]
                      + [dp.final.idx, dp.final.mask]):
                if np.asarray(a).shape[:1] != (ns,):
                    raise ValueError(f"{name}: tables lack the leading "
                                     f"axis of {ns} shards")
        chains = tuple(tuple(plan_from_numpy(_unstack_plan(dp, k), dev)
                             for dp in stacked) for k in range(ns))
        c0 = chains[0]
        if not c0 or c0[0].m_in_f32 < need_in \
                or c0[-1].m_out_f32 < need_out:
            raise ValueError(f"{name} does not take {need_in} values to "
                             f"{need_out}")
        groups[name] = chains
    return ShardPushDelivery(
        n=n, local_n=loc, num_shards=ns, nu=nu, m_pairs=m_pairs,
        block_pairs=bp, classes=classes,
        realmask=torch.from_numpy(realmask.copy()).to(dev),
        degree=torch.from_numpy(degree.astype(np.int32)).to(dev), **groups)
