"""Carry state and plan tables across from host arrays.

The system has no weights; what stands in for them is the push-sum state
and the delivery's plan tables. These converters take them as numpy
arrays — for example the fields of a JAX-package ``PushSumState`` or of a
``PallasDelivery`` built with ``device=False`` — and place them on a
torch device, checking shapes, types and index bounds on the way. The
device is ``cuda`` unless the caller asks for ``cpu``; asking for ``cuda``
with no card present raises.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gossipprotocol_tpu_torch.ops.build import resolve_device
from gossipprotocol_tpu_torch.ops.pallasdelivery import (
    LANES, TILE, TILE_ROWS, GatherPlan, PallasDelivery,
)
from gossipprotocol_tpu_torch.protocols.state import PushSumState


def state_from_numpy(s, w, ratio, streak, converged, alive, round,
                     device="cuda") -> PushSumState:
    """A :class:`PushSumState` on ``device`` from its fields as numpy
    (the scalar push-sum path: every field ``[n]``, ``round`` a scalar)."""
    dev = resolve_device(device)
    s, w, ratio = (np.ascontiguousarray(a) for a in (s, w, ratio))
    n = s.shape[0]
    for name, a in (("s", s), ("w", w), ("ratio", ratio)):
        if a.shape != (n,) or a.dtype != np.float32:
            raise ValueError(f"state field {name}: expected float32 [{n}], "
                             f"got {a.dtype} {a.shape}")
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
