"""Executor of routing plans (port of ``gossipprotocol_tpu/ops/exec.py``).

A plan (``ops/plan.py``) is L radix stages and one final pass. Each
stage routes every input [128,128] tile through O Clos permutations and
writes the routed rows into bucket runs of a strided staging slab; the
final pass K-merges each output tile from K staging tiles with
bit-packed masks, slots with no flow reading +0.0. Both passes only move
f32 values, so the CUDA kernel, its plain version and the JAX package
agree bitwise.

Device table format (the JAX package's, so routed plan-cache entries are
interchangeable): unit-2 stage/final indices stored pair-halved and
transposed, ``[.., 3, 64, 128]`` int8; unit-1 indices ``[.., 3, 128,
128]`` int8; final masks bit-packed and transposed, ``[nt_out, k, 16,
128]`` uint8.

Each pass has two bodies behind one wrapper, in the style of
``ops/classops.py``: the CUDA kernel (``csrc/route.cu``) for a tensor on
a CUDA device — it launches or raises — and the plain PyTorch version
(``*_plain``: the JAX kernel's three lane gathers and two transposes,
literally) for a tensor on the CPU.

On the card the three gathers compose into one per output element
(:func:`composed_route_index`): with ``m = i3[r][c]`` and
``j = i2[m][r]``, ``y[r][c] = x[j][i1[j][m]]``.
"""

from __future__ import annotations

import weakref
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from gossipprotocol_tpu_torch.ops import build
from gossipprotocol_tpu_torch.ops.plan import RoutePlan

LANES = 128
TILE = LANES * LANES

# kernel launches since the last reset (counted where each wrapper
# launches its kernel; the CPU path launches nothing)
LAUNCHES = {"stage_call": 0, "final_call": 0}


class DeviceStage(NamedTuple):
    p: int
    tau_in: int
    b: int
    cr: int
    o: int
    tau_slab: int
    idx: Any   # int8 [p*tau_in, o, 3, 64, 128] for unit=2 plans
               # (pair-redundant entries dropped, stored transposed —
               # see device_plan), else [p*tau_in, o, 3, 128, 128];
               # numpy on the host, a tensor once placed


class DeviceFinal(NamedTuple):
    k: int
    idx: Any   # int8 [nt_out, k, 3, 64|128, 128]
    mask: Any  # uint8 [nt_out, k, 16, 128] — bit-packed source-k
               # selector, stored transposed (bit c&7 of byte
               # [c>>3][r] selects slot (r, c))


class DevicePlan(NamedTuple):
    """A RoutePlan in its device storage format: host numpy from
    :func:`device_plan`, torch tensors once placed
    (``convert.plan_from_numpy``)."""

    unit: int
    nt_in: int
    nt_out: int
    stages: Tuple[DeviceStage, ...]
    final: DeviceFinal

    @property
    def m_in_f32(self) -> int:
        return self.nt_in * TILE

    @property
    def m_out_f32(self) -> int:
        return self.nt_out * TILE


def device_plan(plan: RoutePlan) -> DevicePlan:
    """Compact a RoutePlan's tables into their device storage format
    (host numpy; the JAX package's ``device_plan``, byte for byte)."""
    def shrink(idx):
        # unit=2: odd entries are derivable (see widen_idx). The
        # lane-stage arrays (components 0, 2) halve along lanes; the
        # row-stage array (component 1) has its redundancy along rows.
        # All three are stored TRANSPOSED [64, 128].
        if plan.unit != 2:
            return idx
        out = np.empty(idx.shape[:-2] + (64, 128), idx.dtype)
        out[..., 0, :, :] = np.swapaxes(idx[..., 0, :, 0::2], -1, -2)
        out[..., 2, :, :] = np.swapaxes(idx[..., 2, :, 0::2], -1, -2)
        out[..., 1, :, :] = np.swapaxes(idx[..., 1, :, :], -1, -2)[..., 0::2].swapaxes(-1, -2)
        return out

    stages = tuple(
        DeviceStage(st.p, st.tau_in, st.b, st.cr, st.o, st.tau_slab,
                    shrink(st.idx))
        for st in plan.stages)
    m = np.asarray(plan.final.mask, np.uint8).reshape(
        plan.nt_out, plan.final.k, 128, 16, 8)
    packed = np.zeros(m.shape[:-1], np.uint8)
    for b in range(8):
        packed |= (m[..., b] << b).astype(np.uint8)
    packed = np.swapaxes(packed, -1, -2)
    fin = DeviceFinal(plan.final.k, shrink(plan.final.idx), packed)
    return DevicePlan(plan.unit, plan.nt_in, plan.nt_out, stages, fin)


# ---- the Clos route, plain -----------------------------------------------

# The plain path decodes the same int8 tables every round. On the CPU the
# decoded form of a small table is kept for the table's lifetime (keyed
# by the tensor object); a large table, or one on the card, is decoded
# per call.
_DECODED: dict = {}
_MEMO_MAX_ELEMS = 1 << 22


def _memo(table: torch.Tensor, tag, fn):
    if table.device.type != "cpu" or table.numel() > _MEMO_MAX_ELEMS:
        return fn()
    key = (id(table), tag)
    hit = _DECODED.get(key)
    if hit is not None and hit[0]() is table:
        return hit[1]
    value = fn()
    _DECODED[key] = (weakref.ref(table, lambda _r, k=key:
                                 _DECODED.pop(k, None)), value)
    return value


def widen_idx(planes: torch.Tensor, unit: int):
    """Stored index planes ``[..., 3, 64|128, 128]`` int8 -> the three
    lane-gather index arrays ``(i1, i2, i3)``, int64 ``[..., 128, 128]``.

    Unit 2 (the JAX package's ``_widen_pair_idx``): with stored planes
    S0, S1, S2, ``i1[r][c] = S0[c>>1][r] + (c&1)``, ``i2[j][r] =
    S1[j>>1][r]`` (its redundancy runs along rows, so no parity term) and
    ``i3[r][c] = S2[c>>1][r] + (c&1)``. Unit 1 stores them directly."""
    p = planes.long()
    if unit != 2:
        return p[..., 0, :, :], p[..., 1, :, :], p[..., 2, :, :]
    parity = torch.arange(LANES, device=planes.device) % 2
    i1 = p[..., 0, :, :].transpose(-1, -2).repeat_interleave(2, dim=-1) + parity
    i2 = p[..., 1, :, :].repeat_interleave(2, dim=-2)
    i3 = p[..., 2, :, :].transpose(-1, -2).repeat_interleave(2, dim=-1) + parity
    return i1, i2, i3


def route_plain(x: torch.Tensor, planes: torch.Tensor,
                unit: int) -> torch.Tensor:
    """The JAX kernel's ``_route_one``, batched: ``a = G(x, i1)``,
    ``b = G(aᵀ, i2)``, ``y = G(bᵀ, i3)`` over the last two dims
    (``x`` [..., 128, 128] broadcast against the planes' batch dims)."""
    i1, i2, i3 = _memo(planes, unit, lambda: widen_idx(planes, unit))
    x = x.expand(i1.shape)
    a = torch.gather(x, -1, i1)
    b = torch.gather(a.transpose(-1, -2), -1, i2)
    return torch.gather(b.transpose(-1, -2), -1, i3)


def composed_route_index(planes: torch.Tensor, unit: int) -> torch.Tensor:
    """The route as one gather: int64 ``[..., 128, 128]`` holding, for
    each output slot (r, c), the source slot ``j*128 + i1[j][m]`` with
    ``m = i3[r][c]`` and ``j = i2[m][r]`` — the decoding the CUDA kernels
    run per element."""
    i1, i2, i3 = widen_idx(planes, unit)
    j = torch.gather(i2.transpose(-1, -2), -1, i3)   # i2[m][r], m = i3[r][c]
    col = torch.gather(i1.flatten(-2), -1,
                       (j * LANES + i3).flatten(-2)).view(j.shape)
    return j * LANES + col


def final_bits(mask: torch.Tensor) -> torch.Tensor:
    """Unpack ``[..., 16, 128]`` transposed bit-packed masks to
    ``[..., 128, 128]`` bools: slot (r, c) reads bit ``c & 7`` of byte
    ``[c >> 3][r]``."""
    col = torch.arange(LANES, device=mask.device)
    by = mask.transpose(-1, -2).long()[..., col // 8]   # [..., r, c]
    return ((by >> (col % 8)) & 1) != 0


# ---- _stage_call ---------------------------------------------------------

def _check_pass_args(x: torch.Tensor, idx: torch.Tensor, n_in: int,
                     lead: int, per: int, unit: int, what: str) -> None:
    """``x`` f32 ``[n_in, 128, 128]``, ``idx`` int8 ``[lead, per, 3,
    64|128, 128]`` (64 for unit-2 plans)."""
    iw = 64 if unit == 2 else LANES
    want = (lead, per, 3, iw, LANES)
    if tuple(x.shape) != (n_in, LANES, LANES):
        raise ValueError(f"{what}: input must be [{n_in}, 128, 128], got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: expected float32, got {x.dtype}")
    if tuple(idx.shape) != want or idx.dtype != torch.int8:
        raise ValueError(f"{what}: index planes must be int8 {want}, got "
                         f"{idx.dtype} {tuple(idx.shape)}")


def _require_cuda(what: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: tables and input on other devices")
        if not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: data pointer not 16-byte aligned")


def stage_rows_written(st: DeviceStage, staging: torch.Tensor) -> torch.Tensor:
    """The part of a stage's output the stage writes: ``[p, b, tau_in,
    cr, 128]`` (slab rows ``i >= tau_in`` stay unwritten; no final mask
    selects them)."""
    return staging.view(st.p, st.b, st.tau_slab, st.cr,
                        LANES)[:, :, : st.tau_in]


def stage_call_plain(st: DeviceStage, cur: torch.Tensor,
                     unit: int) -> torch.Tensor:
    """Plain PyTorch body of one stage: per input tile, the O routed
    tiles concatenated and cut to ``b*cr`` rows, written as
    ``staging[p][bucket][i][0:cr] = rows[bucket*cr:(bucket+1)*cr]``.
    Unwritten slab rows read +0.0 here."""
    tiles = st.p * st.tau_in
    _check_pass_args(cur, st.idx, tiles, tiles, st.o, unit, "stage_call")
    y = route_plain(cur[:, None], st.idx, unit)        # [T, o, 128, 128]
    rows = y.reshape(tiles, st.o * LANES, LANES)[:, : st.b * st.cr]
    rows = rows.reshape(st.p, st.tau_in, st.b, st.cr, LANES)
    out = torch.zeros((st.p, st.b, st.tau_slab, st.cr, LANES),
                      dtype=cur.dtype, device=cur.device)
    out[:, :, : st.tau_in] = rows.transpose(1, 2)
    return out.view(-1, LANES, LANES)


def stage_call(st: DeviceStage, cur: torch.Tensor, unit: int) -> torch.Tensor:
    """One radix stage: ``cur`` f32 ``[p*tau_in, 128, 128]`` -> staging
    f32 ``[p*b*tau_slab*cr/128, 128, 128]``.

    On CUDA: ``csrc/route.cu`` ``route_stage_kernel``, replacing the
    Pallas kernel at ``gossipprotocol_tpu/ops/exec.py:154``
    (``_stage_call``). Bound by bytes (tiles and index planes in, slab
    rows out); one block per (input tile, o) stages the tile and its
    planes in shared memory and gathers each output element through the
    composed route. Slab rows ``i >= tau_in`` are left unwritten."""
    if cur.device.type == "cpu":
        return stage_call_plain(st, cur, unit)
    tiles = st.p * st.tau_in
    _check_pass_args(cur, st.idx, tiles, tiles, st.o, unit, "stage_call")
    _require_cuda("stage_call", cur, st.idx)
    if (st.o * LANES < st.b * st.cr or (st.o - 1) * LANES >= st.b * st.cr
            or LANES % st.cr or (st.tau_slab * st.cr) % LANES
            or st.tau_slab < st.tau_in):
        raise ValueError(f"stage_call: inconsistent geometry {tuple(st[:6])}")
    out = torch.empty((st.p * st.b * st.tau_slab * st.cr // LANES, LANES,
                       LANES), dtype=torch.float32, device=cur.device)
    lib = build.library("route")
    rc = lib.gossip_route_stage(
        cur.data_ptr(), st.idx.data_ptr(), out.data_ptr(), tiles, st.o,
        st.b, st.cr, st.tau_in, st.tau_slab, unit,
        build.stream_handle(cur.device))
    build.check(lib, rc, "stage_call")
    LAUNCHES["stage_call"] += 1
    return out


# ---- _final_call ---------------------------------------------------------

def _check_mask(fin: DeviceFinal, nt_out: int) -> None:
    want = (nt_out, fin.k, 16, LANES)
    if tuple(fin.mask.shape) != want or fin.mask.dtype != torch.uint8:
        raise ValueError(f"final_call: masks must be uint8 {want}, got "
                         f"{fin.mask.dtype} {tuple(fin.mask.shape)}")


def final_call_plain(fin: DeviceFinal, nt_out: int, cur: torch.Tensor,
                     unit: int) -> torch.Tensor:
    """Plain PyTorch body of the final pass: for kk = 0 .. k-1 in
    ascending order, ``acc = where(bit_kk, route(region[kk]), acc)`` from
    +0.0 — the last kk whose bit is set wins, no set bit reads +0.0.
    Output tile f merges input tiles ``f*k .. f*k + k-1``; tiles past
    ``nt_out*k`` (empty radix regions) are not read."""
    cur = cur[: nt_out * fin.k]
    _check_pass_args(cur, fin.idx, nt_out * fin.k, nt_out, fin.k, unit,
                     "final_call")
    _check_mask(fin, nt_out)
    y = route_plain(cur.view(nt_out, fin.k, LANES, LANES), fin.idx, unit)
    bits = _memo(fin.mask, "bits", lambda: final_bits(fin.mask))
    acc = torch.zeros((nt_out, LANES, LANES), dtype=cur.dtype,
                      device=cur.device)
    for kk in range(fin.k):
        acc = torch.where(bits[:, kk], y[:, kk], acc)
    return acc


def final_call(fin: DeviceFinal, nt_out: int, cur: torch.Tensor,
               unit: int) -> torch.Tensor:
    """The final K-merge: ``cur`` f32 ``[>= nt_out*k, 128, 128]`` -> f32
    ``[nt_out, 128, 128]``.

    On CUDA: ``csrc/route.cu`` ``route_final_pipe_kernel``, replacing the
    Pallas kernel at ``gossipprotocol_tpu/ops/exec.py:193``
    (``_final_call``). Bound by bytes; a persistent grid walks the (tile,
    kk) steps, each step's tile, planes and masks landing by bulk copies
    in a two-stage shared-memory ring while the step before routes."""
    if cur.device.type == "cpu":
        return final_call_plain(fin, nt_out, cur, unit)
    cur = cur[: nt_out * fin.k]
    _check_pass_args(cur, fin.idx, nt_out * fin.k, nt_out, fin.k, unit,
                     "final_call")
    _check_mask(fin, nt_out)
    if fin.k < 1 or unit not in (1, 2):
        raise ValueError(f"final_call: k={fin.k}, unit={unit} (k >= 1, "
                         "unit 1 or 2)")
    _require_cuda("final_call", cur, fin.idx, fin.mask)
    out = torch.empty((nt_out, LANES, LANES), dtype=torch.float32,
                      device=cur.device)
    lib = build.library("route")
    rc = lib.gossip_route_final(
        cur.data_ptr(), fin.idx.data_ptr(), fin.mask.data_ptr(),
        out.data_ptr(), nt_out, fin.k, unit, cur.device.index,
        build.stream_handle(cur.device))
    build.check(lib, rc, "final_call")
    LAUNCHES["final_call"] += 1
    return out


def apply_plan(dp: DevicePlan, x: torch.Tensor) -> torch.Tensor:
    """Route a flat f32 array through a placed plan.

    ``x``: f32 ``[nt_in*16384]``. Returns f32 ``[nt_out*16384]``; slots
    compiled as don't-care are +0.0."""
    cur = x.reshape(dp.nt_in, LANES, LANES)
    for st in dp.stages:
        cur = stage_call(st, cur, dp.unit)
    return final_call(dp.final, dp.nt_out, cur, dp.unit).reshape(-1)
