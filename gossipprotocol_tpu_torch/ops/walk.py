"""The reference walk's chunk of hops as one CUDA kernel (``csrc/walk.cu``),
its host-side inputs, and host replays of what it computes.

No Pallas kernel computes the walk: ``walk_chunk`` is the port's
counterpart of the JAX package's on-device ``lax.while_loop`` over
``pushsum_walk_round`` (``gossipprotocol_tpu/protocols/walk.py:122-177``).
Its plain version is ``protocols/walk.py`` :func:`walk_chunk_plain` (a
chunk of hops as PyTorch operations), and the engine's chunk runner
(:func:`~gossipprotocol_tpu_torch.protocols.walk.make_walk_chunk_runner`)
launches the kernel for CUDA tensors and runs the plain version for CPU
ones. Nothing falls back: a failed build or launch raises.

The kernel cannot run on the CPU, so what surrounds it is held here in
Python the CPU tests reach: :func:`walk_layout` (the flattened neighbour
table, its row starts and degrees, checked), :func:`hop_words` and
:func:`draw_in` (the kernel's per-hop words and draw, in numpy uint32),
and :func:`walk_chunk_replay` (the kernel's walker, statement for
statement, over numpy arrays).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gossipprotocol_tpu_torch.ops import build
from gossipprotocol_tpu_torch.protocols.sampling import (
    THREEFRY_PARTITIONABLE, CSRNeighbors, DenseNeighbors, InvertedDense,
)

# kernel launches since the last reset (counted where the wrapper
# launches; the CPU path launches nothing)
LAUNCHES = {"walk_chunk": 0}

# the neighbour layouts of csrc/walk.cu
LAYOUT_FULL, LAYOUT_DENSE, LAYOUT_CSR = 0, 1, 2
# hops whose words one shared-memory buffer of the kernel holds
WALK_TILE = 1024

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


class WalkLayout(NamedTuple):
    """The kernel's view of the neighbours: ``layout`` (full, dense or
    CSR), the degrees (int32 ``[n]``), the CSR row starts (int64 ``[n]``),
    the flattened table (int32: a dense table row-major, or the CSR
    indices), the dense row width and the node count."""

    layout: int
    degree: Optional[torch.Tensor]
    starts: Optional[torch.Tensor]
    flat: Optional[torch.Tensor]
    row_width: int
    n: int


def walk_layout(nbrs, n: int) -> WalkLayout:
    """The kernel's inputs for ``nbrs`` (``DenseNeighbors``,
    ``InvertedDense``, ``CSRNeighbors`` or None for the implicit complete
    graph) over ``n`` nodes, with their shapes and types checked: int32
    degrees and table, int64 CSR starts, all contiguous."""
    if nbrs is None:
        if n < 2:
            raise ValueError("walk_layout: the complete graph needs n >= 2")
        return WalkLayout(LAYOUT_FULL, None, None, None, 0, n)

    def need(t: torch.Tensor, dtype, shape, name):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"walk_layout: {name} must be {dtype} "
                             f"{list(shape)}, got {t.dtype} "
                             f"{list(t.shape)}")
        return t.contiguous()

    degree = need(nbrs.degree, torch.int32, (n,), "degree")
    if isinstance(nbrs, (DenseNeighbors, InvertedDense)):
        width = nbrs.table.shape[1] if nbrs.table.dim() == 2 else -1
        table = need(nbrs.table, torch.int32, (n, width), "table")
        return WalkLayout(LAYOUT_DENSE, degree, None, table.reshape(-1),
                          width, n)
    if not isinstance(nbrs, CSRNeighbors):
        raise TypeError(f"walk_layout: no walk over {type(nbrs).__name__}")
    starts = need(nbrs.starts, torch.int64, (n,), "starts")
    flat = need(nbrs.indices, torch.int32, (nbrs.indices.shape[0],),
                "indices")
    return WalkLayout(LAYOUT_CSR, degree, starts, flat, 0, n)


def walk_chunk(lay: WalkLayout, state, base_key: torch.Tensor, hops: int,
               quorum: int, streak_target: int,
               partitionable: bool = THREEFRY_PARTITIONABLE
               ) -> torch.Tensor:
    """Run ``hops`` hops of the walk from ``state`` (a ``WalkState`` on one
    CUDA device) in ONE launch of ``csrc/walk.cu``, updating the state's
    tensors in place: the node arrays, ``round``, ``cur``, ``msg_s`` and
    ``msg_w``. Returns the settled count after the chunk (int32 scalar on
    the device). Bitwise :func:`~gossipprotocol_tpu_torch.protocols.walk.
    walk_chunk_plain` on the same inputs; the launch returns once
    ``quorum`` rows are settled (converged or not alive)."""
    dev = base_key.device
    if dev.type != "cuda":
        raise ValueError("walk_chunk: the kernel runs on a CUDA device "
                         "(walk_chunk_plain is the CPU path)")
    for name, dtype in (("s", torch.float32), ("w", torch.float32),
                        ("ratio", torch.float32), ("streak", torch.int32),
                        ("converged", torch.bool), ("alive", torch.bool)):
        t = getattr(state, name)
        if (t.device != dev or t.dtype != dtype or t.shape != (lay.n,)
                or not t.is_contiguous()):
            raise ValueError(f"walk_chunk: state.{name} must be contiguous "
                             f"{dtype} [{lay.n}] on {dev}")
    for name, dtype in (("round", torch.int32), ("cur", torch.int32),
                        ("msg_s", torch.float32), ("msg_w", torch.float32)):
        t = getattr(state, name)
        if t.device != dev or t.dtype != dtype or t.numel() != 1:
            raise ValueError(f"walk_chunk: state.{name} must be one {dtype} "
                             f"on {dev}")
    for t in (lay.degree, lay.starts, lay.flat):
        if t is not None and t.device != dev:
            raise ValueError("walk_chunk: the layout and the state lie on "
                             "different devices")
    if base_key.dtype != torch.int64 or base_key.shape != (2,):
        raise ValueError("walk_chunk: base_key must be int64 [2]")
    if hops < 0 or quorum >= 2**31 or streak_target < 1:
        raise ValueError("walk_chunk: hops >= 0, quorum < 2**31 and "
                         "streak_target >= 1")
    settled = torch.sum((state.converged | ~state.alive).to(torch.int32))
    settled = settled.reshape(1).contiguous()

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    lib = build.library("walk")
    rc = lib.gossip_walk_chunk(
        state.s.data_ptr(), state.w.data_ptr(), state.ratio.data_ptr(),
        state.streak.data_ptr(), state.converged.data_ptr(),
        ptr(lay.degree), ptr(lay.starts), ptr(lay.flat),
        state.round.data_ptr(), state.cur.data_ptr(),
        state.msg_s.data_ptr(), state.msg_w.data_ptr(), settled.data_ptr(),
        base_key.data_ptr(), lay.n,
        0 if lay.flat is None else lay.flat.numel(), lay.row_width,
        lay.layout, hops, quorum, streak_target, int(partitionable),
        build.stream_handle(dev))
    build.check(lib, rc, "walk_chunk")
    LAUNCHES["walk_chunk"] += 1
    return settled.reshape(())


def pointer_chase(nxt: torch.Tensor, steps: int) -> torch.Tensor:
    """Follow ``i = nxt[i]`` from 0 for ``steps`` dependent loads on one
    thread (``csrc/walk.cu`` ``pointer_chase_kernel``); returns where the
    chain ended (int32 [1]). A measurement of the card's dependent-load
    latency — the walk kernel's floor — not a path kernel: no count."""
    if (nxt.device.type != "cuda" or nxt.dtype != torch.int32
            or nxt.dim() != 1 or not nxt.is_contiguous()):
        raise ValueError("pointer_chase: nxt must be contiguous int32 [m] "
                         "on a CUDA device")
    out = torch.empty(1, dtype=torch.int32, device=nxt.device)
    lib = build.library("walk")
    rc = lib.gossip_pointer_chase(nxt.data_ptr(), steps, out.data_ptr(),
                                  build.stream_handle(nxt.device))
    build.check(lib, rc, "pointer_chase")
    return out


# ---- host replays of the kernel ---------------------------------------------

def _threefry(k0, k1, x0, x1):
    """threefry-2x32 in numpy uint32 (``csrc/walk.cu`` threefry2x32)."""
    with np.errstate(over="ignore"):
        k0, k1, x0, x1 = (np.asarray(v, dtype=_U32) for v in (k0, k1, x0,
                                                              x1))
        ks = (k0, k1, k0 ^ k1 ^ _U32(_PARITY))
        x0 = x0 + k0
        x1 = x1 + k1
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << _U32(r)) | (x1 >> _U32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def hop_words(base_key: Tuple[int, int], rounds: np.ndarray,
              partitionable: bool = THREEFRY_PARTITIONABLE
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's ``hop_words`` for every round in ``rounds``: the two
    uint32 words ``(hi, lo)`` of ``randint_words(fold_in(base_key, r))``,
    computed as the kernel computes them (a tile of hops at once)."""
    b0, b1 = (_U32(int(k) & 0xFFFFFFFF) for k in base_key)
    r = np.asarray(rounds, dtype=np.int64).astype(_U32)
    zero = np.zeros_like(r)
    a0, a1 = _threefry(b0, b1, zero, r)
    if partitionable:
        p0, p1 = _threefry(a0, a1, zero, zero)
        q0, q1 = _threefry(a0, a1, zero, zero + _U32(1))
        key0, key1 = (p0, p1), (q0, q1)
    else:
        p0, p1 = _threefry(a0, a1, zero, zero + _U32(2))
        q0, q1 = _threefry(a0, a1, zero + _U32(1), zero + _U32(3))
        key0, key1 = (p0, q0), (p1, q1)
    h0, h1 = _threefry(*key0, zero, zero)
    l0, l1 = _threefry(*key1, zero, zero)
    if partitionable:
        return h0 ^ h1, l0 ^ l1
    return h0, l0


def draw_in(hi, lo, span):
    """The kernel's ``draw_in``: ``randint_from_words`` for ``span >= 1``
    in numpy uint32, every product and sum wrapped."""
    with np.errstate(over="ignore"):
        hi, lo, span = (np.asarray(v, dtype=_U32) for v in (hi, lo, span))
        mult = _U32(65536) % span
        mult = (mult * mult) % span
        off = (hi % span) * mult
        off = off + lo % span
        return off % span


def walk_chunk_replay(layout: int, degree, starts, flat, row_width: int,
                      n: int, state: dict, base_key: Tuple[int, int],
                      hops: int, quorum: int, streak_target: int,
                      partitionable: bool = THREEFRY_PARTITIONABLE) -> int:
    """``csrc/walk.cu``'s walker replayed on the host, statement for
    statement, over numpy arrays: ``state`` holds ``s``, ``w``, ``ratio``
    (float32), ``streak`` (int32), ``converged``, ``alive`` (bool) and the
    scalars ``round``, ``cur``, ``msg_s``, ``msg_w``; it is updated in
    place, tile by tile of :data:`WALK_TILE` hops. Returns the settled
    count. The CPU tests hold it to :func:`~gossipprotocol_tpu_torch.
    protocols.walk.walk_chunk_plain`."""
    s, w, ratio = state["s"], state["w"], state["ratio"]
    streak, conv = state["streak"], state["converged"]
    f32 = np.float32
    half, tiny = f32(0.5), f32(1e-30)

    def rat(a, b):
        return f32(a / (tiny if b < tiny else b))

    settled = int(np.sum(conv | ~state["alive"]))
    cur, rnd = int(state["cur"]), int(state["round"])
    r0 = rnd
    msg_s, msg_w = f32(state["msg_s"]), f32(state["msg_w"])
    deg_cur = int(degree[cur]) if layout != LAYOUT_FULL else 0
    start_cur = int(starts[cur]) if layout == LAYOUT_CSR else 0
    flat_len = 0 if flat is None else len(flat)
    tiles = -(-hops // WALK_TILE)
    for t in range(tiles):
        if settled >= quorum:
            break
        first = t * WALK_TILE
        count = min(WALK_TILE, hops - first)
        his, los = hop_words(base_key, r0 + first + np.arange(count),
                             partitionable)
        for k in range(count):
            if settled >= quorum:
                break
            rnd += 1
            hi, lo = his[k], los[k]
            if layout == LAYOUT_FULL:
                if n < 2:
                    continue
                off = int(draw_in(hi, lo, n - 1))
                tgt = off + (off >= cur)
            else:
                if deg_cur <= 0:
                    continue
                j = int(draw_in(hi, lo, deg_cur))
                if layout == LAYOUT_DENSE:
                    p = cur * row_width + j
                else:
                    p = min(max(start_cur + j, 0), flat_len - 1)
                tgt = int(flat[p])
            c_t, s_t, w_t, k_t = bool(conv[tgt]), s[tgt], w[tgt], \
                int(streak[tgt])
            deg_next = int(degree[tgt]) if layout != LAYOUT_FULL else 0
            start_next = int(starts[tgt]) if layout == LAYOUT_CSR else 0
            if c_t:
                ratio[tgt] = rat(s_t, w_t)
            else:
                hs = f32(f32(s_t + msg_s) * half)
                hw = f32(f32(w_t + msg_w) * half)
                s[tgt], w[tgt], ratio[tgt] = hs, hw, rat(hs, hw)
                streak[tgt] = k_t + 1
                if k_t + 1 >= streak_target:
                    conv[tgt] = True
                    settled += 1
                msg_s, msg_w = hs, hw
            cur, deg_cur, start_cur = tgt, deg_next, start_next
    state.update(round=rnd, cur=cur, msg_s=msg_s, msg_w=msg_w)
    return settled
