"""Round-loop megakernel: K diffusion push-sum rounds in one launch.

Port of ``gossipprotocol_tpu/ops/megakernel.py`` (``--delivery
megakernel``, or ``--rounds-per-kernel K`` on the pallas path). When both
gather plans of the fused delivery are resident, one launch of
``csrc/megakernel.cu`` runs K whole rounds — share, gather-pre, class
folds, gather-out, update, predicate — and tests the supervisor predicate
before each round: once it holds the kernel stops, so the state and the
round count are bitwise the per-round trajectory for every K, and
``executed`` counts only the rounds run.

The state the kernel reads is the JAX kernel's padded block form: s, w,
ratio f32 and streak, conv int32, each ``[rp, 128]``
(:class:`MegakernelState`; ``round`` is the run's int32 scalar). On the
card the kernel updates it IN PLACE and adds ``executed`` to ``round``;
a chunk pads once, launches, and unpads once (``engine/driver.py``).
For tensors on the CPU the wrapper runs the plain PyTorch version,
:func:`megakernel_rounds_plain`, which replays the per-round path op for
op with the freeze rule (and returns new tensors).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gossipprotocol_tpu_torch.ops import build
from gossipprotocol_tpu_torch.ops.delivery import RoutedConfigError
from gossipprotocol_tpu_torch.ops.pallasdelivery import (
    LANES, TILE_ROWS, PallasDelivery, _resident_rows,
)
from gossipprotocol_tpu_torch.protocols.state import PushSumState

# kernel launches since the last reset (counted where the wrapper
# launches the kernel; the CPU path launches nothing)
LAUNCHES = {"megakernel": 0}

THREADS = 256            # csrc/megakernel.cu MK_THREADS
_CLASS_COLS = 8          # columns of the kernel's class table


def _pad_rows(n: int) -> int:
    """128-lane rows of the padded 2-D state view, sublane-aligned."""
    return -(-n // (TILE_ROWS * LANES)) * TILE_ROWS


class MegakernelState(NamedTuple):
    """The padded state a K-round launch reads and writes."""

    s: torch.Tensor           # f32 [rp, 128]
    w: torch.Tensor           # f32 [rp, 128]
    ratio: torch.Tensor       # f32 [rp, 128]
    streak: torch.Tensor      # int32 [rp, 128]
    conv: torch.Tensor        # int32 [rp, 128]
    round: torch.Tensor       # int32 scalar


def pad_state(state: PushSumState) -> MegakernelState:
    """Copy ``state`` into the padded form (zero tails); ``round`` is
    copied too, since the kernel adds to it in place."""
    n = state.s.shape[0]
    rp = _pad_rows(n)

    def pad(v, dtype):
        out = torch.zeros(rp * LANES, dtype=dtype, device=v.device)
        out[:n] = v
        return out.view(rp, LANES)

    return MegakernelState(
        pad(state.s, torch.float32), pad(state.w, torch.float32),
        pad(state.ratio, torch.float32), pad(state.streak, torch.int32),
        pad(state.converged, torch.int32), state.round.clone())


def unpad_state(ms: MegakernelState, alive: torch.Tensor) -> PushSumState:
    """The :class:`PushSumState` of the first ``n`` rows (views of the
    padded tensors, ``converged`` as bool)."""
    n = alive.shape[0]
    return PushSumState(
        s=ms.s.view(-1)[:n], w=ms.w.view(-1)[:n],
        ratio=ms.ratio.view(-1)[:n], streak=ms.streak.view(-1)[:n],
        converged=ms.conv.view(-1)[:n] != 0, alive=alive, round=ms.round)


class MegakernelDelivery(NamedTuple):
    """A resident-mode :class:`PallasDelivery` plus the f32 degree vector
    (the exact small-integer floats the per-round path computes each
    round) and, on the card, the kernel's class table and scratch buffers,
    which make a delivery serve one launch at a time (launches on one
    stream run in order). Exposes ``degree``/``matvec`` like the JAX
    package's."""

    pd: PallasDelivery
    deg_f: torch.Tensor           # f32 [n]
    scratch: Optional[dict]       # the kernel's buffers (None on the CPU)

    @property
    def degree(self) -> torch.Tensor:
        return self.pd.degree

    def matvec(self, xs, xw, plain: bool = False):
        return self.pd.matvec(xs, xw, plain)


def check_megakernel_eligible(pd: PallasDelivery) -> None:
    """Raise :class:`RoutedConfigError` unless both gathers run in
    resident mode (the JAX package's rule). Hub classes are fine: their
    sub-class partials left-fold inside the kernel."""
    bucketed = [name for name, g in (("gather_pre", pd.gather_pre),
                                     ("gather_out", pd.gather_out))
                if g.mode != "resident"]
    if bucketed:
        raise RoutedConfigError(
            f"megakernel needs resident-mode gather plans; {bucketed} "
            f"compiled in bucket mode at this size (a gather source "
            f"above {_resident_rows()} 128-lane rows). Raise the "
            "resident bound (GOSSIP_TPU_PALLAS_RESIDENT_ROWS, default "
            "8192 rows, kept equal to the JAX package's so plans stay "
            "byte-equal), or use --delivery pallas")


def _class_table(pd: PallasDelivery):
    """``(table rows, split-partial count, has_split)``: per class
    ``(c, n_c, start_pair, cap, q, out_at, part_at, 0)`` with q = 0 for
    small classes, ``out_at`` the class's packed-output prefix and
    ``part_at`` its offset in the split-partial scratch."""
    rows, out_at, part_at, has_split = [], 0, 0, False
    for c, n_c, start, _reg_rows, cap in pd.classes:
        q = 0 if 2 * c <= LANES else (2 * c) // LANES
        rows.append([c, n_c, start, cap, q, out_at, part_at, 0])
        out_at += 2 * n_c
        if q:
            part_at += q * n_c
            has_split = True
    return rows, part_at, has_split


def build_megakernel_delivery(pd: PallasDelivery) -> MegakernelDelivery:
    """Wrap a resident-mode delivery for the K-round kernel (checked
    loudly here, before any launch); on the card, allocate the kernel's
    scratch once."""
    check_megakernel_eligible(pd)
    dev = pd.degree.device
    deg_f = pd.degree.to(torch.float32)
    if dev.type == "cpu":
        return MegakernelDelivery(pd, deg_f, None)
    rows, n_part, has_split = _class_table(pd)
    max_grid = max_grid_size(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = dict(
        classes=torch.tensor(rows, dtype=torch.int32,
                             device=dev).reshape(-1, _CLASS_COLS),
        xp=torch.zeros(pd.gather_pre.src_rows * LANES, **f32),
        yp=torch.zeros(pd.gather_out.src_rows * LANES, **f32),
        part=torch.zeros(max(1, 2 * n_part), **f32),
        red=torch.zeros(2 * max_grid, **f32),
        cnt=torch.zeros(max_grid, dtype=torch.int32, device=dev),
        bar=torch.zeros(2, dtype=torch.int32, device=dev),
        max_grid=max_grid, has_split=has_split,
    )
    return MegakernelDelivery(pd, deg_f, scratch)


def megakernel_working_set_bytes(pd: PallasDelivery) -> int:
    """Closed-form bytes of the K-round kernel's working set — the JAX
    package's ``megakernel_vmem_bytes`` (there is no VMEM on the card;
    ``chip_smoke.py`` prints it against the 50 MB L2): the padded state
    I/O (6 in + 5 out 128-lane vectors), both int32 index tables, the two
    gather sources with their gathered f32 streams, and the widest class
    region with its fold accumulator. K-independent."""
    rp = _pad_rows(pd.n)
    state_io = 11 * rp * LANES * 4
    idx = (pd.gather_pre.idx.numel() + pd.gather_out.idx.numel()) * 4
    srcs = (pd.gather_pre.src_rows + pd.gather_out.src_rows) * LANES * 4
    gathered = (pd.gather_pre.idx.numel() + pd.gather_out.idx.numel()) * 4
    region = max((reg_rows * LANES * 4 * 2
                  for _c, _n_c, _start, reg_rows, _cap in pd.classes),
                  default=0)
    return state_io + idx + srcs + gathered + region


def launch_grid(mk: MegakernelDelivery) -> int:
    """Blocks of one launch: as many co-resident blocks as the work (the
    larger of the node and pair-slot counts, one thread each) can use."""
    work = max(mk.pd.n, mk.pd.m_pairs)
    return max(1, min(mk.scratch["max_grid"], -(-work // THREADS)))


def max_grid_size(device) -> int:
    """The most blocks one cooperative launch of the kernel may hold on
    ``device``: co-resident blocks per SM times the SM count."""
    import ctypes

    lib = build.library("megakernel")
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.gossip_megakernel_max_grid(ctypes.addressof(out))
    build.check(lib, rc, "megakernel (occupancy query)")
    return out.value


# ---- the plain version ---------------------------------------------------

class _PlainView(NamedTuple):
    """The delivery with its plain gathers and folds, for the round."""

    pd: PallasDelivery

    @property
    def degree(self) -> torch.Tensor:
        return self.pd.degree

    def matvec(self, xs, xw):
        return self.pd.matvec(xs, xw, plain=True)


def _done(conv: torch.Tensor, quorum: Optional[int]) -> torch.Tensor:
    if quorum is None:
        return torch.all(conv)
    return torch.sum(conv.to(torch.int32)) >= quorum


def kernel_order_mean(s: torch.Tensor, w: torch.Tensor,
                      grid: int) -> torch.Tensor:
    """``sum(s) / max(sum(w), 1e-30)`` summed in the kernel's order for a
    launch of ``grid`` blocks: per thread over its nodes
    ``i = thread + t * grid * THREADS`` in ascending t, a shuffle-down tree
    in each warp, the warps of a block in order, then the blocks in order
    (a left fold). Returns an f32 scalar on ``s``'s device."""
    import numpy as np

    n = s.shape[0]
    stride = grid * THREADS
    rows = -(-n // stride)
    sums = []
    for x in (s, w):
        v = torch.zeros(rows * stride, dtype=torch.float32, device=x.device)
        v[:n] = x
        acc = torch.zeros(stride, dtype=torch.float32, device=x.device)
        for r in v.view(rows, stride):    # +0.0 tails add exactly
            acc = acc + r
        lanes = acc.view(grid, THREADS // 32, 32)
        off = 16
        while off:
            lanes = lanes[..., :off] + lanes[..., off: 2 * off]
            off //= 2
        warps = lanes[..., 0]
        block = warps[:, 0]
        for j in range(1, THREADS // 32):
            block = block + warps[:, j]
        part = block.cpu().numpy()
        tot = part[0]
        for v_b in part[1:]:
            tot = np.float32(tot + v_b)
        sums.append(np.float32(tot))
    floor = max(sums[1], np.float32(1e-30))
    return torch.tensor(np.float32(sums[0] / floor), device=s.device)


def megakernel_rounds_plain(ms: MegakernelState, mk: MegakernelDelivery,
                            *, n: int, rounds_per_kernel: int, eps: float,
                            streak_target: int, predicate: str, tol: float,
                            quorum: Optional[int] = None,
                            mean_grid: Optional[int] = None
                            ) -> MegakernelState:
    """Plain PyTorch body of one launch, on any device: K rounds of the
    per-round path (``pushsum_diffusion_round_routed`` at ``all_alive``
    over the plain gathers and folds, ``_keep`` included), each preceded
    by the done test, frozen with ``torch.where(done, old, new)`` — the
    JAX kernel's loop. Returns new tensors.

    The global predicate's mean is ``torch.sum``'s, as on the per-round
    path. The kernel sums in its own fixed order, which can move the mean
    by an ulp and flip ``near`` at a node within that of ``tol``; with
    ``mean_grid`` (the launch's grid, :func:`launch_grid`) the mean is
    summed in the kernel's order instead (:func:`kernel_order_mean`), which
    is what the kernel is held to on the card. s, w and ratio never
    depend on the mean."""
    from gossipprotocol_tpu_torch.protocols.diffusion import (
        pushsum_diffusion_round_routed,
    )

    alive = torch.ones(n, dtype=torch.bool, device=ms.s.device)
    st = unpad_state(ms, alive)
    view = _PlainView(mk.pd)
    for _ in range(rounds_per_kernel):
        done = _done(st.converged, quorum)
        nxt = pushsum_diffusion_round_routed(
            st, view, eps=eps, streak_target=streak_target,
            predicate=predicate, tol=tol, all_alive=True,
            targets_alive=True)
        if predicate == "global" and mean_grid is not None:
            mean = kernel_order_mean(nxt.s, nxt.w, mean_grid)
            near = torch.abs(nxt.ratio - mean) <= tol
            streak = torch.where(near, st.streak + 1,
                                 torch.zeros_like(st.streak))
            nxt = nxt._replace(streak=streak,
                               converged=streak >= streak_target)
        st = PushSumState(*(torch.where(done, old, new)
                            for new, old in zip(nxt, st)))
    return pad_state(st)


# ---- the kernel ----------------------------------------------------------

def _require_state(ms: MegakernelState, mk: MegakernelDelivery, n: int):
    dev = ms.s.device
    rp = _pad_rows(n)
    if dev.type != "cuda":
        raise ValueError(f"megakernel: no kernel for device {dev}")
    if mk.scratch is None or mk.deg_f.device != dev:
        raise ValueError("megakernel: the delivery is not on the state's "
                         "device")
    if mk.pd.n != n:
        raise ValueError(f"megakernel: delivery has {mk.pd.n} nodes, "
                         f"n={n}")
    for name, t, dtype in (("s", ms.s, torch.float32),
                           ("w", ms.w, torch.float32),
                           ("ratio", ms.ratio, torch.float32),
                           ("streak", ms.streak, torch.int32),
                           ("conv", ms.conv, torch.int32)):
        if t.dtype != dtype or t.shape != (rp, LANES):
            raise ValueError(f"megakernel: {name} must be {dtype} "
                             f"[{rp}, {LANES}], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"megakernel: {name} must be contiguous on "
                             f"{dev}")
    if (ms.round.dtype != torch.int32 or ms.round.numel() != 1
            or ms.round.device != dev):
        raise ValueError("megakernel: round must be an int32 scalar on "
                         "the state's device")
    pre, out = mk.pd.gather_pre, mk.pd.gather_out
    for t in (pre.idx, out.idx):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("megakernel: index tables must be contiguous "
                             "int32")
        if t.data_ptr() % 16:
            raise ValueError("megakernel: index table not 16-byte aligned")
    if pre.out_len != 2 * mk.pd.m_pairs or out.out_len != 2 * n:
        raise ValueError("megakernel: gather plans do not match the "
                         "delivery")


def megakernel_rounds(ms: MegakernelState, mk: MegakernelDelivery, *,
                      n: int, rounds_per_kernel: int, eps: float,
                      streak_target: int, predicate: str, tol: float,
                      quorum: Optional[int] = None) -> MegakernelState:
    """Advance up to ``rounds_per_kernel`` rounds, stopping once the
    supervisor predicate holds (every row converged, or ``quorum``
    converged rows), and add the rounds run to ``ms.round``.

    On CUDA: one cooperative launch of ``csrc/megakernel.cu``, replacing
    the Pallas kernel at ``gossipprotocol_tpu/ops/megakernel.py:279``; the
    state is updated in place and returned. A refused launch raises. For
    CPU tensors: :func:`megakernel_rounds_plain`."""
    if predicate not in ("delta", "global"):
        raise ValueError("predicate must be 'delta' or 'global'")
    if rounds_per_kernel < 1:
        raise ValueError("rounds_per_kernel must be >= 1")
    if ms.s.device.type == "cpu":
        return megakernel_rounds_plain(
            ms, mk, n=n, rounds_per_kernel=rounds_per_kernel, eps=eps,
            streak_target=streak_target, predicate=predicate, tol=tol,
            quorum=quorum)
    _require_state(ms, mk, n)
    sc = mk.scratch
    pd = mk.pd
    grid = launch_grid(mk)
    lib = build.library("megakernel")
    rc = lib.gossip_megakernel(
        ms.s.data_ptr(), ms.w.data_ptr(), ms.ratio.data_ptr(),
        ms.streak.data_ptr(), ms.conv.data_ptr(), ms.round.data_ptr(),
        mk.deg_f.data_ptr(),
        pd.gather_pre.idx.data_ptr(), pd.gather_out.idx.data_ptr(),
        sc["xp"].data_ptr(), sc["xp"].numel(),
        sc["yp"].data_ptr(), sc["yp"].numel(), 2 * pd.nu,
        sc["part"].data_ptr(), sc["red"].data_ptr(), sc["cnt"].data_ptr(),
        sc["bar"].data_ptr(), sc["classes"].data_ptr(),
        sc["classes"].shape[0], int(sc["has_split"]), n,
        int(rounds_per_kernel), float(eps), float(tol), int(streak_target),
        int(predicate == "global"), -1 if quorum is None else int(quorum),
        grid, build.stream_handle(ms.s.device))
    build.check(lib, rc, "megakernel")
    LAUNCHES["megakernel"] += 1
    return ms


def make_megakernel_round(*, n: int, rounds_per_kernel: int, eps: float,
                          streak_target: int, predicate: str, tol: float,
                          quorum: Optional[int] = None):
    """Round core ``(ms, mk) -> ms`` advancing up to
    ``rounds_per_kernel`` rounds per call — what the chunk runner
    launches for ``--delivery megakernel`` / ``--rounds-per-kernel K``."""
    def round_core(ms: MegakernelState, mk: MegakernelDelivery):
        return megakernel_rounds(
            ms, mk, n=n, rounds_per_kernel=rounds_per_kernel, eps=eps,
            streak_target=streak_target, predicate=predicate, tol=tol,
            quorum=quorum)

    return round_core
