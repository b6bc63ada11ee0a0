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
card the kernel updates it IN PLACE (it holds the state in shared memory
for the launch where it fits and writes it back at the end; past that,
about 811,000 nodes on 132 SMs, it works on the state in device memory;
:func:`state_in_shared_memory` asks which)
and adds ``executed`` to
``round``; a chunk pads once, launches, and unpads once
(``engine/driver.py``). The kernel gathers through compact tables it
derives once from the delivery's plans (:func:`_pair_tables`); the plans
themselves stay the JAX package's.
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
    LANES, TILE, TILE_ROWS, PallasDelivery, _resident_rows,
)
from gossipprotocol_tpu_torch.protocols.state import PushSumState

# kernel launches since the last reset (counted where the wrapper
# launches the kernel; the CPU path launches nothing)
LAUNCHES = {"megakernel": 0}

THREADS = 1024           # csrc/megakernel.cu MK_THREADS
_CLASS_COLS = 10         # columns of the kernel's class table (K_COLS)
# the phase probe's stamps per block (csrc/megakernel.cu PROBE_HEAD,
# PROBE_EVENTS per round)
_PROBE_HEAD, _PROBE_EVENTS = 6, 6


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
    """``(table rows, split-partial count, arrival-counter count,
    split units, small units)``: per class ``(c, n_c, start_pair, cap, q,
    out_at, part_at, arr_at, unit_at, units)`` with q = 0 for small
    classes, ``out_at`` the class's packed-output prefix, ``part_at`` and
    ``arr_at`` its offsets in the split partials and arrival counters, and
    ``unit_at`` the prefix of its work units among its kind: a small
    class's unit is 128 pairs (a warp's 16-byte load of four pairs a
    lane), a split class's two of its q*n_c rows."""
    rows, out_at, part_at, arr_at = [], 0, 0, 0
    units_at = {True: 0, False: 0}           # keyed by "is split"
    for c, n_c, start, reg_rows, cap in pd.classes:
        split = 2 * c > LANES
        q = (2 * c) // LANES if split else 0
        units = q * n_c // 2 if split else -(-n_c * c // 128)
        if start % 4 or (not split and units * 128 > reg_rows * 64):
            raise ValueError("megakernel: class region not aligned to "
                             "the kernel's 128-pair units")
        rows.append([c, n_c, start, cap, q, out_at, part_at,
                     arr_at if split else 0, units_at[split], units])
        units_at[split] += units
        out_at += 2 * n_c
        if split:
            part_at += q * n_c
            arr_at += n_c
    return rows, part_at, arr_at, units_at[True], units_at[False]


def _pair_tables(pd: PallasDelivery):
    """The compact tables the kernel reads in place of the plans': the
    source node of every gather-pre pair (``n`` for the zero slot) and
    the packed fold output of every node (``nu`` for the zero slot).
    Exact because the plans gather pairs: pre pair k reads flat slots
    (u, n + u) or the zero slot 2n twice; node i's out slots are
    (2r, 2r + 1) or the zero slot 2nu twice. Checked here, once, so the
    kernel's float2 loads fetch exactly the floats the plans name."""
    n, nu = pd.n, pd.nu
    pre = pd.gather_pre.idx.view(-1, 2).long()
    s_i, w_i = pre[:, 0], pre[:, 1]
    real = s_i < n
    ok_pre = torch.where(real, w_i == s_i + n,
                         (s_i == 2 * n) & (w_i == 2 * n))
    out = pd.gather_out.idx.view(-1)[: 2 * n].long()
    o_s, o_w = out[:n], out[n:]
    ok_out = torch.where(o_s < 2 * nu, (o_s % 2 == 0) & (o_w == o_s + 1),
                         (o_s == 2 * nu) & (o_w == 2 * nu))
    if not (bool(ok_pre.all()) and bool(ok_out.all())):
        raise ValueError("megakernel: the gather plans do not gather "
                         "(s, w) pairs")
    pre_node = torch.where(real, s_i, torch.full_like(s_i, n))
    return (pre_node.to(torch.int32).contiguous(),
            (o_s // 2).to(torch.int32).contiguous())


def build_megakernel_delivery(pd: PallasDelivery) -> MegakernelDelivery:
    """Wrap a resident-mode delivery for the K-round kernel (checked
    loudly here, before any launch); on the card, derive the kernel's
    compact pair tables (:func:`_pair_tables`) and allocate its scratch
    once."""
    check_megakernel_eligible(pd)
    dev = pd.degree.device
    deg_f = pd.degree.to(torch.float32)
    if dev.type == "cpu":
        return MegakernelDelivery(pd, deg_f, None)
    rows, n_part, n_arr, split_units, small_units = _class_table(pd)
    pre_node, out_rank = _pair_tables(pd)
    max_grid = max_grid_size(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    scratch = dict(
        classes=torch.tensor(rows, **i32).reshape(-1, _CLASS_COLS),
        pre_node=pre_node, out_rank=out_rank,
        xp2=torch.zeros(2 * (pd.n + 1), **f32),
        yp2=torch.zeros(2 * (pd.nu + 1), **f32),
        part=torch.zeros(max(1, 2 * n_part), **f32),
        arrived=torch.zeros(max(1, n_arr), **i32),
        red=torch.zeros(2 * max_grid, **f32),
        cnt=torch.zeros(2 * max_grid, **i32),
        bar=torch.zeros(1, **i32),
        work=torch.zeros(2, dtype=torch.int64, device=dev),
        max_grid=max_grid, split_units=split_units,
        small_units=small_units,
    )
    return MegakernelDelivery(pd, deg_f, scratch)


def megakernel_working_set_bytes(pd: PallasDelivery) -> int:
    """Closed-form bytes of the K-round kernel's working set — the JAX
    package's ``megakernel_vmem_bytes`` (there is no VMEM on the card;
    ``chip_smoke.py`` prints it against the 50 MB L2).
    :func:`working_set_bytes` of the delivery's geometry, with its widest
    class region."""
    region = max((reg_rows for _c, _n_c, _start, reg_rows, _cap
                  in pd.classes), default=0)
    return working_set_bytes(pd.n, pd.m_pairs, pd.nu, region)


def working_set_bytes(n: int, m_pairs: int, nu: int,
                      region_rows: int) -> int:
    """The working set from the geometry alone (the capacity planner
    prices it before any plan build): the padded state I/O (6 in + 5 out
    128-lane vectors), both int32 index tables (gather-pre over the
    ``2·m_pairs`` pair slots, gather-out over the ``2·n`` node slots), the
    two gather sources (``2·n`` and ``2·nu`` values and a zero slot) with
    their gathered f32 streams, and the widest class region
    (``region_rows`` 128-lane rows) with its fold accumulator.
    K-independent."""
    idx = (_ceil_to(2 * m_pairs, TILE) + _ceil_to(2 * n, TILE)) * 4
    srcs = (_ceil_to(2 * n + 1, TILE) + _ceil_to(2 * nu + 1, TILE)) * 4
    return (11 * _pad_rows(n) * LANES * 4 + 2 * idx + srcs
            + region_rows * LANES * 4 * 2)


def _ceil_to(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def launch_grid(mk: MegakernelDelivery) -> int:
    """Blocks of one launch: as many co-resident blocks as the work (the
    larger of the node and pair-slot counts, one thread each) can use."""
    return _grid(mk.pd.n, mk.pd.m_pairs, mk.scratch["max_grid"])


def _grid(n: int, m_pairs: int, max_grid: int) -> int:
    return max(1, min(max_grid, -(-max(n, m_pairs) // THREADS)))


def state_in_shared_memory(n: int, m_pairs: int, device) -> bool:
    """Does a launch over ``n`` nodes and ``m_pairs`` pair slots keep the
    node state in shared memory on ``device``? The launcher's own choice
    (``csrc/megakernel.cu`` ``pick_kernel``) at :func:`launch_grid`'s
    grid, asked of the built library without a launch."""
    import ctypes

    grid = _grid(n, m_pairs, max_grid_size(device))
    lib = build.library("megakernel")
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.gossip_megakernel_state_in_smem(int(n), grid,
                                                 ctypes.addressof(out))
    build.check(lib, rc, "megakernel (shared-memory query)")
    return bool(out.value)


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


def format_phase_split(split: dict) -> str:
    """One line of :func:`megakernel_phase_split`'s result: each phase's
    mean microseconds per round over the blocks, [least; largest]."""
    parts = [f"{name} {v['mean_us']:.2f} [{v['min_mean_us']:.2f}; "
             f"{v['max_us']:.2f}]" for name, v in split["phases"].items()]
    return (", ".join(parts)
            + f"; round {split.get('round_us', 0.0):.2f}; prologue "
            f"{split['prologue_us']:.2f} + barrier "
            f"{split['prologue_barrier_us']:.2f}; launch "
            f"{split['launch_us']:.1f}")


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


def _check_options(predicate: str, rounds_per_kernel: int) -> None:
    if predicate not in ("delta", "global"):
        raise ValueError("predicate must be 'delta' or 'global'")
    if rounds_per_kernel < 1:
        raise ValueError("rounds_per_kernel must be >= 1")


def _launch(ms: MegakernelState, mk: MegakernelDelivery, *, n: int,
            rounds_per_kernel: int, eps: float, streak_target: int,
            predicate: str, tol: float, quorum: Optional[int],
            stamps: Optional[torch.Tensor]) -> None:
    """One cooperative launch of ``csrc/megakernel.cu`` (the probe
    instantiation when ``stamps`` is given); raises if refused."""
    _check_options(predicate, rounds_per_kernel)
    _require_state(ms, mk, n)
    sc = mk.scratch
    pd = mk.pd
    grid = launch_grid(mk)
    lib = build.library("megakernel")
    with torch.cuda.device(ms.s.device):   # the launcher's current device
        rc = lib.gossip_megakernel(
            ms.s.data_ptr(), ms.w.data_ptr(), ms.ratio.data_ptr(),
            ms.streak.data_ptr(), ms.conv.data_ptr(), ms.round.data_ptr(),
            mk.deg_f.data_ptr(), sc["pre_node"].data_ptr(),
            sc["out_rank"].data_ptr(), sc["xp2"].data_ptr(),
            sc["yp2"].data_ptr(), sc["part"].data_ptr(),
            sc["arrived"].data_ptr(), sc["red"].data_ptr(),
            sc["cnt"].data_ptr(), sc["bar"].data_ptr(),
            sc["work"].data_ptr(),
            None if stamps is None else stamps.data_ptr(),
            sc["classes"].data_ptr(), sc["classes"].shape[0],
            sc["split_units"], sc["small_units"], n, pd.nu,
            int(rounds_per_kernel), float(eps), float(tol),
            int(streak_target), int(predicate == "global"),
            -1 if quorum is None else int(quorum), grid,
            build.stream_handle(ms.s.device))
    build.check(lib, rc, "megakernel")


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
    if ms.s.device.type == "cpu":
        _check_options(predicate, rounds_per_kernel)
        return megakernel_rounds_plain(
            ms, mk, n=n, rounds_per_kernel=rounds_per_kernel, eps=eps,
            streak_target=streak_target, predicate=predicate, tol=tol,
            quorum=quorum)
    _launch(ms, mk, n=n, rounds_per_kernel=rounds_per_kernel, eps=eps,
            streak_target=streak_target, predicate=predicate, tol=tol,
            quorum=quorum, stamps=None)
    LAUNCHES["megakernel"] += 1
    return ms


# the probe's phases: (name, first event, last event) of a round's stamps
_PHASES = (("fold", 0, 1), ("fold barrier", 1, 2),
           ("done test + update", 2, 3), ("update barrier", 3, 4),
           ("mean + second pass", 4, 5))


def megakernel_phase_split(ms: MegakernelState, mk: MegakernelDelivery, *,
                           n: int, rounds_per_kernel: int, eps: float,
                           streak_target: int, predicate: str, tol: float,
                           quorum: Optional[int] = None) -> dict:
    """One launch of the kernel's probe instantiation (the same rounds,
    state updated in place like :func:`megakernel_rounds`; not counted in
    ``LAUNCHES``, which counts the main path's kernel), which stamps
    ``clock64`` per block at every phase boundary and barrier. Returns
    microseconds per executed round: each phase's mean and largest time
    over blocks and rounds (a barrier's time is the block's wait, from its
    arrival to its release; the least wait over the blocks, the last
    arrival's, is the barrier's own cost), the round, the prologue, and
    the launch. Cycles convert to time by the launch's ``%globaltimer``
    span. Measurement only: ``chip_smoke.py`` and ``utils/profiling.py``
    call it."""
    import numpy as np

    if ms.s.device.type != "cuda":
        raise ValueError("megakernel_phase_split: the probe runs on the card")
    grid = launch_grid(mk)
    k = int(rounds_per_kernel)
    width = _PROBE_HEAD + _PROBE_EVENTS * k
    stamps = torch.zeros(grid * width, dtype=torch.int64,
                         device=ms.s.device)
    before = int(ms.round)
    _launch(ms, mk, n=n, rounds_per_kernel=k, eps=eps,
            streak_target=streak_target, predicate=predicate, tol=tol,
            quorum=quorum, stamps=stamps)
    st = stamps.view(grid, width).cpu().numpy().astype(np.float64)
    executed = int(ms.round) - before
    ns_per_cycle = float(np.mean((st[:, 1] - st[:, 0])
                                 / (st[:, 3] - st[:, 2])))
    us = ns_per_cycle / 1e3
    ev = st[:, _PROBE_HEAD:].reshape(grid, k, _PROBE_EVENTS)[:, :executed]
    out = dict(grid=grid, executed=executed, ns_per_cycle=ns_per_cycle,
               launch_us=float(np.mean(st[:, 3] - st[:, 2])) * us,
               prologue_us=float(np.mean(st[:, 4] - st[:, 2])) * us,
               prologue_barrier_us=float(np.mean(st[:, 5] - st[:, 4])) * us,
               phases={})
    if executed:
        for name, a, b in _PHASES:
            d = (ev[:, :, b] - ev[:, :, a]) * us
            out["phases"][name] = dict(mean_us=float(d.mean()),
                                       max_us=float(d.max()),
                                       min_mean_us=float(d.min(0).mean()))
        out["round_us"] = float(np.mean(ev[:, :, 5] - ev[:, :, 0])) * us
    return out


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
