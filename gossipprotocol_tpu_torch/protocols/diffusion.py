"""Fanout-all diffusion push-sum (port of
``gossipprotocol_tpu/protocols/diffusion.py``): over the fused gather and
routed deliveries (:func:`pushsum_diffusion_round_routed`) and over the
edge list by scatter (``--delivery scatter``,
:func:`pushsum_diffusion_round`).

Every node keeps ``1/(deg+1)`` of its ``(s, w)`` and ships one share per
edge. ``s`` may be ``[n]`` or an ``[n, d]`` vector payload (the fused
and routed deliveries carry it through ``matvec_payload``). Under a
Poisson clock (``async_/clock.py``) a node whose clock did not tick ships
nothing; the scatter round also takes per-edge loss windows and
``edge_chunks`` sequential slices of the edge list.

Bitwise parity with the JAX package: the expressions keep the JAX order
of operations, ``s - share*deg`` rounds once as the JAX package's XLA
build computes it (:func:`_keep`), and every division is an IEEE division
by a tensor (see ``protocols/state.py``). On the CPU the scatter round
adds each message onto ``s - share*deg`` in edge order, as XLA's scatter
fused into the add does; on the card the scatter's float adds are
atomics, so card and CPU agree up to accumulation order.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gossipprotocol_tpu_torch.ops.build import resolve_device
from gossipprotocol_tpu_torch.protocols.pushsum import (
    finish_pushsum_round, pushsum_trace_row, rowmask, sum0, tree_sum0,
)
from gossipprotocol_tpu_torch.protocols.sampling import (
    LOSS_FOLD, drop_mask, fold_in, loss_probability,
)
from gossipprotocol_tpu_torch.protocols.state import PushSumState
from gossipprotocol_tpu_torch.topology.base import Topology


def _keep(x: torch.Tensor, share: torch.Tensor,
          sent: torch.Tensor) -> torch.Tensor:
    """``x - share * sent`` with ONE rounding: what the JAX package's
    ``s - share*deg`` compiles to under XLA on the CPU, which contracts
    the product and the difference into a fused multiply-add (the
    source text alone would round twice; see ROADMAP.md Queue 3). PyTorch
    has no fused multiply-add that rounds alike on CPU and CUDA, so the
    product and the difference are taken in float64, where both are exact
    (``share`` has 24 significant bits, ``sent`` is a small integer and
    ``share * sent`` lies within a factor ``deg + 1`` of ``x``: at most
    ~25 + log2(deg + 1) bits, exact below degree 2**28), then rounded to
    float32 once. ``sent`` is per node; a vector payload broadcasts it
    over its columns. A float64 state (``--x64``, the scatter paths)
    rounds twice: no wider type holds its product."""
    sent = rowmask(sent, x)
    if x.dtype == torch.float64:
        return x - share * sent
    return (x.double() - share.double() * sent.double()).float()


def _active_rows(key, clock: tuple, rows: int, device):
    """The rows whose Poisson clock ticked this round, or None under the
    synchronous clock."""
    if not clock:
        return None
    from gossipprotocol_tpu_torch.async_.clock import activation_mask

    return activation_mask(key, clock, torch.arange(
        rows, dtype=torch.int64, device=device))


def _zero_where_not(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(rowmask(mask, x), x, torch.zeros_like(x))


def pushsum_diffusion_round_routed(
    state: PushSumState,
    delivery,  # ops.pallasdelivery.PallasDelivery or ops.delivery.RoutedDelivery
    key: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-10,
    streak_target: int = 3,
    predicate: str = "delta",
    tol: float = 1e-4,
    all_alive: bool = False,
    targets_alive: bool = False,
    clock: tuple = (),
) -> PushSumState:
    """One fanout-all round through ``delivery.matvec``.

    Fast paths (``all_alive`` — no node is dead — and ``targets_alive`` —
    the dead set is whole components, so an alive node's neighbors are
    alive) ship every share and keep ``sent = share · deg``. Under any
    other dead set one extra ``matvec(alive, alive)`` gives each node's
    count of alive neighbors (``live_deg``, exact small-integer floats);
    received sums are masked to alive rows and ``sent = share ·
    live_deg``. A vector payload goes through
    :func:`~gossipprotocol_tpu_torch.ops.delivery.matvec_payload`
    (``ceil((d + 1) / 2)`` matvec calls). Under a Poisson ``clock`` the
    round key ``key`` draws the active senders and the idle ones' shares
    are zeroed before delivery (``mask_sender_rows``).
    """
    from gossipprotocol_tpu_torch.ops.delivery import (
        mask_sender_rows, matvec_payload,
    )

    deg = delivery.degree.to(state.w.dtype)
    inv = torch.ones_like(deg) / (deg + 1)
    share_s = state.s * rowmask(inv, state.s)
    share_w = state.w * inv
    if not all_alive:
        share_s = _zero_where_not(state.alive, share_s)
        share_w = _zero_where_not(state.alive, share_w)
    if clock:
        share_s, share_w = mask_sender_rows(
            share_s, share_w, key, clock, torch.arange(
                state.w.shape[0], dtype=torch.int64, device=key.device))
    in_s, in_w = matvec_payload(delivery.matvec, share_s, share_w)
    if all_alive or targets_alive:
        sent = deg
    else:
        alive_f = state.alive.to(state.w.dtype)
        live_deg, _ = delivery.matvec(alive_f, alive_f)
        # a dead receiver's in-sum is garbage only to itself: discard it
        in_s = _zero_where_not(state.alive, in_s)
        in_w = _zero_where_not(state.alive, in_w)
        sent = live_deg
    return finish_pushsum_round(
        state, _keep(state.s, share_s, sent) + in_s,
        _keep(state.w, share_w, sent) + in_w,
        eps=eps, streak_target=streak_target, predicate=predicate, tol=tol,
        all_alive=all_alive,
    )


# ---- the scatter delivery over the edge list ------------------------------

class DiffusionEdges(NamedTuple):
    """The edge list of the scatter round: the CSR ``(row, col)`` pairs,
    sorted by source, and the per-node degree."""

    src: torch.Tensor     # int64 [E]  edge source
    dst: torch.Tensor     # int64 [E]  edge target
    degree: torch.Tensor  # int32 [n]


def diffusion_edges(topo: Topology, device="cuda") -> Optional[DiffusionEdges]:
    """The edge list on ``device``; None for the implicit complete graph,
    which needs none."""
    if topo.implicit_full:
        return None
    dev = resolve_device(device)
    n = topo.num_nodes
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(topo.offsets))
    return DiffusionEdges(
        src=torch.from_numpy(src).to(dev),
        dst=torch.from_numpy(np.asarray(topo.indices, np.int64)).to(dev),
        degree=torch.from_numpy(np.asarray(topo.degree, np.int32)).to(dev))


def diffusion_mix(
    state,
    nbrs: Optional[DiffusionEdges],
    key: Optional[torch.Tensor],
    *,
    n: int,
    all_alive: bool = False,
    targets_alive: bool = False,
    edge_chunks: int = 1,
    loss_windows: tuple = (),
    clock: tuple = (),
):
    """The lazy-random-walk mixing step alone: ``(s_new, w_new)`` with no
    predicate applied (the accelerated rounds combine it with the
    previous iterate before the predicate tail).

    ``key`` is the round key (``fold_in(base_key, round)``); it draws the
    per-edge drops of ``loss_windows`` (keyed on the global (src, dst)
    pair) and the active senders of a Poisson ``clock`` (an idle node's
    shares are zeroed: delivery is linear in the shares, so every
    accounting term stays exact and mass is conserved). The delivered
    count makes ``sent = share · cnt`` exact wherever an edge can fail
    to deliver — a dead target or a dropped message.

    ``edge_chunks`` delivers in that many sequential slices of the edge
    list: the per-edge intermediates shrink that many times. Each slice is
    scattered into an in-vector of its own, the partial in-vectors are
    added in slice order, and the sum is added to ``s - share·deg``, so
    the sums agree with the unchunked round up to accumulation order (on
    the CPU bitwise the JAX round's at two slices; at more, XLA's order is
    not replayed). With one slice each message is added straight onto
    ``s - share·deg``. On the CPU the messages are added in edge order."""
    dt = state.w.dtype
    rows = state.w.shape[0]
    dev = state.w.device
    active = _active_rows(key, clock, rows, dev)
    if loss_windows:
        assert nbrs is not None, (
            "per-edge loss needs an explicit edge list; the implicit "
            "complete graph has none (RunConfig validation rejects this)")
        key_loss = fold_in(key, LOSS_FOLD)
        p_loss = loss_probability(state.round, loss_windows)

    if nbrs is None:
        # implicit complete graph: in_i = Σ share − share_i; mixes in one
        # round (s_new_i = Σ s_j / A for every i)
        if all_alive:
            a_count = torch.full((), n, dtype=dt, device=dev)
            s_m, w_m = state.s, state.w
        else:
            a_count = torch.clamp(sum0(state.alive.to(dt)), min=1)
            s_m = _zero_where_not(state.alive, state.s)
            w_m = _zero_where_not(state.alive, state.w)
        share_s = s_m / a_count
        share_w = w_m / a_count
        if active is not None:
            # an idle node ships nothing; its own zero share subtracts out
            share_s = _zero_where_not(active, share_s)
            share_w = _zero_where_not(active, share_w)
        in_s = sum0(share_s) - share_s
        in_w = sum0(share_w) - share_w
        sent_s = share_s * (a_count - 1)
        sent_w = share_w * (a_count - 1)
        if not all_alive:
            in_s = _zero_where_not(state.alive, in_s)
            in_w = _zero_where_not(state.alive, in_w)
        return state.s - sent_s + in_s, state.w - sent_w + in_w

    deg = nbrs.degree.to(dt)
    inv = torch.ones_like(deg) / (deg + 1)
    share_s = state.s * rowmask(inv, state.s)
    share_w = state.w * inv
    if not all_alive:
        share_s = _zero_where_not(state.alive, share_s)
        share_w = _zero_where_not(state.alive, share_w)
    if active is not None:
        share_s = _zero_where_not(active, share_s)
        share_w = _zero_where_not(active, share_w)

    fast_alive = all_alive or targets_alive
    needs_cnt = bool(loss_windows) or not fast_alive
    e_total = nbrs.src.shape[0]
    bounds = [e_total * k // edge_chunks for k in range(edge_chunks + 1)]
    cnt = torch.zeros(rows, dtype=dt, device=dev) if needs_cnt else None
    parts = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi == lo:
            continue
        src_k, dst_k = nbrs.src[lo:hi], nbrs.dst[lo:hi]
        es, ew = share_s[src_k], share_w[src_k]
        deliver = None if fast_alive else state.alive[dst_k]
        if loss_windows:
            keep = ~drop_mask(key_loss, p_loss, src_k, dst_k)
            deliver = keep if deliver is None else deliver & keep
        if needs_cnt:
            ones = (torch.ones(src_k.shape, dtype=dt, device=dev)
                    if deliver is None else deliver.to(dt))
            cnt = cnt.index_add(0, src_k, ones)
        if deliver is not None:
            es, ew = _zero_where_not(deliver, es), _zero_where_not(deliver, ew)
        parts.append((dst_k, es, ew))
    sent = cnt if needs_cnt else deg
    s_keep = _keep(state.s, share_s, sent)
    w_keep = _keep(state.w, share_w, sent)
    if len(parts) == 1:
        dst_k, es, ew = parts[0]
        return (s_keep.index_add_(0, dst_k, es),
                w_keep.index_add_(0, dst_k, ew))
    in_s = torch.zeros_like(state.s)
    in_w = torch.zeros_like(state.w)
    for dst_k, es, ew in parts:
        in_s = in_s + torch.zeros_like(state.s).index_add_(0, dst_k, es)
        in_w = in_w + torch.zeros_like(state.w).index_add_(0, dst_k, ew)
    return s_keep + in_s, w_keep + in_w


def pushsum_diffusion_round(
    state: PushSumState,
    nbrs: Optional[DiffusionEdges],
    key: Optional[torch.Tensor] = None,
    *,
    n: int,
    eps: float = 1e-10,
    streak_target: int = 3,
    predicate: str = "delta",
    tol: float = 1e-4,
    all_alive: bool = False,
    targets_alive: bool = False,
    edge_chunks: int = 1,
    loss_windows: tuple = (),
    clock: tuple = (),
) -> PushSumState:
    """One fanout-all round by scatter over the edge list (the JAX
    package's ``pushsum_diffusion_round``): :func:`diffusion_mix`, then
    the shared predicate tail."""
    s_new, w_new = diffusion_mix(
        state, nbrs, key, n=n, all_alive=all_alive,
        targets_alive=targets_alive, edge_chunks=edge_chunks,
        loss_windows=loss_windows, clock=clock)
    return finish_pushsum_round(
        state, s_new, w_new, eps=eps, streak_target=streak_target,
        predicate=predicate, tol=tol, all_alive=all_alive)


# ---- telemetry: message counters and the trace row ------------------------

def diffusion_message_counts(
    old: PushSumState,
    nbrs: Optional[DiffusionEdges],
    key: Optional[torch.Tensor],
    *,
    n: int,
    all_alive: bool,
    targets_alive: bool,
    loss_windows: tuple,
    clock: tuple = (),
) -> torch.Tensor:
    """Telemetry recount of one fanout-all scatter round: int32 ``[sent,
    delivered, dropped]`` (``obs/counters.py`` semantics; the JAX
    package's ``diffusion_message_counts``).

    Walks the same edge list with the same per-edge masks (target
    liveness, the (src, dst)-keyed drop mask, the senders' clock) the
    round applied — read-only, one extra pass over E per round while
    telemetry is on. The implicit complete graph has no edges: every
    alive node attempts ``a − 1`` sends and all land, counted in float32
    and saturated to int32."""
    from gossipprotocol_tpu_torch.obs.counters import clip_count

    rows = old.w.shape[0]
    dev = old.w.device
    active = _active_rows(key, clock, rows, dev)
    if nbrs is None:
        send_rows = None if all_alive else old.alive
        if active is not None:
            send_rows = active if send_rows is None else send_rows & active
        a = (torch.full((), float(n), dtype=torch.float32, device=dev)
             if all_alive else sum0(old.alive.to(torch.float32)))
        local = (torch.full((), float(rows), dtype=torch.float32,
                            device=dev) if send_rows is None
                 else torch.sum(send_rows.to(torch.float32)))
        cnt = clip_count(local * torch.clamp(a - 1.0, min=0.0))
        return torch.stack([cnt, cnt, torch.zeros_like(cnt)])

    mask = None if all_alive else old.alive[nbrs.src]
    if active is not None:
        src_active = active[nbrs.src]
        mask = src_active if mask is None else mask & src_active
    sent = (torch.full((), nbrs.src.shape[0], dtype=torch.int32, device=dev)
            if mask is None else torch.sum(mask.to(torch.int32)))
    deliver = mask
    if not (all_alive or targets_alive):
        tgt_alive = old.alive[nbrs.dst]
        deliver = tgt_alive if deliver is None else deliver & tgt_alive
    if loss_windows:
        keep = ~drop_mask(fold_in(key, LOSS_FOLD),
                          loss_probability(old.round, loss_windows),
                          nbrs.src, nbrs.dst)
        if deliver is None:
            dropped = torch.sum((~keep).to(torch.int32))
            deliver = keep
        else:
            dropped = torch.sum((deliver & ~keep).to(torch.int32))
            deliver = deliver & keep
    else:
        dropped = torch.zeros((), dtype=torch.int32, device=dev)
    delivered = (sent if deliver is None
                 else torch.sum(deliver.to(torch.int32)))
    return torch.stack([x.to(torch.int32) for x in (sent, delivered,
                                                   dropped)])


def routed_message_counts(
    old: PushSumState,
    delivery,  # ops.pallasdelivery.PallasDelivery or ops.delivery.RoutedDelivery
    *,
    n: int,
    all_alive: bool,
    targets_alive: bool,
    key: Optional[torch.Tensor] = None,
    clock: tuple = (),
) -> torch.Tensor:
    """Telemetry recount of one fused-gather or routed round (the JAX
    package's ``routed_message_counts``).

    The deliveries ship one share per directed edge of a live sender and
    take no loss windows, so ``dropped`` is 0 and ``sent`` is Σ degree
    over live rows (whose clock ticked). ``delivered`` equals ``sent`` on
    the fast paths; under an arbitrary dead set the round recovers each
    node's live-neighbour count with one extra ``matvec(alive, alive)``,
    and the recount repeats it through the same delivery (its kernels
    launch a second time in the round while faults are in force and
    telemetry is on)."""
    from gossipprotocol_tpu_torch.obs.counters import clip_count

    dt = old.s.dtype
    rows = old.s.shape[0]
    deg = delivery.degree.to(dt)
    active = None
    if clock:
        from gossipprotocol_tpu_torch.async_.clock import activation_mask

        active = activation_mask(key, clock, torch.arange(
            rows, dtype=torch.int64, device=key.device))
        deg = torch.where(active, deg, torch.zeros_like(deg))
    zero = torch.zeros((), dtype=torch.int32, device=deg.device)
    if all_alive:
        sent = clip_count(torch.sum(deg))
        return torch.stack([sent, sent, zero])
    sent = clip_count(torch.sum(torch.where(old.alive, deg,
                                            torch.zeros_like(deg))))
    if targets_alive:
        return torch.stack([sent, sent, zero])
    alive_f = old.alive.to(dt)
    live_deg, _ = delivery.matvec(alive_f, alive_f)
    if active is not None:
        live_deg = torch.where(active, live_deg, torch.zeros_like(live_deg))
    delivered = clip_count(torch.sum(torch.where(
        old.alive, live_deg, torch.zeros_like(live_deg))))
    return torch.stack([sent, delivered, zero])


def diffusion_trace_row(state, *, all_sum=tree_sum0, all_max=torch.max):
    """Observatory trace row for fanout-all diffusion (and the accelerated
    two-buffer variants): diffusion shares ``PushSumState``'s (s, w,
    ratio) fields, so the row IS push-sum's (the JAX package's
    ``diffusion_trace_row``)."""
    return pushsum_trace_row(state, all_sum=all_sum, all_max=all_max)
