"""Push-sum: the single-target round, the round tail and the supervisor
predicate (port of ``gossipprotocol_tpu/protocols/pushsum.py``).

Only the intended semantics run here (the reference's walk is
``protocols/walk.py``): every round every node halves its ``(s, w)``,
keeps one half and sends the other to one random neighbour — by scatter
(``index_add_``), or by the gather-inverted ``delivery='invert'``
(:func:`received_by_inversion`), where each receiver recomputes its
neighbours' draws. Under a loss window (``utils/faults.py``) a dropped
send keeps its half at the sender; under a Poisson clock
(``async_/clock.py``) a node whose clock did not tick keeps its whole
pair. ``s`` may be ``[n]`` or an ``[n, d]`` vector payload. The
convergence predicate is either the local delta streak ``|Δ(s/w)| <=
eps`` for ``streak_target`` rounds (sticky) or the global ``|s/w - mean|
<= tol`` streak (non-sticky); under vector payloads every column must be
within tolerance.

Sweep lanes (``sweep/engine.py``): a state with a leading ``[B]``
dimension (``round`` ``[B]``), ``[B, 2]`` round keys and, for swept
tolerances, ``[B]`` tensors ``eps`` / ``tol`` run B independent rounds in
one pass; the messages scatter into a flattened ``[B·n]`` target
(:func:`~gossipprotocol_tpu_torch.protocols.sampling.index_add_rows`) and
the global mean is taken per lane.
"""

from __future__ import annotations

import torch

from gossipprotocol_tpu_torch.protocols.sampling import (
    fold_in, index_add_rows, lane_param, node_sum, recomputed_hits,
    round_drops, sample_neighbors,
)
from gossipprotocol_tpu_torch.protocols.state import PushSumState


def sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over the node axis."""
    return torch.sum(x, dim=0)


# XLA's CPU tree reduction: windows of this many rows, summed in order
TREE_WINDOW = 32


def tree_sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over the node axis in the order the JAX package's ``sum0``
    takes on the CPU, for the telemetry's mass sums and trace rows: XLA
    rewrites a long reduction into windows of :data:`TREE_WINDOW` rows
    (zero-padded, the padding split evenly with the smaller half in
    front), each summed in order from 0, level after level until at most
    32 partial sums remain, which are summed in order from 0. On the card
    it is ``torch.sum`` (these sums are read, never fed back into a
    round, and a replay of the order would cost a launch an add)."""
    if x.device.type != "cpu":
        return torch.sum(x, dim=0)
    rest = tuple(x.shape[1:])
    while x.shape[0] > TREE_WINDOW:
        n = x.shape[0]
        m = -(-n // TREE_WINDOW)
        pad = m * TREE_WINDOW - n
        left = pad // 2
        x = torch.cat([x.new_zeros((left,) + rest), x,
                       x.new_zeros((pad - left,) + rest)]).view(
                           (m, TREE_WINDOW) + rest)
        acc = x.new_zeros((m,) + rest)
        for j in range(TREE_WINDOW):
            acc = acc + x[:, j]
        x = acc
    acc = x.new_zeros(rest)
    for j in range(x.shape[0]):
        acc = acc + x[j]
    return acc


def rowmask(mask: torch.Tensor, like: torch.Tensor,
            lanes: bool = False) -> torch.Tensor:
    """Broadcast a per-node ``[rows]`` mask against ``like`` (``[rows]``
    or ``[rows, d]``; with ``lanes``, ``[B, rows]`` or ``[B, rows, d]``
    against a ``[rows]`` or ``[B, rows]`` mask)."""
    return mask if like.dim() == 1 + lanes else mask[..., None]


def finish_pushsum_round(state: PushSumState, s_new: torch.Tensor,
                         w_new: torch.Tensor, *, eps: float,
                         streak_target: int, predicate: str, tol: float,
                         all_alive: bool, all_sum=sum0) -> PushSumState:
    """Shared round tail: estimate refresh + convergence predicate.

    The ``1e-30`` floor guards dead rows and alive rows whose weight
    underflowed (0/0 would be NaN). Divisions take tensor divisors (see
    :func:`~gossipprotocol_tpu_torch.protocols.state.pushsum_init`).
    ``all_sum`` sums over the node axis for the global mean (the sharded
    engine passes its shard-ordered sum). Sweep lanes take the mean per
    lane, and ``eps`` / ``tol`` may be ``[B]`` tensors.
    """
    lanes = state.round.dim() == 1
    floor = torch.clamp(w_new, min=1e-30)
    ratio_new = s_new / rowmask(floor, s_new, lanes)
    if predicate == "global":
        s_healthy = s_new if all_alive else torch.where(
            rowmask(state.alive, s_new, lanes), s_new,
            torch.zeros_like(s_new))
        w_healthy = w_new if all_alive else torch.where(
            state.alive, w_new, torch.zeros_like(w_new))
        if lanes:
            den = torch.clamp(torch.sum(w_healthy, dim=1, keepdim=True),
                              min=1e-30)
            mean = torch.sum(s_healthy, dim=1, keepdim=True) / rowmask(
                den, s_new, lanes)
        else:
            mean = all_sum(s_healthy) / torch.clamp(all_sum(w_healthy),
                                                    min=1e-30)
        near = torch.abs(ratio_new - mean) <= lane_param(tol, ratio_new)
        if near.dim() == 2 + lanes:
            near = torch.all(near, dim=-1)
        streak = torch.where(near, state.streak + 1,
                             torch.zeros_like(state.streak))
        # non-sticky: a node that drifts back out of tol un-converges
        converged = streak >= streak_target
    elif predicate == "delta":
        near = torch.abs(ratio_new - state.ratio) <= lane_param(eps,
                                                                 ratio_new)
        if near.dim() == 2 + lanes:
            near = torch.all(near, dim=-1)
        streak = torch.where(near, state.streak + 1,
                             torch.zeros_like(state.streak))
        # sticky, like the reference's one-shot Alert
        converged = state.converged | (streak >= streak_target)
    else:
        raise ValueError("predicate must be 'delta' or 'global'")
    return state._replace(s=s_new, w=w_new, ratio=ratio_new, streak=streak,
                          converged=converged, round=state.round + 1)


def pushsum_round_core(state: PushSumState, nbrs, key: torch.Tensor, *,
                       n: int, eps: float = 1e-10, streak_target: int = 3,
                       predicate: str = "delta", tol: float = 1e-4,
                       all_alive: bool = False,
                       targets_alive: bool = False,
                       loss_windows: tuple = (), clock: tuple = (),
                       delivery: str = "scatter") -> PushSumState:
    """One fanout-one round under the round key ``key``, delivered by
    scatter (``index_add_``, the JAX package's ``segment_sum``) or, with
    ``delivery='invert'``, by :func:`received_by_inversion`.

    A send lands when its sender has a neighbour and, unless
    ``all_alive``, the sender is alive and (unless ``targets_alive``, the
    dead set being whole components) so is its target, its Poisson clock
    ticked (``clock``, ``async_/clock.py``), and no loss window drops it
    (``loss_windows``, the static ``(start, stop, prob)`` table); an
    undelivered half stays with the sender, so mass is conserved.

    Summation order: the JAX package's text is ``s - s_sent + in_s``
    with ``in_s = segment_sum(s_sent)``, but XLA on the CPU rewrites the
    add of a scatter into zeros as a scatter onto the addend: each
    message is added straight onto ``s - s_sent``, in ascending sender
    order. The port does the same (``index_add_`` onto ``s - s_sent``,
    which on the CPU adds in ascending index order), so the round is
    bitwise the JAX package's there (ROADMAP.md Queue 3). On the card the
    float adds are atomics: equal up to accumulation order.

    The inverted delivery is legal only where every drawn send lands: a
    dense table, a component-closed dead set (``targets_alive``), the
    synchronous clock, no loss window and a scalar payload (the engine's
    config checks pin this); its sums are taken by receivers, in slot
    order, bitwise the JAX package's. The JAX package's sweep lanes take
    the same fused order on the CPU, a swept tolerance's too (its lane
    body scatters with ``segment_sum``, which XLA rewrites alike), so
    sweep lanes run this body as it is."""
    lanes = state.round.dim() == 1
    if delivery == "invert":
        assert not (clock or loss_windows) and state.s.dim() == 1 + lanes, (
            "delivery='invert' needs the synchronous clock, no loss and a "
            "scalar payload")
        valid = nbrs.degree > 0
        deliver = valid if all_alive else valid & state.alive
        zero = torch.zeros_like(state.s)
        s_sent = torch.where(deliver, state.s * 0.5, zero)
        w_sent = torch.where(deliver, state.w * 0.5, zero)
        in_s, in_w = received_by_inversion(nbrs, key, state.s, state.w)
        if not all_alive:
            # dead rows neighbour only dead rows (component closure), but
            # their own gather output is garbage: pin them unchanged
            in_s = torch.where(state.alive, in_s, zero)
            in_w = torch.where(state.alive, in_w, zero)
        return finish_pushsum_round(
            state, state.s - s_sent + in_s, state.w - w_sent + in_w,
            eps=eps, streak_target=streak_target, predicate=predicate,
            tol=tol, all_alive=all_alive)
    targets, valid = sample_neighbors(nbrs, n, key)
    if all_alive:
        deliver = valid
    elif targets_alive:
        deliver = valid & state.alive
    elif lanes:
        deliver = valid & state.alive & torch.gather(state.alive, 1,
                                                     targets.long())
    else:
        deliver = valid & state.alive & state.alive[targets]
    if clock:
        from gossipprotocol_tpu_torch.async_.clock import activation_mask

        deliver = deliver & activation_mask(
            key, clock, torch.arange(n, dtype=torch.int64,
                                     device=key.device))
    if loss_windows:
        deliver = deliver & ~round_drops(key, state.round, loss_windows, n)
    s_sent = torch.where(rowmask(deliver, state.s, lanes), state.s * 0.5,
                         torch.zeros_like(state.s))
    w_sent = torch.where(deliver, state.w * 0.5, torch.zeros_like(state.w))
    s_new = index_add_rows(state.s - s_sent, targets, s_sent)
    w_new = index_add_rows(state.w - w_sent, targets, w_sent)
    return finish_pushsum_round(
        state, s_new, w_new, eps=eps, streak_target=streak_target,
        predicate=predicate, tol=tol, all_alive=all_alive)


def received_by_inversion(nbrs, key: torch.Tensor, s: torch.Tensor,
                          w: torch.Tensor):
    """Receiver-side ``(in_s, in_w)``: no scatter, one static-index
    gather over the dense table (the JAX package's
    ``received_by_inversion``). Receiver ``i`` recomputes each
    neighbour's draw, so the mass landing on it is

        in_s_i = Σ_k [slot(table[i,k]) == rev[i,k]] · s[table[i,k]] / 2

    (``w`` alike). The slots are summed left to right from zero, then
    halved, as XLA's reduction over the slot axis of ``[rows, max_deg, 2]``
    adds them; each add is elementwise, so the card sums in the same
    order. Exact (the scatter's multiset of messages) only where every
    sender with a valid draw delivers; ``nbrs`` is an
    :class:`~gossipprotocol_tpu_torch.protocols.sampling.InvertedDense`."""
    hit = recomputed_hits(nbrs, key)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    acc_s = torch.zeros_like(s)
    acc_w = torch.zeros_like(w)
    for k in range(nbrs.table.shape[1]):
        j = nbrs.table[:, k].long()
        acc_s = acc_s + torch.where(hit[..., k], s[..., j], zero)
        acc_w = acc_w + torch.where(hit[..., k], w[..., j], zero)
    return acc_s * 0.5, acc_w * 0.5


def pushsum_round(state: PushSumState, nbrs, base_key: torch.Tensor, *,
                  n: int, **kw) -> PushSumState:
    """One round keyed by ``fold_in(base_key, state.round)`` (the JAX
    package's single-card ``pushsum_round``, scatter delivery)."""
    return pushsum_round_core(state, nbrs, fold_in(base_key, state.round),
                              n=n, **kw)


def pushsum_message_counts(old: PushSumState, nbrs, key: torch.Tensor, *,
                           n: int, all_alive: bool, targets_alive: bool,
                           delivery: str, loss_windows: tuple,
                           clock: tuple = ()) -> torch.Tensor:
    """Telemetry recount of one fanout-one round under its round key
    ``key``: int32 ``[sent, delivered, dropped]`` (``obs/counters.py``
    semantics; the JAX package's ``pushsum_message_counts``).

    Re-derives the round's draws through the same
    :func:`~gossipprotocol_tpu_torch.protocols.sampling.sample_neighbors`
    and drop-mask calls :func:`pushsum_round_core` made — read-only.
    ``sent`` counts live senders with a valid draw (whose clock ticked);
    a half kept because the target was dead is sent-not-delivered, one
    lost to a loss window is ``dropped``. Sweep lanes give ``[B, 3]``,
    one row a lane."""
    lanes = old.round.dim() == 1
    if delivery == "invert":
        # invert is legal only while every send lands: sent == delivered
        valid = nbrs.degree > 0
        deliver = valid if all_alive else valid & old.alive
        cnt = node_sum(deliver.expand(old.alive.shape).to(torch.int32),
                       lanes)
        return torch.stack([cnt, cnt, torch.zeros_like(cnt)], dim=-1).to(
            torch.int32)
    targets, valid = sample_neighbors(nbrs, n, key)
    senders = valid if all_alive else valid & old.alive
    if clock:
        from gossipprotocol_tpu_torch.async_.clock import activation_mask

        senders = senders & activation_mask(
            key, clock, torch.arange(old.w.shape[-1], dtype=torch.int64,
                                     device=key.device))
    senders = senders.expand(old.alive.shape)
    sent = node_sum(senders.to(torch.int32), lanes)
    if all_alive or targets_alive:
        deliver = senders
    elif lanes:
        deliver = senders & torch.gather(old.alive, 1, targets.long())
    else:
        deliver = senders & old.alive[targets.long()]
    if loss_windows:
        drop = round_drops(key, old.round, loss_windows, n)
        dropped = node_sum((deliver & drop).to(torch.int32), lanes)
        deliver = deliver & ~drop
    else:
        dropped = torch.zeros_like(sent)
    delivered = node_sum(deliver.to(torch.int32), lanes)
    return torch.stack([sent, delivered, dropped], dim=-1).to(torch.int32)


def pushsum_done(state: PushSumState) -> torch.Tensor:
    """Supervisor predicate: every healthy node's estimate has stabilized
    (a bool scalar tensor, left on the device)."""
    return torch.all(state.converged | ~state.alive)


def mass(state: PushSumState):
    """(Σs, Σw) — the conservation invariant."""
    return state.s.sum(), state.w.sum()


def pushsum_trace_row(state, *, all_sum=tree_sum0, all_max=torch.max
                      ) -> torch.Tensor:
    """Observatory trace row for any push-sum-family state (plain, accel,
    walk, SGP — everything carrying ``s/w/ratio``; the JAX package's
    ``pushsum_trace_row``, column contract in
    :mod:`gossipprotocol_tpu_torch.obs.trace`): the consensus residual
    max over alive rows of ``|s/w − mean|`` against the alive-mass mean,
    the converged fraction, Σs (collapsed over payload columns) and Σw
    over every row (the walk's in-flight token included), and the train
    loss (NaN without one). Reads the post-round state only. ``all_sum``
    sums over the node axis (:func:`tree_sum0`, or the sharded engine's
    shard-ordered sum), ``all_max`` is the full max."""
    dt = torch.float32
    alive = state.alive
    live = rowmask(alive, state.ratio)
    zero_w = torch.zeros((), dtype=state.w.dtype, device=alive.device)
    zero_s = torch.zeros((), dtype=state.s.dtype, device=alive.device)
    sw = all_sum(torch.where(alive, state.w, zero_w))
    ss = all_sum(torch.where(live, state.s, zero_s))
    mean = ss / torch.clamp(sw, min=1e-30)
    residual = all_max(torch.where(live, torch.abs(state.ratio - mean),
                                   torch.zeros_like(state.ratio)))
    n_alive = all_sum(alive.to(dt))
    frac = all_sum((state.converged & alive).to(dt)) / torch.clamp(
        n_alive, min=1)
    ms = all_sum(state.s)
    mw = all_sum(state.w)
    if hasattr(state, "msg_s"):
        ms = ms + state.msg_s
        mw = mw + state.msg_w
    if ms.dim():
        ms = tree_sum0(ms)  # collapse [d] payload mass to one scalar
    loss = (state.loss if hasattr(state, "loss")
            else torch.full((), float("nan"), dtype=dt,
                            device=alive.device))
    return torch.stack([residual.to(dt), frac.to(dt), ms.to(dt),
                        mw.to(dt), loss.to(dt)])
