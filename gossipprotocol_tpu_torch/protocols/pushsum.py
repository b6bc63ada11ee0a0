"""Push-sum: the single-target scatter round, the round tail and the
supervisor predicate (port of the scalar pieces of
``gossipprotocol_tpu/protocols/pushsum.py``).

Only the intended semantics are ported (the gather-inverted
``delivery='invert'`` and clocks are not yet): every round every node
halves its ``(s, w)``, keeps one half and scatter-adds the other to one
random neighbour; under a loss window (``utils/faults.py``) a dropped
send keeps its half at the sender. The convergence
predicate is either the local delta streak ``|Δ(s/w)| <= eps`` for
``streak_target`` rounds (sticky) or the global ``|s/w - mean| <= tol``
streak (non-sticky).
"""

from __future__ import annotations

import torch

from gossipprotocol_tpu_torch.protocols.sampling import (
    fold_in, round_drops, sample_neighbors,
)
from gossipprotocol_tpu_torch.protocols.state import PushSumState


def sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over the node axis."""
    return torch.sum(x, dim=0)


def rowmask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-node ``[rows]`` mask against ``like`` (``[rows]``
    or ``[rows, d]``)."""
    return mask if like.dim() == 1 else mask[:, None]


def finish_pushsum_round(state: PushSumState, s_new: torch.Tensor,
                         w_new: torch.Tensor, *, eps: float,
                         streak_target: int, predicate: str, tol: float,
                         all_alive: bool, all_sum=sum0) -> PushSumState:
    """Shared round tail: estimate refresh + convergence predicate.

    The ``1e-30`` floor guards dead rows and alive rows whose weight
    underflowed (0/0 would be NaN). Divisions take tensor divisors (see
    :func:`~gossipprotocol_tpu_torch.protocols.state.pushsum_init`).
    ``all_sum`` sums over the node axis for the global mean (the sharded
    engine passes its shard-ordered sum).
    """
    floor = torch.clamp(w_new, min=1e-30)
    ratio_new = s_new / rowmask(floor, s_new)
    if predicate == "global":
        s_healthy = s_new if all_alive else torch.where(
            rowmask(state.alive, s_new), s_new, torch.zeros_like(s_new))
        w_healthy = w_new if all_alive else torch.where(
            state.alive, w_new, torch.zeros_like(w_new))
        mean = all_sum(s_healthy) / torch.clamp(all_sum(w_healthy),
                                                min=1e-30)
        near = torch.abs(ratio_new - mean) <= tol
        streak = torch.where(near, state.streak + 1,
                             torch.zeros_like(state.streak))
        # non-sticky: a node that drifts back out of tol un-converges
        converged = streak >= streak_target
    elif predicate == "delta":
        near = torch.abs(ratio_new - state.ratio) <= eps
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
                       loss_windows: tuple = ()) -> PushSumState:
    """One fanout-one round under the round key ``key``, delivered by
    scatter (``index_add_``, the JAX package's ``segment_sum``).

    A send lands when its sender has a neighbour and, unless
    ``all_alive``, the sender is alive and (unless ``targets_alive``, the
    dead set being whole components) so is its target, and no loss
    window drops it (``loss_windows``, the static ``(start, stop, prob)``
    table); an undelivered half stays with the sender, so mass is
    conserved.

    Summation order: the JAX package's text is ``s - s_sent + in_s``
    with ``in_s = segment_sum(s_sent)``, but XLA on the CPU rewrites the
    add of a scatter into zeros as a scatter onto the addend: each
    message is added straight onto ``s - s_sent``, in ascending sender
    order. The port does the same (``index_add_`` onto ``s - s_sent``,
    which on the CPU adds in ascending index order), so the round is
    bitwise the JAX package's there (ROADMAP.md Queue 3). On the card the
    float adds are atomics: equal up to accumulation order."""
    targets, valid = sample_neighbors(nbrs, n, key)
    if all_alive:
        deliver = valid
    elif targets_alive:
        deliver = valid & state.alive
    else:
        deliver = valid & state.alive & state.alive[targets]
    if loss_windows:
        deliver = deliver & ~round_drops(key, state.round, loss_windows, n)
    zero = torch.zeros_like(state.s)
    s_sent = torch.where(deliver, state.s * 0.5, zero)
    w_sent = torch.where(deliver, state.w * 0.5, zero)
    s_new = (state.s - s_sent).index_add_(0, targets, s_sent)
    w_new = (state.w - w_sent).index_add_(0, targets, w_sent)
    return finish_pushsum_round(
        state, s_new, w_new, eps=eps, streak_target=streak_target,
        predicate=predicate, tol=tol, all_alive=all_alive)


def pushsum_round(state: PushSumState, nbrs, base_key: torch.Tensor, *,
                  n: int, **kw) -> PushSumState:
    """One round keyed by ``fold_in(base_key, state.round)`` (the JAX
    package's single-card ``pushsum_round``, scatter delivery)."""
    return pushsum_round_core(state, nbrs, fold_in(base_key, state.round),
                              n=n, **kw)


def pushsum_done(state: PushSumState) -> torch.Tensor:
    """Supervisor predicate: every healthy node's estimate has stabilized
    (a bool scalar tensor, left on the device)."""
    return torch.all(state.converged | ~state.alive)


def mass(state: PushSumState):
    """(Σs, Σw) — the conservation invariant."""
    return state.s.sum(), state.w.sum()
