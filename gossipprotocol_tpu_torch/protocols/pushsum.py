"""Push-sum round tail and supervisor predicate (port of the scalar
pieces of ``gossipprotocol_tpu/protocols/pushsum.py``).

Only the intended semantics are ported (``--semantics reference`` and
the single-target sender are not yet): the convergence predicate is
either the local delta streak ``|Δ(s/w)| <= eps`` for ``streak_target``
rounds (sticky) or the global ``|s/w - mean| <= tol`` streak
(non-sticky).
"""

from __future__ import annotations

import torch

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


def pushsum_done(state: PushSumState) -> torch.Tensor:
    """Supervisor predicate: every healthy node's estimate has stabilized
    (a bool scalar tensor, left on the device)."""
    return torch.all(state.converged | ~state.alive)


def mass(state: PushSumState):
    """(Σs, Σw) — the conservation invariant."""
    return state.s.sum(), state.w.sum()
