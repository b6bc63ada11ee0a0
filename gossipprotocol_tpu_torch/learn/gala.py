"""GALA: gossip-based actor-learner groups (arXiv:1906.04585; port of
``gossipprotocol_tpu/learn/gala.py``).

Learners form G groups of equal size. Inside a group the models stay
exactly synchronized; between groups they mix only by push-sum gossip.
One round is

    z′     = local SGP gradient step(s) on each node's shard
    x_half = x + (z′ − z)                      (as in learn/sgp.py)
    (x̄, w̄) = exact per-group average of (x_half, w) over alive members
    (x₊₁, w₊₁) = push-sum mixing round of (x̄, w̄)   (inter-group gossip)

The group average keeps each group's Σs, Σw, so every push-sum invariant
survives. Under a Poisson clock the engine keys the clock on ``gid //
group_size``, so a group gossips, or idles, as one. Convergence is SGP's.
The group sums are ``index_add_`` over the group ids on the CPU (XLA's
``segment_sum``, in ascending row order). On the card they are
:func:`contiguous_group_sum`, a reduction over each group's rows: the
same bits every run, where ``index_add_``'s float atomics add in an order
that changes from run to run. The two differ by the ascending order's
rounding: with 8,192 rows a group, about 1e-4 in w after 32 rounds, and
the reduction is the one nearer the exact sum.
"""

from __future__ import annotations

import torch

from gossipprotocol_tpu_torch.learn.sgp import local_step, with_loss
from gossipprotocol_tpu_torch.protocols.state import SGPState


def contiguous_group_sum(x: torch.Tensor, num_groups: int,
                         group_size: int) -> torch.Tensor:
    """``[num_groups, ...]`` sums of ``x``'s rows, group g holding rows
    ``[g * group_size, (g + 1) * group_size)`` and the last group every
    row from ``(num_groups - 1) * group_size`` on (the clamped group ids of
    :func:`make_gala_core`): ``torch.sum`` over each group's rows."""
    rows, rest = x.shape[0], tuple(x.shape[1:])
    full = (num_groups - 1) * group_size
    head = x[:min(rows, full)]
    if head.shape[0] < full:
        head = torch.cat([head, head.new_zeros((full - head.shape[0],)
                                               + rest)])
    return torch.cat([head.reshape((num_groups - 1, group_size) + rest)
                      .sum(1), x[full:].sum(0, keepdim=True)])


def make_gala_core(mix_core, *, num_groups: int, group_size: int,
                   lr: float, local_steps: int, loss_tol: float):
    """Wrap a bound push-sum mixing core into a GALA round core of the
    same calling shape (an ``SGPBundle`` in the neighbour slot)."""

    def group_sum(x: torch.Tensor, group_ids: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cpu":
            return contiguous_group_sum(x, num_groups, group_size)
        out = torch.zeros((num_groups,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        return out.index_add_(0, group_ids, x)

    def core(state: SGPState, bundle, *key) -> SGPState:
        x_half = local_step(state, bundle, lr, local_steps)
        live = state.alive[:, None]
        rows = state.w.shape[0]
        group_ids = torch.clamp(torch.div(
            torch.arange(rows, dtype=torch.int64, device=state.w.device),
            group_size, rounding_mode="floor"), 0, num_groups - 1)
        alive_f = state.alive.to(state.w.dtype)
        g_cnt = torch.clamp(group_sum(alive_f, group_ids), min=1)
        g_s = group_sum(torch.where(live, x_half, torch.zeros_like(x_half)),
                        group_ids)
        g_w = group_sum(torch.where(state.alive, state.w,
                                    torch.zeros_like(state.w)), group_ids)
        x_avg = torch.where(live, (g_s / g_cnt[:, None])[group_ids], x_half)
        w_avg = torch.where(state.alive, (g_w / g_cnt)[group_ids], state.w)
        st = mix_core(state._replace(s=x_avg, w=w_avg), bundle.nbrs, *key)
        return with_loss(st, state.loss, bundle, loss_tol)

    return core
