"""Stochastic Gradient Push (arXiv:1811.10792) on the gossip engine (port
of ``gossipprotocol_tpu/learn/sgp.py``).

One SGP round is a local gradient step and one push-sum mixing round,
composed so that the mixing core runs unchanged:

    zₜ   = xₜ / wₜ                      (de-biased estimate — state.ratio)
    z′   = zₜ − lr·∇Fᵢ(zₜ)  (× local_steps, full local batch)
    xₜ₊½ = xₜ + (z′ − zₜ)              (gradient applied to the numerator)
    (xₜ₊₁, wₜ₊₁) = push-sum mix of (xₜ₊½, wₜ)

Convergence is consensus distance AND a loss plateau: the mixing core's
``global`` predicate, and the mean train loss moved by at most
``loss_tol`` since the previous round.

The wrapper takes any of the port's mixing cores — fanout-one scatter
(``core(state, nbrs, key)``), fanout-all scatter, pallas or routed
(``core(state, delivery[, key])``) — and keeps its calling shape, with an
:class:`~gossipprotocol_tpu_torch.learn.data.SGPBundle` in the neighbour
slot. Given the same ``xₜ₊½`` the mixing step is the core's own, bitwise;
the gradient products agree with the JAX package's to a tolerance
(``learn/data.py``).
"""

from __future__ import annotations

import torch

from gossipprotocol_tpu_torch.learn.data import lsq_node_grad, lsq_node_loss
from gossipprotocol_tpu_torch.ops.build import resolve_device
from gossipprotocol_tpu_torch.protocols.pushsum import (
    pushsum_trace_row, sum0, tree_sum0,
)
from gossipprotocol_tpu_torch.protocols.state import SGPState, torch_dtype


def sgp_init(num_nodes: int, payload_dim: int, device="cuda",
             dtype=torch.float32) -> SGPState:
    """Every node starts at x₀ = 0, w₀ = 1; the loss at +∞, so the
    plateau test cannot fire on the first round."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    return SGPState(
        s=torch.zeros((num_nodes, payload_dim), dtype=dt, device=dev),
        w=torch.ones(num_nodes, dtype=dt, device=dev),
        ratio=torch.zeros((num_nodes, payload_dim), dtype=dt, device=dev),
        streak=torch.zeros(num_nodes, dtype=torch.int32, device=dev),
        converged=torch.zeros(num_nodes, dtype=torch.bool, device=dev),
        alive=torch.ones(num_nodes, dtype=torch.bool, device=dev),
        round=torch.zeros((), dtype=torch.int32, device=dev),
        loss=torch.full((), float("inf"), dtype=torch.float32, device=dev),
    )


def local_step(state: SGPState, bundle, lr: float,
               local_steps: int) -> torch.Tensor:
    """``xₜ₊½``: ``local_steps`` gradient steps from z = ``state.ratio``,
    applied to the numerator of the alive rows."""
    step = torch.full((), lr, dtype=state.s.dtype, device=state.s.device)
    z0 = state.ratio
    z = z0
    for _ in range(local_steps):
        z = z - step * lsq_node_grad(bundle.A, bundle.b, z)
    return state.s + torch.where(state.alive[:, None], z - z0,
                                 torch.zeros_like(z))


def with_loss(st: SGPState, prev_loss: torch.Tensor, bundle,
              loss_tol: float) -> SGPState:
    """The mixed state with its mean train loss over alive rows (float32)
    and the plateau gate ``|Δ loss| <= loss_tol`` on ``converged``."""
    dt = st.s.dtype
    node_loss = lsq_node_loss(bundle.A, bundle.b, st.ratio)
    alive_f = st.alive.to(dt)
    mean_loss = (sum0(torch.where(st.alive, node_loss,
                                  torch.zeros_like(node_loss)))
                 / torch.clamp(sum0(alive_f), min=1)).to(torch.float32)
    plateau = torch.abs(mean_loss - prev_loss) <= loss_tol
    return st._replace(converged=st.converged & plateau, loss=mean_loss)


def sgp_trace_row(state: SGPState, *, all_sum=tree_sum0,
                  all_max=torch.max):
    """Observatory trace row for SGP (the JAX package's ``sgp_trace_row``):
    push-sum's consensus and mass columns plus the mean train loss the
    state already carries (``pushsum_trace_row`` picks the ``loss`` field
    up)."""
    return pushsum_trace_row(state, all_sum=all_sum, all_max=all_max)


def make_sgp_core(mix_core, *, lr: float, local_steps: int,
                  loss_tol: float):
    """Wrap a bound push-sum mixing core into an SGP round core of the
    same calling shape, expecting an ``SGPBundle`` in the neighbour
    slot."""

    def core(state: SGPState, bundle, *key) -> SGPState:
        x_half = local_step(state, bundle, lr, local_steps)
        st = mix_core(state._replace(s=x_half), bundle.nbrs, *key)
        return with_loss(st, state.loss, bundle, loss_tol)

    return core
