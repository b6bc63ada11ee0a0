"""Fanout-all diffusion push-sum over a single-chip delivery (port of
``pushsum_diffusion_round_routed``, ``gossipprotocol_tpu/protocols/
diffusion.py``; the poisson-clock branch is not yet ported).

Every node keeps ``1/(deg+1)`` of its ``(s, w)`` and ships one share per
edge; the delivery's ``matvec`` sums each node's incoming shares. The
round draws nothing, so it is deterministic.

Bitwise parity with the JAX package: the expressions keep the JAX order
of operations, ``s - share*deg`` rounds once as the JAX package's XLA
build computes it (:func:`_keep`), and every division is an IEEE division
by a tensor (see ``protocols/state.py``).
"""

from __future__ import annotations

import torch

from gossipprotocol_tpu_torch.protocols.pushsum import (
    finish_pushsum_round, rowmask,
)
from gossipprotocol_tpu_torch.protocols.state import PushSumState


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
    float32 once."""
    return (x.double() - share.double() * sent.double()).float()


def pushsum_diffusion_round_routed(
    state: PushSumState,
    delivery,  # ops.pallasdelivery.PallasDelivery or ops.delivery.RoutedDelivery
    *,
    eps: float = 1e-10,
    streak_target: int = 3,
    predicate: str = "delta",
    tol: float = 1e-4,
    all_alive: bool = False,
    targets_alive: bool = False,
) -> PushSumState:
    """One fanout-all round through ``delivery.matvec``.

    Fast paths (``all_alive`` — no node is dead — and ``targets_alive`` —
    the dead set is whole components, so an alive node's neighbors are
    alive) ship every share and keep ``sent = share · deg``. Under any
    other dead set one extra ``matvec(alive, alive)`` gives each node's
    count of alive neighbors (``live_deg``, exact small-integer floats);
    received sums are masked to alive rows and ``sent = share ·
    live_deg``.
    """
    deg = delivery.degree.to(torch.float32)
    inv = torch.ones_like(deg) / (deg + 1)
    share_s = state.s * rowmask(inv, state.s)
    share_w = state.w * inv
    if not all_alive:
        share_s = torch.where(rowmask(state.alive, share_s), share_s,
                              torch.zeros_like(share_s))
        share_w = torch.where(state.alive, share_w,
                              torch.zeros_like(share_w))
    in_s, in_w = delivery.matvec(share_s, share_w)
    if all_alive or targets_alive:
        sent = deg
    else:
        alive_f = state.alive.to(torch.float32)
        live_deg, _ = delivery.matvec(alive_f, alive_f)
        # a dead receiver's in-sum is garbage only to itself: discard it
        in_s = torch.where(rowmask(state.alive, in_s), in_s,
                           torch.zeros_like(in_s))
        in_w = torch.where(state.alive, in_w, torch.zeros_like(in_w))
        sent = live_deg
    return finish_pushsum_round(
        state, _keep(state.s, share_s, sent) + in_s,
        _keep(state.w, share_w, sent) + in_w,
        eps=eps, streak_target=streak_target, predicate=predicate, tol=tol,
        all_alive=all_alive,
    )
