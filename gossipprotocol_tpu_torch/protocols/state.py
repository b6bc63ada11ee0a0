"""Gossip and push-sum state (port of
``gossipprotocol_tpu/protocols/state.py``, scalar payload path).

The whole system state is a handful of dense tensors in a NamedTuple.
``ratio`` caches s/w from the previous round so the convergence delta is
computed against the pre-update estimate. ``alive`` marks healthy nodes:
a dead node neither sends nor receives, and the predicate ignores it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gossipprotocol_tpu_torch.ops.build import resolve_device


class GossipState(NamedTuple):
    counts: torch.Tensor      # int32 [N]  times each node heard the rumor
    converged: torch.Tensor   # bool [N]
    alive: torch.Tensor       # bool [N]
    round: torch.Tensor       # int32 scalar


def gossip_init(num_nodes: int, seed_node: int,
                device="cuda") -> GossipState:
    """All-zero state with the rumor seeded at ``seed_node`` (count 1: its
    own knowledge of the rumor is the first hearing), on ``device``."""
    dev = resolve_device(device)
    counts = torch.zeros(num_nodes, dtype=torch.int32, device=dev)
    counts[seed_node] = 1
    return GossipState(
        counts=counts,
        converged=torch.zeros(num_nodes, dtype=torch.bool, device=dev),
        alive=torch.ones(num_nodes, dtype=torch.bool, device=dev),
        round=torch.zeros((), dtype=torch.int32, device=dev),
    )


class PushSumState(NamedTuple):
    s: torch.Tensor           # float32 [N]  running sum component
    w: torch.Tensor           # float32 [N]  running weight component
    ratio: torch.Tensor       # float32 [N]  previous s/w estimate
    streak: torch.Tensor      # int32 [N]  consecutive rounds within tolerance
    converged: torch.Tensor   # bool [N]
    alive: torch.Tensor       # bool [N]
    round: torch.Tensor       # int32 scalar


def pushsum_init(num_nodes: int, value_mode: str = "scaled",
                 device="cuda") -> PushSumState:
    """Initial push-sum state on ``device`` (``cuda`` unless asked for
    ``cpu``; raises when ``cuda`` is asked for and no card is present).

    value_mode:
      * ``"index"``  — s_i = i, the reference's ``InitialSum``; the true
        average is (N-1)/2;
      * ``"scaled"`` — s_i = i/N (default), average (N-1)/(2N).

    Every division divides by a tensor of the operand's shape: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, which
    is not the IEEE quotient the JAX package computes.
    """
    if value_mode not in ("scaled", "index"):
        raise ValueError("value_mode must be 'scaled' or 'index'")
    dev = resolve_device(device)
    i = torch.arange(num_nodes, dtype=torch.float32, device=dev)
    s = i / torch.full_like(i, num_nodes) if value_mode == "scaled" else i
    w = torch.ones(num_nodes, dtype=torch.float32, device=dev)
    ratio = s / torch.clamp(w, min=1e-30)
    return PushSumState(
        s=s,
        w=w,
        ratio=ratio,
        streak=torch.zeros(num_nodes, dtype=torch.int32, device=dev),
        converged=torch.zeros(num_nodes, dtype=torch.bool, device=dev),
        alive=torch.ones(num_nodes, dtype=torch.bool, device=dev),
        round=torch.zeros((), dtype=torch.int32, device=dev),
    )
