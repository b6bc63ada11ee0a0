"""Gossip and push-sum state (port of
``gossipprotocol_tpu/protocols/state.py``).

The whole system state is a handful of dense tensors in a NamedTuple.
``ratio`` caches s/w from the previous round so the convergence delta is
computed against the pre-update estimate. ``alive`` marks healthy nodes:
a dead node neither sends nor receives, and the predicate ignores it.

With ``payload_dim > 1`` (vector payloads) ``s`` and ``ratio`` are
``[N, d]`` while ``w`` stays ``[N]``: one weight per node scales every
payload column, as in Stochastic Gradient Push (arXiv:1811.10792).
``payload_dim == 1`` keeps the scalar ``[N]`` state, byte for byte.
:class:`SGPState` adds the mean train loss, :class:`AccelState` the
previous iterate of the accelerated schemes (``protocols/accel.py``).
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
    s: torch.Tensor           # float [N] or [N, d]  running sum component
    w: torch.Tensor           # float [N]  running weight component
    ratio: torch.Tensor       # float [N] or [N, d]  previous s/w estimate
    streak: torch.Tensor      # int32 [N]  consecutive rounds within tolerance
    converged: torch.Tensor   # bool [N]
    alive: torch.Tensor       # bool [N]
    round: torch.Tensor       # int32 scalar


class SGPState(NamedTuple):
    """Stochastic-Gradient-Push state: the push-sum fields (same order, so
    the round cores' ``_replace`` carries it) plus the mean train loss of
    the de-biased estimates, which the convergence predicate reads."""

    s: torch.Tensor           # float [N, d]  biased parameter numerator x
    w: torch.Tensor           # float [N]  push-sum weight
    ratio: torch.Tensor       # float [N, d]  de-biased estimate z = x / w
    streak: torch.Tensor      # int32 [N]
    converged: torch.Tensor   # bool [N]
    alive: torch.Tensor       # bool [N]
    round: torch.Tensor       # int32 scalar
    loss: torch.Tensor        # float32 scalar  mean train loss, alive rows


class AccelState(NamedTuple):
    """Two-buffer accelerated push-sum state (Chebyshev / EPD):
    ``s_prev``/``w_prev`` hold the previous iterate of
    x_{t+1} = a_t·W x_t + (1 − a_t)·x_{t−1}; ``omega`` carries the
    Chebyshev weight recurrence (unused by EPD)."""

    s: torch.Tensor           # float [N] or [N, d]
    w: torch.Tensor           # float [N]
    ratio: torch.Tensor       # float [N] or [N, d]
    streak: torch.Tensor      # int32 [N]
    converged: torch.Tensor   # bool [N]
    alive: torch.Tensor       # bool [N]
    round: torch.Tensor       # int32 scalar
    s_prev: torch.Tensor      # float [N] or [N, d]  x_{t-1}
    w_prev: torch.Tensor      # float [N]  w_{t-1}
    omega: torch.Tensor       # float scalar  Chebyshev ω_t (0 before round 1)


DTYPES = {"float32": torch.float32, "float64": torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """A state dtype from its name (``"float32"``, ``"float64"``) or a
    torch dtype."""
    return DTYPES[dtype] if isinstance(dtype, str) else dtype


def pushsum_payload_values(ids: torch.Tensor, num_nodes: int,
                           payload_dim: int, value_mode: str,
                           dtype=torch.float32) -> torch.Tensor:
    """Vector-payload initial values of the node ids ``ids``: column ``k``
    holds the scalar init of node ``(i + k) mod N``, each column a
    rotation of the scalar profile (same mean, distinct per-node signal).
    Shared by the init and the host events (revive, ``stuck`` faults), so
    a revived row is bitwise a fresh-born one: the id converted to the
    dtype, then an IEEE division by a tensor of N."""
    cols = torch.arange(payload_dim, dtype=torch.int64, device=ids.device)
    vals = ((ids.to(torch.int64)[:, None] + cols[None, :])
            % num_nodes).to(torch_dtype(dtype))
    if value_mode == "index":
        return vals
    return vals / torch.full_like(vals, num_nodes)


def pushsum_init(num_nodes: int, value_mode: str = "scaled",
                 device="cuda", dtype=torch.float32,
                 payload_dim: int = 1) -> PushSumState:
    """Initial push-sum state on ``device`` (``cuda`` unless asked for
    ``cpu``; raises when ``cuda`` is asked for and no card is present).

    value_mode:
      * ``"index"``  — s_i = i, the reference's ``InitialSum``; the true
        average is (N-1)/2;
      * ``"scaled"`` — s_i = i/N (default), average (N-1)/(2N).

    ``dtype`` is the state's float type (float64 under ``--x64``);
    ``payload_dim > 1`` gives the ``[N, d]`` payload of
    :func:`pushsum_payload_values`.

    Every division divides by a tensor of the operand's shape: PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal, which
    is not the IEEE quotient the JAX package computes.
    """
    if value_mode not in ("scaled", "index"):
        raise ValueError("value_mode must be 'scaled' or 'index'")
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    w = torch.ones(num_nodes, dtype=dt, device=dev)
    if payload_dim == 1:
        i = torch.arange(num_nodes, dtype=dt, device=dev)
        s = i / torch.full_like(i, num_nodes) if value_mode == "scaled" \
            else i
        ratio = s / torch.clamp(w, min=1e-30)
    else:
        s = pushsum_payload_values(
            torch.arange(num_nodes, dtype=torch.int64, device=dev),
            num_nodes, payload_dim, value_mode, dt)
        ratio = s / torch.clamp(w, min=1e-30)[:, None]
    return PushSumState(
        s=s,
        w=w,
        ratio=ratio,
        streak=torch.zeros(num_nodes, dtype=torch.int32, device=dev),
        converged=torch.zeros(num_nodes, dtype=torch.bool, device=dev),
        alive=torch.ones(num_nodes, dtype=torch.bool, device=dev),
        round=torch.zeros((), dtype=torch.int32, device=dev),
    )
