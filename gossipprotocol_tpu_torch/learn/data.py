"""Synthetic per-node data shards of the learning workloads (port of
``gossipprotocol_tpu/learn/data.py``).

Node ``i`` holds ``m`` rows ``(Aᵢ, bᵢ)`` with ``bᵢ = Aᵢ·θ* + noise``
against one shared ground truth ``θ*``, so the global objective

    F(z) = (1/n) Σᵢ Fᵢ(z),   Fᵢ(z) = (1/2m) ‖Aᵢ z − bᵢ‖²

is strongly convex, and each shard alone is under-determined for
``m < d``, so the nodes' optima disagree. The data is made on the host
with numpy (:func:`make_least_squares`, the JAX package's draws byte for
byte) and placed on the device once.

The per-node products (``Aᵢ zᵢ``, ``Aᵢᵀ r``) are batched products that
XLA computes outside any Pallas kernel; here they are ``torch.bmm``. Their
float summation order is not XLA CPU's, so the learner agrees with the
JAX package to a stated tolerance, not bitwise.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

# fold applied to the run seed so the data draw never collides with the
# protocol's key streams (the JAX package's)
DATA_SEED_FOLD = 0xDA7A


class SGPBundle(NamedTuple):
    """What a learning round reads per node, riding the engine's
    neighbour slot: the mixing core's own arrays (``nbrs``: a delivery,
    the neighbour tables or the edge list) and the node's data shard."""

    nbrs: Any              # the mixing core's delivery or neighbour arrays
    A: torch.Tensor        # float [rows, m, d]  per-node design matrix
    b: torch.Tensor        # float [rows, m]     per-node targets


def make_least_squares(num_nodes: int, payload_dim: int, samples: int,
                       seed: int, dtype=np.float32, noise: float = 0.01,
                       rows: int | None = None):
    """Seed-deterministic shards ``(A, b, theta_star)`` as numpy arrays
    (a copy of the JAX package's): float64 draws, rounded to ``dtype``;
    ``rows`` pads the node axis with zero data."""
    rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(DATA_SEED_FOLD))
    theta = rng.standard_normal(payload_dim)
    a_full = rng.standard_normal((num_nodes, samples, payload_dim))
    b_full = a_full @ theta + noise * rng.standard_normal((num_nodes, samples))
    rows = num_nodes if rows is None else rows
    a_out = np.zeros((rows, samples, payload_dim), dtype=dtype)
    b_out = np.zeros((rows, samples), dtype=dtype)
    a_out[:num_nodes] = a_full
    b_out[:num_nodes] = b_full
    return a_out, b_out, theta.astype(dtype)


def _residual(a: torch.Tensor, b: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    """``Aᵢ zᵢ − bᵢ`` → float [rows, m]."""
    return torch.bmm(a, z[:, :, None])[:, :, 0] - b


def lsq_node_loss(a: torch.Tensor, b: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """Per-node loss Fᵢ(zᵢ) = (1/2m) ‖Aᵢ zᵢ − bᵢ‖² → float [rows]; the
    mean divides by a tensor of m (IEEE division on the card too)."""
    r = _residual(a, b, z)
    sq = (r * r).sum(dim=1)
    return 0.5 * (sq / torch.full_like(sq, a.shape[1]))


def lsq_node_grad(a: torch.Tensor, b: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """Per-node gradient ∇Fᵢ(zᵢ) = (1/m) Aᵢᵀ(Aᵢ zᵢ − bᵢ) → float
    [rows, d]."""
    r = _residual(a, b, z)
    g = torch.bmm(r[:, None, :], a)[:, 0, :]
    return g / torch.full_like(g, a.shape[1])
