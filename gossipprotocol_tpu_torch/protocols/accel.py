"""Accelerated push-sum averaging: Chebyshev and EPD two-buffer iterations
(port of ``gossipprotocol_tpu/protocols/accel.py``).

Plain diffusion applies the lazy-random-walk matrix ``W`` once a round.
Both schemes here keep the previous iterate and take an affine
combination

    x_{t+1} = a_t · W x_t + (1 − a_t) · x_{t−1}

whose coefficients sum to 1, so Σx is conserved whenever ``W`` conserves
it; applied alike to ``s`` and ``w``, the ratio ``s/w`` converges at the
accelerated O(1/√gap) rate.

* ``chebyshev`` — ω₁ = 1, ω₂ = 1/(1 − γ²/2), ω_{t+1} = 1/(1 − (γ²/4)·ω_t),
  with γ a bound on |λ₂(W)| (``--accel-lambda``, or :func:`estimate_gamma`
  on the host).
* ``epd`` — parameter-free: a_t = (2t + 1)/(t + 1).

Both run the scatter diffusion mix (``protocols/diffusion.py``
:func:`~gossipprotocol_tpu_torch.protocols.diffusion.diffusion_mix`) and
the shared predicate tail, and assume a fixed mixing matrix (the config
rejects faults, loss, events and repair with them).

Bitwise parity with the JAX package on the CPU: the coefficients are
computed in the state's dtype with IEEE divisions by tensors, and the
places where XLA on the CPU contracts a product into the following add
are replayed with one rounding (:func:`_fma32`).
"""

from __future__ import annotations

import numpy as np
import torch

from gossipprotocol_tpu_torch.protocols.diffusion import diffusion_mix
from gossipprotocol_tpu_torch.protocols.pushsum import finish_pushsum_round
from gossipprotocol_tpu_torch.protocols.state import (
    AccelState, pushsum_init, torch_dtype,
)
from gossipprotocol_tpu_torch.topology.base import Topology

EPD_DELTA = 1.0


def accel_init(num_nodes: int, value_mode: str = "scaled", device="cuda",
               dtype=torch.float32, payload_dim: int = 1) -> AccelState:
    """Push-sum init plus the second buffer (``s_prev = s₀``: both schemes
    weigh it 0 at t = 0)."""
    ps = pushsum_init(num_nodes, value_mode=value_mode, device=device,
                      dtype=dtype, payload_dim=payload_dim)
    return AccelState(*ps, s_prev=ps.s.clone(), w_prev=ps.w.clone(),
                      omega=torch.zeros((), dtype=torch_dtype(dtype),
                                        device=ps.s.device))


def _fma32(a: torch.Tensor, b: torch.Tensor,
           c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once, for float32 operands: the product is
    exact in float64 and the sum is rounded to float64 and then to
    float32 (equal to one rounding unless the float64 sum falls exactly
    on a float32 tie, which needs the operands' exponents to lie over 29
    binades apart). A float64 state rounds twice: no wider type holds
    its product."""
    if a.dtype == torch.float64:
        return a * b + c
    return (a.double() * b.double() + c.double()).float()


def accel_coefficient(round_idx: torch.Tensor, omega: torch.Tensor, *,
                      variant: str, gamma: float, dtype):
    """``(a_t, ω_{t+1})`` for the combination at round ``round_idx``, in
    ``dtype``."""
    dt = torch_dtype(dtype)
    dev = omega.device
    one = torch.ones((), dtype=dt, device=dev)
    if variant == "epd":
        t = round_idx.to(dt)
        return (2 * t + EPD_DELTA) / (t + EPD_DELTA), omega
    g2 = torch.full((), float(np.asarray(gamma * gamma, dtype=np.float64)),
                    dtype=dt, device=dev)
    second = one / (one - g2 * 0.5)
    # 1 - (γ²/4)·ω: XLA on the CPU contracts the product into the
    # difference
    later = one / _fma32(-(g2 * 0.25), omega, one)
    om_next = torch.where(round_idx == 0, one,
                          torch.where(round_idx == 1, second, later))
    return om_next, om_next


def accel_round(state: AccelState, nbrs, key=None, *, n: int,
                variant: str, gamma: float = 0.0, eps: float = 1e-10,
                streak_target: int = 3, predicate: str = "delta",
                tol: float = 1e-4, all_alive: bool = False,
                targets_alive: bool = False,
                edge_chunks: int = 1) -> AccelState:
    """One accelerated round on one card (the JAX package's
    ``accel_round``; the call shape of ``pushsum_diffusion_round``):
    ``W x_t`` by the scatter diffusion mix, the two-buffer combination,
    then the shared predicate tail."""
    dt = state.w.dtype
    mix_s, mix_w = diffusion_mix(
        state, nbrs, key, n=n, all_alive=all_alive,
        targets_alive=targets_alive, edge_chunks=edge_chunks)
    a, om_next = accel_coefficient(state.round, state.omega,
                                   variant=variant, gamma=gamma, dtype=dt)
    b = 1 - a
    # a·(W x) + b·x_prev: XLA on the CPU rounds b·x_prev, then adds a·(W x)
    # with one rounding
    s_next = _fma32(a, mix_s, b * state.s_prev)
    w_next = _fma32(a, mix_w, b * state.w_prev)
    st = finish_pushsum_round(
        state, s_next, w_next, eps=eps, streak_target=streak_target,
        predicate=predicate, tol=tol, all_alive=all_alive)
    return st._replace(s_prev=state.s, w_prev=state.w, omega=om_next)


def estimate_gamma(topo: Topology, iters: int = 200, seed: int = 0) -> float:
    """Host power-iteration estimate of γ = |λ₂(W)| for the lazy random
    walk ``W = (I + A) D̂⁻¹`` (D̂ = deg + 1), the matrix diffusion applies
    (a numpy copy of the JAX package's, so the value is equal): the right
    principal eigenvector π first, then the deflated ``W − π𝟙ᵀ/(𝟙ᵀπ)``."""
    if topo.implicit_full:
        # K_n diffusion mixes in one round; Chebyshev degenerates to plain
        return 0.0
    n = topo.num_nodes
    offsets = np.asarray(topo.offsets, dtype=np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
    dst = np.asarray(topo.indices, dtype=np.int64)
    inv = 1.0 / (np.asarray(topo.degree, dtype=np.float64) + 1.0)

    def apply_w(x):
        xh = x * inv
        return xh + np.bincount(src, weights=xh[dst], minlength=n)

    rng = np.random.default_rng(seed)
    pi = np.abs(rng.standard_normal(n)) + 1e-3
    for _ in range(iters):
        pi = apply_w(pi)
        pi /= np.linalg.norm(pi)
    pi_sum = float(pi.sum())

    z = rng.standard_normal(n)
    lam = 0.0
    for _ in range(iters):
        z = apply_w(z) - pi * (z.sum() / pi_sum)
        norm = np.linalg.norm(z)
        if norm < 1e-300:
            return 0.0
        lam = norm
        z /= norm
    return float(min(lam, 1.0 - 1e-9))
