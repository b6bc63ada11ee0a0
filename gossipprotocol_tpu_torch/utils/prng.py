"""splitmix64 — the host-side RNG for graph construction.

A copy of ``gossipprotocol_tpu/utils/prng.py``: the numpy topology
builders of both packages (and the JAX package's native C++ builder)
draw from this exact counter-based generator, so a topology built by
either package is byte-identical for the same seed.

splitmix64 reference: Steele, Lea & Flood, "Fast splittable pseudorandom
number generators" (the public-domain mix function used by java.util
.SplittableRandom and most C++ seeding utilities).
"""

from __future__ import annotations

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def splitmix64(seed: int, counters: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64: hash of (seed, counter) per element.

    counters: uint64 array (any shape). Returns uint64 of same shape.
    """
    seed = np.uint64(int(seed) & (2**64 - 1))  # mask like a C uint64_t
    with np.errstate(over="ignore"):
        x = (seed + (counters.astype(np.uint64) + np.uint64(1)) * _GOLDEN)
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        x = x ^ (x >> np.uint64(31))
    return x


def uniform_int(seed: int, counters: np.ndarray, bound: int) -> np.ndarray:
    """Draws in [0, bound) — modulo map (bias < bound/2⁶⁴, negligible)."""
    return (splitmix64(seed, counters) % np.uint64(bound)).astype(np.int64)
