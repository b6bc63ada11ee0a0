"""Per-node activation clocks, counter-based like every other draw (port
of ``gossipprotocol_tpu/async_/clock.py``).

A rate-``r`` Poisson clock on every node, thinned to unit rounds: a node
is active in a round with probability ``p = 1 - exp(-r)`` (its clock
ticked at least once), and only active nodes send; receivers stay
passive. The mask is :func:`~gossipprotocol_tpu_torch.protocols.sampling.
drop_mask` under ``fold_in(round_key, CLOCK_FOLD)`` at the threshold
``float32(p)``, so a trajectory is a function of (seed, round, global
id), bitwise the JAX package's.

Clock specs:

* ``()`` — synchronous; every node acts every round.
* ``(rate, id_div)`` — Poisson clock; the coins are keyed on ``gid //
  id_div`` (1: independent node clocks; GALA passes its group size so a
  group shares one clock).
* ``("prob", p, id_div)`` — Poisson clock with the per-round activation
  probability given directly: the sweep engine's form
  (``sweep/engine.py``), with ``p`` a float32 ``[B]`` tensor, one value a
  lane, already the host-rounded ``float32(1 - exp(-rate))`` and used
  verbatim, so every lane draws at its standalone run's threshold.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from gossipprotocol_tpu_torch.protocols.sampling import drop_mask, fold_in

# Domain-separation constant folded into the round key before the
# activation draws (the JAX package's): distinct from LOSS_FOLD, so loss
# and activation coins are independent streams.
CLOCK_FOLD = 0xA51C


def clock_spec(clock: str, activation_rate: float, id_div: int = 1) -> Tuple:
    """The clock-spec tuple of a config's values; ``ValueError`` on an
    unknown clock name."""
    if clock == "sync":
        return ()
    if clock == "poisson":
        return (float(activation_rate), int(id_div))
    raise ValueError(f"unknown clock model {clock!r}; use 'sync' or 'poisson'")


def activation_probability(clock: Tuple) -> float:
    """Per-round activation probability ``1 - exp(-rate)`` (a Python
    float, 1.0 for the synchronous clock)."""
    if not clock:
        return 1.0
    return 1.0 - math.exp(-float(clock[0]))


def activation_mask(round_key: torch.Tensor, clock: Tuple,
                    gids: torch.Tensor) -> torch.Tensor:
    """bool [rows]: whose clock ticked this round. ``round_key`` is the
    round's key (``fold_in(base_key, round)``); ``gids`` are global row
    ids. Call it under a Poisson spec only."""
    assert clock, "activation_mask called under the synchronous clock"
    if clock[0] == "prob":
        prob = clock[1].to(torch.float32)
        id_div = int(clock[2])
    else:
        prob = torch.tensor(
            float(np.float32(activation_probability(clock))),
            dtype=torch.float32, device=gids.device)
        id_div = int(clock[1])
    ids = gids if id_div == 1 else torch.div(gids, id_div,
                                             rounding_mode="floor")
    # drop_mask draws u32 < p·2³²: a Bernoulli(p) sampler where "dropped"
    # reads "active"
    return drop_mask(fold_in(round_key, CLOCK_FOLD), prob, ids)
