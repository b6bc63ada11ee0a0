"""Poisson activation clocks (port of ``gossipprotocol_tpu/async_``).

A clock spec is a small tuple threaded through the round cores like the
loss windows: ``()`` is the synchronous clock (every node acts; the round
launches what it launched before clocks existed), ``(rate, id_div)`` a
Poisson clock thinned to rounds, each node active with probability
``1 - exp(-rate)``, drawn counter-based from the run's key.
"""

from gossipprotocol_tpu_torch.async_.clock import (
    CLOCK_FOLD,
    activation_mask,
    activation_probability,
    clock_spec,
)

__all__ = ["CLOCK_FOLD", "activation_mask", "activation_probability",
           "clock_spec"]
