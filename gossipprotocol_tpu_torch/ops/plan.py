"""Host-side plan helpers (the one piece of
``gossipprotocol_tpu/ops/plan.py`` the fused gather delivery needs; the
radix routing-plan compiler belongs to ``--delivery routed`` and is not
yet ported)."""

from __future__ import annotations

import numpy as np


def argsort_pairs(primary: np.ndarray, secondary: np.ndarray,
                  bound: int) -> np.ndarray:
    """``np.lexsort((secondary, primary))`` as one combined-key argsort.

    ``bound``: exclusive upper bound of ``secondary`` (checked: the
    packed key must fit int64). Ties broken stably.
    """
    primary = np.asarray(primary, np.int64)
    secondary = np.asarray(secondary, np.int64)
    if primary.size and int(primary.max()) >= (1 << 63) // max(bound, 1):
        return np.lexsort((secondary, primary))  # key would overflow
    return np.argsort(primary * np.int64(bound) + secondary,
                      kind="stable")
