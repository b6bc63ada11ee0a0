"""Message counters folded through the chunk loop (port of
``gossipprotocol_tpu/obs/counters.py``).

:func:`make_counter_fn` mirrors :func:`engine.driver.build_protocol`'s
dispatch exactly — one counter function per protocol/delivery branch,
each implemented next to the round it measures (``protocols/gossip.py``,
``protocols/pushsum.py``, ``protocols/diffusion.py``,
``ops/sharddelivery.py``) so the two can never drift apart silently.

The returned function has one fixed call shape for every engine::

    counter_fn(old_state, new_state, nbrs, round_key)
        -> int32[3]   # (sent, delivered, dropped)

(``int32[S, 3]``, one row per shard, under the sharded engine) and is
called once per round by the chunk runner, on the delivery the round ran
through — after a repair, churn or quarantine that is the rebuilt one.
``round_key`` is the round's key ``fold_in(base_key, round)`` (None where
the round draws nothing). The chunk's rows ride its one int32 fetch
(``engine/driver.py`` ``chunk_stats``).

Correctness contract (the bitwise-invariance tests pin this):

* counter functions only **read** the old/new states — they re-derive the
  round's draws through the very same counter-based primitives
  (:func:`protocols.sampling.sample_neighbors` / ``drop_mask``) the round
  itself used, so no state bit and no RNG stream is ever perturbed;
* the counters are never read by a round, so the state trajectory with
  telemetry on is bitwise identical to telemetry off.

Counter semantics, uniform across protocols:

* ``sent`` — messages a live node attempted this round (including ones a
  converged/dead receiver will ignore);
* ``delivered`` — messages accepted by a receiver (gossip: hits actually
  credited, i.e. receiver-side suppression excluded; push-sum: shares
  that moved mass);
* ``dropped`` — messages lost to an active loss window (mass-conserving
  drops: the sender kept the share).

Counts are int32 (a single round's message count is bounded by the
directed edge count); the per-round rows are summed on the host as Python
ints, so *cumulative* totals never overflow. The one exception is the
implicit complete graph, where a round sends ``a·(a−1)`` messages —
computed in f32 and saturated at ``INT32_MAX``. The reference walk (one
message a hop, ``[1, 1, 0]``) is counted on the host from the hop count
its chunk returns (no device op a hop).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

COUNTER_FIELDS = ("sent", "delivered", "dropped")
NUM_COUNTERS = len(COUNTER_FIELDS)

# one hop of the reference walk: one message sent and delivered
WALK_HOP_COUNTS = (1, 1, 0)

_INT32_MAX = int(np.iinfo(np.int32).max)


def clip_count(x: torch.Tensor) -> torch.Tensor:
    """A float32 message count -> int32, saturating at ``INT32_MAX`` (the
    JAX package's clip and convert)."""
    return torch.clamp(x.to(torch.float32).double(), 0.0,
                       float(_INT32_MAX)).to(torch.int32)


def make_counter_fn(
    topo,
    cfg,
    *,
    all_alive: bool,
    targets_alive: bool,
    num_shards: Optional[int] = None,
    clock_override: Optional[tuple] = None,
) -> Optional[Callable]:
    """Build the per-round counter function for this run's exact branch;
    None for the reference walk, whose hops are counted on the host
    (:data:`WALK_HOP_COUNTS` a hop).

    ``all_alive`` / ``targets_alive`` must be the flag pair
    ``build_protocol`` returned (they select the same fast paths the
    round runs). ``num_shards`` selects the sharded push design's
    per-shard counts (``int32[S, 3]``)."""
    n = topo.num_nodes
    loss_windows = cfg.schedule.static_loss_windows()
    # same spec the round ran with: counters re-derive the round's
    # activation draws, so counts match senders (a lazy import: the
    # engine imports this package)
    from gossipprotocol_tpu_torch.engine.driver import run_clock_spec

    clock = (clock_override if clock_override is not None
             else run_clock_spec(topo, cfg))

    if cfg.algorithm == "push-sum" and cfg.workload in ("sgp", "gala"):
        # SGP/GALA rounds are learner steps wrapped around a plain mixing
        # round; the message traffic is exactly the mixing round's, with
        # the delivery riding inside the SGPBundle's nbrs slot — count
        # through the inner branch after unwrapping. GALA's clock spec
        # (group-level id_div) survives the unwrap: it is computed from
        # the *outer* cfg and closed over
        import dataclasses as _dc

        inner = make_counter_fn(
            topo, _dc.replace(cfg, workload="avg", groups=1),
            all_alive=all_alive, targets_alive=targets_alive,
            num_shards=num_shards, clock_override=clock)

        def fn(old, new, bundle, key):
            return inner(old, new, bundle.nbrs, key)

        return fn

    if cfg.algorithm == "push-sum" and cfg.accel != "off":
        # the accelerated rounds apply the same one-W-pass diffusion
        # delivery as plain scatter diffusion; the affine recombination
        # moves no messages
        import dataclasses as _dc

        return make_counter_fn(
            topo, _dc.replace(cfg, accel="off"), all_alive=all_alive,
            targets_alive=targets_alive, num_shards=num_shards,
            clock_override=clock)

    if cfg.algorithm == "gossip":
        from gossipprotocol_tpu_torch.engine.driver import (
            effective_keep_alive,
        )
        from gossipprotocol_tpu_torch.protocols.gossip import (
            gossip_message_counts,
        )

        keep_alive = effective_keep_alive(topo, cfg)

        def fn(old, new, nbrs, key):
            return gossip_message_counts(
                old, new, nbrs, key, n=n, keep_alive=keep_alive,
                all_alive=all_alive, loss_windows=loss_windows, clock=clock)

        return fn

    if cfg.semantics == "reference" and cfg.fanout == "one":
        # the single-token walk: exactly one message per hop, no loss —
        # counted on the host from the chunk's hop count
        return None

    if cfg.fanout == "all":
        if cfg.delivery in ("routed", "pallas", "megakernel"):
            # pallas/megakernel deliveries answer the same .matvec/
            # .degree recount surface (MegakernelDelivery forwards to its
            # inner PallasDelivery)
            if num_shards is not None:
                from gossipprotocol_tpu_torch.ops.sharddelivery import (
                    shard_routed_message_counts,
                )

                fast = all_alive or targets_alive

                def fn(old, new, plans, key):
                    return shard_routed_message_counts(
                        old, plans, num_shards=num_shards,
                        fast_alive=fast, all_alive=all_alive,
                        exchange=_sharded_exchange(cfg), key=key,
                        clock=clock)

                return fn

            from gossipprotocol_tpu_torch.protocols.diffusion import (
                routed_message_counts,
            )

            def fn(old, new, delivery, key):
                return routed_message_counts(
                    old, delivery, n=n, all_alive=all_alive,
                    targets_alive=targets_alive, key=key, clock=clock)

            return fn

        from gossipprotocol_tpu_torch.protocols.diffusion import (
            diffusion_message_counts,
        )

        def fn(old, new, edges, key):
            return diffusion_message_counts(
                old, edges, key, n=n, all_alive=all_alive,
                targets_alive=targets_alive, loss_windows=loss_windows,
                clock=clock)

        return fn

    from gossipprotocol_tpu_torch.protocols.pushsum import (
        pushsum_message_counts,
    )

    def fn(old, new, nbrs, key):
        return pushsum_message_counts(
            old, nbrs, key, n=n, all_alive=all_alive,
            targets_alive=targets_alive, delivery=cfg.delivery,
            loss_windows=loss_windows, clock=clock)

    return fn


def _sharded_exchange(cfg) -> str:
    from gossipprotocol_tpu_torch.parallel.sharded import exchange_of

    return exchange_of(cfg)


def ulp_drift(value, baseline) -> float:
    """|value − baseline| measured in ULPs *of the baseline's dtype* (the
    JAX package's ``ulp_drift``): 0.0 when equal, NaN/Inf propagate.

    Vector payloads pass per-dimension [d] mass sums: drift is then
    measured per dimension against that dimension's own baseline and the
    *max* over dimensions is reported."""
    b = np.asarray(baseline)
    v = np.asarray(value)
    if b.ndim:
        return max(ulp_drift(v.reshape(-1)[k], b.reshape(-1)[k])
                   for k in range(b.size))
    v = float(np.float64(v))
    bf = float(np.float64(b))
    if v == bf:
        return 0.0
    ulp = float(np.spacing(np.abs(b).astype(b.dtype, copy=False)))
    if ulp == 0.0:  # baseline exactly 0 in a zero-width format corner
        ulp = float(np.spacing(np.asarray(0, b.dtype)))
    return abs(v - bf) / ulp
