"""Bulk-synchronous gossip rumor spreading (port of
``gossipprotocol_tpu/protocols/gossip.py``, single card, with the loss
windows of ``utils/faults.py`` — a dropped rumor message never lands —
and the Poisson clocks of ``async_/clock.py``: only a node whose clock
ticked spreads).

One round advances every node at once: every spreading node draws one
random neighbour, hits accumulate by a scatter-add (``index_add_`` on
int32, exact in any order, so the card's atomics and the CPU's serial
loop agree), and counts and converged flags update. ``keep_alive=True``
keeps every node that has heard the rumor spreading until global
convergence (the bulk-synchronous analogue of the reference's keep-alive
actor); ``keep_alive=False`` silences a node at its threshold.

The gather-inverted delivery (:func:`hits_by_inversion`) computes the
same hit histogram receiver-side when every eligible node spreads. The
JAX package picks it per round with ``jax.lax.cond`` on a device flag;
here the caller picks the branch (``inverted``) and must take it only
while :func:`inversion_legal` holds — then both branches give bitwise
equal hits, so the trajectory does not depend on the rule.

Sweep lanes (``sweep/engine.py``): a state with a leading ``[B]``
dimension (``round`` ``[B]``), ``[B, 2]`` round keys and, for a swept
threshold, a ``[B]`` int32 ``threshold`` run B independent rounds in one
pass; the hits scatter into a flattened ``[B·n]`` target
(:func:`~gossipprotocol_tpu_torch.protocols.sampling.index_add_rows`).
"""

from __future__ import annotations

import numpy as np
import torch

from gossipprotocol_tpu_torch.ops.build import resolve_device
from gossipprotocol_tpu_torch.protocols.sampling import (
    InvertedDense, dense_table, fold_in, index_add_rows, lane_param,
    node_sum, recomputed_hits, round_drops, sample_neighbors,
)
from gossipprotocol_tpu_torch.protocols.state import GossipState
from gossipprotocol_tpu_torch.topology.base import Topology


def _spreaders(state: GossipState, keep_alive: bool,
               all_alive: bool) -> torch.Tensor:
    heard = state.counts >= 1
    spreaders = heard if keep_alive else heard & ~state.converged
    return spreaders if all_alive else spreaders & state.alive


def inversion_legal(state: GossipState, nbrs: InvertedDense, *,
                    keep_alive: bool, all_alive: bool) -> torch.Tensor:
    """Device bool: does every node with a neighbour spread this round
    (the JAX package's ``mismatches == 0``)? Then the inverted branch's
    histogram is the scatter's."""
    valid = nbrs.degree > 0
    eligible = _spreaders(state, keep_alive, all_alive) & valid
    return torch.all(eligible == valid)


def gossip_round_core(state: GossipState, nbrs, key: torch.Tensor, *,
                      n: int, threshold: int = 10, keep_alive: bool = True,
                      all_alive: bool = False,
                      inverted: bool = False,
                      loss_windows: tuple = (),
                      clock: tuple = ()) -> GossipState:
    """One synchronous round under the round key ``key``.

    ``all_alive=True`` drops the aliveness masks (legal only when no node
    is dead). ``inverted=True`` takes the gather-inverted branch (``nbrs``
    an :class:`InvertedDense`), which the caller may do only while
    :func:`inversion_legal` holds and no loss window is active (a dropped
    send breaks the histogram's equality; the engine never inverts a run
    with loss windows). ``loss_windows`` (``FaultSchedule.
    static_loss_windows()``): a dropped send never lands — gossip needs
    no mass return. ``clock`` (a Poisson spec, ``async_/clock.py``): only
    rows whose clock ticked spread; the inverted branch is never taken
    under it (activation breaks its legality every round). Sweep lanes:
    see the module docstring (``threshold`` an int or a ``[B]`` tensor)."""
    spreaders = _spreaders(state, keep_alive, all_alive)
    if clock:
        assert not inverted, "inverted delivery requires the sync clock"
        from gossipprotocol_tpu_torch.async_.clock import activation_mask

        spreaders = spreaders & activation_mask(
            key, clock, torch.arange(state.counts.shape[-1],
                                     dtype=torch.int64, device=key.device))
    if inverted:
        assert not loss_windows, "the inverted branch cannot drop sends"
        hits = hits_by_inversion(nbrs, key)
    else:
        targets, valid = sample_neighbors(nbrs, n, key)
        send = spreaders & valid
        if loss_windows:
            send = send & ~round_drops(key, state.round, loss_windows, n)
        hits = index_add_rows(torch.zeros_like(state.counts), targets,
                              send.to(torch.int32))
    # the reference's sender-side dictionary check, applied at the
    # receiver: no hit lands on a converged or failed node
    suppressed = (state.converged if all_alive
                  else state.converged | ~state.alive)
    hits = torch.where(suppressed, torch.zeros_like(hits), hits)
    counts = state.counts + hits
    return GossipState(counts=counts,
                       converged=state.converged
                       | (counts >= lane_param(threshold, counts)),
                       alive=state.alive, round=state.round + 1)


def gossip_round(state: GossipState, nbrs, base_key: torch.Tensor, *,
                 n: int, threshold: int = 10, keep_alive: bool = True,
                 all_alive: bool = False,
                 inverted: bool = False,
                 loss_windows: tuple = (),
                 clock: tuple = ()) -> GossipState:
    """One round keyed by ``fold_in(base_key, state.round)`` (the JAX
    package's ``gossip_round``, with the branch chosen by the caller)."""
    return gossip_round_core(
        state, nbrs, fold_in(base_key, state.round), n=n,
        threshold=threshold, keep_alive=keep_alive, all_alive=all_alive,
        inverted=inverted, loss_windows=loss_windows, clock=clock)


def gossip_message_counts(old: GossipState, new: GossipState, nbrs,
                          key: torch.Tensor, *, n: int, keep_alive: bool,
                          all_alive: bool, loss_windows: tuple = (),
                          clock: tuple = ()) -> torch.Tensor:
    """Telemetry recount of one gossip round under its round key ``key``:
    int32 ``[sent, delivered, dropped]`` (``obs/counters.py`` semantics;
    the JAX package's ``gossip_message_counts``).

    Read-only: ``sent`` is the spreader set :func:`gossip_round_core`
    computed (re-derived from ``old`` with the same flags, the clock's
    activation mask included), ``delivered`` is ΣΔcounts — hits actually
    credited, exact in both delivery branches — and ``dropped`` re-draws
    the same loss mask from the same key. Sends suppressed by a
    converged/dead receiver count as sent but not delivered. Sweep lanes
    give ``[B, 3]``, one row a lane."""
    from gossipprotocol_tpu_torch.protocols.sampling import send_valid_mask

    lanes = old.round.dim() == 1
    spreaders = _spreaders(old, keep_alive, all_alive)
    rows = old.counts.shape[-1]
    if clock:
        from gossipprotocol_tpu_torch.async_.clock import activation_mask

        spreaders = spreaders & activation_mask(
            key, clock, torch.arange(rows, dtype=torch.int64,
                                     device=key.device))
    valid = send_valid_mask(nbrs, n)
    sent_mask = spreaders if valid is None else spreaders & valid
    sent = node_sum(sent_mask.to(torch.int32), lanes)
    delivered = (node_sum(new.counts.to(torch.int32), lanes)
                 - node_sum(old.counts.to(torch.int32), lanes))
    if loss_windows:
        drop = round_drops(key, old.round, loss_windows, n)
        dropped = node_sum((sent_mask & drop).to(torch.int32), lanes)
    else:
        dropped = torch.zeros(sent.shape, dtype=torch.int64,
                              device=sent.device)
    return torch.stack([sent, delivered, dropped], dim=-1).to(torch.int32)


def gossip_trace_row(state: GossipState, *, all_sum=None,
                     all_max=None) -> torch.Tensor:
    """Observatory trace row for gossip (column contract in
    :mod:`gossipprotocol_tpu_torch.obs.trace`; the JAX package's
    ``gossip_trace_row``): the "residual" is the fraction of alive nodes
    the rumor has not reached yet, the mass and train-loss columns NaN.
    ``all_max`` is accepted for signature parity but unused."""
    from gossipprotocol_tpu_torch.protocols.pushsum import tree_sum0

    del all_max
    if all_sum is None:
        all_sum = tree_sum0
    dt = torch.float32
    alive = state.alive
    n_alive = torch.clamp(all_sum(alive.to(dt)), min=1)
    heard = all_sum(((state.counts >= 1) & alive).to(dt))
    frac = all_sum((state.converged & alive).to(dt)) / n_alive
    nan = torch.full((), float("nan"), dtype=dt, device=alive.device)
    return torch.stack([(1 - heard / n_alive).to(dt), frac.to(dt), nan,
                        nan, nan])


def gossip_done(state: GossipState) -> torch.Tensor:
    """Supervisor predicate: every healthy node has converged."""
    return torch.all(state.converged | ~state.alive)


def reverse_slot_table(topo: Topology):
    """Host-side inversion table (int8 ``rev``; the JAX package's first
    table): for dense slot ``(i, k)`` with neighbour ``j = table[i, k]``,
    ``rev[i, k]`` is i's position in j's sorted neighbour row (the slot j
    must draw to hit i). One lexsort over the edges by (dst, src)."""
    offsets = np.asarray(topo.offsets, dtype=np.int64)
    indices = np.asarray(topo.indices, dtype=np.int64)
    deg = np.asarray(topo.degree, dtype=np.int64)
    n = topo.num_nodes
    maxd = int(deg.max()) if deg.size else 1
    assert maxd < 128, "reverse-slot tables are int8; dense path only"
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
    # slots are ranks within the sorted row: the CSR must be canonical
    interior = np.ones(len(row), dtype=bool)
    starts = offsets[1:-1]
    interior[starts[starts < len(row)]] = False
    if len(row) > 1:
        assert (np.diff(indices)[interior[1:]] > 0).all(), (
            "reverse_slot_table requires sorted, deduplicated CSR rows")
    order = np.lexsort((row, indices))
    rev_slot = np.empty(len(row), dtype=np.int8)
    rev_slot[order] = (np.arange(len(row), dtype=np.int64)
                       - offsets[indices[order]]).astype(np.int8)
    mask = np.arange(max(maxd, 1))[None, :] < deg[:, None]
    rev = np.zeros((n, max(maxd, 1)), dtype=np.int8)
    rev[mask] = rev_slot
    return rev


def inverted_dense(topo: Topology, device="cuda") -> InvertedDense:
    """The dense table and its inversion table on ``device``."""
    dev = resolve_device(device)
    table, deg = dense_table(topo)
    return InvertedDense(*(torch.from_numpy(a).to(dev)
                           for a in (table, deg, reverse_slot_table(topo))))


def hits_by_inversion(nbrs: InvertedDense, key: torch.Tensor) -> torch.Tensor:
    """Receiver-side hit counts: node i's hits are the neighbours whose
    draw points back at i, ``Σ_k [slot(table[i,k]) == rev[i,k]]`` over
    ``k < degree[i]`` — the scatter's histogram when every eligible node
    spreads."""
    return recomputed_hits(nbrs, key).sum(dim=-1, dtype=torch.int32)
