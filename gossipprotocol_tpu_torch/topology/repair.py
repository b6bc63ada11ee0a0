"""Deterministic overlay repair under churn (port of
``gossipprotocol_tpu/topology/repair.py``; numpy only, as there).

The fault engine (utils/faults.py) degrades the network passively:
survivors keep dead entries in their neighbor lists, and anything the
kill strands away from the majority partition is itself executed by
``kill_disconnected``.  Real gossip systems repair their overlay
instead — peers notice dead neighbors and re-splice the graph so the
computation keeps every reachable survivor.  This module implements
that as a pure host-side graph transform executed at the same
chunk-boundary host events the fault engine already uses:

``off``
    No repair.  The engine keeps today's batched kill/revive path
    byte-for-byte (the majority-partition rule runs against the birth
    adjacency).

``prune``
    Drop every edge with a dead endpoint from the CSR, so delivery
    stops addressing corpses.  The adjacency among live nodes is
    unchanged, so the majority-partition rule keeps today's victim set:
    stranded survivors still die.

``rewire``
    Prune, then splice survivors back together deterministically from
    the run seed, degree-preserving: every pruned edge leaves a *stub*
    at its live endpoint, stubs are shuffled with a counter-based rng
    keyed on ``(run_seed, event_round)`` and paired consecutively into
    new edges (self-loops and duplicates fall back to a random live
    peer).  Revived nodes — whose edges were pruned when they died —
    are re-attached with one edge to a random live peer.  Previously-
    stranded survivors therefore stay in the computation; the
    majority-partition rule (now policy-conditional, see
    :func:`gossipprotocol_tpu_torch.utils.faults.apply_partition_rule`) runs
    against the *repaired* adjacency, where it is normally a no-op.

Repair never touches protocol state: push-sum mass over the survivors
is conserved exactly (the engine asserts this across every rebuild).
Determinism: the rng is keyed per event round, not threaded through the
run, so a resume can replay the repaired topology bitwise from the
birth adjacency plus the fault schedule (:func:`replay_repaired_topology`).
"""

from __future__ import annotations

import numpy as np

from gossipprotocol_tpu_torch.topology.base import Topology, csr_from_edges

REPAIR_POLICIES = ("off", "prune", "rewire")

# Domain-separation constant for the per-event rng key (arbitrary, fixed
# forever: it is part of the bitwise-replay contract).
_REWIRE_STREAM = 0x5EED42

# Attempts to find a non-duplicate live peer for an unmatched stub
# before giving up on it (bounded so a nearly-complete live graph cannot
# spin; a dropped stub only costs one edge of degree, never correctness).
_PEER_DRAWS = 16


def validate_policy(policy: str) -> str:
    if policy not in REPAIR_POLICIES:
        raise ValueError(
            f"repair policy must be one of {REPAIR_POLICIES}, got {policy!r}")
    return policy


def repair_topology(topo: Topology, alive: np.ndarray, policy: str, *,
                    run_seed: int, event_round: int,
                    revived: np.ndarray | None = None):
    """Repair ``topo`` around the dead set implied by ``alive``.

    Called after a strike batch (kills applied, revives applied) and
    before the partition rule.  ``alive`` is the length-``num_nodes``
    post-strike liveness mask; ``revived`` lists the node ids revived in
    this batch (they need re-attachment under ``rewire`` because their
    edges were pruned when they died).

    Returns ``(new_topo, stats)`` where ``stats`` is a plain-typed dict
    (json-serializable, it goes straight into the metrics stream)::

        {"changed": bool, "nodes_pruned": int, "edges_dropped": int,
         "edges_spliced": int, "stubs_unmatched": int}

    ``new_topo`` is ``topo`` itself (same object) when nothing changed,
    so callers can skip the device rebuild.  The transform is a pure
    function of ``(topo, alive, policy, run_seed, event_round,
    revived)`` — replaying the same inputs reproduces the same CSR
    bitwise.
    """
    validate_policy(policy)
    stats = {"changed": False, "nodes_pruned": 0, "edges_dropped": 0,
             "edges_spliced": 0, "stubs_unmatched": 0}
    if policy == "off":
        return topo, stats
    if topo.implicit_full:
        raise ValueError(
            "repair needs an explicit edge list; the implicit complete "
            "graph has no CSR to prune (use --repair off)")
    if topo.asymmetric:
        raise ValueError(
            "repair is defined on symmetric simple graphs; got an "
            "asymmetric adjacency")

    n = topo.num_nodes
    alive = np.asarray(alive, bool)
    if alive.shape != (n,):
        raise ValueError(f"alive mask has shape {alive.shape}, want ({n},)")

    offsets = np.asarray(topo.offsets, np.int64)
    indices = np.asarray(topo.indices, np.int64)
    deg = np.diff(offsets)
    row = np.repeat(np.arange(n, dtype=np.int64), deg)
    und = row < indices               # one record per undirected edge
    u, v = row[und], indices[und]
    au, av = alive[u], alive[v]
    keep = au & av

    stats["nodes_pruned"] = int((~alive & (deg > 0)).sum())
    stats["edges_dropped"] = int((~keep).sum())

    spliced: list[tuple[int, int]] = []
    if policy == "rewire":
        # One stub per pruned edge, at its live endpoint (edges with
        # both endpoints dead leave no stub).  Multiplicity matters:
        # that is what makes the splice degree-preserving.
        orphan = au ^ av
        stubs = np.concatenate([u[orphan & au], v[orphan & av]])

        # Revived nodes whose surviving degree is zero get one stub, so
        # the splice re-attaches them instead of leaving them to the
        # partition rule.
        if revived is not None and np.asarray(revived).size:
            rev = np.unique(np.asarray(revived, np.int64))
            rev = rev[alive[rev]]
            if rev.size:
                kept_deg = np.zeros(n, np.int64)
                if keep.any():
                    np.add.at(kept_deg, u[keep], 1)
                    np.add.at(kept_deg, v[keep], 1)
                stubs = np.concatenate([stubs, rev[kept_deg[rev] == 0]])

        if stubs.size:
            rng = np.random.default_rng(
                [int(run_seed) & 0xFFFFFFFF, int(event_round),
                 _REWIRE_STREAM])
            shuffled = stubs[rng.permutation(stubs.size)]
            existing = set((np.minimum(u[keep], v[keep]) * n
                            + np.maximum(u[keep], v[keep])).tolist())
            leftovers: list[int] = []
            for i in range(0, int(shuffled.size) - 1, 2):
                a, b = int(shuffled[i]), int(shuffled[i + 1])
                key = min(a, b) * n + max(a, b)
                if a == b or key in existing:
                    leftovers += [a, b]
                else:
                    spliced.append((a, b))
                    existing.add(key)
            if shuffled.size % 2:
                leftovers.append(int(shuffled[-1]))

            live_ids = np.flatnonzero(alive)
            for a in leftovers:
                for _ in range(_PEER_DRAWS):
                    b = int(live_ids[int(rng.integers(live_ids.size))])
                    key = min(a, b) * n + max(a, b)
                    if a != b and key not in existing:
                        spliced.append((a, b))
                        existing.add(key)
                        break
                else:
                    stats["stubs_unmatched"] += 1

    stats["edges_spliced"] = len(spliced)
    if not stats["edges_dropped"] and not spliced:
        return topo, stats          # nothing to rebuild

    kept_edges = np.stack([u[keep], v[keep]], axis=1)
    if spliced:
        kept_edges = np.concatenate(
            [kept_edges, np.asarray(spliced, np.int64)], axis=0)
    stats["changed"] = True
    return csr_from_edges(n, kept_edges, kind=topo.kind), stats


def replay_repaired_topology(topo: Topology, schedule, policy: str,
                             run_seed: int, upto_round: int) -> Topology:
    """Reconstruct the repaired adjacency at a resume point.

    A checkpoint at round ``C`` reflects every strike with round
    ``r < C`` (the engine fires events at the top of the chunk loop and
    prunes strictly-past events on resume).  Replaying those rounds in
    order — kills, revives, repair, partition rule, exactly as the live
    driver batches them — reproduces the live topology sequence
    bitwise, because the repair rng is keyed per event round rather
    than threaded through the run.
    """
    # delegates to the unified event engine with an empty edge-event
    # plan: the replay rounds are then exactly the strike rounds, repair
    # and partition fire at each — bitwise the pre-engine loop
    from gossipprotocol_tpu_torch.events import engine as events_engine
    from gossipprotocol_tpu_torch.events.plan import EventPlan

    validate_policy(policy)
    if policy == "off":
        return topo
    return events_engine.replay_topology_events(
        topo, schedule, EventPlan(), policy, run_seed, upto_round)
