"""Topology builders (a copy of ``gossipprotocol_tpu/topology/builders.py``).

Pure functions replacing the reference's actor-wiring match block
(``Program.fs:178-279``): each returns a :class:`Topology` (CSR neighbor
arrays) instead of delivering ``NeighbourRef`` messages to live actors.

The four reference topologies keep the reference's *shape rules*:

* ``line``  — path graph; endpoints have one neighbor (``Program.fs:184-189``).
* ``full``  — complete graph; represented implicitly, never materialized
  (the reference materializes O(n²) ref arrays, ``Program.fs:211-216``).
* ``3D``    — node count rounded **up** to the next perfect cube
  ``ceil(cbrt n)**3`` and wired as a 6-connected lattice via
  ``i*g² + j*g + k`` index arithmetic (``Program.fs:239-257``).
* ``imp3D`` — 3D plus one uniform-random extra neighbor per node
  (``Program.fs:258-260``). Divergence from the reference, documented: the
  extra neighbor here is always a proper non-self node drawn over the whole
  index range (the reference's ``Random().Next(0, nodes-1)`` excludes the two
  highest indices and may pick self or duplicate a lattice neighbor — an
  off-by-one quirk, not a capability). ``--semantics reference`` runs build
  the quirk itself (:func:`build_imp3d_reference_quirks`) and the
  reference's extra, isolated actor (:func:`add_isolated_rows`).

Two additional random families, per the BASELINE.json north-star configs
("10M-node push-sum on Erdős–Rényi / power-law graphs"):

* ``erdos_renyi`` — G(n, M) with M = avg_degree·n/2 sampled edges.
* ``power_law``   — preferential-attachment (Barabási–Albert) graph, built
  with the vectorized repeated-endpoint trick so 10M-node graphs build in
  seconds on the host.
"""

from __future__ import annotations

import numpy as np

from gossipprotocol_tpu_torch.topology.base import Topology, csr_from_edges
from gossipprotocol_tpu_torch.utils.prng import uniform_int


def build_line(num_nodes: int) -> Topology:
    """Path graph 0—1—…—(n−1)."""
    if num_nodes < 2:
        raise ValueError("line topology needs >= 2 nodes")
    a = np.arange(num_nodes - 1, dtype=np.int64)
    edges = np.stack([a, a + 1], axis=1)
    return csr_from_edges(num_nodes, edges, kind="line")


def build_full(num_nodes: int) -> Topology:
    """Complete graph K_n, implicit (sampled, never materialized)."""
    if num_nodes < 2:
        raise ValueError("full topology needs >= 2 nodes")
    return Topology(
        kind="full", num_nodes=num_nodes, offsets=None, indices=None,
        implicit_full=True,
    )


def cube_side(num_nodes: int) -> int:
    """Smallest g with g**3 >= num_nodes (reference's ``ceil(cbrt n)``,
    ``Program.fs:239``)."""
    g = int(round(num_nodes ** (1.0 / 3.0)))
    while g**3 < num_nodes:
        g += 1
    while g > 1 and (g - 1) ** 3 >= num_nodes:
        g -= 1
    return g


def _grid3d_edges(g: int) -> np.ndarray:
    """Directed-once edge list of the 6-connected g×g×g lattice."""
    idx = np.arange(g**3, dtype=np.int64).reshape(g, g, g)
    edges = []
    # +1 step along each axis covers every lattice edge exactly once
    edges.append(np.stack([idx[:-1, :, :].ravel(), idx[1:, :, :].ravel()], axis=1))
    edges.append(np.stack([idx[:, :-1, :].ravel(), idx[:, 1:, :].ravel()], axis=1))
    edges.append(np.stack([idx[:, :, :-1].ravel(), idx[:, :, 1:].ravel()], axis=1))
    return np.concatenate(edges, axis=0)


def build_grid3d(num_nodes: int) -> Topology:
    """6-connected 3-D lattice on ``ceil(cbrt n)**3`` nodes (rounded up,
    mirroring ``Program.fs:239-240``)."""
    g = cube_side(num_nodes)
    n = g**3
    topo = csr_from_edges(n, _grid3d_edges(g), kind="3D")
    return topo


def build_imp3d(num_nodes: int, seed: int = 0) -> Topology:
    """3-D lattice + one uniform-random extra neighbor per node
    (``Program.fs:258-260``; see module docstring for the documented
    divergence from the reference's off-by-one range).

    """
    g = cube_side(num_nodes)
    n = g**3
    src = np.arange(n, dtype=np.int64)
    r = uniform_int(seed, src, n - 1)
    extra_dst = r + (r >= src)  # uniform over [0, n) \ {i}
    extra = np.stack([src, extra_dst], axis=1)
    edges = np.concatenate([_grid3d_edges(g), extra], axis=0)
    topo = csr_from_edges(n, edges, kind="imp3D")
    return topo


def build_imp3d_reference_quirks(num_nodes: int, seed: int = 0) -> Topology:
    """imp3D exactly as the reference wires it (``Program.fs:258-260``).

    Three deliberate differences from :func:`build_imp3d`, each a quirk
    of ``Random().Next(0, nodes-1)`` on the already-cube-rounded count:

      * the extra neighbor is **directed** — only the drawing node gets
        it in its array; the target does not learn about the drawer;
      * the draw range is ``[0, n-1)`` — the top lattice index ``n-1``
        (and the unwired ``n``-th actor) can never be drawn;
      * no self/duplicate exclusion — the extra may equal the node
        itself (a self-loop) or repeat a lattice neighbor (doubling that
        neighbor's draw probability, as the reference's 7-entry array
        does).

    The returned CSR therefore carries one appended (possibly duplicate
    or self) entry per row and is marked ``asymmetric`` so the
    symmetry-dependent fast paths stay off.
    """
    base = build_grid3d(num_nodes)
    n = base.num_nodes
    src = np.arange(n, dtype=np.int64)
    extra = uniform_int(seed, src, max(n - 1, 1))  # [0, n-1): off-by-one
    off = np.asarray(base.offsets, np.int64)
    idx = np.asarray(base.indices)
    new_off = off + np.arange(n + 1, dtype=np.int64)
    new_idx = np.empty(len(idx) + n, dtype=idx.dtype)
    keep = np.ones(len(new_idx), bool)
    ends = new_off[1:] - 1                      # appended slot per row
    keep[ends] = False
    new_idx[keep] = idx
    new_idx[ends] = extra.astype(idx.dtype)
    otype = base.offsets.dtype
    return Topology(
        kind="imp3D",
        num_nodes=n,
        offsets=new_off.astype(otype),
        indices=new_idx,
        asymmetric=True,
    )


def add_isolated_rows(topo: Topology, count: int = 1) -> Topology:
    """Append ``count`` edge-less rows to an explicit topology.

    Renders the reference's N+1-actor population (``Program.fs:169-176``
    spawns actors ``0..nodes``) for the 3D/imp3D arms, whose wiring loop
    covers only the cube — the extra actor exists but never receives a
    neighbor list. Isolated rows are excluded from the convergence
    predicate by the engine's birth-exclusion rule, which reproduces the
    supervisor only ever hearing ``nodes`` Alerts.
    """
    if topo.implicit_full:
        raise ValueError("add_isolated_rows needs an explicit topology")
    off = np.asarray(topo.offsets)
    tail = np.full(count, off[-1], dtype=off.dtype)
    out = Topology(
        kind=topo.kind,
        num_nodes=topo.num_nodes + count,
        offsets=np.concatenate([off, tail]),
        indices=topo.indices,
        asymmetric=topo.asymmetric,
    )
    # pre-populate the birth mask: kinds connected by construction skip
    # the component pass (Topology.birth_alive), which would miss the
    # appended rows and leave the supervisor waiting on them forever
    base_mask = topo.birth_alive()
    if base_mask is None:
        base_mask = np.ones(topo.num_nodes, bool)
    mask = np.concatenate([base_mask, np.zeros(count, bool)])
    # birth_alive() freezes cached masks because the cache hands the same
    # array to every caller; a seeded cache must honor the same contract
    mask.setflags(write=False)
    object.__setattr__(out, "_birth_alive_cache", mask)
    return out


def build_erdos_renyi(num_nodes: int, avg_degree: float = 8.0, seed: int = 0) -> Topology:
    """G(n, M) random graph with M ≈ avg_degree·n/2 undirected edges.

    Uses the G(n, M) model (sample M random pairs) rather than per-pair coin
    flips so 10M-node graphs are O(M) to build. Duplicate pairs and
    self-loops are dropped by ``csr_from_edges``, so realized mean degree is
    marginally below ``avg_degree`` for dense settings.
    """
    if num_nodes < 2:
        raise ValueError("erdos_renyi needs >= 2 nodes")
    m = int(round(avg_degree * num_nodes / 2.0))
    m = min(m, num_nodes * (num_nodes - 1) // 2)
    k = np.arange(m, dtype=np.uint64)
    src = uniform_int(seed, 2 * k, num_nodes)
    dst = uniform_int(seed, 2 * k + 1, num_nodes)
    edges = np.stack([src, dst], axis=1)
    return csr_from_edges(num_nodes, edges, kind="erdos_renyi")


def build_power_law(num_nodes: int, m: int = 4, seed: int = 0) -> Topology:
    """Barabási–Albert preferential-attachment graph (power-law degrees).

    Vectorized chunked construction: a new node's ``m`` targets are drawn
    uniformly from the *endpoint list* of edges created so far (the classic
    repeated-nodes trick — endpoint frequency ∝ degree), with chunks of new
    nodes attaching against the endpoint list frozen at the chunk start.
    This is a standard O(E) approximation of sequential BA that preserves
    the power-law tail while building 10M-node graphs in seconds.
    """
    if num_nodes < m + 1:
        raise ValueError("power_law needs num_nodes > m")

    from gossipprotocol_tpu_torch import native

    # csrc/host/graphgen.cpp draws the identical splitmix64 stream, so
    # both paths give the same graph; GOSSIP_TPU_NATIVE=0 takes numpy
    native_edges = native.ba_edges(num_nodes, m, seed)
    if native_edges is not None:
        return csr_from_edges(num_nodes, native_edges, kind="power_law")

    # seed clique on m+1 nodes
    seed_nodes = np.arange(m + 1, dtype=np.int64)
    si, sj = np.triu_indices(m + 1, k=1)
    edge_src = [seed_nodes[si]]
    edge_dst = [seed_nodes[sj]]
    endpoints = np.concatenate([seed_nodes[si], seed_nodes[sj]])

    start = m + 1
    chunk = max(1024, (num_nodes - start) // 64 or 1)
    draw_counter = 0  # global splitmix counter — in lockstep with C++
    while start < num_nodes:
        stop = min(start + chunk, num_nodes)
        new = np.arange(start, stop, dtype=np.int64)
        # each new node draws m endpoints (∝ degree at chunk start)
        n_draws = len(new) * m
        counters = np.arange(draw_counter, draw_counter + n_draws, dtype=np.uint64)
        draw_counter += n_draws
        draws = endpoints[uniform_int(seed, counters, len(endpoints))]
        src = np.repeat(new, m)
        dst = draws
        edge_src.append(src)
        edge_dst.append(dst)
        endpoints = np.concatenate([endpoints, src, dst])
        start = stop

    edges = np.stack([np.concatenate(edge_src), np.concatenate(edge_dst)], axis=1)
    topo = csr_from_edges(num_nodes, edges, kind="power_law")
    # BA can leave duplicate draws collapsed; isolated nodes are impossible
    # (every new node keeps >= 1 distinct target since draws include at
    # least one endpoint != itself).
    return topo


def build_small_world(
    num_nodes: int, k: int = 6, beta: float = 0.1, seed: int = 0
) -> Topology:
    """Watts–Strogatz small-world graph (beyond-reference family).

    The classic interpolation between the reference's two extremes: a ring
    lattice (``beta=0`` — line-like diameter, slow gossip like the
    reference's ``line``) and a random graph (``beta=1`` — log diameter,
    fast gossip like ``full``/``imp3D``); small ``beta`` gives the
    small-world regime (high clustering, short paths) classic gossip
    papers study. Built vectorized: the ring lattice's k/2 forward chords
    per node, each rewired to a uniform random endpoint with probability
    ``beta`` using the same counter-based splitmix64 stream as the other
    random builders (deterministic per seed, O(E) host work at 10M
    nodes). Rewired chords that land on self, and duplicate chords, are
    dropped by ``csr_from_edges`` — standard WS semantics keep the edge
    count ≈ n·k/2.
    """
    if k < 2 or k % 2:
        raise ValueError(
            "small_world k must be a positive even integer (the ring "
            "lattice places k/2 chords per side) — got "
            f"{k!r}; silently rounding odd k down would record the wrong "
            "parameter against results"
        )
    half = k // 2
    if num_nodes < k + 2:
        raise ValueError("small_world needs num_nodes >= k + 2")
    if not 0.0 <= beta <= 1.0:
        raise ValueError("small_world beta must be in [0, 1]")
    n = num_nodes
    src = np.repeat(np.arange(n, dtype=np.int64), half)
    offset = np.tile(np.arange(1, half + 1, dtype=np.int64), n)
    dst = (src + offset) % n
    e = src.shape[0]
    counters = np.arange(2 * e, dtype=np.uint64)
    # coin in [0, 2^32) against a fixed-point threshold: exact for the
    # beta=0 / beta=1 endpoints, 2^-32 quantization between
    coin = uniform_int(seed, counters[:e], 2**32)
    rewired = coin < int(round(beta * 2**32))
    new_dst = uniform_int(seed, counters[e:], n)
    dst = np.where(rewired, new_dst, dst)
    edges = np.stack([src, dst], axis=1)
    return csr_from_edges(num_nodes, edges, kind="small_world")
