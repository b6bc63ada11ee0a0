"""Topology representation: CSR neighbor arrays (host side, numpy).

A copy of ``gossipprotocol_tpu/topology/base.py`` for the port: a
topology is a pure value, a compressed-sparse-row adjacency over node
indices. The *full* topology is implicit (never materialized).

:func:`csr_from_edges` builds through the native library
(``native.csr_build``, a byte copy of the JAX package's ``graphgen.cpp``)
unless ``GOSSIP_TPU_NATIVE=0`` asks for the numpy branch; both give the
same canonical CSR. The difference from the JAX package's module is on a
path this port does not run yet: the streamed out-of-core build is not
ported — :func:`csr_from_edge_chunks` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """A static undirected neighbor structure over ``num_nodes`` nodes.

    Attributes:
      kind: builder name ("line", "full", "3D", "imp3D", "erdos_renyi",
        "power_law", "small_world").
      num_nodes: number of nodes actually in the graph (the 3D builders
        round up to the next perfect cube).
      offsets: int32[num_nodes + 1] CSR row offsets, or None for implicit
        topologies.
      indices: int32[num_edges * 2] CSR column indices (each undirected
        edge appears once per endpoint), or None for implicit topologies.
      implicit_full: if True the graph is the complete graph K_n.
      asymmetric: reference-quirk builds with directed/self/duplicate
        entries; the fanout-all deliveries refuse them.
    """

    kind: str
    num_nodes: int
    offsets: Optional[np.ndarray]
    indices: Optional[np.ndarray]
    implicit_full: bool = False
    asymmetric: bool = False

    def __post_init__(self):
        if self.implicit_full:
            if self.offsets is not None or self.indices is not None:
                raise ValueError("implicit_full topology must not carry CSR arrays")
            return
        if self.offsets is None or self.indices is None:
            raise ValueError("explicit topology requires offsets and indices")
        if self.offsets.shape != (self.num_nodes + 1,):
            raise ValueError(
                f"offsets shape {self.offsets.shape} != ({self.num_nodes + 1},)"
            )
        if self.offsets[0] != 0 or self.offsets[-1] != len(self.indices):
            raise ValueError("offsets must span indices exactly")

    @property
    def degree(self) -> np.ndarray:
        """int32[num_nodes] per-node neighbor count."""
        if self.implicit_full:
            return np.full(self.num_nodes, self.num_nodes - 1, dtype=np.int32)
        return np.diff(self.offsets).astype(np.int32)

    @property
    def num_directed_edges(self) -> int:
        if self.implicit_full:
            return self.num_nodes * (self.num_nodes - 1)
        return int(len(self.indices))

    # builders whose output is connected for every input
    _CONNECTED_KINDS = frozenset({"line", "3D", "imp3D", "power_law"})
    _UNSET = object()

    def birth_alive(self):
        """bool[num_nodes] mask of the largest connected component, or
        None when that is every node (majority-partition semantics: a
        minority component can never agree with the majority). Cached on
        the instance; kinds connected by construction skip the pass."""
        cached = self.__dict__.get("_birth_alive_cache", Topology._UNSET)
        if cached is not Topology._UNSET:
            return cached
        if self.implicit_full or self.kind in Topology._CONNECTED_KINDS:
            result = None
        else:
            alive = kill_disconnected(
                self, np.ones(self.num_nodes, dtype=bool))
            result = None if alive.all() else alive
        if result is not None:
            # the cache hands out the same array to every caller
            result.setflags(write=False)
        object.__setattr__(self, "_birth_alive_cache", result)
        return result

    def validate(self) -> None:
        """Structural sanity checks (the CLI's ``--check``): raises
        AssertionError, as the JAX package's ``assert`` statements do, and
        under ``python -O`` too."""
        def need(cond, msg):
            if not cond:
                raise AssertionError(msg)

        if self.implicit_full:
            need(self.num_nodes >= 2, "full topology needs >= 2 nodes")
            return
        n = self.num_nodes
        need((np.diff(self.offsets) >= 0).all(), "offsets must be monotone")
        if len(self.indices):
            need(self.indices.min() >= 0 and self.indices.max() < n,
                 "neighbor index out of range")
        # no self-loops — except for asymmetric (reference-quirk) builds,
        # whose extra-neighbor draw can land on self (Program.fs:260):
        # --check stays usable on a topology the same CLI builds and runs
        if not self.asymmetric:
            row = np.repeat(np.arange(n, dtype=np.int64),
                            np.diff(self.offsets))
            need(not (row == self.indices).any(), "self-loop present")


def kill_disconnected(topo: Topology, alive: np.ndarray) -> np.ndarray:
    """Keep only the largest alive connected component; everything else
    is marked dead (copy of ``gossipprotocol_tpu.utils.faults
    .kill_disconnected``). If the largest component has fewer than 2
    nodes, everyone is marked dead. Majority-partition semantics, applied
    at birth and after every strike batch (``events/engine.py``)."""
    alive = np.asarray(alive, dtype=bool).copy()
    if topo.implicit_full:
        # any two alive nodes are neighbors: one component by definition
        if alive.sum() < 2:
            alive[:] = False
        return alive
    from scipy import sparse
    from scipy.sparse import csgraph

    n = topo.num_nodes
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(topo.offsets))
    col = np.asarray(topo.indices, dtype=np.int64)
    live = alive[row] & alive[col]
    g = sparse.csr_matrix(
        (np.ones(int(live.sum()), dtype=np.int8), (row[live], col[live])),
        shape=(n, n),
    )
    _, labels = csgraph.connected_components(g, directed=False)
    sizes = np.bincount(labels[alive]) if alive.any() else np.zeros(1, int)
    if sizes.size == 0 or sizes.max() < 2:
        alive[:] = False
        return alive
    return alive & (labels == int(sizes.argmax()))


def csr_from_edges(num_nodes: int, edges: np.ndarray, kind: str) -> Topology:
    """Build a symmetric CSR Topology from an undirected edge list [E, 2].

    Deduplicates repeated edges and drops self-loops so every builder
    yields a simple graph. The CSR is *canonical* — each row's neighbors
    sorted ascending — so the native and numpy paths, and the JAX
    package's build of the same edge multiset, give the same bytes. An
    edge outside ``[0, num_nodes)`` raises on the native path.
    """
    if num_nodes > 2**31 - 1:
        raise ValueError(
            f"num_nodes={num_nodes} exceeds int32 CSR index range"
        )
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    # past int32 range of the symmetrized count the native library's
    # buffers are not trusted (C int arithmetic): the numpy path, int64
    # throughout, builds it (the JAX package's rule)
    built = None
    if len(edges) * 2 < 2**31:
        from gossipprotocol_tpu_torch import native

        built = native.csr_build(num_nodes, edges[:, 0], edges[:, 1])
    if built is not None:
        offsets, indices = built
    else:
        edges = edges[edges[:, 0] != edges[:, 1]]
        # symmetrize: each undirected edge contributes both directions
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        # canonical order (src, dst) ascending, dedup directed pairs
        key = np.unique(src * np.int64(num_nodes) + dst)
        src = key // num_nodes
        dst = key % num_nodes
        counts = np.bincount(src, minlength=num_nodes)
        offsets = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        indices = dst.astype(np.int32)
    # offsets compact to int32 when the directed-edge count allows it
    otype = np.int32 if len(indices) < 2**31 else np.int64
    return Topology(
        kind=kind,
        num_nodes=num_nodes,
        offsets=offsets.astype(otype),
        indices=indices,
    )


def csr_from_edge_chunks(num_nodes: int, chunks, kind: str,
                         memory_budget: Optional[int] = None,
                         num_buckets: int = 8) -> Topology:
    """The streamed out-of-core build is not yet ported."""
    raise NotImplementedError(
        "csr_from_edge_chunks (the streamed topology build) is not yet "
        "ported to the PyTorch package")
