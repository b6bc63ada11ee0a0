"""Counter-based draws and the random-neighbour pick (port of
``gossipprotocol_tpu/protocols/sampling.py``, single-card rows).

Node ``i``'s draw in round ``r`` is a threefry-2x32 hash of its global id
under the round key ``fold_in(key(seed), r)``, so a run is replayed bit
for bit from its seed, on any device. The hash is the JAX package's
``jax.extend.random.threefry_2x32`` (rotation constants and key schedule
copied from ``jax/_src/prng.py``, ``_threefry2x32_lowering``), written in
PyTorch: PyTorch has no full uint32 arithmetic, so every word is an int64
holding a uint32 value, masked with ``& 0xFFFFFFFF`` after each add and
rotate. ``jax_threefry_partitionable`` changes ``split`` and
``random_bits`` only; neither the hash nor ``fold_in`` reads it. The
scalar ``jax.random.randint`` of the reference walk reads both, so
:func:`randint` takes the setting (default: jax 0.9's, True).

Topology arrays are runtime arguments: :class:`DenseNeighbors` (a padded
``[n, max_degree]`` table, bounded-degree graphs), :class:`CSRNeighbors`
(hub graphs) or ``None`` for the implicit complete graph.

Sweep lanes (``sweep/engine.py``): a key may be ``[B, 2]``, one per lane,
and then every draw gains a leading ``[B]`` dimension; lane ``i``'s words
are those of its standalone run under key ``i``. A ``[2]`` key runs the
single-run path unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gossipprotocol_tpu_torch.ops.build import resolve_device
from gossipprotocol_tpu_torch.topology.base import Topology

_U32 = 0xFFFFFFFF
# jax/_src/prng.py, _threefry2x32_lowering: the two rotation schedules
# and the key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# jax 0.9's default of ``jax_threefry_partitionable``
THREEFRY_PARTITIONABLE = True

# Domain-separation constant folded into the round key before the drop
# draws (the JAX package's): without it node i's drop coin would be the
# same u32 stream as its neighbour pick.
LOSS_FOLD = 0x10553

# Above this max degree the dense table stops paying; CSR covers hubs.
DENSE_MAX_DEGREE = 32


class CSRNeighbors(NamedTuple):
    starts: torch.Tensor   # int64 [N]  offsets[:-1]
    degree: torch.Tensor   # int32 [N]
    indices: torch.Tensor  # int32 [E]


class DenseNeighbors(NamedTuple):
    """``table[i, k]`` = k-th neighbour of row i; slots k >= degree[i]
    hold 0 and are never drawn."""

    table: torch.Tensor    # int32 [N, max_degree]
    degree: torch.Tensor   # int32 [N]


class InvertedDense(NamedTuple):
    """:class:`DenseNeighbors` plus the gather-inversion table
    (``protocols/gossip.py`` :func:`reverse_slot_table`): ``rev[i, k]``
    is the slot neighbour ``table[i, k]`` must draw to hit i. (The JAX
    package also carries each neighbour's degree, ``deg_nbr``, to hash
    every table entry; :func:`recomputed_hits` hashes each node once
    with its own degree instead.)"""

    table: torch.Tensor    # int32 [N, max_degree]
    degree: torch.Tensor   # int32 [N]
    rev: torch.Tensor      # int8 [N, max_degree]


# ---- threefry-2x32 -----------------------------------------------------

def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _U32) | (x >> (32 - r))


def threefry2x32_words(k0, k1, x0: torch.Tensor,
                       x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry-2x32 block function (20 rounds) of the counter words
    ``(x0, x1)`` under the key ``(k0, k1)``: int64 tensors (or ints)
    holding uint32 values; returns the two output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _U32
    x1 = (x1 + k1) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _U32
    return x0, x1


def _key_words(key: torch.Tensor):
    """``(k0, k1)`` of a key: scalars for a ``[2]`` key, ``[B, 1]``
    columns for ``[B, 2]`` lane keys (broadcasting against ``[n]`` ids or
    ``[B, m]`` counters to ``[B, ...]``)."""
    if key.dim() == 1:
        return key[0], key[1]
    return key[:, 0:1], key[:, 1:2]


def key_data(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` as int64 [2] on
    ``device``: a 32-bit seed pads to ``(0, seed mod 2**32)`` (the JAX
    package runs without x64, so its seed is 32 bits)."""
    return torch.tensor([0, int(seed) & _U32], dtype=torch.int64,
                        device=resolve_device(device))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter words
    ``(0, data)``; ``data`` an int or an integer tensor of any shape
    (then one key per element, shape ``[*data.shape, 2]``). Lane keys
    ``[B, 2]`` take a scalar ``data`` (``[B, 2]`` out) or ``[B, ...]``
    data (``[B, ..., 2]`` out)."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _U32
    if key.dim() == 1:
        y0, y1 = threefry2x32_words(key[0], key[1], torch.zeros_like(d), d)
    else:
        shape = (-1,) + (1,) * max(d.dim() - 1, 0)
        y0, y1 = threefry2x32_words(key[:, 0].reshape(shape),
                                    key[:, 1].reshape(shape),
                                    torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def round_keys(base_key: torch.Tensor, first_round: torch.Tensor,
               count: int) -> torch.Tensor:
    """``[count, 2]``: ``fold_in(base_key, r)`` for the rounds
    ``first_round .. first_round + count - 1`` (``first_round`` a device
    scalar), hashed in one pass instead of one small hash per round.
    Lane keys ``[B, 2]`` with a ``[B]`` ``first_round`` give ``[count, B,
    2]``: round i of lane b is ``fold_in(base_key[b], first_round[b] +
    i)``."""
    steps = torch.arange(count, dtype=torch.int64, device=base_key.device)
    if base_key.dim() == 1:
        return fold_in(base_key, first_round.to(torch.int64) + steps)
    rounds = first_round.to(torch.int64)[:, None] + steps[None, :]
    return fold_in(base_key, rounds).transpose(0, 1)


def per_node_randint(key: torch.Tensor, gids: torch.Tensor,
                     maxval) -> torch.Tensor:
    """One draw in ``[0, maxval_i)`` per global node id: the threefry
    hash of ``(gid, gid)`` under ``key`` (the JAX package's ``[g, g]``
    pairing, which makes a draw a function of the id alone), then
    ``u % maxval`` in uint32. Returns int32."""
    g = gids.to(torch.int64) & _U32
    u, _ = threefry2x32_words(*_key_words(key), g, g)
    mx = torch.as_tensor(maxval, device=g.device).to(torch.int64) & _U32
    return (u % mx).to(torch.int32)


def split2(key: torch.Tensor,
           partitionable: bool = THREEFRY_PARTITIONABLE) -> torch.Tensor:
    """``jax.random.split(key)`` (two keys) for keys ``[..., 2]``:
    ``[..., 2, 2]``. Partitionable: the hash of the counters ``(0, 0)``
    and ``(0, 1)``, one key each. Original: the hash of the counter pairs
    ``(0, 2)`` and ``(1, 3)`` (``iota(4)`` split in halves), the first
    words making key 0 and the second words key 1."""
    k0, k1 = key[..., 0:1], key[..., 1:2]
    if partitionable:
        y0, y1 = threefry2x32_words(
            k0, k1, torch.zeros(2, dtype=torch.int64, device=key.device),
            torch.arange(2, dtype=torch.int64, device=key.device))
        return torch.stack([y0, y1], dim=-1)
    y0, y1 = threefry2x32_words(
        k0, k1, torch.arange(2, dtype=torch.int64, device=key.device),
        torch.arange(2, 4, dtype=torch.int64, device=key.device))
    return torch.stack([y0, y1], dim=-2)


def randint_words(key: torch.Tensor,
                  partitionable: bool = THREEFRY_PARTITIONABLE):
    """The two 32-bit words ``jax.random.randint(key, (), ...)`` draws for
    keys ``[..., 2]``: ``(higher, lower)``, the 32 random bits of each of
    ``split(key)``'s two keys (partitionable: the XOR of the two words of
    the hash of ``(0, 0)``; original: its first word)."""
    sub = split2(key, partitionable)
    zero = torch.zeros_like(sub[..., 0])
    y0, y1 = threefry2x32_words(sub[..., 0], sub[..., 1], zero, zero)
    bits = y0 ^ y1 if partitionable else y0
    return bits[..., 0], bits[..., 1]


def randint_from_words(higher: torch.Tensor, lower: torch.Tensor,
                       maxval) -> torch.Tensor:
    """``jax.random.randint``'s draw in ``[0, maxval)`` from its two words
    (``jax/_src/random.py``, ``_randint``, for 32-bit ints): a span of
    ``maxval`` (1 when ``maxval <= 0``), ``2**32 mod span`` as
    ``(2**16 mod span)**2 mod span``, then ``((higher mod span) *
    multiplier + lower mod span) mod span``, every product and sum wrapped
    to uint32. int64 words holding uint32 values; broadcasts; returns
    int64. Divides only by tensors."""
    span = torch.clamp(torch.as_tensor(maxval, device=higher.device).to(
        torch.int64), min=1)
    mult = torch.remainder(torch.full_like(span, 1 << 16), span)
    mult = torch.remainder((mult * mult) & _U32, span)
    off = (torch.remainder(higher, span) * mult) & _U32
    off = (off + torch.remainder(lower, span)) & _U32
    return torch.remainder(off, span)


def randint(key: torch.Tensor, maxval,
            partitionable: bool = THREEFRY_PARTITIONABLE) -> torch.Tensor:
    """``jax.random.randint(key, (), 0, maxval)`` for keys ``[..., 2]``
    (one draw per key; ``maxval`` an int or a tensor broadcasting against
    the keys' batch shape), bitwise under either
    ``jax_threefry_partitionable`` setting. Returns int32."""
    hi, lo = randint_words(key, partitionable)
    return randint_from_words(hi, lo, maxval).to(torch.int32)


# ---- host tables and their placement ------------------------------------

def dense_table(topo: Topology):
    """Host-side padded ``[N, max_deg]`` int32 table + int32 degree."""
    deg = topo.degree.astype(np.int32)
    maxd = int(deg.max()) if deg.size else 1
    table = np.zeros((topo.num_nodes, max(maxd, 1)), dtype=np.int32)
    mask = np.arange(table.shape[1])[None, :] < deg[:, None]
    table[mask] = topo.indices
    return table, deg


def use_dense(topo: Topology) -> bool:
    """The dense table when the max degree is at most
    :data:`DENSE_MAX_DEGREE` (the JAX package's rule; its
    ``GOSSIP_TPU_DENSE`` switch is not ported — ``device_topology(dense=
    False)`` forces CSR)."""
    return not topo.implicit_full and dense_for_degree(
        int(topo.degree.max() if topo.degree.size else 0))


def dense_for_degree(max_degree: int) -> bool:
    """:func:`use_dense`'s rule from the max degree alone (the capacity
    planner's, before any graph exists)."""
    return int(max_degree) <= DENSE_MAX_DEGREE


def device_topology(topo: Topology, dense: Optional[bool] = None,
                    device="cuda"):
    """Topology -> tensors on ``device``; None for the implicit complete
    graph. ``dense`` forces the dense table (True) or CSR (False)."""
    dev = resolve_device(device)
    if topo.implicit_full:
        return None
    if dense is None:
        dense = use_dense(topo)
    if dense:
        table, deg = dense_table(topo)
        return DenseNeighbors(table=torch.from_numpy(table).to(dev),
                              degree=torch.from_numpy(deg).to(dev))
    return CSRNeighbors(
        starts=torch.from_numpy(topo.offsets[:-1].astype(np.int64)).to(dev),
        degree=torch.from_numpy(topo.degree.astype(np.int32)).to(dev),
        indices=torch.from_numpy(topo.indices.astype(np.int32)).to(dev),
    )


# ---- the draws ------------------------------------------------------------

def _ids(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def node_slots(degree: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Every node's slot draw ``randint(key, i, max(degree_i, 1))``."""
    return per_node_randint(key, _ids(degree.shape[0], degree.device),
                            torch.clamp(degree, min=1))


def recomputed_hits(nbrs: InvertedDense, key: torch.Tensor) -> torch.Tensor:
    """``hit[i, k]``: does neighbour ``table[i, k]``'s draw land on row i?

    The JAX package hashes every table entry (``[rows * max_deg]`` ids,
    each with its neighbour's degree). A node's draw is a function of its
    id and degree alone, so the port hashes each node once and gathers
    the draws at the table: the same values, max_deg times fewer hashes.
    Slots ``k >= degree[i]`` are masked off."""
    table = nbrs.table
    maxd = table.shape[1]
    slot = node_slots(nbrs.degree, key)
    slot = slot[table] if slot.dim() == 1 else slot[:, table]
    col = torch.arange(maxd, dtype=torch.int32, device=table.device)
    return (slot == nbrs.rev.to(torch.int32)) & (
        col[None, :] < nbrs.degree[:, None])


def sample_neighbors(nbrs, n: int, key: torch.Tensor):
    """One uniform-random neighbour per node: ``(targets int32 [n], valid
    bool [n])``. Isolated rows are invalid, their target pinned to 0.

    Three branches, each drawing with the JAX package's convention so the
    picks are bitwise its picks:

    * dense table: slot in ``[0, max(deg, 1))``, then ``table[i, slot]``
      (a gather; the JAX package's one-hot sum picks the same entry);
    * implicit complete graph (``nbrs is None``): a draw in ``[0, n-1)``,
      draws ``>= i`` shifted up by one (never itself);
    * CSR: ``indices[clip(starts + slot, 0, E - 1)]``.
    """
    if isinstance(nbrs, (DenseNeighbors, InvertedDense)):
        deg = nbrs.degree
        slot = node_slots(deg, key)
        if slot.dim() == 1:
            targets = torch.gather(nbrs.table, 1, slot.long()[:, None])[:, 0]
        else:  # lanes: [B, n] slots into the one shared table
            maxd = nbrs.table.shape[1]
            flat = _ids(n, key.device) * maxd + slot.long()
            targets = nbrs.table.reshape(-1)[flat]
        valid = deg > 0
        return torch.where(valid, targets, torch.zeros_like(targets)), valid
    if nbrs is None:
        gids = _ids(n, key.device)
        r = per_node_randint(key, gids, n - 1)
        targets = r + (r.to(torch.int64) >= gids).to(torch.int32)
        return targets, torch.ones(n, dtype=torch.bool, device=key.device)
    deg = nbrs.degree
    slot = node_slots(deg, key)
    max_slot = max(nbrs.indices.shape[0] - 1, 0)
    flat = torch.clamp(nbrs.starts + slot.to(torch.int64), 0, max_slot)
    targets = nbrs.indices[flat]
    valid = deg > 0
    return torch.where(valid, targets, torch.zeros_like(targets)), valid


def loss_probability(rnd: torch.Tensor, windows) -> torch.Tensor:
    """Active drop probability at round ``rnd`` (a float32 device
    scalar): overlapping windows ``(start, stop, prob)`` compose as
    independent drops, survive = Π (1 − pₖ·activeₖ), in float32, each
    factor ``1 - prob`` rounded from the double once, as the JAX
    package's ``jnp.float32(1.0 - prob)``. Sweep lanes pass ``rnd`` as
    ``[B]`` rounds and a window's ``prob`` as a float32 ``[B]`` tensor of
    the SURVIVE factors ``float32(1 - p)``, pre-complemented on the host
    in the same one rounding (the JAX package's traced entry); the result
    is then ``[B]``."""
    survive = torch.ones((), dtype=torch.float32, device=rnd.device)
    for start, stop, prob in windows:
        active = (rnd >= int(start)) & (rnd < int(stop))
        if isinstance(prob, torch.Tensor):
            survive = survive * torch.where(active, prob,
                                            torch.ones_like(prob))
            continue
        keep = float(np.float32(1.0 - prob))
        survive = survive * torch.where(
            active, torch.full_like(survive, keep), torch.ones_like(survive))
    return 1.0 - survive


def drop_mask(key: torch.Tensor, prob: torch.Tensor, ids: torch.Tensor,
              ids2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-message Bernoulli drops under a loss-folded round key
    (``fold_in(round_key, LOSS_FOLD)``): the threefry hash of the id pair
    ``(ids_i, ids2_i)`` (``(ids_i, ids_i)`` without ``ids2``: the JAX
    package's concatenated ``[a, b]`` layout, whose first output word
    belongs to pair i), dropped where ``float32(u) < prob · 2³²``. The
    uint32 word converts to float32 rounding to nearest even, as XLA's
    ``uitofp`` does, and ``prob · 2³²`` is exact; the mask is a function
    of global ids, so any layout draws the same drops."""
    a = ids.to(torch.int64) & _U32
    b = a if ids2 is None else ids2.to(torch.int64) & _U32
    u, _ = threefry2x32_words(*_key_words(key), a, b)
    thresh = prob.to(torch.float32) * 4294967296.0
    if key.dim() == 2 and thresh.dim() == 1:
        thresh = thresh[:, None]  # one probability a lane
    return u.to(torch.float32) < thresh


def round_drops(key: torch.Tensor, rnd: torch.Tensor, windows,
                n: int) -> torch.Tensor:
    """The fanout-one rounds' drop mask of round ``rnd`` under its round
    key ``key``: one draw per sender id in ``[0, n)``."""
    return drop_mask(fold_in(key, LOSS_FOLD),
                     loss_probability(rnd, windows), _ids(n, key.device))


def index_add_rows(base: torch.Tensor, targets: torch.Tensor,
                   src: torch.Tensor) -> torch.Tensor:
    """``base.index_add_(0, targets, src)``: add message ``i`` onto row
    ``targets[i]`` of ``base``, in place. Sweep lanes (``[B, n]``
    targets, ``base`` ``[B, n, ...]``) add into the flattened ``[B·n,
    ...]`` view at ``lane·n + target``, so on the CPU, which adds in
    source order, each lane's messages land in ascending sender order, as
    in its standalone run."""
    if targets.dim() == 1:
        return base.index_add_(0, targets, src)
    lanes, n = targets.shape
    tail = tuple(base.shape[2:])
    off = torch.arange(lanes, dtype=torch.int64,
                       device=targets.device)[:, None] * n
    flat = (targets.to(torch.int64) + off).reshape(-1)
    base.view((lanes * n,) + tail).index_add_(
        0, flat, src.expand((lanes, n) + tail).reshape((lanes * n,) + tail))
    return base


def lane_param(value, like: torch.Tensor):
    """A round parameter against ``like`` (``[B, n, ...]``): a sweep
    lane's ``[B]`` tensor viewed as ``[B, 1, ...]``; a Python number as
    it is."""
    if not isinstance(value, torch.Tensor):
        return value
    return value.view((-1,) + (1,) * (like.dim() - 1))


def node_sum(x: torch.Tensor, lanes: bool) -> torch.Tensor:
    """Sum over the node axis: everything for a single run, the last axis
    (one sum a lane) for sweep lanes."""
    return torch.sum(x, dim=-1) if lanes else torch.sum(x)


def send_valid_mask(nbrs, n: int) -> Optional[torch.Tensor]:
    """Rows that can emit a message (degree > 0); None for the implicit
    complete graph, where every row can."""
    return None if nbrs is None else nbrs.degree > 0
