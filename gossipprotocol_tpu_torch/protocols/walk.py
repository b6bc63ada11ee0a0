"""The reference's actual push-sum dynamics: a single-token random walk
(port of ``gossipprotocol_tpu/protocols/walk.py``).

Each ``MainPushSum`` handler of the reference sends exactly one message
(``Program.fs:128``), so exactly one ``(s, w)`` message exists at any
time; with the commit-before-compare bug (the delta is identically zero,
``Program.fs:109-114``) and ``count`` starting at 1 (``Program.fs:67``),
a node converges on receiving its second message. One engine round is
one token hop, so a run's ``rounds`` is a hop count.

Three bodies of the same hop:

* :func:`pushsum_walk_round` — the JAX function's counterpart, one hop
  of any :class:`WalkState` (the parity tests step it hop by hop);
* :func:`walk_chunk_plain` — a chunk of hops between two host fetches as
  PyTorch operations: the chunk hashes its hops' draws in one pass first
  (for every span the graph's degrees can give), then each hop, about 30
  small operations on one-element tensors, picks its draw. It is the
  plain version of the kernel below and the CPU path;
* ``ops/walk.py`` :func:`~gossipprotocol_tpu_torch.ops.walk.walk_chunk` —
  the same chunk as ONE launch of ``csrc/walk.cu`` (one thread walks,
  the block hashes the next tile of hops' words meanwhile), the JAX
  package's on-device ``while_loop`` over hops.

:func:`make_walk_chunk_runner` is the engine's: the kernel for CUDA
tensors, the plain version for CPU ones.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gossipprotocol_tpu_torch.ops.build import resolve_device
from gossipprotocol_tpu_torch.protocols.sampling import (
    CSRNeighbors, DenseNeighbors, InvertedDense, fold_in, randint,
    randint_from_words, randint_words, round_keys,
)


class WalkState(NamedTuple):
    """Per-node arrays mirror ``PushSumState``; three scalars carry the
    token: its position and the in-flight ``(s, w)`` message."""

    s: torch.Tensor           # float32 [N]
    w: torch.Tensor           # float32 [N]
    ratio: torch.Tensor       # float32 [N]  s/w
    streak: torch.Tensor      # int32 [N]  the reference's ``count`` (from 1)
    converged: torch.Tensor   # bool [N]
    alive: torch.Tensor       # bool [N]
    round: torch.Tensor       # int32 scalar — hop count
    cur: torch.Tensor         # int32 scalar — token position
    msg_s: torch.Tensor       # float32 scalar — in-flight message
    msg_w: torch.Tensor       # float32 scalar


def _ratio(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return s / torch.clamp(w, min=1e-30)


def pushsum_walk_init(num_nodes: int, start_node: int,
                      value_mode: str = "scaled", device="cuda") -> WalkState:
    """Initial walk state, the seed message already emitted: the start
    node halves its own pair and the token carries the other half (no
    receipt is counted there). ``value_mode`` as in ``pushsum_init``."""
    if value_mode not in ("scaled", "index"):
        raise ValueError("value_mode must be 'scaled' or 'index'")
    dev = resolve_device(device)
    i = torch.arange(num_nodes, dtype=torch.float32, device=dev)
    s = i / torch.full_like(i, num_nodes) if value_mode == "scaled" else i
    w = torch.ones(num_nodes, dtype=torch.float32, device=dev)
    s[start_node] *= 0.5
    w[start_node] *= 0.5
    return WalkState(
        s=s, w=w, ratio=_ratio(s, w),
        streak=torch.ones(num_nodes, dtype=torch.int32, device=dev),
        converged=torch.zeros(num_nodes, dtype=torch.bool, device=dev),
        alive=torch.ones(num_nodes, dtype=torch.bool, device=dev),
        round=torch.zeros((), dtype=torch.int32, device=dev),
        cur=torch.tensor(start_node, dtype=torch.int32, device=dev),
        msg_s=s[start_node].clone(), msg_w=w[start_node].clone(),
    )


def draw_next(nbrs, n: int, key: torch.Tensor, cur: torch.Tensor):
    """``(target, movable)`` for the token holder ``cur`` (int32 scalar):
    one ``jax.random.randint`` draw under the hop's key. Implicit complete
    graph: uniform over ``[0, n) \\ {cur}``; a table: a uniform slot below
    ``max(degree, 1)``. ``movable`` is False for a holder with no
    neighbour (a trapped walk)."""
    c = cur.reshape(1).long()
    if nbrs is None:
        t = randint(key, n - 1)
        t = torch.where(t >= cur, t + 1, t)
        return t.to(torch.int32), torch.tensor(n > 1, device=key.device)
    deg = nbrs.degree.index_select(0, c)[0]
    j = randint(key, torch.clamp(deg, min=1)).long()
    if isinstance(nbrs, (DenseNeighbors, InvertedDense)):
        row = nbrs.table.index_select(0, c)[0]
        tgt = row.index_select(0, j.reshape(1))[0]
    else:
        assert isinstance(nbrs, CSRNeighbors)
        p = torch.clamp(nbrs.starts.index_select(0, c)[0] + j, 0,
                        max(nbrs.indices.shape[0] - 1, 0))
        tgt = nbrs.indices.index_select(0, p.reshape(1))[0]
    return tgt.to(torch.int32), deg > 0


def pushsum_walk_round(state: WalkState, nbrs, base_key: torch.Tensor, *,
                       n: int, streak_target: int = 3) -> WalkState:
    """One token hop, ``Program.fs:107-131``: the holder sends to a
    uniform neighbour; an unconverged receiver accumulates, advances
    ``count``, converges at ``count >= streak_target``, halves its pair
    and forwards one half; a converged receiver relays the message
    untouched. A trapped token (no neighbour) changes nothing but the hop
    count. The draw's key is ``fold_in(base_key, state.round)``."""
    key = fold_in(base_key, state.round)
    tgt, movable = draw_next(nbrs, n, key, state.cur)
    t = tgt.reshape(1).long()
    relay = state.converged.index_select(0, t)[0]
    s_t = state.s.index_select(0, t)[0]
    w_t = state.w.index_select(0, t)[0]
    k_t = state.streak.index_select(0, t)[0]
    s_half = (s_t + state.msg_s) * 0.5
    w_half = (w_t + state.msg_w) * 0.5
    count = k_t + 1
    newly = count >= streak_target

    def put(arr, val):
        return arr.index_put((t,), val.reshape(1))

    s_new = torch.where(relay, s_t, s_half)
    w_new = torch.where(relay, w_t, w_half)
    s = put(state.s, s_new)
    w = put(state.w, w_new)
    streak = put(state.streak, torch.where(relay, k_t, count))
    converged = put(state.converged, relay | newly)
    ratio = put(state.ratio, _ratio(s_new, w_new))

    def keep(new, old):
        return torch.where(movable, new, old)

    return WalkState(
        s=keep(s, state.s), w=keep(w, state.w),
        ratio=keep(ratio, state.ratio), streak=keep(streak, state.streak),
        converged=keep(converged, state.converged), alive=state.alive,
        round=state.round + 1, cur=keep(tgt, state.cur),
        msg_s=keep(torch.where(relay, state.msg_s, s_half), state.msg_s),
        msg_w=keep(torch.where(relay, state.msg_w, w_half), state.msg_w),
    )


class WalkDraws:
    """The walk's neighbour pick as a few index operations per hop.

    For a table, every degree class shares one span ``max(degree, 1)``:
    the chunk computes each hop's draw for every distinct span at once
    (``[hops, spans]``), and a hop picks its holder's column. The table is
    flattened (dense ``[n * max_degree]`` or the CSR ``indices``) with each
    row's start, so a hop's target is one gather."""

    def __init__(self, nbrs, n: int, device):
        self.full = nbrs is None
        if self.full:
            self.span = torch.tensor(n - 1, dtype=torch.int64, device=device)
            return
        deg = nbrs.degree.long()
        spans = torch.clamp(deg, min=1)
        self.spans = torch.unique(spans)
        self.cls = torch.searchsorted(self.spans, spans)
        self.movable = deg > 0
        # CSR clips the slot of an edge-less last row, as the JAX gather
        # clamps its index; a dense row always has slot 0
        self.csr = isinstance(nbrs, CSRNeighbors)
        if self.csr:
            self.flat = nbrs.indices.long()
            self.start = nbrs.starts.long()
        else:
            self.flat = nbrs.table.reshape(-1).long()
            self.start = torch.arange(
                deg.shape[0], dtype=torch.int64,
                device=device) * nbrs.table.shape[1]
        self.last = max(self.flat.shape[0] - 1, 0)

    def offsets(self, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
        """Each hop's draw: ``[hops]`` (complete graph) or ``[hops,
        spans]``."""
        if self.full:
            return randint_from_words(hi, lo, self.span)
        return randint_from_words(hi[:, None], lo[:, None],
                                  self.spans[None, :])

    def target(self, off: torch.Tensor, cur: torch.Tensor):
        """``(target [1] int64, movable [1] bool or None)`` for the holder
        ``cur`` ([1] int64) and one hop's draws ``off``."""
        if self.full:
            t = off.reshape(1)
            return t + (t >= cur).long(), None
        j = off.index_select(0, self.cls.index_select(0, cur))
        p = self.start.index_select(0, cur) + j
        if self.csr:
            p = torch.clamp(p, 0, self.last)
        return self.flat.index_select(0, p), self.movable.index_select(0, cur)


def walk_chunk_plain(draws: WalkDraws, state: WalkState,
                     base_key: torch.Tensor, hops: int, quorum: int,
                     streak_target: int) -> WalkState:
    """``hops`` hops of the walk from ``state`` as PyTorch operations,
    each frozen once ``quorum`` rows are settled (converged or not
    alive); the input state is not changed. The plain version of
    ``csrc/walk.cu``.

    Inside the chunk the node state carries one scratch row (index ``n``,
    converged): a hop that must change nothing but the hop count — the
    holder has no neighbour — is sent there, and the relay rule then
    writes back what it read and leaves the token's message as it was.
    The settled count is carried as a device scalar and advanced by the
    hop that converges a node, so no hop reduces over the nodes. Once the
    quorum is met every further hop would be frozen, so the loop stops
    there (one host read of the flag a hop)."""
    dev = base_key.device
    n = state.s.shape[0]
    if hops <= 0:
        return state
    scratch = torch.full((1,), n, dtype=torch.int64, device=dev)
    hi, lo = randint_words(round_keys(base_key, state.round, hops))
    offs = draws.offsets(hi, lo)
    pad = torch.zeros(1, dtype=torch.float32, device=dev)
    sw = torch.stack([torch.cat([state.s, pad]),
                      torch.cat([state.w, pad])], dim=1)
    ratio = torch.cat([state.ratio, pad])
    streak = torch.cat([state.streak,
                        torch.zeros(1, dtype=torch.int32, device=dev)])
    conv = torch.cat([state.converged,
                      torch.ones(1, dtype=torch.bool, device=dev)])
    settled = torch.sum((state.converged | ~state.alive).to(torch.int32))
    active = settled < quorum
    cur = state.cur.reshape(1).long()
    msg = torch.stack([state.msg_s, state.msg_w]).reshape(1, 2)
    rnd = state.round
    for i in range(hops):
        if not bool(active):
            break
        tgt, movable = draws.target(offs[i], cur)
        gate = active if movable is None else movable & active
        tgt = torch.where(gate, tgt, scratch)
        sw_t = sw.index_select(0, tgt)
        k_t = streak.index_select(0, tgt)
        c_t = conv.index_select(0, tgt)
        half = (sw_t + msg) * 0.5
        new_sw = torch.where(c_t[:, None], sw_t, half)
        count = k_t + 1
        newly = count >= streak_target
        sw.index_copy_(0, tgt, new_sw)
        ratio.index_copy_(0, tgt, _ratio(new_sw[:, 0], new_sw[:, 1]))
        streak.index_copy_(0, tgt, torch.where(c_t, k_t, count))
        conv.index_copy_(0, tgt, c_t | newly)
        msg = torch.where(c_t[:, None], msg, half)
        cur = torch.where(gate, tgt, cur)
        rnd = rnd + active
        settled = settled + (newly & ~c_t)
        active = settled < quorum
    return WalkState(
        s=sw[:n, 0].contiguous(), w=sw[:n, 1].contiguous(),
        ratio=ratio[:n], streak=streak[:n], converged=conv[:n],
        alive=state.alive, round=rnd.reshape(()).to(torch.int32),
        cur=cur.reshape(()).to(torch.int32), msg_s=msg[0, 0],
        msg_w=msg[0, 1])


def make_walk_chunk_runner(nbrs, n: int, *, streak_target: int, quorum: int,
                           base_key: torch.Tensor, done_fn,
                           **stats_kw):
    """``chunk(state, nbrs, start_round, round_limit) -> (state, stats)``
    for the walk: ``round_limit - start_round`` hops, each frozen once
    the run is done (``quorum`` settled rows, settled meaning converged or
    not alive), with the engine's ``[round, done]`` stats after.

    On a CUDA device the chunk is one launch of ``csrc/walk.cu``
    (:func:`~gossipprotocol_tpu_torch.ops.walk.walk_chunk`), which
    updates the state in place: a state the runner did not hand out
    itself (the engine's initial state, which the warm-up chunk must not
    change) is copied once first. On the CPU it is
    :func:`walk_chunk_plain`. ``stats_kw`` (``records``, ``mass``) goes
    to the engine's ``chunk_stats``: the telemetry counts the hops on the
    host from the round count, with no device op a hop."""
    from gossipprotocol_tpu_torch.engine.driver import chunk_stats

    if base_key.is_cuda:
        from gossipprotocol_tpu_torch.ops.walk import walk_chunk, walk_layout

        lay = walk_layout(nbrs, n)
        handed_out = [None]   # the node array of the state last returned

        def chunk(state: WalkState, _nbrs, start_round: int,
                  round_limit: int):
            if state.s is not handed_out[0]:
                state = WalkState(*(t if f == "alive" else
                                    t.clone(memory_format=torch.
                                            contiguous_format)
                                    for f, t in zip(WalkState._fields,
                                                    state)))
            hops = max(0, round_limit - start_round)
            if hops:
                walk_chunk(lay, state, base_key, hops, quorum, streak_target)
            handed_out[0] = state.s
            return state, chunk_stats(state, done_fn, **stats_kw)

        return chunk

    draws = WalkDraws(nbrs, n, base_key.device)

    def chunk(state: WalkState, _nbrs, start_round: int, round_limit: int):
        hops = max(0, round_limit - start_round)
        state = walk_chunk_plain(draws, state, base_key, hops, quorum,
                                 streak_target)
        return state, chunk_stats(state, done_fn, **stats_kw)

    return chunk
