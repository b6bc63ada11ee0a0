"""Analytic device-memory capacity planner: will (n, topology, shards) fit
at all? (port of ``gossipprotocol_tpu/obs/capacity.py``, its structure,
names, document fields and exit codes, with the byte terms re-derived
from the tensors the port holds on the card).

The memory-side twin of :mod:`gossipprotocol_tpu_torch.obs.predict`:
where that module predicts *rounds*, this one predicts the card's bytes
for a run **before any plan build**, so an over-capacity request is
refused in milliseconds instead of dying in the CUDA caching allocator.

Model structure:

* **state** — measured, not modeled: the protocol state is built once at
  a tiny probe size with the *same* config knobs (algorithm, payload
  dim, dtype, workload, acceleration) through the port's
  ``build_protocol`` on the CPU, and its exact bytes/row scale linearly
  to any n.
* **delivery** — per-path formulas over the tensors the port's
  ``engine.driver.device_arrays`` (and the sharded engine) place on the
  card: the dense neighbour table or the CSR for the drawing rounds, the
  int64 edge list for the fanout-all scatter, the pallas gather plans
  (int32 ``[tiles, 8, 128]`` index tiles, plus the per-tile row table in
  bucket mode), the megakernel's compact pair tables and scratch, the
  Clos-routed plans (int8 index planes a tile per stage pass, the final
  pass's planes and bit-packed masks) with their realmask, and the
  sharded push plans with their exchange slabs. The routed planes'
  geometry follows ``ops/plan.py``'s radix recursion, with each run's
  capacity priced at 1.25x the mean bucket load (the class layout's
  shuffle and the stride chain make the loads near uniform). Given a
  built topology, the class layout (pair slots, node capacities, the
  shards' uniformized capacities and slab blocks) is computed exactly
  from the degrees; without one, from closed forms.
* **temp** — the round's PyTorch temporaries: the round's new state and
  the freeze select's copy beside the old state, the threefry hash's
  int64 words for the drawing rounds, the gathered shares and fold
  streams of the plan paths, the routed staging slabs, the megakernel's
  padded state copy and its build's int64 table checks, and the sharded
  exchange slabs.
* **edges** — closed-form per topology family (``line`` 2(n−1), grids
  ~6n/7n, ER ``avg_degree·n``, …) so planning 1B nodes never builds a
  1B-node graph; exact counts are passed in when a topology exists.

The port's ``--devices S`` shards all live on one card, so
``per_device`` prices every shard's state and plans together.

Device capacity comes from ``$GOSSIP_TPU_HBM_BYTES`` (override / CI) or
the card's total memory (``torch.cuda.get_device_properties``); the CPU
exposes neither, so the preflight is a no-op there unless the env var is
set.

``python -m gossipprotocol_tpu_torch plan N TOPOLOGY [ALGO] [flags]``
renders the breakdown, predicts the max feasible n at the same geometry,
and exits 1 for an over-capacity request — the admission-control hook.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Any, Dict, Optional, Tuple

__all__ = ["CapacityError", "edges_estimate", "estimate_run_bytes",
           "estimate_for_topology", "device_capacity_bytes",
           "max_feasible_nodes", "estimate_build_host_bytes",
           "suggest_build_shards", "build_rss_budget_bytes",
           "preflight", "main"]


class CapacityError(ValueError):
    """A requested run cannot fit in device memory."""


# refuse runs predicted above this fraction of per-device capacity — the
# caching allocator needs headroom beyond the model's accounted buffers
DEFAULT_SAFETY = 0.9
# probe size for the measured state bytes/row (any small multiple of
# every supported shard count; the probe build costs ~ms)
_PROBE_ROWS = 512

# the streamed build's defaults (the JAX package's topology/stream.py,
# whose streamed build the port does not have yet): generator chunk in
# directed pairs, and the spill budget in bytes
DEFAULT_CHUNK_EDGES = 1 << 20
DEFAULT_SPILL_BUDGET = 512 * 1024 * 1024

# the routed plans (ops/plan.py, ops/exec.py): f32 slots a 128x128 tile,
# and a run's capacity priced at this multiple of its mean bucket load
_PLAN_TILE_F32 = 128 * 128
_RUN_SLACK = 1.25
# the threefry hash of the drawing rounds: int64 words live at once a row
# (the counters, the key-schedule sums and rotations, the drawn slots and
# targets), of which sweep lanes share this many (the node ids, the
# clamped degrees: ``[n]``, not ``[B, n]``)
_HASH_WORDS_PER_ROW = 12
_HASH_SHARED_WORDS = 4

_state_probe_cache: Dict[Tuple, Tuple[float, int]] = {}


def parse_byte_size(text) -> int:
    """``'512M'``/``'2G'``/``'65536'`` -> bytes (K/M/G/T suffixes,
    case-insensitive, optional trailing 'B'). Ints pass through."""
    if isinstance(text, int):
        return int(text)
    s = str(text).strip().upper()
    if s.endswith("B"):
        s = s[:-1]
    mult = 1
    for suffix, m in (("K", 1 << 10), ("M", 1 << 20),
                      ("G", 1 << 30), ("T", 1 << 40)):
        if s.endswith(suffix):
            mult = m
            s = s[:-1]
            break
    try:
        value = float(s)
    except ValueError:
        raise ValueError(
            f"unparseable byte size {text!r} (want e.g. 512M, 2G, 65536)"
        ) from None
    if value < 0:
        raise ValueError(f"byte size must be non-negative, got {text!r}")
    return int(value * mult)


def _dtype_bytes(cfg) -> int:
    return 8 if str(cfg.dtype) == "float64" else 4


def edges_estimate(kind: str, num_nodes: int, *, avg_degree: float = 8.0,
                   m: int = 4, k: int = 6) -> Tuple[int, int]:
    """(directed edge count, max-degree estimate) for a topology family,
    closed-form — no graph build. The implicit complete graph has no
    materialized edges at all (its delivery is arithmetic)."""
    from gossipprotocol_tpu_torch.topology.registry import canonical_name

    n = int(num_nodes)
    kind = canonical_name(kind)
    if kind == "line":
        return max(0, 2 * (n - 1)), 2
    if kind == "full":
        return 0, 0  # implicit: no edge arrays, no sampling table
    if kind == "3D":
        return 6 * n, 6
    if kind == "imp3D":
        return 7 * n, 8  # 3D lattice + one imperfect extra per node
    if kind == "erdos_renyi":
        # max degree: Poisson tail bound, generous enough for dense/CSR
        # dispatch at the default avg_degree=8
        return int(avg_degree * n), int(avg_degree + 6 * math.sqrt(avg_degree) + 4)
    if kind == "power_law":
        return 2 * m * n, int(math.sqrt(max(n, 1)) + 2 * m)  # hub-bound
    if kind == "small_world":
        return k * n, k + 8
    raise CapacityError(f"no edge model for topology {kind!r}")


def _state_row_bytes(cfg) -> Tuple[float, int]:
    """(bytes per state row, fixed bytes) measured from a probe build of
    the port's protocol state with this config's knobs (on the CPU)."""
    import dataclasses

    key = (cfg.algorithm, cfg.workload, int(cfg.payload_dim),
           str(cfg.dtype), cfg.fanout, cfg.predicate, cfg.accel,
           cfg.semantics, cfg.delivery, int(cfg.rounds_per_kernel))
    hit = _state_probe_cache.get(key)
    if hit is not None:
        return hit
    from gossipprotocol_tpu_torch.engine.driver import build_protocol
    from gossipprotocol_tpu_torch.topology import build_topology

    # the probe keeps the knobs of the key and drops every field that
    # names nodes of the real graph (the start node, the strikes, the
    # edge events, the logged quarantines): the state's layout does not
    # depend on them, and an id past the probe's rows indexes nothing
    probe_cfg = dataclasses.replace(
        cfg, telemetry=None, seed=0, sweep=None, device="cpu",
        seed_node=None, alert_quorum=None, fault_plan=None,
        fault_schedule=None, event_plan=None, quarantine_log=(),
        repair="off", sentinel="off", checkpoint_every=0,
        checkpoint_dir=None,
        groups=2 if cfg.workload == "gala" else cfg.groups,
        accel_lambda=0.5 if cfg.accel == "chebyshev" else cfg.accel_lambda)
    topo = build_topology("line", _PROBE_ROWS)
    state, *_ = build_protocol(topo, probe_cfg)
    row = 0.0
    fixed = 0
    for leaf in state:
        nbytes = leaf.numel() * leaf.element_size()
        if leaf.dim() >= 1 and leaf.shape[0] == _PROBE_ROWS:
            row += nbytes / _PROBE_ROWS
        else:
            fixed += nbytes
    _state_probe_cache[key] = (row, fixed)
    return row, fixed


def _class_pair_slots(num_edges: int, max_degree: int) -> int:
    """Closed-form class-layout pair-slot bound (no degrees at hand): a
    node's pair slots are its degree class, the ceil-pow2 of its degree,
    so at most twice the edges; plus the per-class quantization floors
    (``ops/delivery.py`` ``class_layout``): small classes (c <= 64) pad
    to BLK-row regions, split hub classes (one ceil-pow2 class per octave
    from 512 up to max_degree) to at least 8 node slots."""
    from gossipprotocol_tpu_torch.ops.classops import BLK
    from gossipprotocol_tpu_torch.ops.pallasdelivery import LANES

    cp2 = 1 << max(0, (max(1, max_degree) - 1)).bit_length()
    if cp2 > 64:
        cp2 = max(cp2, 512)  # 128/256 band merges into 512
    n_small = min(cp2.bit_length(), 7)  # classes 1..64
    floors = n_small * BLK * (LANES // 2)
    c = 512
    while c <= cp2:
        floors += max(BLK * (LANES // 2), 8 * c)
        c *= 2
    return 2 * num_edges + floors


def _hub_split_summary(max_degree: int) -> Optional[Dict[str, int]]:
    """Predicted hub-splitting layout geometry from the degree range:
    one split class per octave from 512 up to the merged ceil-pow2 of
    ``max_degree`` (an upper bound — only populated octaves split on a
    real graph), each contributing ``2c / 128`` sub-classes. None when
    the layout has no split classes."""
    cp2 = 1 << max(0, (max(1, max_degree) - 1)).bit_length()
    if cp2 > 64:
        cp2 = max(cp2, 512)
    if cp2 < 512:
        return None
    split = [512 << i for i in range((cp2 // 512).bit_length())]
    return {
        "classes": len(split),
        "subclasses": sum((2 * c) // 128 for c in split),
        "max_degree": int(max_degree),
    }


def layout_geometry(topo, num_shards: int = 1) -> Dict[str, int]:
    """The class layout of a built topology, exactly as the plan builders
    compute it, from the degrees alone (no plan build): ``m_pairs`` and
    ``nu`` (the single-card layout); with ``num_shards > 1`` the sharded
    push design's uniformized per-shard ``shard_m_pairs``,
    ``shard_nu`` (capacity-padded node slots) and ``block_pairs`` (the
    slab block)."""
    import numpy as np

    from gossipprotocol_tpu_torch.ops.delivery import (
        class_layout, degree_classes,
    )
    from gossipprotocol_tpu_torch.parallel.mesh import padded_size

    degree = np.asarray(topo.degree, np.int64)
    cls = degree_classes(degree)
    _, _, m_pairs, _, _ = class_layout(np.sort(cls[cls > 0]))
    geo = {"m_pairs": int(m_pairs), "nu": int((cls > 0).sum())}
    if num_shards > 1:
        from gossipprotocol_tpu_torch.ops.sharddelivery import shard_geometry

        _, block_pairs, _, classes, m_u = shard_geometry(
            topo, padded_size(topo.num_nodes, num_shards), num_shards)
        geo.update(shard_m_pairs=int(m_u),
                   shard_nu=int(sum(cap for *_r, cap in classes)),
                   block_pairs=int(block_pairs))
    return geo


def _plan_bytes(m_in: int, m_out: int, unit: int) -> int:
    """Bytes of one placed routing plan (``ops/exec.py`` ``DevicePlan``)
    of ``m_in`` input and ``m_out`` output units (``unit`` f32 each):
    per stage pass one ``[3, 128/unit·64, 128]`` int8 index plane set per
    (input tile, stacked output tile), and per final tile ``k`` plane
    sets plus their bit-packed ``[16, 128]`` masks. The geometry follows
    ``ops/plan.py`` ``build_route_plan``'s radix recursion, each run's
    capacity priced at :data:`_RUN_SLACK` times its mean load."""
    u = _PLAN_TILE_F32 // unit            # units a tile
    upr = 128 // unit                     # units a tile row
    planes = 3 * (64 if unit == 2 else 128) * 128
    nt_in = max(1, -(-int(m_in) // u))
    nt_out = max(1, -(-int(m_out) // u))
    total = 0
    p, tau_in, span = 1, nt_in, nt_out
    while span > 1:
        b = min(128, span)
        span = -(-span // b)
        rows = max(1, -(-int(_RUN_SLACK * u / b) // upr))
        cr = min(128, 1 << (rows - 1).bit_length())
        o = -(-b * cr // 128)
        tau_slab = -(-(tau_in * cr) // 128) * (128 // cr)
        total += p * tau_in * o * planes
        p *= b
        tau_in = tau_slab * cr // 128
    return total + nt_out * tau_in * (planes + 16 * 128)


def _chain_bytes(m_in: int, m_out: int, unit: int) -> int:
    """Bytes of a chained pair of plans (``ops/delivery.py``
    ``_chained_plans``): the stride permutation over the input, then the
    descrambled one onto the output."""
    return _plan_bytes(m_in, m_in, unit) + _plan_bytes(m_in, m_out, unit)


def _gather_plan_bytes(out_len: int, src_len: int) -> int:
    """Bytes of one pallas gather plan (``ops/pallasdelivery.py``
    ``GatherPlan``): int32 ``[tiles, 8, 128]`` indices; in bucket mode
    (a source past the resident bound) also the per-tile row table,
    priced at its bound of one row a slot."""
    from gossipprotocol_tpu_torch.ops.pallasdelivery import (
        LANES, TILE, TILE_ROWS, _resident_rows,
    )

    tiles = -(-int(out_len) // TILE)
    src_rows = -(-(int(src_len) + 1) // (TILE_ROWS * LANES)) * TILE_ROWS
    total = tiles * TILE * 4
    if src_rows > _resident_rows():
        r_cap = -(-min(TILE, src_rows) // TILE_ROWS) * TILE_ROWS
        total += tiles * r_cap * 4
    return total


def _delivery_bytes(cfg, n_pad: int, local_rows: int, num_shards: int,
                    num_edges: int, max_degree: int, implicit_full: bool,
                    geometry: Optional[Dict[str, int]] = None,
                    ) -> Tuple[int, str, Dict[str, int]]:
    """Device delivery bytes + which path was modeled + the layout sizes
    the temporaries reuse (``m_pairs``, ``nu``, and for shards
    ``shard_m_pairs``, ``block_pairs``).

    Mirrors ``engine.driver.device_arrays`` and the sharded engine's
    plans — when those grow a new path, grow this."""
    import torch

    n = n_pad
    geo = dict(geometry or {})
    if implicit_full:
        return 0, "implicit-full", geo
    is_pushsum = cfg.algorithm != "gossip"
    if is_pushsum and cfg.fanout == "all" and cfg.delivery != "scatter":
        geo.setdefault("m_pairs", _class_pair_slots(num_edges, max_degree))
        geo.setdefault("nu", n)
    if is_pushsum and cfg.fanout == "all":
        m_pairs = geo.get("m_pairs", 0)
        nu = geo.get("nu", n)
        if num_shards > 1 and cfg.delivery in ("routed", "pallas"):
            # the sharded push plans of every shard, all on the one card:
            # per shard plan_in (its rows -> class order), plan_send (edge
            # shares -> [f_local | slab]), plan_recv ([f_local |
            # incoming] -> f), plan_out, plus realmask and degree
            s = num_shards
            e_local = -(-num_edges // s)
            mp = geo.setdefault("shard_m_pairs",
                                _class_pair_slots(e_local, max_degree))
            nu_s = geo.setdefault("shard_nu", 2 * local_rows)
            bp = geo.setdefault("block_pairs",
                                max(64, -(-e_local // 64) * 64))
            per_shard = (_chain_bytes(2 * local_rows, 2 * nu_s, 1)
                         + _chain_bytes(mp, mp + s * bp, 2)
                         + _chain_bytes(mp + s * bp, mp, 2)
                         + _chain_bytes(2 * nu_s, 2 * local_rows, 1)
                         + 8 * mp)
            return s * per_shard + 4 * n, cfg.delivery, geo
        if cfg.delivery == "routed":
            plans = (_chain_bytes(2 * n, 2 * nu, 1)
                     + _chain_bytes(m_pairs, m_pairs, 2)
                     + _chain_bytes(2 * nu, 2 * n, 1))
            return plans + 8 * m_pairs + 4 * n, "routed", geo
        if cfg.delivery in ("pallas", "megakernel"):
            tables = (_gather_plan_bytes(2 * m_pairs, 2 * n)
                      + _gather_plan_bytes(2 * n, 2 * nu) + 4 * n)
            from gossipprotocol_tpu_torch.engine.driver import use_megakernel

            if not use_megakernel(cfg):
                return tables, "pallas", geo
            # the f32 degree, and on the card the kernel's compact pair
            # tables (int32 a pre pair, a node), its padded gather
            # sources (xp2, yp2) and per-class scratch
            mk = 4 * n
            if torch.device(cfg.device).type != "cpu":
                mk += 4 * m_pairs + 4 * n + 8 * (n + 1) + 8 * (nu + 1)
                mk += 8 * (2 * m_pairs // 128) + 4 * nu + 4096
            return tables + mk, "megakernel", geo
        # diffusion edge list: int64 src + dst per edge + int32 degree
        return 16 * num_edges + 4 * n, "diffusion-edges", geo
    # fanout-one sampling (and gossip): dense row table when the max
    # degree is bounded (with the int8 inversion table where the round
    # inverts), else the CSR
    from gossipprotocol_tpu_torch.engine.driver import gossip_inverts
    from gossipprotocol_tpu_torch.protocols.sampling import dense_for_degree

    width = max(max_degree, 1)
    if dense_for_degree(max_degree):
        if cfg.delivery == "invert" or gossip_inverts(
                cfg, asymmetric=geo.get("asymmetric", False), dense=True):
            return n * (5 * width + 4), "dense-table+inversion", geo
        return 4 * n * (width + 1), "dense-table", geo
    # CSRNeighbors: int64 starts + int32 degree [n], int32 indices [E]
    return 12 * n + 4 * num_edges, "csr", geo


def _temp_bytes(cfg, path: str, n: int, num_edges: int, state_row: float,
                geo: Dict[str, int], num_shards: int, lanes: int = 1) -> int:
    """The round's PyTorch temporaries (see the module docstring), for
    ``lanes`` sweep lanes; the largest of the round's and the plan
    build's."""
    d = int(cfg.payload_dim)
    B = _dtype_bytes(cfg)
    # the round's new state and the freeze select's copy beside the old
    states = int(2 * state_row * n)
    hash_lane = 8 * (_HASH_WORDS_PER_ROW - _HASH_SHARED_WORDS) * n
    hash_shared = 8 * _HASH_SHARED_WORDS * n
    if path == "implicit-full":
        return (lanes * (states + 2 * n * (d + 1) * B + hash_lane)
                + hash_shared)
    if cfg.algorithm == "gossip" or cfg.fanout == "one":
        return lanes * (states + hash_lane) + hash_shared
    # the plan paths run one lane (sweeps draw)
    states *= lanes
    m_pairs = geo.get("m_pairs", 0)
    if path == "diffusion-edges":
        per_round = -(-num_edges // max(1, int(cfg.edge_chunks)))
        return states + 3 * per_round * (d + 1) * B + 4 * n * (d + 1) * B
    # the plan paths move (s, w) pairs of f32: the padded source, the
    # gathered fold input, the fold outputs and the natural-order result
    streams = 8 * (2 * m_pairs) + 8 * 3 * n
    if d > 1:
        streams *= d
    if path == "megakernel":
        # the chunk's padded [rp, 128] state copy, and the build's int64
        # checks of the pair tables
        return max(states + streams + 20 * n, 8 * 4 * m_pairs)
    if path == "pallas" and num_shards == 1:
        return states + streams
    if num_shards > 1:
        mp = geo.get("shard_m_pairs", m_pairs)
        bp = geo.get("block_pairs", 64)
        # every shard's f_local and slab rows, the incoming slabs, and one
        # shard's staging slabs at a time
        slabs = 2 * num_shards * (8 * mp + 2 * 8 * num_shards * bp)
        return states + slabs + 4 * 8 * mp + 8 * 3 * n
    # routed: the staging slabs of the widest plan (twice its f32 slots)
    return states + streams + 4 * 8 * m_pairs


def estimate_run_bytes(
    kind: str,
    num_nodes: int,
    cfg,
    num_devices: int = 1,
    *,
    num_edges: Optional[int] = None,
    max_degree: Optional[int] = None,
    implicit_full: Optional[bool] = None,
    telemetry_on: bool = True,
    avg_degree: float = 8.0,
    m: int = 4,
    k: int = 6,
    geometry: Optional[Dict[str, int]] = None,
) -> Dict[str, Any]:
    """Predicted device footprint for a (topology, n, config, shards)
    request. Pass exact ``num_edges``/``max_degree`` (and the class
    layout's ``geometry``, :func:`layout_geometry`) when a topology
    exists; otherwise the family's closed-form estimate is used."""
    from gossipprotocol_tpu_torch.parallel.mesh import padded_size
    from gossipprotocol_tpu_torch.topology.registry import canonical_name

    n = int(num_nodes)
    if n < 1:
        raise CapacityError(f"num_nodes must be >= 1, got {n}")
    num_shards = max(1, int(num_devices))
    if implicit_full is None:
        implicit_full = canonical_name(kind) == "full"
    if num_edges is None or max_degree is None:
        e_est, d_est = edges_estimate(
            kind, n, avg_degree=avg_degree, m=m, k=k)
        num_edges = e_est if num_edges is None else int(num_edges)
        max_degree = d_est if max_degree is None else int(max_degree)
    n_pad = padded_size(n, num_shards) if num_shards > 1 else n
    local_rows = n_pad // num_shards
    B = _dtype_bytes(cfg)
    d = int(cfg.payload_dim)

    # sweep lanes stack per-run state [B, ...]: everything per-trajectory
    # (state, workload data, round temporaries, counter buffers) is paid
    # once per lane; delivery tables stay shared — the topology is a
    # structural invariant across the sweep
    sweep = getattr(cfg, "sweep", None)
    lanes = max(1, int(getattr(sweep, "lanes", 1))) if sweep is not None else 1

    row_bytes, fixed_bytes = _state_row_bytes(cfg)
    # the port's shards share one card: every shard's rows are priced
    state_bytes = (int(row_bytes * n_pad) + fixed_bytes) * lanes

    delivery_bytes, path, geo = _delivery_bytes(
        cfg, n_pad, local_rows, num_shards, num_edges, max_degree,
        implicit_full, geometry)

    # SGP data: A [rows, samples, d] + b [rows, samples]
    data_bytes = 0
    if cfg.workload in ("sgp", "gala"):
        data_bytes = n_pad * int(cfg.sgp_samples) * (d + 1) * B * lanes

    temp_bytes = _temp_bytes(cfg, path, n_pad, num_edges, row_bytes, geo,
                             num_shards, lanes)

    telemetry_bytes = 0
    if telemetry_on:
        slots = cfg.chunk
        # counter rows [slots, 3] i32 + shard partials + trace [slots, 5]
        # f32, and the chunk's stats tensor
        telemetry_bytes = slots * (12 + 12 * num_shards + 20) * lanes + 4096

    argument_bytes = state_bytes + delivery_bytes + data_bytes + 16
    total = argument_bytes + temp_bytes + telemetry_bytes
    extra_per_device: Dict[str, int] = {}
    if path == "megakernel":
        # advisory: the K-round kernel's working set (against the card's
        # 50 MB L2; the widest class region priced at every pair slot) and,
        # on a card, whether the launcher keeps its state in shared memory
        from gossipprotocol_tpu_torch.ops import megakernel as mkm

        m_pairs = geo.get("m_pairs", 0)
        extra_per_device["megakernel_working_set_bytes"] = (
            mkm.working_set_bytes(n, m_pairs, geo.get("nu", n),
                                  -(-2 * m_pairs // 128)))
        extra_per_device["megakernel_state_in_shared_memory"] = (
            _megakernel_state_in_smem(cfg, n, m_pairs))
    if (num_shards > 1 and path in ("routed", "pallas")
            and getattr(cfg, "payload_wire", "f32") != "f32"):
        # per-round exchange bytes under the compressed wire, next to the
        # f32 figure it replaces
        wire = {"f32": 4, "bf16": 2, "int8": 1}[cfg.payload_wire]
        slots = 2 * num_shards * num_shards * geo.get("block_pairs", 0)
        extra_per_device["wire_exchange_bytes_per_round"] = wire * slots
        extra_per_device["f32_exchange_bytes_per_round"] = 4 * slots
    return {
        "kind": canonical_name(kind),
        "num_nodes": n,
        "num_padded": n_pad,
        "num_devices": num_shards,
        "lanes": lanes,
        "num_edges": int(num_edges),
        "delivery_path": path,
        "hub_split": (_hub_split_summary(max_degree)
                      if path in ("routed", "pallas", "megakernel")
                      else None),
        "dtype_bytes": B,
        "payload_dim": d,
        "per_device": {
            "state_bytes": state_bytes,
            "delivery_bytes": int(delivery_bytes),
            "data_bytes": int(data_bytes),
            "temp_bytes": int(temp_bytes),
            "telemetry_bytes": int(telemetry_bytes),
            **extra_per_device,
            "total_bytes": int(total),
        },
        "argument_bytes": int(argument_bytes),
    }


def _megakernel_state_in_smem(cfg, n: int, m_pairs: int) -> Optional[bool]:
    """The launcher's own choice on the run's card
    (``ops/megakernel.py`` ``state_in_shared_memory``); None off a card,
    where no kernel runs."""
    import torch

    from gossipprotocol_tpu_torch.ops.megakernel import (
        state_in_shared_memory,
    )

    dev = torch.device(cfg.device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return state_in_shared_memory(n, m_pairs, dev)


def estimate_for_topology(topo, cfg, num_devices: int = 1,
                          telemetry_on: bool = True) -> Dict[str, Any]:
    """Exact-geometry variant for an already-built topology: its edge
    count, max degree and (for the plan paths) class layout."""
    max_deg = int(topo.degree.max()) if topo.degree.size else 0
    geometry = {"asymmetric": bool(getattr(topo, "asymmetric", False))}
    if (cfg.algorithm == "push-sum" and cfg.fanout == "all"
            and cfg.delivery != "scatter" and not topo.implicit_full):
        geometry.update(layout_geometry(topo, max(1, int(num_devices))))
    return estimate_run_bytes(
        topo.kind, topo.num_nodes, cfg, num_devices,
        num_edges=int(topo.num_directed_edges), max_degree=max_deg,
        implicit_full=bool(topo.implicit_full), telemetry_on=telemetry_on,
        geometry=geometry,
    )


def estimate_build_host_bytes(
    kind: str,
    num_nodes: int,
    num_shards: int = 1,
    *,
    streamed: bool = False,
    memory_budget: Optional[int] = None,
    store_on_disk: bool = False,
    chunk_edges: Optional[int] = None,
    avg_degree: float = 8.0,
    m: int = 4,
    k: int = 6,
) -> int:
    """Predicted peak *host* RSS of topology construction, closed-form —
    the build-time twin of :func:`estimate_run_bytes` (the JAX package's
    figures, kept equal).

    Materialized (``topology/builders.py`` + ``csr_from_edges``): the
    global undirected edge list, its symmetrized int64 src/dst pair, the
    dedup sort key, and the final CSR are all simultaneously live —
    ~40 bytes per directed edge plus ~16 per node.

    Streamed (the JAX package's ``topology/stream.py``; the port has no
    streamed build yet): one shard's pair set plus its finalize workspace
    (~24 bytes per *per-shard* directed edge), the bounded generator
    chunk, the spill buffer (``memory_budget``), and — unless slices go
    to ``store_dir`` files — the finished int32 slices (4 B/edge).
    Power-law adds its frozen endpoint list (4 B/edge).
    """
    from gossipprotocol_tpu_torch.topology.registry import canonical_name

    n = int(num_nodes)
    e_dir, _ = edges_estimate(kind, n, avg_degree=avg_degree, m=m, k=k)
    if not streamed:
        return 40 * e_dir + 16 * n
    s = max(1, int(num_shards))
    if chunk_edges is None:
        chunk_edges = DEFAULT_CHUNK_EDGES
    if memory_budget is None:
        memory_budget = DEFAULT_SPILL_BUDGET
    total = 24 * (e_dir // s) + 32 * int(chunk_edges) + int(memory_budget)
    if not store_on_disk:
        total += 4 * e_dir + 8 * n  # finished slices stay resident
    if canonical_name(kind) == "power_law":
        total += 4 * e_dir
    return total


def build_rss_budget_bytes() -> Optional[int]:
    """``$GOSSIP_TPU_BUILD_RSS_BYTES`` — the host-memory admission budget
    for topology construction (None when unset)."""
    env = os.environ.get("GOSSIP_TPU_BUILD_RSS_BYTES")
    if not env:
        return None
    try:
        return parse_byte_size(env)
    except ValueError:
        raise CapacityError(
            f"bad $GOSSIP_TPU_BUILD_RSS_BYTES {env!r} (want bytes, "
            "K/M/G suffixes ok)")


def suggest_build_shards(kind: str, num_nodes: int, budget: int,
                         max_shards: int = 4096, **topo_params) -> Optional[int]:
    """Smallest power-of-two shard count whose *streamed* build estimate
    fits ``budget`` host bytes — the shard-count knob driven by build
    memory rather than device memory. None when even ``max_shards``
    won't fit (the per-chunk and resident-slice floors are
    shard-independent)."""
    s = 1
    while s <= max_shards:
        if estimate_build_host_bytes(
                kind, num_nodes, s, streamed=True, **topo_params) <= budget:
            return s
        s *= 2
    return None


def device_capacity_bytes() -> Tuple[Optional[int], str]:
    """(per-device byte capacity, source). ``$GOSSIP_TPU_HBM_BYTES``
    wins (explicit admission-control budget); else the first card's total
    memory (``torch.cuda.get_device_properties(0).total_memory``); else
    (None, 'unknown') — the CPU has no accounting, and the preflight
    stays silent there."""
    env = os.environ.get("GOSSIP_TPU_HBM_BYTES")
    if env:
        try:
            return int(float(env)), "$GOSSIP_TPU_HBM_BYTES"
        except ValueError:
            raise CapacityError(
                f"bad $GOSSIP_TPU_HBM_BYTES {env!r} (want bytes)")
    try:
        import torch

        if torch.cuda.is_available():
            total = torch.cuda.get_device_properties(0).total_memory
            if total:
                return int(total), "torch.cuda total_memory"
    except Exception:
        pass
    return None, "unknown"


def max_feasible_nodes(kind: str, cfg, num_devices: int,
                       capacity: int, *, safety: float = DEFAULT_SAFETY,
                       **topo_params) -> int:
    """Largest n whose predicted per-device total fits ``safety ×
    capacity`` at this geometry (binary search over the monotone model,
    closed-form edges)."""
    budget = safety * capacity

    def fits(n: int) -> bool:
        doc = estimate_run_bytes(kind, n, cfg, num_devices, **topo_params)
        return doc["per_device"]["total_bytes"] <= budget

    lo = 1
    if not fits(lo):
        return 0
    hi = 2
    while fits(hi) and hi < 2 ** 40:
        lo, hi = hi, hi * 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo


def preflight(topo, cfg, num_devices: int = 1, tel=None) -> Optional[Dict[str, Any]]:
    """Refuse an over-capacity run before any plan build.

    Returns the estimate doc (annotated with capacity) when capacity is
    known, None when it is not (the CPU without the env override).
    Raises :class:`CapacityError` when the prediction exceeds the safety
    budget."""
    build_budget = build_rss_budget_bytes()
    if build_budget is not None and not topo.implicit_full:
        # the materialized build this topology needed (exact edge count —
        # the graph exists by now): warn when it exceeds the host budget
        e_dir = int(topo.num_directed_edges)
        mat = 40 * e_dir + 16 * int(topo.num_nodes)
        if mat > build_budget:
            streamed_est = estimate_build_host_bytes(
                topo.kind, topo.num_nodes, max(1, int(num_devices)),
                streamed=True)
            msg = (
                f"host-build warning: a materialized {topo.kind}-"
                f"{topo.num_nodes} build peaks at ~{_fmt(mat)} host RSS, "
                f"over $GOSSIP_TPU_BUILD_RSS_BYTES={_fmt(build_budget)} "
                f"(a streamed build would need ~{_fmt(streamed_est)}, but "
                f"the PyTorch port has no streamed build yet: use python "
                f"-m gossipprotocol_tpu --build streamed, or a smaller n)")
            print(msg, file=sys.stderr)
            if tel is not None:
                tel.note_resource("build_rss_warning", {
                    "materialized_bytes": mat,
                    "streamed_bytes": int(streamed_est),
                    "budget_bytes": int(build_budget),
                })
    capacity, source = device_capacity_bytes()
    if capacity is None:
        return None
    doc = estimate_for_topology(topo, cfg, num_devices)
    doc["capacity_bytes"] = capacity
    doc["capacity_source"] = source
    total = doc["per_device"]["total_bytes"]
    doc["capacity_fraction"] = round(total / capacity, 4)
    if tel is not None:
        tel.note_resource("capacity_plan", doc)
    if total > DEFAULT_SAFETY * capacity:
        feasible = max_feasible_nodes(
            topo.kind, cfg, num_devices, capacity,
        )
        lanes = doc.get("lanes", 1)
        what = (f"{lanes}-lane sweep over {topo.kind}-{topo.num_nodes}"
                if lanes > 1 else f"{topo.kind}-{topo.num_nodes}")
        hint = ("shrink the sweep (per-lane state is priced lanes x), "
                if lanes > 1 else "")
        raise CapacityError(
            f"predicted per-device footprint {_fmt(total)} exceeds "
            f"{int(DEFAULT_SAFETY * 100)}% of device capacity "
            f"{_fmt(capacity)} ({source}) for {what} "
            f"on {num_devices} device(s); max feasible n at this geometry "
            f"is ~{feasible} ({hint}add devices, shrink --payload-dim, or "
            f"raise $GOSSIP_TPU_HBM_BYTES if the budget is wrong)"
        )
    return doc


def _fmt(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return "?"


def main(argv=None) -> int:
    """``python -m gossipprotocol_tpu_torch plan N TOPOLOGY [ALGO]
    [flags]``.

    Exit 0 when the request fits (or capacity is unknown and no budget
    was given), 1 when it is over capacity, 2 on bad input.
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m gossipprotocol_tpu_torch plan",
        description="Predict the card's memory footprint and feasibility "
                    "before building anything.",
    )
    parser.add_argument("num_nodes", type=int)
    parser.add_argument("topology")
    parser.add_argument("algorithm", nargs="?", default="push-sum",
                        choices=["gossip", "push-sum"])
    parser.add_argument("--devices", type=int, default=1)
    parser.add_argument("--fanout", choices=["one", "all"], default="one")
    parser.add_argument("--delivery", default=None,
                        choices=["scatter", "invert", "routed", "pallas",
                                 "megakernel"])
    parser.add_argument("--payload-wire", default="f32",
                        choices=["f32", "bf16", "int8"],
                        help="price the sharded exchange slab at the "
                             "compressed wire format")
    parser.add_argument("--payload-dim", type=int, default=1)
    parser.add_argument("--workload", choices=["avg", "sgp", "gala"],
                        default="avg")
    parser.add_argument("--sgp-samples", type=int, default=16)
    parser.add_argument("--x64", action="store_true")
    parser.add_argument("--avg-degree", type=float, default=8.0)
    parser.add_argument("--hbm-bytes", type=float, default=None,
                        help="override per-device capacity (bytes)")
    parser.add_argument("--safety", type=float, default=DEFAULT_SAFETY)
    parser.add_argument("--json", action="store_true",
                        help="emit the raw estimate document")
    try:
        args = parser.parse_args(list(sys.argv[1:] if argv is None else argv))
    except SystemExit as e:
        return int(e.code or 0)
    if args.num_nodes < 1 or args.devices < 1:
        print("plan: num_nodes and --devices must be >= 1", file=sys.stderr)
        return 2
    if args.delivery == "megakernel" and args.devices > 1:
        print("plan: the round-loop megakernel is single-chip only — "
              "drop --devices", file=sys.stderr)
        return 2

    from gossipprotocol_tpu_torch.engine.driver import RunConfig

    try:
        cfg_kw: Dict[str, Any] = dict(
            algorithm=args.algorithm, fanout=args.fanout,
            payload_dim=args.payload_dim, workload=args.workload,
            sgp_samples=args.sgp_samples,
            dtype="float64" if args.x64 else "float32",
        )
        if args.workload == "sgp":
            cfg_kw.update(fanout="all", predicate="global")
        elif args.workload == "gala":
            # smallest legal GALA shape for sizing: group count does not
            # change the byte estimate (data/state are per-row)
            cfg_kw.update(fanout="all", predicate="global", groups=2)
        if args.delivery is not None:
            cfg_kw["delivery"] = args.delivery
            if args.delivery == "megakernel":
                cfg_kw["fanout"] = "all"  # the only legal megakernel shape
        elif args.fanout == "all":
            cfg_kw["delivery"] = "routed"
        if args.payload_wire != "f32":
            if args.devices <= 1:
                raise CapacityError(
                    "--payload-wire prices the sharded exchange; it "
                    "needs --devices N > 1")
            cfg_kw["payload_wire"] = args.payload_wire
            cfg_kw["fanout"] = "all"  # the wire is the routed-push slab
            if cfg_kw.get("delivery") not in ("routed", "pallas"):
                cfg_kw["delivery"] = "routed"
        cfg = RunConfig(**cfg_kw)
        doc = estimate_run_bytes(
            args.topology, args.num_nodes, cfg, args.devices,
            avg_degree=args.avg_degree,
        )
    except (ValueError, CapacityError) as e:
        print(f"plan: {e}", file=sys.stderr)
        return 2

    if args.hbm_bytes is not None:
        capacity: Optional[int] = int(args.hbm_bytes)
        source = "--hbm-bytes"
    else:
        capacity, source = device_capacity_bytes()

    total = doc["per_device"]["total_bytes"]
    over = capacity is not None and total > args.safety * capacity
    if args.json:
        # pure JSON on stdout (pipeable into jq): the verdict rides in
        # the document and the exit code, never as trailing text
        import json as _json

        doc["capacity_bytes"] = capacity
        doc["capacity_source"] = source
        doc["safety"] = args.safety
        if doc["kind"] != "full":
            doc["build_host_bytes"] = {
                "materialized": estimate_build_host_bytes(
                    args.topology, args.num_nodes,
                    avg_degree=args.avg_degree),
                "streamed": estimate_build_host_bytes(
                    args.topology, args.num_nodes, args.devices,
                    streamed=True, avg_degree=args.avg_degree),
            }
        if capacity is not None:
            doc["capacity_fraction"] = round(total / capacity, 4)
            doc["max_feasible_nodes"] = max_feasible_nodes(
                args.topology, cfg, args.devices, capacity,
                safety=args.safety, avg_degree=args.avg_degree)
        doc["verdict"] = ("unknown" if capacity is None
                         else "over_capacity" if over else "fits")
        print(_json.dumps(doc, indent=2))
        return 1 if over else 0
    else:
        per = doc["per_device"]
        print(f"capacity plan: {args.algorithm} on "
              f"{doc['kind']}-{doc['num_nodes']}, "
              f"{doc['num_devices']} device(s), "
              f"delivery={doc['delivery_path']}, "
              f"d={doc['payload_dim']} x {doc['dtype_bytes']} B")
        print(f"  state:        {_fmt(per['state_bytes']):>12}/device")
        print(f"  delivery:     {_fmt(per['delivery_bytes']):>12}/device")
        hs = doc.get("hub_split")
        if hs:
            print(f"  hub split:    {hs['classes']} classes -> "
                  f"{hs['subclasses']} sub-classes "
                  f"(max degree ~{hs['max_degree']})")
        if per["data_bytes"]:
            print(f"  workload data:{_fmt(per['data_bytes']):>12}/device")
        print(f"  temp (est):   {_fmt(per['temp_bytes']):>12}/device")
        print(f"  telemetry:    {_fmt(per['telemetry_bytes']):>12}/device")
        if "megakernel_working_set_bytes" in per:
            where = {True: "state in shared memory",
                     False: "state in device memory",
                     None: "state placement unknown off a card"}[
                         per["megakernel_state_in_shared_memory"]]
            print(f"  fused set:    "
                  f"{_fmt(per['megakernel_working_set_bytes']):>12}/kernel"
                  f"  (advisory: against the 50 MB L2; {where})")
        if "wire_exchange_bytes_per_round" in per:
            print(f"  exchange:     "
                  f"{_fmt(per['wire_exchange_bytes_per_round']):>12}"
                  f"/round/device  ({args.payload_wire} wire; f32 would "
                  f"be {_fmt(per['f32_exchange_bytes_per_round'])})")
        print(f"  total:        {_fmt(per['total_bytes']):>12}/device"
              f"  (argument bytes {_fmt(doc['argument_bytes'])})")
        if doc["kind"] != "full":
            mat_b = estimate_build_host_bytes(
                args.topology, args.num_nodes, avg_degree=args.avg_degree)
            str_b = estimate_build_host_bytes(
                args.topology, args.num_nodes, args.devices, streamed=True,
                avg_degree=args.avg_degree)
            print(f"  host build:   {_fmt(str_b):>12} streamed "
                  f"({args.devices} shard(s); not in the port yet) vs "
                  f"{_fmt(mat_b)} materialized")

    if capacity is None:
        print("  capacity:     unknown (no device memory accounting on "
              "this backend; pass --hbm-bytes or set $GOSSIP_TPU_HBM_BYTES)")
        return 0
    frac = total / capacity
    feasible = max_feasible_nodes(
        args.topology, cfg, args.devices, capacity, safety=args.safety,
        avg_degree=args.avg_degree)
    print(f"  capacity:     {_fmt(capacity)}/device ({source}), "
          f"safety {args.safety:.0%}")
    print(f"  max feasible n at this geometry: ~{feasible}")
    if over:
        print(f"  verdict: OVER CAPACITY ({frac:.0%} of device memory "
              f"> {args.safety:.0%} safety budget)")
        return 1
    print(f"  verdict: fits ({frac:.1%} of device memory)")
    return 0
