"""Declarative topology-schedule plans: churn as a first-class workload
(port of ``gossipprotocol_tpu/events/plan.py``; numpy only, as there).

The fault engine (utils/faults.py) changes *liveness*; the repair engine
(topology/repair.py) changes the adjacency in *response* to liveness.
This module adds the third axis the ROADMAP names — the environment
changing the adjacency *itself*: timed edge additions/removals/swaps
(mobile/P2P overlay churn, time-varying mixing graphs — exactly the
regime SGP's theory is built for, arXiv:1811.10792) plus a seeded
synthetic churn generator for trace-free experiments.

An :class:`EventPlan` is pure data: explicit per-round edge events and an
optional :class:`ChurnSpec` generator. Execution lives in
:mod:`gossipprotocol_tpu_torch.events.engine`, which folds these together with
the fault schedule and repair policy into ONE host-event pipeline at
chunk boundaries.

Determinism contract (the bitwise-replay invariant):

* Explicit events are literal edge lists — trivially replayable.
* Generated churn draws from a counter-based rng keyed on
  ``(run_seed, event_round, _CHURN_STREAM)`` and the *current* adjacency,
  never threaded through the run — so a resume can regenerate the exact
  event sequence from the birth topology plus the plan
  (:func:`gossipprotocol_tpu_torch.events.engine.replay_topology`).
* Application rebuilds through :func:`csr_from_edges`, whose output is
  canonical (sorted, deduped) and therefore independent of the order the
  surviving edge set was assembled in.

The plan's :meth:`EventPlan.digest` is a checkpoint trajectory field
(utils/checkpoint.py): resuming under a different plan would splice two
different topology histories and is refused like any seed mismatch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from gossipprotocol_tpu_torch.topology.base import Topology, csr_from_edges

CHURN_MODELS = ("edge", "swap")

# Value-fault corruption models (``scale:K`` carries its factor inline).
VALUE_FAULT_MODELS = ("nan", "inf", "stuck", "scale")

# Domain-separation constant for the churn rng key (arbitrary, fixed
# forever: part of the bitwise-replay contract, like repair's
# _REWIRE_STREAM).
_CHURN_STREAM = 0xC4BA9E

# Domain-separation constant for value-fault node draws (fixed forever,
# same contract as _CHURN_STREAM).
_VALUEFAULT_STREAM = 0xFA017

# Rejection-sampling budget per requested churn edge addition (a nearly
# complete graph must not spin; a short add only costs event size, never
# correctness).
_ADD_DRAWS = 16

_PLAN_KEYS = ("add_edges", "remove_edges", "swap_neighbors", "churn",
              "kill", "revive", "loss", "value_faults")


@dataclasses.dataclass(frozen=True)
class ChurnSpec:
    """Seeded synthetic churn generator (``--churn rate,model[,period]``).

    Every ``period`` rounds (rounds ``period, 2*period, ...``) the
    generator emits one churn event sized by ``rate`` (fraction of the
    current undirected edge count, floor 1):

    * ``edge`` — remove that many uniform-random existing edges and add
      the same number of uniform-random new non-edges (overlay membership
      churn).
    * ``swap`` — degree-preserving double-edge swaps: pick 2k random
      edges, pair them, cross the endpoints (mobility-style rewiring that
      keeps every node's degree).
    """

    rate: float
    model: str
    period: int = 10

    def validate(self) -> "ChurnSpec":
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(
                f"churn rate {self.rate} must be in (0, 1] — it is the "
                "fraction of current edges touched per churn event")
        if self.model not in CHURN_MODELS:
            raise ValueError(
                f"churn model must be one of {CHURN_MODELS}, "
                f"got {self.model!r}")
        if int(self.period) < 1:
            raise ValueError(f"churn period {self.period} must be >= 1")
        return self


@dataclasses.dataclass(frozen=True)
class ValueFaultSpec:
    """One seeded value-fault injection (``--value-faults
    rate,model[,round]``).

    At ``round`` a uniform-random sample of ``rate * n`` live nodes
    (floor 1) has its push-sum numerator ``s`` corrupted:

    * ``nan``     — payload becomes NaN (the classic silent poison);
    * ``inf``     — payload becomes +Inf;
    * ``stuck``   — payload resets to the node's initial value (a
      learner that stopped learning but keeps gossiping);
    * ``scale:K`` — payload multiplied by K (an adversarial or
      miscalibrated contribution).

    Node draws use a counter-based rng keyed on
    ``(run_seed, round, _VALUEFAULT_STREAM)`` over *global* ids, so the
    sample is identical across shard counts and resume replays. Dead
    nodes are skipped at fire time — after a quarantine-and-rollback the
    replayed injection lands on already-dead rows and is a no-op.
    """

    rate: float
    model: str
    round: int = 10

    def validate(self) -> "ValueFaultSpec":
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(
                f"value-fault rate {self.rate} must be in (0, 1] — it is "
                "the fraction of live nodes corrupted per event")
        base = str(self.model).split(":", 1)[0]
        if base not in VALUE_FAULT_MODELS:
            raise ValueError(
                f"value-fault model must be one of {VALUE_FAULT_MODELS} "
                f"(scale as 'scale:K'), got {self.model!r}")
        if base == "scale":
            k = self.scale_factor()
            if not np.isfinite(k) or k == 1.0:
                raise ValueError(
                    f"value-fault scale factor must be finite and != 1, "
                    f"got {self.model!r}")
        elif ":" in str(self.model):
            raise ValueError(
                f"value-fault model {self.model!r} takes no ':' argument")
        if int(self.round) < 1:
            raise ValueError(
                f"value-fault round {self.round} must be >= 1")
        return self

    def scale_factor(self) -> float:
        """The K of ``scale:K`` (ValueError for malformed specs)."""
        parts = str(self.model).split(":", 1)
        if parts[0] != "scale" or len(parts) != 2:
            raise ValueError(f"not a scale model: {self.model!r}")
        try:
            return float(parts[1])
        except ValueError:
            raise ValueError(
                f"value-fault scale factor {parts[1]!r} is not a number")


def value_fault_ids(num_nodes: int, spec: ValueFaultSpec, *,
                    run_seed: int) -> np.ndarray:
    """The global ids ``spec`` corrupts — a pure function of
    ``(num_nodes, spec, run_seed)``, independent of shard count and of
    everything the run did before the event round (the churn PRNG
    discipline)."""
    rng = np.random.default_rng(
        [int(run_seed) & 0xFFFFFFFF, int(spec.round), _VALUEFAULT_STREAM])
    k = min(num_nodes, max(1, int(round(spec.rate * num_nodes))))
    return np.sort(rng.choice(num_nodes, size=k, replace=False)).astype(
        np.int64)


@dataclasses.dataclass(frozen=True)
class EventPlan:
    """Timed edge-level topology events + optional churn generator.

    ``adds``/``removes`` map a round to an ``[k, 2]`` int64 edge array;
    ``swaps`` maps a round to ``[k, 4]`` rows ``(u1, v1, u2, v2)`` — the
    classic double-edge swap: both edges must exist, they are removed and
    replaced by ``(u1, v2)`` and ``(u2, v1)``. Treated as immutable after
    construction.
    """

    adds: Mapping[int, np.ndarray] = dataclasses.field(default_factory=dict)
    removes: Mapping[int, np.ndarray] = dataclasses.field(default_factory=dict)
    swaps: Mapping[int, np.ndarray] = dataclasses.field(default_factory=dict)
    churn: Optional[ChurnSpec] = None
    value_faults: Tuple[ValueFaultSpec, ...] = ()

    # ---- queries -------------------------------------------------------

    @property
    def has_events(self) -> bool:
        return (bool(self.adds) or bool(self.removes) or bool(self.swaps)
                or self.churn is not None or bool(self.value_faults))

    def __bool__(self) -> bool:
        return self.has_events

    def explicit_rounds(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.adds) | set(self.removes)
                            | set(self.swaps)))

    def next_churn_round(self, after: int) -> Optional[int]:
        """Smallest churn round >= ``after`` (churn fires at positive
        multiples of the period), or None without a generator."""
        if self.churn is None:
            return None
        p = int(self.churn.period)
        return max(p, p * -(-int(after) // p))  # ceil-div, floor at p

    # ---- validation ----------------------------------------------------

    def validate(self, num_nodes: Optional[int] = None) -> "EventPlan":
        for name, events, width in (("add_edges", self.adds, 2),
                                    ("remove_edges", self.removes, 2),
                                    ("swap_neighbors", self.swaps, 4)):
            for r, arr in events.items():
                if int(r) < 0:
                    raise ValueError(f"{name} round {r} is negative")
                a = np.asarray(arr)
                if a.ndim != 2 or a.shape[1] != width or not a.size:
                    raise ValueError(
                        f"{name}@{r}: want a non-empty [k, {width}] int "
                        f"array, got shape {a.shape}")
                if (a < 0).any():
                    raise ValueError(f"{name}@{r}: negative node id")
                if num_nodes is not None and (a >= num_nodes).any():
                    raise ValueError(
                        f"{name}@{r}: node id {int(a.max())} out of range "
                        f"for {num_nodes} nodes")
        if self.churn is not None:
            self.churn.validate()
        for vf in self.value_faults:
            vf.validate()
        return self

    # ---- construction --------------------------------------------------

    @classmethod
    def from_events(
        cls,
        adds: Optional[Mapping[int, object]] = None,
        removes: Optional[Mapping[int, object]] = None,
        swaps: Optional[Mapping[int, object]] = None,
        churn: Optional[ChurnSpec] = None,
        value_faults: Tuple[ValueFaultSpec, ...] = (),
    ) -> "EventPlan":
        norm = lambda ev, w: {  # noqa: E731
            int(r): np.asarray(arr, dtype=np.int64).reshape(-1, w)
            for r, arr in (ev or {}).items()
        }
        return cls(adds=norm(adds, 2), removes=norm(removes, 2),
                   swaps=norm(swaps, 4), churn=churn,
                   value_faults=tuple(value_faults))

    # ---- identity ------------------------------------------------------

    def digest(self) -> str:
        """Stable content hash for checkpoint trajectory metadata.

        ``"none"`` for the empty plan, so event-free resumes keep
        matching event-free checkpoints without wildcarding. The churn
        generator hashes by its *parameters* — the materialized events
        are a pure function of (parameters, run seed, topology history),
        and the seed/topology are trajectory-checked separately."""
        if not self:
            return "none"
        doc = {
            "add": {str(r): np.asarray(v).tolist()
                    for r, v in sorted(self.adds.items())},
            "remove": {str(r): np.asarray(v).tolist()
                       for r, v in sorted(self.removes.items())},
            "swap": {str(r): np.asarray(v).tolist()
                     for r, v in sorted(self.swaps.items())},
            "churn": (None if self.churn is None else
                      [self.churn.rate, self.churn.model,
                       int(self.churn.period)]),
        }
        if self.value_faults:
            # Key present only when non-empty: fault-free plans keep
            # their pre-existing digests byte-for-byte.
            doc["value_faults"] = [[int(v.round), v.rate, str(v.model)]
                                   for v in sorted(self.value_faults,
                                                   key=lambda v: v.round)]
        blob = json.dumps(doc, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def value_fault_digest(self) -> str:
        """Stable hash of just the value-fault portion — its own
        checkpoint trajectory field (``"none"`` when the plan injects
        nothing), so a resume under a different fault plan is refused
        even when the topology-event portion matches."""
        if not self.value_faults:
            return "none"
        doc = [[int(v.round), v.rate, str(v.model)]
               for v in sorted(self.value_faults, key=lambda v: v.round)]
        blob = json.dumps(doc, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def value_fault_rounds(self) -> Tuple[int, ...]:
        return tuple(sorted({int(v.round) for v in self.value_faults}))


_EMPTY_PLAN = EventPlan()


def as_plan(event_plan: Optional[EventPlan]) -> EventPlan:
    """Normalize RunConfig's optional field into one EventPlan (possibly
    empty), so call sites test ``plan.has_events`` instead of None."""
    return event_plan if event_plan is not None else _EMPTY_PLAN


def parse_churn_arg(spec: str) -> ChurnSpec:
    """``--churn RATE,MODEL[,PERIOD]`` -> validated ChurnSpec."""
    parts = [p.strip() for p in str(spec).split(",")]
    if len(parts) not in (2, 3):
        raise ValueError(
            f"--churn wants RATE,MODEL[,PERIOD], got {spec!r} "
            f"(models: {CHURN_MODELS}, period default 10)")
    try:
        rate = float(parts[0])
    except ValueError:
        raise ValueError(f"--churn rate {parts[0]!r} is not a number")
    period = 10
    if len(parts) == 3:
        try:
            period = int(parts[2])
        except ValueError:
            raise ValueError(f"--churn period {parts[2]!r} is not an int")
    return ChurnSpec(rate=rate, model=parts[1], period=period).validate()


def parse_value_faults_arg(spec: str) -> ValueFaultSpec:
    """``--value-faults RATE,MODEL[,ROUND]`` -> validated ValueFaultSpec."""
    parts = [p.strip() for p in str(spec).split(",")]
    if len(parts) not in (2, 3):
        raise ValueError(
            f"--value-faults wants RATE,MODEL[,ROUND], got {spec!r} "
            f"(models: nan, inf, stuck, scale:K; round default 10)")
    try:
        rate = float(parts[0])
    except ValueError:
        raise ValueError(
            f"--value-faults rate {parts[0]!r} is not a number")
    rnd = 10
    if len(parts) == 3:
        try:
            rnd = int(parts[2])
        except ValueError:
            raise ValueError(
                f"--value-faults round {parts[2]!r} is not an int")
    return ValueFaultSpec(rate=rate, model=parts[1], round=rnd).validate()


def parse_event_plan(obj, num_nodes: Optional[int] = None, seed: int = 0):
    """Parse the ``--event-plan`` JSON document.

    One declarative file for the whole topology schedule — edge events,
    the churn generator, AND the fault keys the legacy ``--fault-plan``
    carries (so one document can express kills, revives, loss windows and
    churn together)::

        {
          "add_edges":      [{"round": 40, "edges": [[0, 5], [3, 9]]}],
          "remove_edges":   [{"round": 60, "edges": [[1, 2]]}],
          "swap_neighbors": [{"round": 80,
                              "pairs": [[[0, 1], [2, 3]]]}],
          "churn":          {"rate": 0.02, "model": "edge", "period": 25},
          "value_faults":   [{"round": 12, "rate": 0.05, "model": "nan"}],
          "kill":   [{"round": 10, "ids": [1, 2]}],
          "revive": [{"round": 30, "ids": [1, 2]}],
          "loss":   [{"start": 5, "stop": 25, "prob": 0.2}]
        }

    Returns ``(EventPlan, FaultSchedule)`` — the caller merges the fault
    part into its schedule (legacy flags and the plan compile down to the
    same engine). Raises ValueError on any malformed input (the CLI's
    exit-2 contract).
    """
    from gossipprotocol_tpu_torch.utils import faults

    if isinstance(obj, str):
        with open(obj) as f:
            obj = json.load(f)
    if not isinstance(obj, dict):
        raise ValueError("event plan must be a JSON object")
    unknown = set(obj) - set(_PLAN_KEYS)
    if unknown:
        raise ValueError(
            f"event plan: unknown key(s) {sorted(unknown)} "
            f"(valid: {', '.join(_PLAN_KEYS)})")

    def edge_events(key):
        out: Dict[int, np.ndarray] = {}
        entries = obj.get(key, ())
        if not isinstance(entries, (list, tuple)):
            raise ValueError(f"{key} must be a list of events")
        for ev in entries:
            if not isinstance(ev, dict) or "round" not in ev:
                raise ValueError(f"{key}: each event needs a 'round'")
            r = int(ev["round"])
            if key == "swap_neighbors":
                if "pairs" not in ev:
                    raise ValueError(f"{key}@{r}: needs 'pairs' "
                                     "([[u1,v1],[u2,v2]] entries)")
                try:
                    arr = np.asarray(ev["pairs"],
                                     dtype=np.int64).reshape(-1, 4)
                except (TypeError, ValueError):
                    raise ValueError(
                        f"{key}@{r}: pairs must be [[[u1,v1],[u2,v2]], ...]")
            else:
                if "edges" not in ev:
                    raise ValueError(f"{key}@{r}: needs 'edges' "
                                     "([[u, v], ...])")
                try:
                    arr = np.asarray(ev["edges"],
                                     dtype=np.int64).reshape(-1, 2)
                except (TypeError, ValueError):
                    raise ValueError(f"{key}@{r}: edges must be "
                                     "[[u, v], ...]")
            if not arr.size:
                raise ValueError(f"{key}@{r}: empty event")
            prev = out.get(r)
            out[r] = arr if prev is None else np.concatenate([prev, arr])
        return out

    value_faults = []
    if "value_faults" in obj:
        entries = obj["value_faults"]
        if not isinstance(entries, (list, tuple)):
            raise ValueError("value_faults must be a list of events")
        for ev in entries:
            if (not isinstance(ev, dict) or "rate" not in ev
                    or "model" not in ev):
                raise ValueError(
                    "value_faults: each event needs 'rate' and 'model' "
                    "(optional 'round')")
            extra = set(ev) - {"rate", "model", "round"}
            if extra:
                raise ValueError(
                    f"value_faults: unknown key(s) {sorted(extra)}")
            value_faults.append(ValueFaultSpec(
                rate=float(ev["rate"]), model=str(ev["model"]),
                round=int(ev.get("round", 10))).validate())

    churn = None
    if "churn" in obj:
        c = obj["churn"]
        if not isinstance(c, dict) or "rate" not in c or "model" not in c:
            raise ValueError(
                "churn must be an object with 'rate' and 'model' "
                "(optional 'period')")
        extra = set(c) - {"rate", "model", "period"}
        if extra:
            raise ValueError(f"churn: unknown key(s) {sorted(extra)}")
        churn = ChurnSpec(rate=float(c["rate"]), model=str(c["model"]),
                          period=int(c.get("period", 10))).validate()

    plan = EventPlan.from_events(
        adds=edge_events("add_edges"),
        removes=edge_events("remove_edges"),
        swaps=edge_events("swap_neighbors"),
        churn=churn,
        value_faults=tuple(value_faults),
    ).validate(num_nodes)
    sched = faults.FaultSchedule.from_json(
        {k: obj[k] for k in ("kill", "revive", "loss") if k in obj},
        num_nodes, seed=seed)
    return plan, sched


# ---------------------------------------------------------------------------
# event generation + application (host-side, chunk-boundary only)


def _undirected_edges(topo: Topology):
    """``(u, v)`` arrays (u < v, one record per undirected edge) plus the
    packed-key set the application pass mutates."""
    n = topo.num_nodes
    offsets = np.asarray(topo.offsets, np.int64)
    indices = np.asarray(topo.indices, np.int64)
    row = np.repeat(np.arange(n, dtype=np.int64), np.diff(offsets))
    und = row < indices
    return row[und], indices[und]


def generate_churn(topo: Topology, spec: ChurnSpec, *, run_seed: int,
                   event_round: int):
    """Materialize one churn event at ``event_round`` from the current
    adjacency — a pure function of its arguments, so live runs and resume
    replays regenerate identical events.

    Returns ``(removes [k,2], adds [k,2], swaps [k,4])`` int64 arrays
    (any may be empty).
    """
    if topo.implicit_full:
        raise ValueError("churn needs an explicit edge list; the implicit "
                         "complete graph has no CSR to rewrite")
    n = topo.num_nodes
    u, v = _undirected_edges(topo)
    num_edges = int(u.size)
    empty2 = np.empty((0, 2), np.int64)
    empty4 = np.empty((0, 4), np.int64)
    if num_edges == 0:
        return empty2, empty2, empty4
    rng = np.random.default_rng(
        [int(run_seed) & 0xFFFFFFFF, int(event_round), _CHURN_STREAM])
    k = max(1, int(round(spec.rate * num_edges)))
    if spec.model == "swap":
        c = min(2 * k, num_edges)
        c -= c % 2
        if c < 2:
            return empty2, empty2, empty4
        idx = rng.choice(num_edges, size=c, replace=False)
        quads = np.stack([u[idx[0::2]], v[idx[0::2]],
                          u[idx[1::2]], v[idx[1::2]]], axis=1)
        return empty2, empty2, quads

    # model == "edge": k removals of existing edges + k additions of
    # fresh non-edges (rejection-sampled with a bounded budget)
    k = min(k, num_edges)
    idx = rng.choice(num_edges, size=k, replace=False)
    removes = np.stack([u[idx], v[idx]], axis=1)
    existing = set((u * n + v).tolist())
    adds: list = []
    for _ in range(k * _ADD_DRAWS):
        if len(adds) >= k:
            break
        a = int(rng.integers(n))
        b = int(rng.integers(n))
        if a == b:
            continue
        key = min(a, b) * n + max(a, b)
        if key in existing:
            continue
        existing.add(key)
        adds.append((a, b))
    adds_arr = (np.asarray(adds, np.int64).reshape(-1, 2)
                if adds else empty2)
    return removes, adds_arr, empty4


def apply_edge_events(topo: Topology, *, removes=None, adds=None,
                      swaps=None):
    """Apply one round's edge events to an explicit-CSR topology.

    Order within the round: removals, then swaps (against the
    post-removal edge set), then additions. Invalid entries are
    *skipped and counted*, never fatal — a remove of an absent edge, an
    add of an existing edge or self-loop, a swap whose source edges are
    missing or whose crossed edges already exist: declarative plans stay
    applicable as the graph evolves under churn around them.

    Returns ``(new_topo, stats)`` with plain-typed stats
    (json-serializable, straight into the metrics stream)::

        {"changed": bool, "edges_added": int, "edges_removed": int,
         "edges_swapped": int, "edges_skipped": int}

    ``new_topo is topo`` when nothing changed (callers skip the device
    rebuild). The rebuilt CSR is canonical (:func:`csr_from_edges`), so
    the result is independent of assembly order — the bitwise-replay
    contract.
    """
    stats = {"changed": False, "edges_added": 0, "edges_removed": 0,
             "edges_swapped": 0, "edges_skipped": 0}
    if topo.implicit_full:
        raise ValueError("edge events need an explicit edge list; the "
                         "implicit complete graph has no CSR to rewrite")
    if topo.asymmetric:
        raise ValueError("edge events are defined on symmetric simple "
                         "graphs; got an asymmetric adjacency")
    n = topo.num_nodes
    u, v = _undirected_edges(topo)
    existing = set((u * n + v).tolist())

    key = lambda a, b: min(a, b) * n + max(a, b)  # noqa: E731
    for a, b in np.asarray(removes if removes is not None else (),
                           np.int64).reshape(-1, 2):
        a, b = int(a), int(b)
        k = key(a, b)
        if a == b or k not in existing:
            stats["edges_skipped"] += 1
            continue
        existing.remove(k)
        stats["edges_removed"] += 1
    for a1, b1, a2, b2 in np.asarray(swaps if swaps is not None else (),
                                     np.int64).reshape(-1, 4):
        a1, b1, a2, b2 = int(a1), int(b1), int(a2), int(b2)
        k1, k2 = key(a1, b1), key(a2, b2)
        n1, n2 = key(a1, b2), key(a2, b1)
        if (k1 == k2 or k1 not in existing or k2 not in existing
                or a1 == b2 or a2 == b1 or n1 == n2
                or n1 in existing or n2 in existing):
            stats["edges_skipped"] += 1
            continue
        existing.remove(k1)
        existing.remove(k2)
        existing.add(n1)
        existing.add(n2)
        stats["edges_swapped"] += 1
    for a, b in np.asarray(adds if adds is not None else (),
                           np.int64).reshape(-1, 2):
        a, b = int(a), int(b)
        k = key(a, b)
        if a == b or k in existing:
            stats["edges_skipped"] += 1
            continue
        existing.add(k)
        stats["edges_added"] += 1

    if not (stats["edges_added"] or stats["edges_removed"]
            or stats["edges_swapped"]):
        return topo, stats
    stats["changed"] = True
    keys = np.fromiter(existing, dtype=np.int64, count=len(existing))
    edges = np.stack([keys // n, keys % n], axis=1)
    return csr_from_edges(n, edges, kind=topo.kind), stats
