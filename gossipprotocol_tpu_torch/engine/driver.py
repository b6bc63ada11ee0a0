"""Experiment driver + convergence supervisor (port of the subset of
``gossipprotocol_tpu/engine/driver.py`` that the ported paths read:
gossip and fanout-one push-sum over the scatter delivery — the
reference's own ``N topology algorithm`` surface — and its gather-
inverted ``invert`` delivery; fanout-all push-sum over the edge-list
scatter, the fused gather delivery, the Clos-routed delivery and the
K-round megakernel; vector payloads (``payload_dim``), float64 state
(``dtype``), Poisson clocks (``clock``), the learning workloads
(``workload``: SGP and GALA, ``learn/``) and acceleration (``accel``,
``protocols/accel.py``); and the reference semantics, ``semantics=
"reference"``: gossip at threshold + 1, push-sum as the single-token walk
of ``protocols/walk.py``, and the quorum supervisor ``alert_quorum``).

The loop is chunked like the JAX engine's: one chunk advances rounds
until a host-known ``round_limit`` or global convergence, whichever comes
first, and the host fetches the chunk's summary once. The JAX engine
tests the supervisor predicate in a ``while_loop`` condition before every
round; here a chunk runs ``round_limit - round`` rounds unconditionally
and freezes the state once the predicate holds
(``torch.where(done, old, new)``, counting ``round`` only while not
frozen — the megakernel's freeze rule, ``ops/megakernel.py:237-254`` of
the JAX package). Round counts therefore equal the JAX engine's exactly,
with no host round-trip per round. The megakernel path
(:func:`use_megakernel`) enqueues one launch per K rounds instead, and
the kernel itself stops at convergence.

The fanout-one paths draw from the counter-based device RNG; a chunk
hashes its rounds' keys ``fold_in(key(seed), r)`` in one pass. Gossip's
gather-inverted branch (on the CPU only: :func:`gossip_inversion_enabled`)
is chosen per chunk on the host, from the previous chunk's fetched
summary (see :class:`GossipCore`). The walk runs its own chunk of hops
(:func:`~gossipprotocol_tpu_torch.protocols.walk.make_walk_chunk_runner`),
:data:`WALK_CHUNK_HOPS` per fetch unless ``chunk_rounds`` says otherwise.

The sharded push design (``--devices S``) has its own engine in
``parallel/sharded.py`` over the same chunk runner; its fields here are
``routed_design``, ``exchange_overlap``, ``payload_wire`` and
``build_workers``.

Faults, events, repair, checkpoints and the health sentinel ride the
host loop (:func:`_drive`) as in the JAX engine: host events
(``events/engine.py`` :class:`~gossipprotocol_tpu_torch.events.engine.
HostEvents`: kills, revives, edge churn, repair, the partition rule,
value faults) fire between chunks, each chunk stopping at the next event
round; an adjacency change rebuilds the round's device arrays through
``rebuild`` (the plan cache, under the new CSR's key); checkpoints are
saved every ``checkpoint_every`` chunks (``utils/checkpoint.py``); the
sentinel, when on, freezes a chunk at the first round whose state holds
a non-finite or negative row and the loop records, quarantines or rolls
back. Loss windows are device events inside the drawing rounds.

Telemetry (``telemetry``, an :class:`~gossipprotocol_tpu_torch.obs.
Telemetry` hub; ``obs/``) rides the same loop, as in the JAX engine:
host spans for the topology, protocol and plan builds, the warm-up, every
chunk, host events, checkpoints and the final sync; the message counters
(``obs/counters.py``) and the per-round trace rows (``obs/trace.py``) of
a chunk ride its one int32 fetch (:func:`chunk_stats`), read from the
states only, so the trajectory is bitwise the run without telemetry; the
mass drift in ULPs against a baseline taken by the chunk's own
reduction; the analytic round prediction and the round budget
(``round_budget``, an int or ``"auto"``, with its ``over_budget``
record); and the graceful stop (:func:`install_stop_check`, ``drain``).
With ``telemetry`` unset and no ``metrics_callback`` the chunk runners
enqueue what they enqueue without this machinery.

Sweeps (``sweep``, a :class:`~gossipprotocol_tpu_torch.sweep.SweepSpec`)
run B lanes through this module's chunk runner with a leading lane
dimension (``sweep/engine.py``): one delivery build, one fetch a chunk,
each lane frozen on its own predicate.

What is not yet ported exits as a :class:`NotPortedError` naming itself:
the sharded pull design, float64 state on the reference walk; and under
the sharded engine (``--devices``) sweeps and every flag of faults,
events, repair, checkpoints, the sentinel, vector payloads, the learning
workloads, clocks, acceleration and float64.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from gossipprotocol_tpu_torch.obs.counters import ulp_drift
from gossipprotocol_tpu_torch.ops.build import resolve_device
from gossipprotocol_tpu_torch.ops.delivery import RoutedConfigError
from gossipprotocol_tpu_torch.protocols.diffusion import (
    pushsum_diffusion_round_routed,
)
from gossipprotocol_tpu_torch.protocols.gossip import (
    gossip_done, gossip_round_core, inversion_legal,
)
from gossipprotocol_tpu_torch.protocols.pushsum import (
    pushsum_done, pushsum_round_core, tree_sum0,
)
from gossipprotocol_tpu_torch.protocols.sampling import (
    key_data, round_keys, use_dense,
)
from gossipprotocol_tpu_torch.protocols.state import (
    DTYPES, GossipState, PushSumState, gossip_init, pushsum_init,
    pushsum_payload_values, torch_dtype,
)
from gossipprotocol_tpu_torch.topology.base import Topology

ALGORITHMS = ("gossip", "push-sum")

# Rounds per chunk (one host fetch each). A fixed default: the JAX
# engine's auto size is a TPU-watchdog cost model that does not apply.
# A chunk runs to its limit, frozen rounds included, so a large chunk
# spends up to chunk - 1 rounds past convergence; 16 beat 64 and 8 on
# the card's smoke graphs (PERF.md, utils/profiling.py). Rounded up to a
# multiple of the megakernel's K.
DEFAULT_CHUNK_ROUNDS = 16
# Hops per chunk of the reference walk (one host fetch each). On the card
# a chunk is one launch of csrc/walk.cu, which stops at the quorum, so a
# large chunk costs no frozen hops and spreads the fetch over more hops:
# through the CLI's --chunk-rounds at imp3D 262,144 on an H100 (PERF.md
# §5, chip_smoke.py (l)) 256 hops a chunk took about twice the time a hop
# of 16,384 did, and 65,536 gained a few per cent more. On the CPU the
# plain chunk stops at the quorum too, but hashes the draws of the whole
# chunk ([hops, spans] on a table graph) first, which bounds the chunk.
# One default for both devices, so that card and CPU print the same lines.
WALK_CHUNK_HOPS = 16384

# the fanout-all deliveries the port runs, and those of them whose fused
# kernel can loop rounds (--rounds-per-kernel > 1); routed dispatches one
# round per launch by construction. The fanout-one sender and gossip run
# the scatter delivery.
DELIVERIES = ("pallas", "megakernel", "routed")
FUSED_DELIVERIES = ("pallas", "megakernel")
ALL_DELIVERIES = ("scatter", "invert", "routed", "pallas", "megakernel")


class NotPortedError(ValueError):
    """The configuration asks for a path the PyTorch port lacks."""


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The fields the ported paths read (names and defaults as in the JAX
    package's ``RunConfig``: gossip, fanout one, the scatter delivery),
    plus ``device``."""

    algorithm: str = "gossip"
    seed: int = 0
    threshold: int = 10            # gossip hits to converge
    keep_alive: bool = True        # gossip: spreaders keep spreading
                                   # until global convergence
    seed_node: Optional[int] = None  # gossip start node; None = drawn
                                   # from the seed (pick_seed_node)
    semantics: str = "intended"    # "intended" | "reference" (the F#
                                   # simulator's accidental rules: gossip
                                   # threshold + 1, push-sum as the
                                   # single-token walk)
    alert_quorum: Optional[int] = None  # settled rows that end the run
                                   # (None = all): the reference's N+1
                                   # actors converging at N Alerts
    eps: float = 1e-10             # push-sum |Δ(s/w)| tolerance
    streak_target: int = 3         # consecutive rounds within tolerance
    predicate: str = "delta"       # "delta" (local) | "global" (sound)
    tol: float = 1e-4              # global-predicate tolerance
    fanout: str = "one"            # push-sum sender: "one" (a random
                                   # neighbour) | "all" (diffusion)
    delivery: str = "scatter"      # fanout one: "scatter" | "invert" (the
                                   # receivers recompute the draws);
                                   # fanout all: "scatter" | "pallas" |
                                   # "routed" | "megakernel"
    edge_chunks: int = 1           # fanout-all scatter: deliver in this
                                   # many sequential edge slices
    value_mode: str = "scaled"     # push-sum init: "scaled" (i/N) | "index" (i)
    payload_dim: int = 1           # push-sum payload width d: 1 = the
                                   # scalar (s, w) protocol; d > 1 rides an
                                   # [n, d] payload (w stays per node)
    workload: str = "avg"          # "avg" | "sgp" (Stochastic Gradient
                                   # Push on a least-squares shard per
                                   # node) | "gala" (learner groups)
    clock: str = "sync"            # "sync" | "poisson" (a node sends iff
                                   # its rate-r clock ticked this round)
    activation_rate: float = 1.0   # poisson clock rate r: per-round
                                   # activation probability 1 - exp(-r)
    groups: int = 1                # GALA learner groups (workload="gala")
    accel: str = "off"             # fanout-all scatter acceleration: "off" |
                                   # "chebyshev" | "epd"
    accel_lambda: Optional[float] = None  # Chebyshev γ = |λ₂(W)| in (0, 1);
                                   # None = host power-iteration estimate
    lr: float = 0.05               # SGP local gradient step size
    local_steps: int = 1           # SGP gradient steps per gossip round
    sgp_samples: int = 8           # SGP least-squares rows per node shard
    loss_tol: float = 1e-5         # SGP loss plateau: converge only when
                                   # |Δ mean loss| <= loss_tol as well
    dtype: str = "float32"         # push-sum state: "float32" | "float64"
                                   # (--x64; the scatter paths)
    max_rounds: int = 1_000_000
    chunk_rounds: Optional[int] = None  # None = DEFAULT_CHUNK_ROUNDS
    rounds_per_kernel: int = 1     # rounds per megakernel launch (K)
    plan_cache: Optional[str] = None  # plan cache dir; None = default
                                   # ($GOSSIP_TPU_PLAN_CACHE or ~/.cache/
                                   # ...), "none" = off. A hit loads the
                                   # tables a build would produce
    build_workers: Optional[int] = None  # processes for cold sharded-plan
                                   # builds; None = min(shards, cpus).
                                   # Plans do not depend on it
    routed_design: str = "push"    # sharded routed delivery: "push"
                                   # (owner-computes + edge-share
                                   # exchange); "pull" is not yet ported
    payload_wire: str = "f32"      # sharded edge-share slab wire dtype:
                                   # "f32" (bitwise) | "bf16" | "int8"
                                   # (quantized on the wire, f32
                                   # accumulation)
    exchange_overlap: bool = False  # sharded exchange on the ring
                                   # schedule (pallas_exchange
                                   # overlap=True); the same bytes move
    checkpoint_every: int = 0      # chunks between checkpoints; 0 = off
    checkpoint_dir: Optional[str] = None
    fault_plan: Optional[dict] = None  # legacy {round: node_ids} kill
                                   # sugar; merges into the schedule
    fault_schedule: Optional[Any] = None  # utils.faults.FaultSchedule:
                                   # timed kill/revive strikes + link-loss
                                   # windows
    repair: str = "off"            # overlay repair at event rounds: "off" |
                                   # "prune" | "rewire" (topology/repair.py)
    event_plan: Optional[Any] = None  # events.EventPlan: timed edge
                                   # add/remove/swap events, the churn
                                   # generator and value faults
    sentinel: str = "off"          # health sentinel: "off" (the chunk
                                   # launches what it launches without
                                   # it) | "on" (detect, record, stop) |
                                   # "quarantine" (kill + zero the
                                   # offending rows through the host
                                   # events) | "rollback" (quarantine +
                                   # restore the newest checkpoint
                                   # predating the trip)
    quarantine_log: Tuple = ()     # ((round, (ids...)), ...) quarantines a
                                   # resumed checkpoint lived through (its
                                   # "quarantines" metadata), replayed into
                                   # the adjacency like scheduled kills
    metrics_callback: Optional[Callable[[dict], None]] = None  # receives
                                   # every chunk and host-event record
                                   # (the CLI's --metrics-out writer)
    telemetry: Optional[Any] = None  # obs.Telemetry hub (None = off: the
                                   # chunk runners enqueue what they do
                                   # without it). On, the counters and
                                   # trace rows are read from the states
                                   # and never fed back, so the
                                   # trajectory is bitwise unchanged. NOT
                                   # a trajectory field
    round_budget: Optional[Any] = None  # None = unlimited; an int caps
                                   # the run at that many rounds with an
                                   # over_budget record; "auto" takes
                                   # the cap from the analytic round
                                   # prediction (obs/predict.py). NOT a
                                   # trajectory field
    sweep: Optional[Any] = None    # sweep.SweepSpec: B lanes (seeds,
                                   # tolerances, rates) through one round
                                   # program with a leading lane dimension
                                   # (sweep/engine.py). None = the
                                   # ordinary single-run engine. Lane i is
                                   # bitwise the standalone run with lane
                                   # i's config (on the card: gossip
                                   # bitwise, push-sum up to the float
                                   # atomics' order)
    device: str = "cuda"

    @property
    def schedule(self):
        """The effective :class:`~gossipprotocol_tpu_torch.utils.faults.
        FaultSchedule`: ``fault_schedule`` with the legacy ``fault_plan``
        kills merged in (possibly empty, never None)."""
        from gossipprotocol_tpu_torch.utils import faults

        return faults.as_schedule(self.fault_schedule, self.fault_plan)

    @property
    def events(self):
        """The effective :class:`~gossipprotocol_tpu_torch.events.plan.
        EventPlan` (possibly empty, never None)."""
        from gossipprotocol_tpu_torch.events import plan as events_plan

        return events_plan.as_plan(self.event_plan)

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; valid: {ALGORITHMS}")
        if self.semantics not in ("intended", "reference"):
            raise ValueError("semantics must be 'intended' or 'reference'")
        ref = self.semantics == "reference"
        if self.predicate not in ("delta", "global"):
            raise ValueError("predicate must be 'delta' or 'global'")
        if self.predicate == "global" and ref:
            raise ValueError(
                "predicate='global' is incompatible with semantics='reference' "
                "(the reference's accidental rule ignores the estimate entirely)"
            )
        if self.alert_quorum is not None and self.alert_quorum < 1:
            raise ValueError("alert_quorum must be >= 1")
        if self.fanout not in ("one", "all"):
            raise ValueError("fanout must be 'one' or 'all'")
        if self.fanout == "all" and ref:
            raise ValueError(
                "fanout='all' is incompatible with semantics='reference': the "
                "single-target send IS the reference's accidental behavior "
                "(Program.fs:128) that the diffusion variant replaces"
            )
        if self.delivery not in ALL_DELIVERIES:
            raise ValueError("delivery must be 'scatter', 'invert', "
                             "'routed', 'pallas', or 'megakernel'")
        sched = self.schedule.validate()  # structural check, loud + early
        from gossipprotocol_tpu_torch.topology.repair import validate_policy

        validate_policy(self.repair)
        # structural plan check (the id range is checked at engine entry,
        # where the topology is known)
        plan = self.events.validate()
        if plan and ref:
            raise ValueError(
                "event plans rewrite the adjacency mid-run; "
                "semantics='reference' replays the F# baseline's static "
                "world and rejects topology schedules")
        if self.repair != "off" and ref:
            raise ValueError(
                "repair applies to faulted runs; semantics='reference' "
                "rejects fault schedules entirely, so there is nothing "
                "to repair")
        if bool(self.checkpoint_every) != bool(self.checkpoint_dir):
            import warnings

            missing = ("checkpoint_dir" if self.checkpoint_every
                       else "checkpoint_every")
            given = ("checkpoint_every" if self.checkpoint_every
                     else "checkpoint_dir")
            warnings.warn(
                f"checkpointing is DISABLED: {given} is set but {missing} "
                "is not — both are required, no checkpoint will be "
                "written this run", stacklevel=2)
        if self.delivery in DELIVERIES and (
                self.algorithm != "push-sum" or self.fanout != "all"):
            raise ValueError(
                f"delivery='{self.delivery}' applies to fanout-all "
                "diffusion only (the static edge structure is what the "
                "routing plan compiles; single-target draws fresh targets "
                "every round — see README 'Performance')")
        if self.delivery in DELIVERIES and sched.has_loss:
            # kill/revive strikes are fine (the live-degree path is exact
            # under any dead set); a static plan cannot thread a fresh
            # per-edge drop mask
            raise ValueError(
                f"delivery='{self.delivery}' compiles a static "
                "routing plan and cannot apply per-edge drop masks "
                "through it; use delivery='scatter' for loss windows")
        if self.edge_chunks < 1:
            raise ValueError("edge_chunks must be >= 1")
        if self.edge_chunks > 1 and not (
                self.algorithm == "push-sum" and self.fanout == "all"):
            raise ValueError(
                "edge_chunks applies to fanout-all diffusion only (the "
                "other senders have no per-edge intermediates to slice)")
        if self.edge_chunks > 1 and self.delivery in DELIVERIES:
            raise ValueError(
                "edge_chunks applies to the scatter delivery; the routed "
                "and pallas plans stream at fixed memory already")
        if self.dtype not in DTYPES:
            raise ValueError("dtype must be 'float32' or 'float64'")
        if self.delivery in DELIVERIES and self.dtype != "float32":
            raise ValueError(
                f"delivery='{self.delivery}' routes f32 lane pairs; "
                "use delivery='scatter' for float64 runs")
        if use_megakernel(self):
            # the in-kernel round loop replays the all-alive synchronous
            # scalar averaging round only
            if self.clock != "sync":
                raise ValueError(
                    "the round-loop megakernel replays the synchronous "
                    "round in-register; poisson activation draws fresh "
                    "masks per round — use clock='sync' or "
                    "rounds_per_kernel=1")
            if self.payload_dim != 1:
                raise ValueError(
                    "the round-loop megakernel carries the scalar (s, w) "
                    "state in VMEM; vector payloads need the per-round "
                    "pallas path — use delivery='pallas' with "
                    "rounds_per_kernel=1")
            if self.workload != "avg":
                raise ValueError(
                    "the round-loop megakernel fuses the plain averaging "
                    "round; SGP/GALA inject gradient mass between rounds "
                    "— use delivery='pallas' with rounds_per_kernel=1")
        if use_megakernel(self) and (sched or plan
                                     or self.repair != "off"):
            raise ValueError(
                "the round-loop megakernel compiles K rounds against "
                "a fixed live topology; fault strikes, loss windows, "
                "topology events and repair all need the per-round "
                "engine — use delivery='pallas' with "
                "rounds_per_kernel=1")
        if self.sentinel not in ("off", "on", "quarantine", "rollback"):
            raise ValueError(
                "sentinel must be 'off', 'on', 'quarantine', or 'rollback'")
        if plan.value_faults and self.algorithm != "push-sum":
            raise ValueError(
                "value faults corrupt push-sum's (s, w) payload; "
                "gossip carries no numeric mass to poison — use "
                "algorithm='push-sum'")
        if self.sentinel != "off":
            if self.algorithm != "push-sum":
                raise ValueError(
                    "the health sentinel checks push-sum's (s, w) mass "
                    "invariants; gossip has none — use "
                    "algorithm='push-sum'")
            if ref:
                raise ValueError(
                    "the sentinel guards the mass-conserving push-sum "
                    "state; semantics='reference' replays the F# walk "
                    "and rejects it")
            if use_megakernel(self):
                raise ValueError(
                    "the sentinel folds its health check through the "
                    "per-round chunk loop; the round-loop megakernel "
                    "checks nothing between its fused rounds — use "
                    "delivery='pallas' with rounds_per_kernel=1")
            if self.sweep is not None:
                raise ValueError(
                    "the sentinel quarantines through the host-event "
                    "pipeline, which the vmapped sweep lanes do not "
                    "carry — run sentinel runs unswept")
        if self.sentinel == "rollback" and not (
                self.checkpoint_every and self.checkpoint_dir):
            raise ValueError(
                "sentinel='rollback' restores the newest checkpoint "
                "predating a trip; it requires checkpoint_every AND "
                "checkpoint_dir")
        if is_walk(self) and self.delivery != "scatter":
            raise ValueError(
                "delivery variants invert/route the all-send deliveries; "
                "reference push-sum is the single-token walk and has "
                "nothing to invert — drop --delivery")
        if self.delivery == "invert":
            if self.algorithm != "push-sum" or self.fanout != "one":
                raise ValueError(
                    "delivery='invert' applies to single-target push-sum "
                    "only (gossip picks its inverted delivery "
                    "automatically; diffusion walks every edge and has "
                    "nothing to invert)")
            if sched or plan:
                raise ValueError(
                    "delivery='invert' is exact only while no node can die "
                    "mid-run, every send lands, and the adjacency never "
                    "changes (receivers recompute senders' draws against "
                    "the compiled graph); drop the fault schedule / event "
                    "plan or use delivery='scatter'")
        self._check_workloads(sched, plan, ref)
        if self.threshold < 1:
            raise ValueError("threshold must be >= 1")
        if self.rounds_per_kernel < 1:
            raise ValueError("rounds_per_kernel must be >= 1")
        if (self.rounds_per_kernel > 1
                and self.delivery not in FUSED_DELIVERIES):
            raise ValueError(
                "rounds_per_kernel > 1 loops rounds inside the fused "
                "kernel — it requires delivery='pallas' (or "
                f"'megakernel'); --delivery {self.delivery} dispatches "
                "one round per launch by construction")
        if (use_megakernel(self) and self.chunk_rounds is not None
                and self.chunk_rounds % self.rounds_per_kernel):
            raise ValueError(
                f"chunk_rounds ({self.chunk_rounds}) must be a multiple "
                f"of rounds_per_kernel ({self.rounds_per_kernel}) so "
                "chunk boundaries land on super-step boundaries")
        if self.delivery == "pallas" and self.routed_design == "pull":
            raise ValueError(
                "delivery='pallas' shards with the push design only "
                "(the async remote-copy exchange replaces the push "
                "path's all_to_all; pull has no edge-share exchange "
                "to replace) — drop routed_design='pull'")
        if self.routed_design not in ("push", "pull"):
            raise ValueError("routed_design must be 'push' or 'pull'")
        if self.routed_design == "pull":
            raise NotPortedError(
                "routed_design 'pull' is not yet ported (the sharded "
                "push design is)")
        if self.payload_wire not in ("f32", "bf16", "int8"):
            raise ValueError(
                "payload_wire must be 'f32', 'bf16', or 'int8'")
        if self.payload_wire != "f32" \
                and self.delivery not in ("routed", "pallas"):
            raise ValueError(
                "payload_wire compresses the sharded push-design "
                "edge-share slab; it requires delivery='routed' or "
                "'pallas' (the scatter paths ship no slab, and the "
                "megakernel is single-chip)")
        if self.exchange_overlap \
                and self.delivery not in ("routed", "pallas"):
            raise ValueError(
                "exchange_overlap schedules the sharded push-design "
                "exchange on the double-buffered DMA ring; it "
                "requires delivery='routed' or 'pallas'")
        if self.build_workers is not None and self.build_workers < 1:
            raise ValueError("build_workers must be >= 1")
        if self.value_mode not in ("scaled", "index"):
            raise ValueError("value_mode must be 'scaled' or 'index'")
        if self.streak_target < 1:
            raise ValueError("streak_target must be >= 1")
        if self.chunk_rounds is not None and self.chunk_rounds < 1:
            raise ValueError("chunk_rounds must be >= 1")
        if self.round_budget is not None and self.round_budget != "auto":
            if not isinstance(self.round_budget, int) or isinstance(
                    self.round_budget, bool) or self.round_budget < 1:
                raise ValueError(
                    "round_budget must be None, a positive int, or 'auto'")

    def _check_workloads(self, sched, plan, ref: bool) -> None:
        """The JAX package's checks of vector payloads, clocks, the
        learning workloads and acceleration (its messages)."""
        if self.payload_dim < 1:
            raise ValueError("payload_dim must be >= 1")
        if self.payload_dim > 1:
            if self.algorithm != "push-sum" or ref:
                raise ValueError(
                    "payload_dim > 1 rides push-sum's (s, w) state under "
                    "intended semantics; gossip and the reference replay "
                    "are scalar protocols")
            if self.delivery == "invert":
                raise ValueError(
                    "delivery='invert' recomputes senders' scalar draws "
                    "and is scalar-payload only; use 'scatter' or 'routed' "
                    "for payload_dim > 1")
        if self.workload not in ("avg", "sgp", "gala"):
            raise ValueError("workload must be 'avg', 'sgp', or 'gala'")
        if self.clock not in ("sync", "poisson"):
            raise ValueError("clock must be 'sync' or 'poisson'")
        if self.activation_rate <= 0:
            raise ValueError(
                "activation_rate is a Poisson clock rate and must be > 0")
        if self.clock == "poisson":
            if self.accel != "off":
                raise ValueError(
                    "clock='poisson' gates senders per round; the "
                    "accelerated schemes assume the *fixed* mixing matrix "
                    "W every iteration — run them under clock='sync'")
            if ref:
                raise ValueError(
                    "clock='poisson' models continuous-time activation; "
                    "semantics='reference' replays the F# baseline's "
                    "synchronous accident and must stay clock='sync'")
            if self.delivery == "invert":
                raise ValueError(
                    "delivery='invert' reconstructs deliveries assuming "
                    "every eligible sender sent; a poisson clock idles "
                    "senders every round — use delivery='scatter'")
        if self.groups < 1:
            raise ValueError("groups must be >= 1")
        if self.groups > 1 and self.workload != "gala":
            raise ValueError(
                "groups partitions nodes into GALA learner groups; it "
                "requires workload='gala'")
        if self.workload == "gala":
            if self.groups < 2:
                raise ValueError(
                    "workload='gala' needs at least 2 learner groups "
                    "(groups=1 is plain SGP — use workload='sgp')")
            if self.algorithm != "push-sum" or ref:
                raise ValueError(
                    "workload='gala' mixes between groups by push-sum "
                    "gossip: it requires algorithm='push-sum' with "
                    "intended semantics")
            if self.predicate != "global":
                raise ValueError(
                    "workload='gala' certifies inter-group consensus, "
                    "which is the 'global' predicate")
            if self.accel != "off":
                raise ValueError(
                    "workload='gala' re-injects mass every round (local "
                    "gradient steps + group averaging); the accelerated "
                    "schemes assume a fixed linear iteration")
            if self.delivery != "scatter":
                raise ValueError(
                    "workload='gala' supports delivery='scatter' (same "
                    "contract as workload='sgp')")
            if sched or plan:
                raise ValueError(
                    "workload='gala' keeps groups exactly synchronized "
                    "by intra-group averaging; fault strikes, loss "
                    "windows and topology events are not modeled for it "
                    "yet — drop the fault schedule / event plan")
        if self.accel not in ("off", "chebyshev", "epd"):
            raise ValueError("accel must be 'off', 'chebyshev', or 'epd'")
        if self.lr <= 0:
            raise ValueError("lr must be > 0")
        if self.local_steps < 1:
            raise ValueError("local_steps must be >= 1")
        if self.sgp_samples < 1:
            raise ValueError("sgp_samples must be >= 1")
        if self.loss_tol <= 0:
            raise ValueError("loss_tol must be > 0")
        if self.workload == "sgp":
            if self.algorithm != "push-sum" or ref:
                raise ValueError(
                    "workload='sgp' is Stochastic Gradient *Push*: it "
                    "requires algorithm='push-sum' with intended semantics")
            if self.predicate != "global":
                raise ValueError(
                    "workload='sgp' certifies consensus distance, which is "
                    "the 'global' predicate; the local 'delta' rule would "
                    "fire while gradients still move the mean")
            if self.accel != "off":
                raise ValueError(
                    "workload='sgp' re-injects mass every round (gradient "
                    "steps); the accelerated two-buffer schemes assume a "
                    "fixed linear iteration — run them on workload='avg'")
            if self.delivery not in ("scatter", "routed", "pallas"):
                raise ValueError(
                    "workload='sgp' supports delivery='scatter', "
                    "'routed', or 'pallas' (the fanout-all plans ride "
                    "the d-dim payload through matvec_payload; invert is "
                    "scalar-only and the megakernel fuses the scalar "
                    "averaging round)")
        if self.accel != "off":
            if self.algorithm != "push-sum" or self.fanout != "all":
                raise ValueError(
                    "accel applies to fanout-all diffusion push-sum: the "
                    "polynomial schemes accelerate a fixed mixing matrix W, "
                    "which only the diffusion sender applies")
            if self.delivery != "scatter":
                raise ValueError(
                    "accel currently runs on delivery='scatter' (the "
                    "two-buffer combination wraps the scatter diffusion "
                    "mix)")
            if sched:
                raise ValueError(
                    "accel assumes a *fixed* mixing matrix: Chebyshev/EPD "
                    "coefficient schedules are invalid the moment a strike "
                    "or loss window rewrites W mid-run; drop the fault "
                    "schedule or use accel='off'")
            if self.repair != "off":
                raise ValueError(
                    "accel assumes a fixed mixing matrix; repair rewrites "
                    "the adjacency mid-run")
            if plan:
                raise ValueError(
                    "accel assumes a fixed mixing matrix; an event plan "
                    "rewrites the adjacency mid-run")
        if self.accel_lambda is not None and not (
                0.0 < self.accel_lambda < 1.0):
            raise ValueError(
                "accel_lambda is a spectral bound γ = |λ₂(W)| and must lie "
                "strictly in (0, 1)")
        if ref and self.algorithm == "push-sum" and self.dtype != "float32":
            raise NotPortedError(
                "option not yet ported: --x64 with --semantics reference "
                "push-sum (the walk runs float32)")

    @property
    def chunk(self) -> int:
        if self.chunk_rounds:
            return self.chunk_rounds
        if is_walk(self):
            return WALK_CHUNK_HOPS
        k = self.rounds_per_kernel
        return -(-DEFAULT_CHUNK_ROUNDS // k) * k


def is_walk(cfg: RunConfig) -> bool:
    """Is this run the reference's single-token push-sum walk?"""
    return cfg.algorithm == "push-sum" and cfg.semantics == "reference"


def use_megakernel(cfg: RunConfig) -> bool:
    """Does this config run the K-round kernel (ops/megakernel.py)?
    ``--delivery megakernel`` always; the pallas path joins it when
    ``--rounds-per-kernel`` exceeds 1. K = 1 on ``--delivery pallas``
    stays the per-round path."""
    return cfg.delivery == "megakernel" or (
        cfg.delivery == "pallas" and cfg.rounds_per_kernel > 1)


@dataclasses.dataclass
class RunResult:
    converged: bool
    rounds: int
    wall_ms: float            # convergence time, excluding warm-up
    compile_ms: float         # warm-up: kernel build/load + first round
    num_nodes: int
    algorithm: str
    final_state: Any          # GossipState or PushSumState, CPU tensors
    # round iterations the device ran. The per-round path counts frozen
    # ones (a chunk runs to its limit, up to chunk - 1 rounds past
    # convergence); the megakernel stops at convergence, so its count —
    # the sum of the kernel's own ``executed`` — equals ``rounds`` less
    # the start
    rounds_executed: int = 0
    # the host loop's records: one per chunk ({"round", ...}) and
    # one per host event ({"event": "repair" | "churn" | "value_fault" |
    # "sentinel_trip" | "quarantine" | "rollback" | "rollback_fallback",
    # ...}), as the JAX engine's metrics stream
    metrics: List[dict] = dataclasses.field(default_factory=list)
    checkpoints: List[str] = dataclasses.field(default_factory=list)
    # "drain" when an installed stop check (install_stop_check) ended the
    # run at a chunk boundary; None for every run that ran its course
    stopped: Optional[str] = None

    @property
    def estimate_error(self) -> Optional[float]:
        """Push-sum: max |s/w − achievable mean| over healthy nodes (the
        mean over healthy rows only, in float64 on the host; the walk's
        in-flight message carries real mass and counts too); None for
        gossip."""
        st = self.final_state
        if not hasattr(st, "ratio"):
            return None
        ratio = st.ratio.numpy().astype(np.float64)
        alive = st.alive.numpy()
        if not alive.any():
            return None
        s = st.s.numpy().astype(np.float64)[alive].sum(axis=0)
        w = st.w.numpy().astype(np.float64)[alive].sum()
        if hasattr(st, "msg_s"):
            s = s + float(st.msg_s)
            w += float(st.msg_w)
        return float(np.abs(ratio[alive] - s / w).max())


def initial_alive(topo: Topology) -> Optional[np.ndarray]:
    """Healthy-at-birth mask: only the largest connected component
    (None = everyone healthy)."""
    return topo.birth_alive()


def pick_seed_node(num_nodes: int, seed: int, alive=None) -> int:
    """Random gossip start node, from the run seed (the JAX package's
    ``seed ^ 0x5EED`` numpy stream); a pick among the birth exclusions is
    redrawn among the alive nodes."""
    rng = np.random.default_rng(seed ^ 0x5EED)
    node = int(rng.integers(0, num_nodes))
    if alive is not None and not bool(alive[node]):
        alive_ids = np.flatnonzero(alive)
        if alive_ids.size:
            node = int(rng.choice(alive_ids))
    return node


def effective_keep_alive(topo: Topology, cfg: RunConfig) -> bool:
    """The keep-alive rule in force. Reference mode renders Actor2's
    asymmetry: the keep-alive driver is started for line/3D/imp3D gossip
    (``Program.fs:200,271``) but not for the full topology
    (``Program.fs:224-228`` sends no ``Adder``)."""
    ref = cfg.semantics == "reference"
    return cfg.keep_alive and not (ref and topo.kind == "full")


def gossip_inversion_enabled(topo: Topology, cfg: RunConfig) -> bool:
    """Does the gossip run carry the gather-inversion table? The JAX
    package's rule (every dense-table gossip run of a symmetric graph;
    its ``GOSSIP_TPU_INVERT=0`` opt-out is not ported), on the CPU only,
    where the port mirrors the JAX engine branch for branch. On the card
    the inverted branch converged no faster than the scatter at imp3D
    and Erdős–Rényi 1M (the round is host-paced) and its table costs a
    1.4-1.8 s host lexsort, so the card runs the scatter (PERF.md,
    ``utils/profiling.py --algorithm gossip``). Whether a chunk takes the
    inverted branch is decided at run time (:class:`GossipCore`). A run
    with loss windows never inverts: the JAX engine's per-round legality
    adds "no loss this round", and both branches give the same hits
    wherever it holds, so the scatter alone is the same trajectory. Nor
    does a run under a Poisson clock (idle spreaders break legality every
    round; the JAX package's rule)."""
    return gossip_inverts(cfg, asymmetric=topo.asymmetric,
                          dense=use_dense(topo))


def gossip_inverts(cfg: RunConfig, *, asymmetric: bool,
                   dense: bool) -> bool:
    """:func:`gossip_inversion_enabled`'s rule from the graph's
    asymmetry and table kind alone (the capacity planner's, before any
    graph exists)."""
    return (cfg.algorithm == "gossip" and not asymmetric and dense
            and not cfg.schedule.has_loss and cfg.clock == "sync"
            and torch.device(cfg.device).type == "cpu")


def gossip_spreading_count(state: GossipState,
                           keep_alive: bool) -> torch.Tensor:
    """Nodes still able to deliver a hit. Zero while unconverged means the
    rumor is dead (``keep_alive=False`` let every spreader go silent): the
    driver stops instead of grinding to ``max_rounds``."""
    heard = (state.counts >= 1) & state.alive
    if not keep_alive:
        heard = heard & ~state.converged
    return torch.sum(heard.to(torch.int32))


class GossipCore:
    """The gossip round of one run, ``core(state, nbrs, key)``, with the
    delivery branch of the current chunk (``inverted``).

    The JAX package tests the inverted branch's legality on the device
    every round (``jax.lax.cond``); reading that flag on the host every
    round would stall the stream. Here the branch is fixed per chunk:
    :meth:`observe` reads the legality of the state a chunk starts from
    out of the previous chunk's one fetch, and the chunk takes the
    inverted branch only if it held and keep-alive is on. Under
    keep-alive with a fixed alive set ``heard`` only grows, so a legal
    state stays legal for the rest of the chunk (host events, which
    change it, fire between chunks, and the engine observes the state
    again after them); under ``keep_alive=False`` a node converging
    mid-chunk falls silent and breaks legality, so such a run keeps the
    scatter branch. On legal rounds both branches give bitwise equal
    hits, so the trajectory is the JAX package's whichever is taken."""

    def __init__(self, *, n: int, threshold: int, keep_alive: bool,
                 all_alive: bool, invertible: bool,
                 loss_windows: tuple = (), clock: tuple = ()):
        self.opts = dict(n=n, threshold=threshold, keep_alive=keep_alive,
                         all_alive=all_alive, loss_windows=loss_windows,
                         clock=clock)
        self.invertible = invertible
        self.inverted = False

    def __call__(self, state: GossipState, nbrs, key) -> GossipState:
        return gossip_round_core(state, nbrs, key, inverted=self.inverted,
                                 **self.opts)

    def extra_stats(self, state: GossipState, nbrs):
        """``[spreading, legal]`` of ``state`` (device int32 scalars)."""
        keep_alive = self.opts["keep_alive"]
        legal = (inversion_legal(state, nbrs, keep_alive=keep_alive,
                                 all_alive=self.opts["all_alive"])
                 if self.invertible
                 else torch.zeros((), dtype=torch.bool,
                                  device=state.counts.device))
        return [gossip_spreading_count(state, keep_alive),
                legal.to(torch.int32)]

    def observe(self, extra) -> bool:
        """Take a chunk summary's ``[spreading, legal]``: set the next
        chunk's branch, and say whether the run has stalled."""
        spreading, legal = extra
        self.inverted = (self.invertible and self.opts["keep_alive"]
                         and bool(legal))
        return spreading == 0


def draws(cfg: RunConfig) -> bool:
    """Does the round draw from the device RNG (gossip, fanout one, a
    Poisson clock, loss windows on the fanout-all scatter)? Its round core
    then takes the round key as a third argument."""
    return (cfg.algorithm == "gossip" or cfg.fanout == "one"
            or cfg.clock == "poisson"
            or (cfg.delivery == "scatter" and cfg.schedule.has_loss))


def run_clock_spec(topo: Topology, cfg: RunConfig) -> tuple:
    """The run's clock spec: ``()`` for the synchronous clock, else
    ``(rate, id_div)`` with ``id_div`` the GALA group size under
    ``workload='gala'`` (a group shares one clock), 1 otherwise."""
    if cfg.clock == "sync":
        return ()
    from gossipprotocol_tpu_torch.async_ import clock_spec

    id_div = 1
    if cfg.workload == "gala":
        if topo.num_nodes % cfg.groups:
            raise ValueError(
                f"workload='gala' splits {topo.num_nodes} nodes into "
                f"{cfg.groups} equal groups — nodes must be divisible "
                "by groups")
        id_div = topo.num_nodes // cfg.groups
    return clock_spec(cfg.clock, cfg.activation_rate, id_div=id_div)


def require_invertible(topo: Topology) -> None:
    """``delivery='invert'`` needs the dense neighbour table of a
    symmetric graph; raises ValueError naming what is missing (the JAX
    package's messages)."""
    from gossipprotocol_tpu_torch.protocols.sampling import (
        DENSE_MAX_DEGREE, use_dense,
    )

    if topo.asymmetric:
        raise ValueError(
            "delivery='invert' needs a symmetric simple graph; this "
            "reference-quirks topology carries directed/self/duplicate "
            "entries — use delivery='scatter'")
    if use_dense(topo):
        return
    if topo.implicit_full:
        why = ("the implicit complete graph has no neighbor table to "
               "invert (neighbors are sampled, never materialized)")
    else:
        why = (f"max degree {int(topo.degree.max())} exceeds "
               f"DENSE_MAX_DEGREE={DENSE_MAX_DEGREE} (hub graphs keep "
               "the CSR path)")
    raise ValueError(
        f"delivery='invert' needs the dense neighbor table: {why} — "
        "use delivery='scatter'")


def build_protocol(topo: Topology, cfg: RunConfig,
                   allow_all_alive: bool = True):
    """``(init_state, round_core, done_fn, (all_alive, targets_alive))``
    on the run's device.

    ``round_core(state, delivery)`` for the fanout-all deliveries,
    ``round_core(state, nbrs, round_key)`` where the round draws
    (:func:`draws`; for gossip a :class:`GossipCore`). With no birth
    exclusions the round drops its aliveness masks (``all_alive``); birth
    exclusions are whole components, so an alive node's neighbors are
    alive (``targets_alive``). A schedule with kill or revive strikes
    takes both away (the dead set changes mid-run); loss windows alone
    keep them. ``allow_all_alive=False`` forces the general dead-set
    path. Under :func:`use_megakernel` the core is the
    K-round kernel's ``(padded state, megakernel delivery) -> padded
    state``, which runs the all-alive round only. The walk
    (:func:`is_walk`) has no per-round core (None): its chunk runner
    (``protocols/walk.py``) is built in :func:`run_simulation`. With
    ``alert_quorum`` the run is done once that many rows are settled
    (converged or not alive).

    ``accel`` swaps the state for :class:`~gossipprotocol_tpu_torch.
    protocols.state.AccelState` and the round for the accelerated one;
    ``workload='sgp'``/``'gala'`` keeps the mixing core and wraps it
    (``learn/``), with an :class:`~gossipprotocol_tpu_torch.learn.
    SGPBundle` in the neighbour slot (:func:`device_arrays`)."""
    dev = resolve_device(cfg.device)
    ref = cfg.semantics == "reference"
    n = topo.num_nodes
    alive0 = initial_alive(topo)
    sched = cfg.schedule
    # only aliveness-changing events (kills, revives) take the liveness
    # fast paths away; loss windows drop messages, never nodes
    strikes = sched.has_strikes
    loss_windows = sched.static_loss_windows()
    clock = run_clock_spec(topo, cfg)
    dt = torch_dtype(cfg.dtype)
    all_alive = allow_all_alive and not strikes and alive0 is None
    targets_alive = allow_all_alive and not strikes
    core = None
    if cfg.algorithm == "gossip":
        if cfg.seed_node is not None:
            seed_node = cfg.seed_node  # explicit: honored even if dead
        else:
            seed_node = pick_seed_node(n, cfg.seed, alive=alive0)
        state = gossip_init(n, seed_node, device=dev)
        done_fn = gossip_done
        # the reference converges on the 11th hearing (Program.fs:91-92);
        # the intended rule is 10 (README.md:2)
        core = GossipCore(n=n,
                          threshold=cfg.threshold + 1 if ref
                          else cfg.threshold,
                          keep_alive=effective_keep_alive(topo, cfg),
                          all_alive=all_alive,
                          invertible=gossip_inversion_enabled(topo, cfg),
                          loss_windows=loss_windows, clock=clock)
    elif is_walk(cfg):
        from gossipprotocol_tpu_torch.protocols.walk import (
            pushsum_walk_init,
        )

        if sched:
            raise ValueError(
                "semantics='reference' push-sum cannot take faults or "
                "loss: killing the token holder — or dropping the one "
                "in-flight message — hangs the walk exactly as an "
                "actor crash would hang the reference (SURVEY §5.3)")
        state = pushsum_walk_init(n, walk_start_node(topo, cfg),
                                  value_mode=cfg.value_mode, device=dev)
        done_fn = pushsum_done
    else:
        state = pushsum_init(n, value_mode=cfg.value_mode, device=dev,
                             dtype=dt, payload_dim=cfg.payload_dim)
        done_fn = pushsum_done
    if cfg.algorithm == "push-sum" and not is_walk(cfg):
        state, core = _pushsum_core(topo, cfg, state, all_alive,
                                    targets_alive, loss_windows, clock)
    if alive0 is not None:
        state = state._replace(
            alive=state.alive & torch.from_numpy(np.array(alive0)).to(dev))
    if cfg.alert_quorum is not None:
        done_fn = quorum_done(cfg.alert_quorum)
    return state, core, done_fn, (all_alive, targets_alive)


def _pushsum_core(topo: Topology, cfg: RunConfig, state, all_alive: bool,
                  targets_alive: bool, loss_windows: tuple, clock: tuple):
    """``(state, round core)`` of intended push-sum: the sender and
    delivery of ``cfg``, accelerated or wrapped by a learner."""
    n = topo.num_nodes
    dev = state.w.device
    pred = dict(eps=cfg.eps, streak_target=cfg.streak_target,
                predicate=cfg.predicate, tol=cfg.tol, all_alive=all_alive,
                targets_alive=targets_alive)
    if cfg.accel != "off":
        from gossipprotocol_tpu_torch.protocols.accel import (
            accel_init, accel_round, estimate_gamma,
        )

        state = accel_init(n, value_mode=cfg.value_mode, device=dev,
                           dtype=cfg.dtype, payload_dim=cfg.payload_dim)
        gamma = 0.0
        if cfg.accel == "chebyshev":
            gamma = (cfg.accel_lambda if cfg.accel_lambda is not None
                     else estimate_gamma(topo))

        def core(st, nbrs, key=None):
            return accel_round(st, nbrs, key, n=n, variant=cfg.accel,
                               gamma=float(gamma),
                               edge_chunks=cfg.edge_chunks, **pred)
    elif cfg.fanout == "one":
        if cfg.delivery == "invert" and not targets_alive:
            raise ValueError(
                "delivery='invert' is exact only while the dead set "
                "is component-closed (no fault plan, no resumed "
                "arbitrary dead set) — use delivery='scatter'")

        def core(st, nbrs, key):
            return pushsum_round_core(
                st, nbrs, key, n=n, loss_windows=loss_windows, clock=clock,
                delivery=cfg.delivery, **pred)
    elif use_megakernel(cfg):
        from gossipprotocol_tpu_torch.ops.megakernel import (
            make_megakernel_round,
        )

        if not all_alive:
            raise RoutedConfigError(
                "the round-loop megakernel compiles the all-alive round "
                "only; this run carries dead rows (birth exclusions or a "
                "resumed dead set) — use delivery='pallas' with "
                "rounds_per_kernel=1")
        core = make_megakernel_round(
            n=n, rounds_per_kernel=cfg.rounds_per_kernel,
            eps=cfg.eps, streak_target=cfg.streak_target,
            predicate=cfg.predicate, tol=cfg.tol)
    elif cfg.delivery == "scatter":
        from gossipprotocol_tpu_torch.protocols.diffusion import (
            pushsum_diffusion_round,
        )

        if loss_windows and topo.implicit_full:
            raise ValueError(
                "per-edge loss windows need an explicit edge list; "
                "the implicit complete graph's diffusion is two "
                "reductions with no edges to mask — materialize the "
                "topology or drop the loss windows")

        def core(st, nbrs, key=None):
            return pushsum_diffusion_round(
                st, nbrs, key, n=n, edge_chunks=cfg.edge_chunks,
                loss_windows=loss_windows, clock=clock, **pred)
    else:
        def core(st, delivery, key=None):
            return pushsum_diffusion_round_routed(st, delivery, key,
                                                  clock=clock, **pred)
    if cfg.workload in ("sgp", "gala"):
        from gossipprotocol_tpu_torch.learn import (
            make_gala_core, make_sgp_core, sgp_init,
        )

        # the mixing core is reused as it is; only the state swaps (x₀ = 0
        # plus the loss) and the round gains the gradient step and the
        # loss-plateau gate
        state = sgp_init(n, cfg.payload_dim, device=dev, dtype=cfg.dtype)
        if cfg.workload == "sgp":
            core = make_sgp_core(core, lr=cfg.lr,
                                 local_steps=cfg.local_steps,
                                 loss_tol=cfg.loss_tol)
        else:
            if n % cfg.groups:
                raise ValueError(
                    f"workload='gala' splits {n} nodes into "
                    f"{cfg.groups} equal groups — nodes must be "
                    "divisible by groups")
            core = make_gala_core(core, num_groups=cfg.groups,
                                  group_size=n // cfg.groups, lr=cfg.lr,
                                  local_steps=cfg.local_steps,
                                  loss_tol=cfg.loss_tol)
    return state, core


def quorum_done(quorum: int):
    """The reference's supervisor: it exits at ``nodes`` Alerts while the
    factory spawned ``nodes + 1`` actors (``Program.fs:169-176,53``), so
    the run is done once ``quorum`` rows are settled (converged or not
    alive)."""
    def done_fn(state):
        settled = torch.sum((state.converged | ~state.alive).to(torch.int32))
        return settled >= quorum

    return done_fn


def walk_start_node(topo: Topology, cfg: RunConfig) -> int:
    """The walk's start: ``cfg.seed_node`` (refused when it has no
    neighbour or lies outside the giant component — the walk would be
    trapped there, as the reference would hang), else drawn from the seed
    among the birth-alive nodes, where every node has a neighbour."""
    birth = topo.birth_alive()
    if cfg.seed_node is None:
        return pick_seed_node(topo.num_nodes, cfg.seed, alive=birth)
    seed_node = cfg.seed_node
    if (not topo.implicit_full and int(topo.degree[seed_node]) == 0) or (
            birth is not None and not bool(birth[seed_node])):
        raise ValueError(
            f"seed node {seed_node} has no neighbors or sits "
            "in a birth-excluded minority component — the "
            "walk would be trapped there forever (the "
            "reference would hang identically)"
        )
    return seed_node


def note_hub_split(tel, topo) -> None:
    """Stamp the hub-splitting layout geometry on the telemetry hub (the
    JAX engine's ``note_hub_split``): report and manifest show it as
    ``hub split: N classes -> M sub-classes (max degree D)``. Left unset
    on graphs without a class wider than one 128-lane row."""
    from gossipprotocol_tpu_torch.ops.delivery import degree_classes

    deg = np.asarray(topo.degree)
    cls = np.unique(degree_classes(deg))
    split = [int(c) for c in cls if 2 * c > 128]
    if split:
        tel.hub_split = {
            "classes": len(split),
            "subclasses": int(sum((2 * c) // 128 for c in split)),
            "max_degree": int(deg.max()),
        }


def device_arrays(topo: Topology, cfg: RunConfig, tel=None):
    """What the round reads, placed on the run's device: for the drawing
    senders the neighbor arrays (gossip's with the inversion tables when
    :func:`gossip_inversion_enabled`, ``delivery='invert'``'s always);
    for the fanout-all scatter the edge list; else the delivery, through
    the plan cache (``cfg.plan_cache``): the routed plans for
    ``delivery='routed'``, else the fused gather plan, under
    :func:`use_megakernel` wrapped for the K-round kernel, whose
    eligibility (resident gathers) is checked here, before any launch.
    The learning workloads wrap these with the nodes' data shards in an
    :class:`~gossipprotocol_tpu_torch.learn.SGPBundle`. ``tel`` (a
    telemetry hub or None) receives the plan cache's provenance (``hit``,
    ``miss`` or ``off``) and the hub-split geometry."""
    from gossipprotocol_tpu_torch.ops.plancache import (
        pallas_delivery_cached, routed_delivery_cached,
    )

    dev = resolve_device(cfg.device)
    if cfg.algorithm == "push-sum" and cfg.workload in ("sgp", "gala"):
        from gossipprotocol_tpu_torch.learn import (
            SGPBundle, make_least_squares,
        )

        # groups rides along with the workload: replace both, or the
        # re-run checks reject groups > 1 without workload='gala'
        inner = device_arrays(topo, dataclasses.replace(
            cfg, workload="avg", groups=1), tel)
        a, b, _ = make_least_squares(
            topo.num_nodes, cfg.payload_dim, cfg.sgp_samples, cfg.seed,
            dtype=np.dtype(cfg.dtype))
        return SGPBundle(nbrs=inner, A=torch.from_numpy(a).to(dev),
                         b=torch.from_numpy(b).to(dev))
    if cfg.algorithm == "gossip" or cfg.fanout == "one":
        from gossipprotocol_tpu_torch.protocols.gossip import inverted_dense
        from gossipprotocol_tpu_torch.protocols.sampling import (
            device_topology,
        )

        if cfg.delivery == "invert":
            require_invertible(topo)
            return inverted_dense(topo, device=dev)
        if gossip_inversion_enabled(topo, cfg):
            return inverted_dense(topo, device=dev)
        return device_topology(topo, device=dev)
    if cfg.delivery == "scatter":
        from gossipprotocol_tpu_torch.protocols.diffusion import (
            diffusion_edges,
        )

        return diffusion_edges(topo, device=dev)
    if cfg.delivery == "routed":
        from gossipprotocol_tpu_torch.ops.delivery import (
            routed_streamed_bytes_per_round,
        )

        rd, prov = routed_delivery_cached(
            topo, cache_dir=cfg.plan_cache, device=dev)
        if tel is not None and tel.enabled:
            tel.event("plan_cache", provenance=prov, design="single-chip",
                      streamed_bytes_per_round=(
                          routed_streamed_bytes_per_round(rd)))
            note_hub_split(tel, topo)
        return rd

    from gossipprotocol_tpu_torch.ops.pallasdelivery import (
        pallas_streamed_bytes_per_round,
    )

    pd, prov = pallas_delivery_cached(topo, cache_dir=cfg.plan_cache,
                                      device=dev)
    if tel is not None and tel.enabled:
        tel.event("plan_cache", provenance=prov, design="single-chip",
                  delivery=cfg.delivery,
                  streamed_bytes_per_round=pallas_streamed_bytes_per_round(
                      pd))
        note_hub_split(tel, topo)
    if use_megakernel(cfg):
        from gossipprotocol_tpu_torch.ops.megakernel import (
            build_megakernel_delivery,
        )

        return build_megakernel_delivery(pd)
    return pd


def _freeze(active: torch.Tensor, new, old):
    """``new`` where ``active``, else ``old``, field by field. ``active``
    is a device bool scalar, or ``[B]`` for sweep lanes (a lane's whole
    state, ``round`` included, stops where its predicate holds)."""
    if active.dim() == 0:
        return type(new)(*(torch.where(active, a, b)
                           for a, b in zip(new, old)))
    return type(new)(*(torch.where(active.view((-1,) + (1,) * (a.dim() - 1)),
                                   a, b) for a, b in zip(new, old)))


def _words(x: torch.Tensor) -> list:
    """The bits of ``x`` as int32 device scalars (one a float32 value,
    two a float64 one), to ride the chunk's one int32 fetch."""
    return list(x.reshape(-1).contiguous().view(torch.int32))


def _from_words(words, dtype) -> np.ndarray:
    """The values whose bits :func:`_words` gave."""
    return np.asarray(words, dtype=np.int32).view(np.dtype(dtype))


def lanes_of(state) -> int:
    """The sweep lanes of ``state``: B for a lane-stacked state (``round``
    is ``[B]``, ``sweep/engine.py``), 0 for a single run's."""
    return int(state.round.shape[0]) if state.round.dim() else 0


def metric_words(state) -> list:
    """The JAX engine's per-chunk record scalars as int32 device scalars:
    ``[converged, alive]`` (alive rows that have converged, alive rows)
    and, for a state with an estimate, the bits of ``ratio_min`` and
    ``ratio_max`` over alive rows (payload columns included) and
    ``w_underflow``, the alive rows whose ``w`` is 0. Of a lane-stacked
    state, each is ``[B]`` (a lane's value over its own rows)."""
    alive = state.alive
    lanes = lanes_of(state)
    if lanes:
        def count(mask):
            return torch.sum(mask.to(torch.int32), dim=-1)

        def lo(x):
            return torch.amin(x.reshape(lanes, -1), dim=1)

        def hi(x):
            return torch.amax(x.reshape(lanes, -1), dim=1)
    else:
        def count(mask):
            return torch.sum(mask.to(torch.int32))

        lo, hi = torch.min, torch.max
    words = [count(state.converged & alive), count(alive)]
    if hasattr(state, "ratio"):
        live = alive if state.ratio.dim() == alive.dim() else alive[..., None]
        big = torch.full((), float("inf"), dtype=state.ratio.dtype,
                         device=alive.device)
        words += _words(lo(torch.where(live, state.ratio, big)))
        words += _words(hi(torch.where(live, state.ratio, -big)))
        words.append(count(alive & (state.w == 0)))
    return words


def chunk_stats(state, done_fn, extra_stats=None, delivery=None,
                sentinel_fn=None, *, records: bool = False,
                mass: bool = False, rows=()) -> torch.Tensor:
    """The chunk's verdict as ONE int32 device tensor (one host fetch):
    ``[round, done, *extra_stats(state, delivery)]``; with ``records``
    the record scalars of :func:`metric_words`; for a learning state the
    float32 bits of its train loss; with
    ``sentinel_fn`` the trip flag; with ``sentinel_fn`` or ``mass`` the
    bits of the mass sums (:func:`mass_words`); and last the chunk's
    per-round rows (``rows``: int32 tensors, flattened — the telemetry
    counters and trace rows). The host reads it with
    :class:`StatsLayout`. Of a lane-stacked state (``sweep/engine.py``)
    the per-run scalars are ``[B]`` lane values, concatenated in the same
    order."""
    extra = [] if extra_stats is None else extra_stats(state, delivery)
    if records:
        extra = extra + metric_words(state)
    if hasattr(state, "loss"):
        extra = extra + _words(state.loss)
    if sentinel_fn is not None or mass:
        sums = mass_words(state)
        if sentinel_fn is not None:
            extra = extra + [sentinel_fn(state).to(torch.int32)]
        extra = extra + sums
    if lanes_of(state):
        return torch.cat([x.reshape(-1).to(torch.int32) for x in
                          (state.round, done_fn(state), *extra, *rows)])
    scalars = torch.stack([state.round, done_fn(state).to(torch.int32),
                           *extra])
    if not rows:
        return scalars
    return torch.cat([scalars, *(r.reshape(-1) for r in rows)])


class StatsLayout:
    """How the host reads a chunk's stats (:func:`chunk_stats`): the
    scalars in order, then ``rows`` per-round rows of the telemetry
    counters (``counter_width`` words each: 3, plus 3 a shard with the
    per-shard attribution) and trace rows (``trace_width`` words: the
    float32 bits of :data:`~gossipprotocol_tpu_torch.obs.trace.
    NUM_TRACE_COLS` columns).

    Of a lane-stacked state (``sweep/engine.py``, B lanes) every per-run
    scalar is B words and reads as a ``[B]`` array (a float's bits, B
    values); ``extra`` stays one word each (the sweep's gossip stats sum
    over the lanes), and a counter row is ``[B, 3]`` (``counter_width``
    ``3·B``)."""

    def __init__(self, state, *, records: bool, extra: int, sentinel: bool,
                 mass: bool, counter_width: int = 0, trace_width: int = 0):
        self.lanes = lanes_of(state)
        b = max(1, self.lanes)
        self.records = records
        self.ratio_dt = (str(state.ratio.dtype).split(".")[-1]
                         if hasattr(state, "ratio") else None)
        self.pv = (state.ratio.element_size() // 4
                   if self.ratio_dt is not None else 0)
        self.metric = 0
        if records:
            self.metric = (2 + (2 * self.pv + 1 if self.pv else 0)) * b
        self.extra = extra
        self.loss = hasattr(state, "loss")
        self.sentinel = sentinel
        self.tracked = mass_stats_tracked(state)
        self.mass = ((mass or sentinel) and self.tracked)
        self.mass_dt = (str(state.w.dtype).split(".")[-1]
                        if hasattr(state, "w") else "float32")
        self.cols = (state.s.shape[-1] if self.tracked
                     and state.s.dim() == 2 + bool(self.lanes) else 1)
        self.mass_width = (mass_width(state) if self.mass else 0)
        self.counter_width = counter_width
        self.trace_width = trace_width
        self.scalars = (2 * b + self.metric + extra + int(self.loss) * b
                        + int(sentinel) + self.mass_width)

    def parse(self, vals: list) -> dict:
        """``{"round", "done", "metric": {...}, "extra": [...],
        "train_loss", "trip", "mass": (Σs, Σw) or None, "counters":
        int64 [rows, 3] or None, "shard_counters": int64 [rows, S, 3] or
        None, "trace": float32 [rows, cols] or None}``; of a lane-stacked
        state ``round``, ``done``, the metric values, ``train_loss`` and
        the mass sums are ``[B]`` arrays (Σs ``[B, d]``) and ``counters``
        is ``[rows, B, 3]``."""
        lanes = self.lanes
        b = max(1, lanes)

        def ints(i):
            return np.asarray(vals[i:i + b], np.int64) if lanes else vals[i]

        def floats(i, dt):
            v = _from_words(vals[i:i + b * (np.dtype(dt).itemsize // 4)], dt)
            return v if lanes else float(v[0])

        out = {"round": ints(0),
               "done": ints(b).astype(bool) if lanes else bool(vals[1])}
        i = 2 * b
        out["extra"] = vals[i:i + self.extra]
        i += self.extra
        metric = {}
        if self.records:
            metric["converged"], metric["alive"] = ints(i), ints(i + b)
            if self.ratio_dt is not None:
                j = i + 2 * b
                metric["ratio_min"] = floats(j, self.ratio_dt)
                metric["ratio_max"] = floats(j + self.pv * b, self.ratio_dt)
                metric["w_underflow"] = ints(j + 2 * self.pv * b)
        out["metric"] = metric
        i += self.metric
        out["train_loss"] = None
        if self.loss:
            out["train_loss"] = floats(i, "float32")
            i += b
        out["trip"] = False
        if self.sentinel:
            out["trip"] = bool(vals[i])
            i += 1
        out["mass"] = None
        if self.mass:
            words = _from_words(vals[i:i + self.mass_width], self.mass_dt)
            if lanes:
                s = words[:b * self.cols]
                out["mass"] = (s.reshape(b, -1) if self.cols > 1 else s,
                               words[b * self.cols:])
            else:
                out["mass"] = ((words[:self.cols] if self.cols > 1
                                else words[0]), words[self.cols])
            i += self.mass_width
        tail = vals[i:]
        width = self.counter_width + self.trace_width
        nrows = len(tail) // width if width else 0
        out["counters"] = out["shard_counters"] = out["trace"] = None
        if self.counter_width and lanes:
            out["counters"] = np.asarray(
                tail[:nrows * self.counter_width], np.int64).reshape(
                    nrows, b, 3)
        elif self.counter_width:
            c = np.asarray(tail[:nrows * 3], np.int64).reshape(nrows, 3)
            out["counters"] = c
            j = nrows * 3
            if self.counter_width > 3:
                s = self.counter_width // 3 - 1
                out["shard_counters"] = np.asarray(
                    tail[j:j + nrows * s * 3], np.int64).reshape(nrows, s, 3)
        if self.trace_width:
            t = tail[nrows * self.counter_width:]
            out["trace"] = _from_words(t, "float32").reshape(
                nrows, self.trace_width)
        return out


def _count_rows(deltas: list, counter_rows: list, shard_rows: list,
                lanes: bool = False) -> None:
    """Split per-round counter deltas (``int32 [3]``, or ``[S, 3]`` per
    shard) into the reduced rows and the per-shard rows; sweep lanes'
    ``[B, 3]`` deltas are rows as they are."""
    for d in deltas:
        if d.dim() == 2 and not lanes:
            shard_rows.append(d)
            d = torch.sum(d, dim=0)
        counter_rows.append(d.to(torch.int32))


def _stack_rows(counter_rows, shard_rows, trace_rows) -> list:
    rows = []
    if counter_rows:
        rows.append(torch.stack(counter_rows))
    if shard_rows:
        rows.append(torch.stack(shard_rows))
    if trace_rows:
        rows.append(torch.stack(trace_rows).to(torch.float32).view(
            torch.int32))
    return rows


def make_chunk_runner(round_core, done_fn, extra_stats=None,
                      base_key: Optional[torch.Tensor] = None,
                      sentinel_fn=None, *, counter_fn=None, trace_fn=None,
                      records: bool = False, mass: bool = False):
    """``chunk(state, delivery, start_round, round_limit) -> (state,
    stats)``: advance until global convergence or ``round ==
    round_limit``. The predicate is evaluated before every round, as the
    JAX engine's loop condition does; a converged state is carried
    through the remaining rounds of the chunk unchanged.

    With ``base_key`` the round draws: the chunk hashes the keys of its
    rounds ``state.round, state.round + 1, ...`` in one pass and hands
    round i the i-th (a round that runs unfrozen is always that round).

    ``sentinel_fn`` (the health sentinel, :func:`make_sentinel_fn`) joins
    the freeze predicate: the chunk freezes at the first round whose
    state trips it, as the JAX engine's loop condition exits there (the
    trip persists in the state, so the stats see it again), and the
    stats gain the trip flag and the mass sums. Unset, the chunk launches
    what it launched before the sentinel existed.

    ``counter_fn`` (``obs/counters.py``) and ``trace_fn``
    (``obs/trace.py``) add one counter row and one trace row a round,
    read from the round's old and new states and never fed back; the
    rows ride the stats (:func:`chunk_stats`). A frozen round's rows are
    computed too, and the host keeps only the valid prefix ``[:
    round - start_round]`` (the rounds run before the predicate held),
    as the JAX engine's ``while_loop`` writes no row past it.
    ``records`` adds the record scalars (:func:`metric_words`), ``mass``
    the mass sums. With all four unset the chunk launches what it
    launched before telemetry existed.

    Sweep lanes (``sweep/engine.py``): a state with a leading ``[B]``
    dimension, ``[B, 2]`` base keys and a ``done_fn`` giving ``[B]``
    freeze each lane on its own predicate (a frozen lane keeps its
    round, so an active lane's i-th key is always its own round's); the
    stats carry a ``[B]`` view of every per-run value (:func:`chunk_stats`)."""
    stop_fn = (done_fn if sentinel_fn is None
               else lambda st: done_fn(st) | sentinel_fn(st))

    def chunk(state, delivery, start_round: int, round_limit: int):
        count = max(0, round_limit - start_round)
        keys = (None if base_key is None
                else round_keys(base_key, state.round, count))
        deltas, trace_rows = [], []
        for i in range(count):
            active = ~stop_fn(state)
            key = None if keys is None else keys[i]
            new = (round_core(state, delivery) if key is None
                   else round_core(state, delivery, key))
            if counter_fn is not None:
                deltas.append(counter_fn(state, new, delivery, key))
            if trace_fn is not None:
                trace_rows.append(trace_fn(new))
            state = _freeze(active, new, state)
        counter_rows, shard_rows = [], []
        _count_rows(deltas, counter_rows, shard_rows,
                    lanes=state.round.dim() == 1)
        return state, chunk_stats(
            state, done_fn, extra_stats, delivery, sentinel_fn,
            records=records, mass=mass,
            rows=_stack_rows(counter_rows, shard_rows, trace_rows))

    return chunk


def make_megakernel_chunk_runner(round_core, done_fn,
                                 rounds_per_kernel: int, *, counter_fn=None,
                                 trace_fn=None, records: bool = False,
                                 mass: bool = False):
    """``chunk(state, mk, start_round, round_limit) -> (state, stats)``
    for the K-round kernel: pad the state once, launch
    ``ceil((round_limit - start_round) / K)`` super-steps — as many as
    the JAX engine's ``while_loop`` runs when the run does not converge —
    and unpad once. Per super-step the host enqueues the launch and
    nothing else; the kernel updates the padded state in place, and a
    launch that finds the predicate already true exits at once, so a
    super-step may overshoot ``round_limit`` by up to K - 1 rounds but
    never runs past convergence.

    ``counter_fn`` / ``trace_fn`` count at K-round granularity, as the
    JAX engine's ``counter_rows`` / ``trace_rows`` do: one super-step's
    counter delta (constant on the all-alive round the kernel runs) and
    the trace row of the state it leaves are repeated over its K rows;
    the host keeps the valid prefix ``[: round - start_round]``, which
    drops the rows past a super-step that stopped at convergence."""
    from gossipprotocol_tpu_torch.ops.megakernel import (
        pad_state, unpad_state,
    )

    k = rounds_per_kernel

    def chunk(state, mk, start_round: int, round_limit: int):
        ms = pad_state(state)
        deltas, trace_rows = [], []
        for _ in range(-(-max(0, round_limit - start_round) // k)):
            if counter_fn is not None:
                deltas += [counter_fn(unpad_state(ms, state.alive), None,
                                      mk, None)] * k
            ms = round_core(ms, mk)
            if trace_fn is not None:
                trace_rows += [trace_fn(unpad_state(ms, state.alive))] * k
        state = unpad_state(ms, state.alive)
        counter_rows, shard_rows = [], []
        _count_rows(deltas, counter_rows, shard_rows)
        return state, chunk_stats(
            state, done_fn, records=records, mass=mass,
            rows=_stack_rows(counter_rows, shard_rows, trace_rows))

    return chunk


def warm_start(step, state) -> None:
    """Run one chunk of one round and discard it: builds and loads the
    CUDA kernels, loads every PyTorch kernel the chunk launches and warms
    the allocator, so the timed loop measures rounds only (the JAX engine
    likewise keeps compilation and program load out of ``wall_ms``)."""
    r = int(state.round)
    _, stats = step(state, r, r + 1)
    stats.cpu()  # the sync point


# ---- host events: revives, the sentinel, value faults -----------------

def _put(field: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """``field`` with rows ``idx`` set to ``values``, as a new tensor on
    the field's device (never a host buffer the next chunk could see)."""
    if not isinstance(values, torch.Tensor):
        values = torch.full((), values, dtype=field.dtype,
                            device=field.device)
    return field.index_put((idx,), values.to(field.dtype))


def _index(ids, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(ids, dtype=np.int64).copy()).to(
        device)


def fresh_values(idx: torch.Tensor, num_nodes: int, value_mode: str,
                 like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Push-sum's initial ``s`` of rows ``idx``, computed on the device as
    :func:`~gossipprotocol_tpu_torch.protocols.state.pushsum_init` computes
    it: the id in the state's dtype, divided (IEEE, by a tensor) by
    ``num_nodes`` under ``value_mode='scaled'``; for an ``[n, d]`` payload
    (``like``, the state's ``s``) the rows of
    :func:`~gossipprotocol_tpu_torch.protocols.state.pushsum_payload_values`,
    and for a learning state the shared start x₀ = 0."""
    dt = torch.float32 if like is None else like.dtype
    if like is not None and like.dim() == 2:
        return pushsum_payload_values(idx, num_nodes, like.shape[1],
                                      value_mode, dt)
    v = idx.to(dt)
    return v / torch.full_like(v, num_nodes) if value_mode == "scaled" \
        else v


def _fresh_s(state, idx: torch.Tensor, cfg: RunConfig,
             num_nodes: int) -> torch.Tensor:
    """The fresh-born ``s`` of rows ``idx`` of ``state``: x₀ = 0 for a
    learning state, else :func:`fresh_values`."""
    if hasattr(state, "loss"):
        return torch.zeros((idx.shape[0],) + tuple(state.s.shape[1:]),
                           dtype=state.s.dtype, device=state.s.device)
    return fresh_values(idx, num_nodes, cfg.value_mode, like=state.s)


def revive_rows(state, ids, cfg: RunConfig, num_nodes: int):
    """Reset rows ``ids`` to fresh-born state on the device — a crashed
    process restarting from its initial value: gossip rows drop to zero
    hearings, push-sum rows get their init ``(s, w)`` back (the values of
    :func:`fresh_values`, so a revived row is bitwise an initial row;
    ``ratio = s`` as ``w == 1``; a learner restarts at x₀ = 0). The
    stranded pre-death mass is discarded. Callers flip ``alive``
    separately."""
    idx = _index(ids, state.alive.device)
    if isinstance(state, GossipState):
        return state._replace(counts=_put(state.counts, idx, 0),
                              converged=_put(state.converged, idx, False))
    vals = _fresh_s(state, idx, cfg, num_nodes)
    streak0 = 1 if cfg.semantics == "reference" else 0
    return state._replace(
        s=_put(state.s, idx, vals), w=_put(state.w, idx, 1.0),
        ratio=_put(state.ratio, idx, vals),
        streak=_put(state.streak, idx, streak0),
        converged=_put(state.converged, idx, False))


# Host mass-drift tripwire threshold (ULPs of the anchored baseline), the
# JAX package's value.
SENTINEL_MASS_ULPS = 256.0


def sentinel_bad_mask(state) -> torch.Tensor:
    """Per-row health predicate of the sentinel: an alive row is bad when
    its ``s`` has a non-finite component, or ``w`` is non-finite or
    negative (``w == 0`` is healthy: the receipt-dry-spell underflow, not
    a data fault). Shared by the trip check and the host's offender
    identification."""
    s_bad = ~torch.isfinite(state.s)
    if s_bad.dim() == 2:
        s_bad = torch.any(s_bad, dim=1)
    return state.alive & (s_bad | ~torch.isfinite(state.w) | (state.w < 0))


def make_sentinel_fn(cfg: RunConfig):
    """The sentinel's trip predicate (``state -> bool`` device scalar) for
    :func:`make_chunk_runner`."""
    del cfg  # the predicate is config-independent once the sentinel is on

    def sentinel_fn(state):
        return torch.any(sentinel_bad_mask(state))

    return sentinel_fn


def mass_words(state) -> list:
    """The bits of the mass sums ``[*bits(Σs), *bits(Σw)]`` (Σs per
    payload column) as int32 device scalars, to ride the chunk's one
    int32 fetch; empty for a state whose mass is not tracked
    (:func:`mass_stats_tracked`)."""
    ms = mass_stats(state)
    if not ms:
        return []
    return _words(ms["mass_s"]) + _words(ms["mass_w"])


def mass_width(state) -> int:
    """How many int32 words :func:`mass_words` gives for ``state``."""
    if not mass_stats_tracked(state):
        return 0
    per_value = state.w.element_size() // 4
    lanes = lanes_of(state)
    cols = state.s.shape[-1] if state.s.dim() == 2 + bool(lanes) else 1
    return per_value * (cols + 1) * max(1, lanes)


def mass_stats_tracked(state) -> bool:
    """Is the push-sum mass a conserved quantity of ``state``? Not for
    gossip, nor for the learning states (their gradient steps move it)."""
    return hasattr(state, "s") and not hasattr(state, "loss")


def quarantine_rows(state, ids):
    """Zero the protocol mass (``s``, ``w``, ``ratio``) of rows ``ids`` on
    the device — the first step of a quarantine, before the synthetic kill
    fires through the host events, so the poison leaves every later sum
    the moment the nodes leave the network."""
    idx = _index(ids, state.alive.device)
    return state._replace(s=_put(state.s, idx, 0.0),
                          w=_put(state.w, idx, 0.0),
                          ratio=_put(state.ratio, idx, 0.0))


def inject_value_fault(state, ids, spec, cfg: RunConfig, num_nodes: int):
    """Corrupt push-sum's ``s`` at rows ``ids`` (live rows) as ``spec``'s
    model says: ``nan``, ``inf``, ``scale:K`` (a float32 multiply by K),
    ``stuck`` (the row's initial value). ``w`` and the rest stay."""
    idx = _index(ids, state.alive.device)
    model = str(spec.model).split(":", 1)[0]
    if model == "nan":
        return state._replace(s=_put(state.s, idx, float("nan")))
    if model == "inf":
        return state._replace(s=_put(state.s, idx, float("inf")))
    if model == "scale":
        k = float(np.asarray(spec.scale_factor(),
                             dtype=str(state.s.dtype).split(".")[-1]))
        return state._replace(s=_put(state.s, idx, state.s[idx] * k))
    return state._replace(
        s=_put(state.s, idx, _fresh_s(state, idx, cfg, num_nodes)))


def mass_stats(state) -> dict:
    """Total push-sum mass ``(Σs, Σw)`` over every row (``Σs`` per payload
    column), in the state's dtype on the device (the chunk's reduction, so
    a baseline taken by a no-op chunk drifts by exactly 0 ULPs on a
    lossless run; on the CPU in the JAX package's order,
    :func:`~gossipprotocol_tpu_torch.protocols.pushsum.tree_sum0`); the
    walk's in-flight token carries real mass and is included. Of a
    lane-stacked state, each lane's own sums (``[B]``, Σs ``[B, d]``).
    Empty for gossip and the learning states."""
    if not mass_stats_tracked(state):
        return {}
    if lanes_of(state):
        # a lane's sums over its own rows, in the single run's order
        ms, mw = (tree_sum0(x.transpose(0, 1)) for x in (state.s, state.w))
        return {"mass_s": ms, "mass_w": mw}
    ms, mw = tree_sum0(state.s), tree_sum0(state.w)
    if hasattr(state, "msg_s"):
        ms = ms + state.msg_s
        mw = mw + state.msg_w
    return {"mass_s": ms, "mass_w": mw}


def _mass_snapshot(state):
    """(Σs, Σw) over every row as float64 host sums — the invariant a
    rebuild must preserve bitwise; None for gossip."""
    if not hasattr(state, "s"):
        return None
    return (float(state.s.cpu().numpy().astype(np.float64).sum()),
            float(state.w.cpu().numpy().astype(np.float64).sum()))


# ---- the host loop's records, shared by _drive and the sweep's loop ----


def round_budget_rounds(cfg: RunConfig,
                        prediction: Optional[dict] = None) -> Optional[int]:
    """The run's round budget: an explicit int, the analytic
    prediction's bound under ``round_budget == "auto"``, or None."""
    if cfg.round_budget == "auto":
        return int(prediction["budget_rounds"])
    if cfg.round_budget is not None:
        return int(cfg.round_budget)
    return None


def record_emitter(cfg: RunConfig, tel, metrics: List[dict]):
    """``emit(rec)``: a chunk or host-event record to ``metrics``, the
    telemetry hub and ``cfg.metrics_callback``."""
    def emit(rec):
        metrics.append(rec)
        tel.metric(rec)
        if cfg.metrics_callback:
            cfg.metrics_callback(rec)

    return emit


def emit_over_budget(emit, tel, cfg: RunConfig, cur_round: int,
                     budget: int, **extra) -> None:
    """The structured record (and telemetry event) of a run stopped at
    its round budget unconverged, instead of grinding on to
    ``max_rounds``."""
    ob = {"event": "over_budget", "round": cur_round,
          "budget_rounds": budget,
          "budget_source": ("auto" if cfg.round_budget == "auto"
                            else "explicit"), **extra}
    emit(ob)
    tel.event("over_budget", **{k: v for k, v in ob.items() if k != "event"})


def note_counters(rec: dict, totals, tel) -> None:
    """A chunk's ``(sent, delivered, dropped)`` totals into its record and
    the telemetry totals, as Python ints (long runs never overflow)."""
    sent, delivered, dropped = (int(x) for x in totals)
    rec["sent"] = sent
    rec["delivered"] = delivered
    rec["dropped"] = dropped
    tel.add_counters(sent, delivered, dropped)


def note_mass_drift(rec: dict, mass, base, tel) -> Tuple[float, float]:
    """The drift of a chunk's mass sums from the baseline's, in ULPs (a
    vector payload, or a sweep's lanes, by its worst entry), into its
    record and the telemetry; returns ``(s_ulps, w_ulps)``."""
    s_ulps = ulp_drift(mass[0], base[0])
    w_ulps = ulp_drift(mass[1], base[1])
    rec["mass_drift_ulps"] = s_ulps
    rec["w_drift_ulps"] = w_ulps
    tel.note_mass_drift(s_ulps, w_ulps)
    return s_ulps, w_ulps


def compute_prediction(run_topo, cfg: RunConfig, tel) -> Optional[dict]:
    """Analytic round prediction for this run (``obs/predict.py``; the JAX
    engine's ``compute_prediction``), computed once before the first
    chunk, on the host from the topology's CSR.

    None when prediction is off (no telemetry, no budget) or the topology
    is too large or the configuration unpredictable; raises when
    ``round_budget == "auto"`` cannot be resolved, since silently running
    unbudgeted is exactly what the flag exists to prevent."""
    if not (tel.enabled or cfg.round_budget is not None):
        return None
    from gossipprotocol_tpu_torch.obs.predict import maybe_predict_rounds

    with tel.span("predict_rounds"):
        pred = maybe_predict_rounds(
            run_topo, cfg, required=(cfg.round_budget == "auto"))
    if cfg.round_budget == "auto" and pred is None:
        raise ValueError(
            "round_budget='auto' needs an analytic round prediction, which "
            "is unavailable for this configuration/topology (obs/predict.py "
            "gates on edge count via $GOSSIP_TPU_PREDICT_EDGE_CAP); pass an "
            "explicit --round-budget N instead"
        )
    if pred is not None and tel.enabled:
        tel.prediction = pred
        tel.event("prediction", **pred)
    return pred


# Graceful-stop hook: a callable checked at every chunk boundary of the
# host loop. Truthy -> save a checkpoint (when the run checkpoints at all)
# and return early with RunResult.stopped = "drain". Module-level rather
# than a RunConfig field so a signal handler installed before cli.main()
# can reach a run whose config it never sees (the JAX engine's hook).
_stop_check: Optional[Callable[[], bool]] = None


def install_stop_check(fn: Optional[Callable[[], bool]]) -> None:
    """Install (or clear, with None) the global graceful-stop check."""
    global _stop_check
    _stop_check = fn


def _drive(cfg: RunConfig, state, step, num_nodes: int,
           compile_ms: float, trim=None, observe=None, *,
           topo: Optional[Topology] = None,
           rebuild: Optional[Callable] = None,
           run_topo: Optional[Topology] = None,
           prediction: Optional[dict] = None,
           num_shards: Optional[int] = None,
           walk: bool = False) -> RunResult:
    """Host loop: chunks up to ``max_rounds`` and the convergence
    verdict. ``trim`` cuts a padded final state to the real rows (the
    sharded engine, ``num_shards`` shards). ``observe(extra)`` takes each
    chunk's extra stats and returns True when the run has stalled (gossip
    with no spreader left): the run then stops unconverged, as the JAX
    engine's does. ``walk``: the chunks are the reference walk's hops,
    counted on the host (``obs/counters.py`` ``WALK_HOP_COUNTS``).

    With ``topo`` (the birth topology; the single-card engine) the loop
    is the JAX engine's host-event loop: due host events fire at the top
    of each iteration and each chunk stops at the next event round;
    ``rebuild(new_topo, state) -> ((step, observe), state, info)``
    re-derives the round for an adjacency change (``run_topo`` is the
    adjacency in force at entry: the birth one unless a resume replayed
    events past it); checkpoints are saved every ``checkpoint_every``
    chunks; and the sentinel's trips are recorded, quarantined or rolled
    back. The rebuilds' warm-up chunks are kept out of ``wall_ms``.

    Every chunk and host-event record goes to ``result.metrics``,
    ``cfg.metrics_callback`` and the telemetry hub (``cfg.telemetry``).
    ``prediction`` (:func:`compute_prediction`) resolves ``round_budget
    == "auto"`` and is completed with the actual outcome."""
    from gossipprotocol_tpu_torch.events import HostEvents
    from gossipprotocol_tpu_torch.obs import as_telemetry
    from gossipprotocol_tpu_torch.obs.counters import WALK_HOP_COUNTS
    from gossipprotocol_tpu_torch.obs.trace import NUM_TRACE_COLS
    from gossipprotocol_tpu_torch.utils import checkpoint as ckpt_mod

    tel = as_telemetry(cfg.telemetry)
    trim = trim if trim is not None else (lambda st: st)
    dev = state.alive.device
    run_topo = run_topo if run_topo is not None else topo
    cur_round = int(state.round)
    host_events = (HostEvents(topo, cfg, start_round=cur_round, tel=tel)
                   if topo is not None else None)
    metrics: List[dict] = []
    checkpoints: List[str] = []
    chunk_i = 0
    done = False
    executed = 0
    excluded_s = 0.0       # rebuild warm-ups, kept out of wall_ms
    fused = use_megakernel(cfg)
    budget = round_budget_rounds(cfg, prediction)
    over_budget = drained = underflow_warned = False
    checkpointing = bool(cfg.checkpoint_every and cfg.checkpoint_dir)
    adjacency = (ckpt_mod.topology_fingerprint(topo)
                 if checkpointing and topo is not None else None)
    topo_kind = topo.kind if topo is not None else None
    sentinel_on = cfg.sentinel != "off"
    # quarantines this trajectory lived through: the resumed prefix plus
    # everything this process performs (saved into every checkpoint)
    quar_log = {int(r): np.asarray(ids, np.int64)
                for r, ids in (cfg.quarantine_log or ())}
    counters_on = tel.counters_on
    counter_width = 0
    if counters_on and not walk:
        counter_width = 3 + (3 * num_shards
                             if num_shards and tel.attribution_on else 0)
    layout = StatsLayout(
        state, records=tel.enabled or cfg.metrics_callback is not None,
        extra=2 if observe is not None else 0, sentinel=sentinel_on,
        mass=counters_on, counter_width=counter_width,
        trace_width=NUM_TRACE_COLS if tel.traces_on and not walk else 0)

    emit = record_emitter(cfg, tel, metrics)

    def quar_meta():
        if not quar_log:
            return None
        return {"quarantines": [[r, quar_log[r].tolist()]
                                for r in sorted(quar_log)]}

    def noop_stats():
        """A chunk of no rounds: the stats of ``state`` through the
        chunk's own reductions."""
        nonlocal state
        r = int(state.round)
        state, st = step(state, r, r)
        return layout.parse(st.tolist())

    def take_engine(new):
        nonlocal step, observe
        if new is not None:
            step, observe = new

    def after_events():
        """Gossip: observe the state again (events change legality)."""
        if observe is not None:
            observe(noop_stats()["extra"])

    def save_checkpoint(**attrs):
        with tel.span("checkpoint_save", round=cur_round, **attrs):
            checkpoints.append(ckpt_mod.save(
                cfg.checkpoint_dir, trim(state), cfg, topo_kind,
                adjacency=adjacency, extra_meta=quar_meta()))

    mass_base = None
    if sentinel_on or counters_on:
        # the baseline from the chunk's own reduction (a no-op chunk), so
        # a lossless run drifts by exactly 0 ULPs
        with tel.span("mass_baseline"):
            mass_base = noop_stats()["mass"]

    t0 = time.perf_counter()
    while cur_round < cfg.max_rounds:
        if host_events is not None and host_events.due(cur_round):
            state, run_topo, new, recs, reborn = host_events.fire(
                state, run_topo, cur_round, rebuild)
            take_engine(new)
            excluded_s += sum(rec.get("warm_s", 0.0) for rec in recs)
            for rec in recs:
                emit(rec)
            if reborn and mass_base is not None:
                # revived rows changed the conserved quantity itself
                mass_base = noop_stats()["mass"]
            after_events()
        next_event = (host_events.next_round(cfg.max_rounds)
                      if host_events is not None else cfg.max_rounds)
        round_limit = min(cur_round + cfg.chunk, cfg.max_rounds, next_event)
        if budget is not None:
            # stop exactly at the budget, so the over-budget record
            # carries the budget round, not the chunk boundary past it
            round_limit = min(round_limit, budget)
        chunk_start = cur_round
        with tel.span("chunk", round_start=cur_round,
                      round_limit=round_limit):
            state, stats = step(state, cur_round, round_limit)
            chunk_i += 1
            # the chunk's one fetch, and the sync point: the span covers
            # the card's work, not only the enqueue
            got = layout.parse(stats.tolist())
        cur_round, done = got["round"], got["done"]
        ran = cur_round - chunk_start
        extra = got["extra"]
        rec = {"round": cur_round, **got["metric"]}
        if observe is not None:
            rec["spreading"] = extra[0]
        if got["train_loss"] is not None:
            rec["train_loss"] = got["train_loss"]
        # the kernel adds the rounds it ran to `round` itself
        executed += ran if fused else (round_limit - chunk_start)
        if got["trace"] is not None and ran > 0:
            # valid prefix only: one row per round this chunk ran
            tel.add_trace_rows(chunk_start, got["trace"][:ran])
        rows = got["counters"]
        if walk and counters_on:
            rows = np.tile(np.asarray(WALK_HOP_COUNTS, np.int64), (ran, 1))
        if rows is not None:
            # per-round int32 rows of the rounds that ran
            note_counters(rec, rows[:ran].sum(axis=0), tel)
            sent, delivered, dropped = (rec["sent"], rec["delivered"],
                                        rec["dropped"])
            if got["shard_counters"] is not None:
                # per-shard attribution: the unreduced partials, whose sum
                # over shards must reproduce the totals exactly
                per_shard = got["shard_counters"][:ran].sum(axis=0)
                total = per_shard.sum(axis=0)
                if (total != np.asarray([sent, delivered, dropped])).any():
                    raise AssertionError(
                        f"per-shard counter partials do not sum to the "
                        f"reduced totals: {per_shard.tolist()} -> "
                        f"{total.tolist()} != "
                        f"{[sent, delivered, dropped]} (round={cur_round})")
                tel.add_shard_counters(per_shard)
        stalled = (not done and observe is not None
                   and bool(observe(extra)))
        trip_dev = got["trip"]
        mass_trip = False
        if got["mass"] is not None and mass_base is not None:
            s_ulps, w_ulps = note_mass_drift(rec, got["mass"], mass_base,
                                             tel)
            if sentinel_on:
                mass_trip = any((not np.isfinite(u))
                                or u > SENTINEL_MASS_ULPS
                                for u in (s_ulps, w_ulps))
        if rec.get("w_underflow", 0) and not underflow_warned:
            import sys as _sys

            print(
                f"warning: {rec['w_underflow']} alive node(s) underflowed "
                "w to 0 in a receipt dry spell — float32 single-target "
                "push-sum cannot certify convergence past this point. "
                "Use --fanout all (no dry spells by construction) or "
                "--x64 (covers ~1000-round gaps).",
                file=_sys.stderr,
            )
            underflow_warned = True
        if stalled:
            rec["stalled"] = True
        trip = trip_dev or mass_trip
        if trip:
            rec["sentinel_trip"] = True
        emit(rec)
        if trip:
            # handled BEFORE the checkpoint save: under quarantine and
            # rollback no poisoned state is ever published, so every
            # checkpoint on disk predates its trip
            bad_ids = torch.nonzero(sentinel_bad_mask(trim(state))).reshape(
                -1).cpu().numpy().astype(np.int64)
            ev = {"event": "sentinel_trip", "round": cur_round,
                  "cause": "nonfinite" if trip_dev else "mass_drift",
                  "nodes": int(bad_ids.size), "mode": cfg.sentinel}
            emit(ev)
            tel.event("sentinel_trip",
                      **{k: v for k, v in ev.items() if k != "event"})

            def requarantine(at_round, ids):
                nonlocal state, run_topo, excluded_s
                state, run_topo, new, q_recs = host_events.quarantine(
                    state, run_topo, at_round, ids, rebuild)
                take_engine(new)
                excluded_s += sum(qr.get("warm_s", 0.0) for qr in q_recs)
                for qr in q_recs:
                    emit(qr)
                    if qr.get("event") == "quarantine":
                        tel.event("quarantine", round=at_round,
                                  nodes=qr["nodes"], policy=qr["policy"])
                quar_log[at_round] = np.union1d(
                    quar_log.get(at_round, np.empty(0, np.int64)), ids)

            def reanchor():
                nonlocal mass_base
                if mass_base is not None:
                    mass_base = noop_stats()["mass"]

            if cfg.sentinel in ("quarantine", "rollback") and bad_ids.size:
                if rebuild is None:
                    raise RuntimeError(
                        "sentinel tripped but the engine supplied no "
                        "rebuild hook for quarantine")
                target = None
                if cfg.sentinel == "rollback":
                    # newest readable checkpoint strictly predating the trip
                    for path in ckpt_mod.candidates(cfg.checkpoint_dir):
                        try:
                            c_meta = ckpt_mod.peek_meta(path)
                        except Exception:
                            continue
                        if int(c_meta.get("round", cur_round)) < cur_round:
                            target = (path, int(c_meta["round"]))
                            break
                if target is not None:
                    from gossipprotocol_tpu_torch.events import (
                        replay_topology_events,
                    )

                    c_path, c_round = target
                    with tel.span("sentinel_rollback", round=cur_round,
                                  target_round=c_round):
                        rb_state, _rb_meta = ckpt_mod.load(c_path)
                        # quarantines of the abandoned timeline (r > C)
                        # go; one at exactly C merges with the new bad set
                        merged = np.union1d(
                            quar_log.get(c_round, np.empty(0, np.int64)),
                            bad_ids)
                        quar_log = {r: v for r, v in quar_log.items()
                                    if r < c_round}
                        run_topo = replay_topology_events(
                            topo, cfg.schedule, cfg.events, cfg.repair,
                            cfg.seed, c_round, quarantines=quar_log)
                        state = type(rb_state)(*(t.to(dev)
                                                 for t in rb_state))
                        # a fresh engine at C restores the events the old
                        # one consumed on the abandoned path
                        host_events = HostEvents(topo, cfg,
                                                 start_round=c_round,
                                                 tel=tel)
                        prev_topo = run_topo
                        requarantine(c_round, merged)
                        if run_topo is prev_topo and (
                                cfg.repair != "off"
                                or cfg.events.has_events):
                            # the adjacency at C can differ from the one
                            # the current round was built against
                            new, state, info = rebuild(run_topo, state)
                            take_engine(new)
                            excluded_s += info.get("warm_s", 0.0)
                        cur_round = c_round
                        emit({"event": "rollback", "round": cur_round,
                              "from_round": int(ev["round"]),
                              "checkpoint": c_path,
                              "nodes": int(merged.size)})
                        tel.event("rollback", round=cur_round,
                                  from_round=int(ev["round"]),
                                  nodes=int(merged.size))
                else:
                    if cfg.sentinel == "rollback":
                        # no checkpoint predates the trip: contain in place
                        emit({"event": "rollback_fallback",
                              "round": cur_round,
                              "reason": "no checkpoint predates the trip"})
                    requarantine(cur_round, bad_ids)
                # the quarantine zeroed rows: re-anchor the drift baseline
                reanchor()
                after_events()
                continue
            if trip_dev:
                # detect-only cannot remove the poison, and a tripped
                # state re-trips at once: record and stop
                break
            # an unattributable mass-level trip: accept the new level
            reanchor()
        if checkpointing and chunk_i % cfg.checkpoint_every == 0:
            save_checkpoint()
        if budget is not None and not done and cur_round >= budget:
            # the run is not converging at the configured (or predicted)
            # rate: stop and leave a structured record instead of
            # grinding on to max_rounds
            over_budget = True
            emit_over_budget(
                emit, tel, cfg, cur_round, budget,
                **({} if prediction is None else
                   {"predicted_rounds": prediction.get("predicted_rounds")}))
        if not done and _stop_check is not None and _stop_check():
            # graceful drain: a checkpoint off the cadence, so the resume
            # loses nothing, a record, and a result stamped "drain"
            drained = True
            if checkpointing:
                save_checkpoint(reason="drain")
            emit({"event": "drained", "round": cur_round,
                  "checkpointed": checkpointing})
            tel.event("drained", round=cur_round,
                      checkpointed=checkpointing)
        if done or stalled or over_budget or drained:
            break
    with tel.span("device_sync"):
        if state.round.is_cuda:
            torch.cuda.synchronize(state.round.device)
    wall_ms = (time.perf_counter() - t0 - excluded_s) * 1e3
    if prediction is not None:
        # close the loop: the manifest's prediction block records what
        # happened next to what was predicted
        prediction["actual_rounds"] = cur_round
        prediction["converged"] = bool(done)
        prediction["over_budget"] = over_budget
        pr = prediction.get("predicted_rounds")
        if pr:
            prediction["actual_over_predicted"] = round(cur_round / pr, 4)
        tel.event("predicted_vs_actual",
                  predicted_rounds=pr, actual_rounds=cur_round,
                  converged=bool(done), over_budget=over_budget)
    state = trim(state)
    return RunResult(
        converged=bool(done), rounds=cur_round, wall_ms=wall_ms,
        compile_ms=compile_ms, num_nodes=num_nodes,
        algorithm=cfg.algorithm,
        final_state=type(state)(*(t.cpu() for t in state)),
        rounds_executed=executed, metrics=metrics,
        checkpoints=checkpoints, stopped="drain" if drained else None,
    )


def sharded_unported(cfg: RunConfig) -> Optional[str]:
    """The flags of faults, events, repair, checkpoints, the sentinel,
    sweeps, vector payloads, the learning workloads, clocks, acceleration
    and float64 that ``cfg`` uses, which the sharded engine does not run yet
    (its side, with the plan patching of ``patch_shard_push_deliveries``
    and the sharded ``matvec_payload``, is still to port), or None."""
    sched = cfg.schedule
    names = []
    if sched.has_strikes:
        names.append("--fail-fraction/--fault-plan (kill and revive "
                     "strikes)")
    if sched.has_loss:
        names.append("--drop-prob/--fault-plan (loss windows)")
    if cfg.events.has_events:
        names.append("--event-plan/--churn/--value-faults")
    if cfg.repair != "off":
        names.append(f"--repair {cfg.repair}")
    if cfg.sentinel != "off":
        names.append(f"--sentinel {cfg.sentinel}")
    if cfg.checkpoint_every or cfg.checkpoint_dir or cfg.quarantine_log:
        names.append("--checkpoint-dir/--checkpoint-every/--resume")
    if cfg.sweep is not None:
        names.append("--sweep/--sweep-seeds")
    for flag, given in (("--payload-dim", cfg.payload_dim != 1),
                        ("--workload", cfg.workload != "avg"),
                        ("--clock", cfg.clock != "sync"),
                        ("--accel", cfg.accel != "off"),
                        ("--x64", cfg.dtype != "float32")):
        if given:
            names.append(flag)
    return ", ".join(names) or None


def resume_allows_fast(topo: Topology,
                       initial_state: Optional[PushSumState]) -> bool:
    """Can a run from ``initial_state`` keep the liveness fast paths? Yes
    iff its dead set is empty or exactly the birth exclusions (component-
    closed by construction); any other dead set takes the general path,
    as in the JAX engine."""
    if initial_state is None:
        return True
    alive = initial_state.alive.cpu().numpy()
    if alive.all():
        return True
    birth = topo.birth_alive()
    return birth is not None and bool(np.array_equal(alive, birth))


def run_simulation(topo: Topology, cfg: RunConfig,
                   initial_state=None) -> RunResult:
    """Build what the round reads, warm the kernels, and drive the
    protocol to convergence (or ``max_rounds``); with ``cfg.sweep`` the
    batched sweep engine runs instead (``sweep/engine.py``
    :func:`~gossipprotocol_tpu_torch.sweep.engine.run_sweep`), which
    cannot resume. ``initial_state``
    continues from a given state (a checkpoint's, or one carried across
    with :mod:`gossipprotocol_tpu_torch.convert`); it runs the general
    dead-set path unless its dead set is the birth exclusions, and a run
    with repair, events or logged quarantines first replays the adjacency
    the state lived through (``events.replay_topology``).

    An adjacency change mid-run (repair, churn, a quarantine under
    repair) goes through ``rebuild``: the round is built again for the
    new topology with the general dead-set path, its device arrays — for
    ``pallas`` and ``routed`` the plans, through the plan cache under the
    new CSR's key — are placed, and its chunk is warmed (kept out of
    ``wall_ms``); a failed build raises. The counters of a rebuilt round
    recount through the rebuilt delivery.

    With ``cfg.telemetry`` the builds, the warm-up and the prediction are
    spans of the hub, and the chunk runners carry the counter and trace
    rows of ``obs/`` (:func:`make_chunk_runner`)."""
    from gossipprotocol_tpu_torch.obs import as_telemetry

    if cfg.sweep is not None:
        from gossipprotocol_tpu_torch.sweep.engine import run_sweep

        if initial_state is not None:
            raise ValueError(
                "sweep runs cannot resume from a checkpoint — lanes have "
                "no per-lane checkpoint story yet"
            )
        return run_sweep(topo, cfg)
    dev = resolve_device(cfg.device)
    tel = as_telemetry(cfg.telemetry)
    walk = is_walk(cfg)
    records = tel.enabled or cfg.metrics_callback is not None
    run_topo = topo
    if initial_state is not None and (
            cfg.repair != "off" or cfg.events.has_events
            or cfg.quarantine_log):
        # the run's adjacency is a function of (birth topology, schedule,
        # event plan, policy, seed): replay the event rounds the state
        # already lived through
        from gossipprotocol_tpu_torch.events import replay_topology

        run_topo = replay_topology(topo, cfg, int(initial_state.round))
    with tel.span("protocol_build", engine="single-card"):
        state, round_core, done_fn, flags = build_protocol(
            run_topo, cfg,
            allow_all_alive=resume_allows_fast(topo, initial_state))
        if initial_state is not None:
            state = type(state)(*(t.to(dev).clone() for t in initial_state))
    sentinel_fn = make_sentinel_fn(cfg) if cfg.sentinel != "off" else None
    base_key = key_data(cfg.seed, dev)

    def telemetry_fns(ctopo, run_flags):
        """``(counter_fn, trace_fn)`` of one build of the round."""
        counter_fn = trace_fn = None
        if tel.counters_on:
            from gossipprotocol_tpu_torch.obs.counters import make_counter_fn

            counter_fn = make_counter_fn(ctopo, cfg, all_alive=run_flags[0],
                                         targets_alive=run_flags[1])
        if tel.traces_on and not walk:
            from gossipprotocol_tpu_torch.obs.trace import make_trace_fn

            trace_fn = make_trace_fn(ctopo, cfg)
        return counter_fn, trace_fn

    def make_step(ctopo, core, done, delivery, run_flags, label="chunk"):
        """``(step, observe)`` for one build of the round."""
        gossip = isinstance(core, GossipCore)
        extra_stats = core.extra_stats if gossip else None
        counter_fn, trace_fn = telemetry_fns(ctopo, run_flags)
        stats_kw = dict(records=records, mass=tel.counters_on)
        if walk:
            from gossipprotocol_tpu_torch.protocols.walk import (
                make_walk_chunk_runner,
            )

            runner = make_walk_chunk_runner(
                delivery, ctopo.num_nodes, streak_target=cfg.streak_target,
                quorum=(ctopo.num_nodes if cfg.alert_quorum is None
                        else cfg.alert_quorum),
                base_key=base_key, done_fn=done, **stats_kw)
        elif use_megakernel(cfg):
            runner = make_megakernel_chunk_runner(
                core, done, cfg.rounds_per_kernel, counter_fn=counter_fn,
                trace_fn=trace_fn, **stats_kw)
        else:
            runner = make_chunk_runner(
                core, done, extra_stats,
                base_key=base_key if draws(cfg) else None,
                sentinel_fn=sentinel_fn, counter_fn=counter_fn,
                trace_fn=trace_fn, **stats_kw)
        tel.record_compiled(
            label, None, engine="single-card", delivery=cfg.delivery,
            rounds_per_kernel=(cfg.rounds_per_kernel if use_megakernel(cfg)
                               else None),
            hub_split=(getattr(tel, "hub_split", None) or {}).get(
                "classes"))

        def step(s, start_round, round_limit):
            return runner(s, delivery, start_round, round_limit)

        return step, (core.observe if gossip else None)

    with tel.span("plan_compile", engine="single-card"):
        delivery = device_arrays(run_topo, cfg, tel=tel)
    prediction = compute_prediction(run_topo, cfg, tel)
    step, observe = make_step(run_topo, round_core, done_fn, delivery, flags)

    def observe_state(step_fn, observe_fn, st):
        if observe_fn is not None:
            # the first chunk's branch, from the state it starts from
            r = int(st.round)
            observe_fn(step_fn(st, r, r)[1].tolist()[2:4])

    t0 = time.perf_counter()
    with tel.span("warm_start"):
        warm_start(step, state)
        observe_state(step, observe, state)
    compile_ms = (time.perf_counter() - t0) * 1e3

    def rebuild(new_topo, st):
        t0p = time.perf_counter()
        _, core2, done2, flags2 = build_protocol(new_topo, cfg,
                                                 allow_all_alive=False)
        delivery2 = device_arrays(new_topo, cfg, tel=tel)
        plan_patch_s = time.perf_counter() - t0p
        step2, observe2 = make_step(new_topo, core2, done2, delivery2,
                                    flags2, label="chunk_rebuild")
        t0w = time.perf_counter()
        warm_start(step2, st)
        observe_state(step2, observe2, st)
        return (step2, observe2), st, {
            "plan_patch_s": plan_patch_s,
            "warm_s": time.perf_counter() - t0w}

    return _drive(cfg, state, step, topo.num_nodes, compile_ms,
                  observe=observe, topo=topo, rebuild=rebuild,
                  run_topo=run_topo, prediction=prediction, walk=walk)


def resume_simulation(topo: Topology, cfg: RunConfig, state) -> RunResult:
    """Continue a run from a checkpointed state (``utils/checkpoint.py``
    :func:`~gossipprotocol_tpu_torch.utils.checkpoint.load`)."""
    return run_simulation(topo, cfg, initial_state=state)
