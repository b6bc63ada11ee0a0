"""Experiment driver + convergence supervisor (port of the subset of
``gossipprotocol_tpu/engine/driver.py`` that fanout-all push-sum over the
fused gather delivery, the Clos-routed delivery and the K-round
megakernel reads).

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

The sharded push design (``--devices S``) has its own engine in
``parallel/sharded.py`` over the same chunk runner; its fields here are
``routed_design``, ``exchange_overlap``, ``payload_wire`` and
``build_workers``.

What is not yet ported exits as a :class:`NotPortedError` naming itself:
gossip, the single-target sender, the ``scatter`` and ``invert``
deliveries, the sharded pull design, faults, checkpoints, telemetry,
sweeps.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from gossipprotocol_tpu_torch.ops.build import resolve_device
from gossipprotocol_tpu_torch.ops.delivery import RoutedConfigError
from gossipprotocol_tpu_torch.protocols.diffusion import (
    pushsum_diffusion_round_routed,
)
from gossipprotocol_tpu_torch.protocols.pushsum import pushsum_done
from gossipprotocol_tpu_torch.protocols.state import PushSumState, pushsum_init
from gossipprotocol_tpu_torch.topology.base import Topology

ALGORITHMS = ("gossip", "push-sum")

# Rounds per chunk (one host fetch each). A fixed default: the JAX
# engine's auto size is a TPU-watchdog cost model that does not apply.
# A chunk runs to its limit, frozen rounds included, so a large chunk
# spends up to chunk - 1 rounds past convergence; 16 beat 64 and 8 on
# the card's smoke graphs (PERF.md, utils/profiling.py). Rounded up to a
# multiple of the megakernel's K.
DEFAULT_CHUNK_ROUNDS = 16

# the deliveries the port runs, and those of them whose fused kernel can
# loop rounds (--rounds-per-kernel > 1); routed dispatches one round per
# launch by construction
DELIVERIES = ("pallas", "megakernel", "routed")
FUSED_DELIVERIES = ("pallas", "megakernel")


class NotPortedError(ValueError):
    """The configuration asks for a path the PyTorch port lacks."""


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The fields the ported path reads (names and defaults as in the
    JAX package's ``RunConfig``), plus ``device``."""

    algorithm: str = "push-sum"
    seed: int = 0
    eps: float = 1e-10             # push-sum |Δ(s/w)| tolerance
    streak_target: int = 3         # consecutive rounds within tolerance
    predicate: str = "delta"       # "delta" (local) | "global" (sound)
    tol: float = 1e-4              # global-predicate tolerance
    fanout: str = "all"
    delivery: str = "pallas"
    value_mode: str = "scaled"     # push-sum init: "scaled" (i/N) | "index" (i)
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
    device: str = "cuda"

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; valid: {ALGORITHMS}")
        if self.algorithm != "push-sum":
            raise NotPortedError(
                f"algorithm {self.algorithm!r} is not yet ported to the "
                "PyTorch package (only push-sum --fanout all is)")
        if self.fanout != "all":
            raise NotPortedError(
                f"fanout {self.fanout!r} is not yet ported (only "
                "--fanout all is)")
        if self.rounds_per_kernel < 1:
            raise ValueError("rounds_per_kernel must be >= 1")
        if (self.rounds_per_kernel > 1
                and self.delivery not in FUSED_DELIVERIES):
            raise ValueError(
                "rounds_per_kernel > 1 loops rounds inside the fused "
                "kernel — it requires delivery='pallas' (or "
                f"'megakernel'); --delivery {self.delivery} dispatches "
                "one round per launch by construction")
        if self.delivery not in DELIVERIES:
            raise NotPortedError(
                f"delivery {self.delivery!r} is not yet ported (only "
                "--delivery pallas, routed and megakernel are)")
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
        if self.predicate not in ("delta", "global"):
            raise ValueError("predicate must be 'delta' or 'global'")
        if self.value_mode not in ("scaled", "index"):
            raise ValueError("value_mode must be 'scaled' or 'index'")
        if self.streak_target < 1:
            raise ValueError("streak_target must be >= 1")
        if self.chunk_rounds is not None and self.chunk_rounds < 1:
            raise ValueError("chunk_rounds must be >= 1")

    @property
    def chunk(self) -> int:
        if self.chunk_rounds:
            return self.chunk_rounds
        k = self.rounds_per_kernel
        return -(-DEFAULT_CHUNK_ROUNDS // k) * k


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
    final_state: Any          # PushSumState of CPU tensors
    # round iterations the device ran. The per-round path counts frozen
    # ones (a chunk runs to its limit, up to chunk - 1 rounds past
    # convergence); the megakernel stops at convergence, so its count —
    # the sum of the kernel's own ``executed`` — equals ``rounds`` less
    # the start
    rounds_executed: int = 0

    @property
    def estimate_error(self) -> Optional[float]:
        """Push-sum: max |s/w − achievable mean| over healthy nodes (the
        mean over healthy rows only, in float64 on the host)."""
        st = self.final_state
        ratio = st.ratio.numpy().astype(np.float64)
        alive = st.alive.numpy()
        if not alive.any():
            return None
        s = st.s.numpy().astype(np.float64)[alive].sum(axis=0)
        w = st.w.numpy().astype(np.float64)[alive].sum()
        return float(np.abs(ratio[alive] - s / w).max())


def initial_alive(topo: Topology) -> Optional[np.ndarray]:
    """Healthy-at-birth mask: only the largest connected component
    (None = everyone healthy)."""
    return topo.birth_alive()


def build_protocol(topo: Topology, cfg: RunConfig,
                   allow_all_alive: bool = True):
    """``(init_state, round_core(state, delivery), done_fn,
    (all_alive, targets_alive))`` on the run's device.

    With no birth exclusions the round drops its aliveness masks
    (``all_alive``); birth exclusions are whole components, so an alive
    node's neighbors are alive (``targets_alive``). ``allow_all_alive=
    False`` forces the general dead-set path. Under
    :func:`use_megakernel` the core is the K-round kernel's
    ``(padded state, megakernel delivery) -> padded state``, which runs
    the all-alive round only."""
    dev = resolve_device(cfg.device)
    alive0 = initial_alive(topo)
    all_alive = allow_all_alive and alive0 is None
    targets_alive = allow_all_alive
    state = pushsum_init(topo.num_nodes, value_mode=cfg.value_mode,
                         device=dev)
    if alive0 is not None:
        state = state._replace(
            alive=state.alive & torch.from_numpy(np.array(alive0)).to(dev))

    if use_megakernel(cfg):
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
            n=topo.num_nodes, rounds_per_kernel=cfg.rounds_per_kernel,
            eps=cfg.eps, streak_target=cfg.streak_target,
            predicate=cfg.predicate, tol=cfg.tol)
        return state, core, pushsum_done, (all_alive, targets_alive)

    def round_core(st, delivery):
        return pushsum_diffusion_round_routed(
            st, delivery, eps=cfg.eps, streak_target=cfg.streak_target,
            predicate=cfg.predicate, tol=cfg.tol, all_alive=all_alive,
            targets_alive=targets_alive)

    return state, round_core, pushsum_done, (all_alive, targets_alive)


def device_arrays(topo: Topology, cfg: RunConfig):
    """The delivery the round reads, through the plan cache
    (``cfg.plan_cache``), placed on the run's device: the routed plans
    for ``delivery='routed'``, else the fused gather plan; under
    :func:`use_megakernel` wrapped for the K-round kernel, whose
    eligibility (resident gathers) is checked here, before any launch."""
    from gossipprotocol_tpu_torch.ops.plancache import (
        pallas_delivery_cached, routed_delivery_cached,
    )

    if cfg.delivery == "routed":
        rd, _prov = routed_delivery_cached(
            topo, cache_dir=cfg.plan_cache, device=resolve_device(cfg.device))
        return rd

    pd, _prov = pallas_delivery_cached(topo, cache_dir=cfg.plan_cache,
                                       device=resolve_device(cfg.device))
    if use_megakernel(cfg):
        from gossipprotocol_tpu_torch.ops.megakernel import (
            build_megakernel_delivery,
        )

        return build_megakernel_delivery(pd)
    return pd


def _freeze(active: torch.Tensor, new: PushSumState,
            old: PushSumState) -> PushSumState:
    return PushSumState(*(torch.where(active, a, b)
                          for a, b in zip(new, old)))


def chunk_stats(state: PushSumState, done_fn) -> torch.Tensor:
    """The chunk's verdict as ONE int32 device tensor (one host fetch):
    ``[round, done]``."""
    return torch.stack([state.round, done_fn(state).to(torch.int32)])


def make_chunk_runner(round_core, done_fn):
    """``chunk(state, delivery, start_round, round_limit) -> (state,
    stats)``: advance until global convergence or ``round ==
    round_limit``. The predicate is evaluated before every round, as the
    JAX engine's loop condition does; a converged state is carried
    through the remaining rounds of the chunk unchanged."""

    def chunk(state, delivery, start_round: int, round_limit: int):
        for _ in range(max(0, round_limit - start_round)):
            active = ~done_fn(state)
            state = _freeze(active, round_core(state, delivery), state)
        return state, chunk_stats(state, done_fn)

    return chunk


def make_megakernel_chunk_runner(round_core, done_fn,
                                 rounds_per_kernel: int):
    """``chunk(state, mk, start_round, round_limit) -> (state, stats)``
    for the K-round kernel: pad the state once, launch
    ``ceil((round_limit - start_round) / K)`` super-steps — as many as
    the JAX engine's ``while_loop`` runs when the run does not converge —
    and unpad once. Per super-step the host enqueues the launch and
    nothing else; the kernel updates the padded state in place, and a
    launch that finds the predicate already true exits at once, so a
    super-step may overshoot ``round_limit`` by up to K - 1 rounds but
    never runs past convergence."""
    from gossipprotocol_tpu_torch.ops.megakernel import (
        pad_state, unpad_state,
    )

    k = rounds_per_kernel

    def chunk(state, mk, start_round: int, round_limit: int):
        ms = pad_state(state)
        for _ in range(-(-max(0, round_limit - start_round) // k)):
            ms = round_core(ms, mk)
        state = unpad_state(ms, state.alive)
        return state, chunk_stats(state, done_fn)

    return chunk


def warm_start(step, state) -> None:
    """Run one chunk of one round and discard it: builds and loads the
    CUDA kernels, loads every PyTorch kernel the chunk launches and warms
    the allocator, so the timed loop measures rounds only (the JAX engine
    likewise keeps compilation and program load out of ``wall_ms``)."""
    r = int(state.round)
    _, stats = step(state, r, r + 1)
    stats.cpu()  # the sync point


def _drive(cfg: RunConfig, state, step, num_nodes: int,
           compile_ms: float, trim=None) -> RunResult:
    """Host loop: chunks up to ``max_rounds`` and the convergence
    verdict. ``trim`` cuts a padded final state to the real rows (the
    sharded engine)."""
    cur_round = int(state.round)
    done = False
    executed = 0
    fused = use_megakernel(cfg)
    t0 = time.perf_counter()
    while cur_round < cfg.max_rounds:
        round_limit = min(cur_round + cfg.chunk, cfg.max_rounds)
        state, stats = step(state, cur_round, round_limit)
        prev = cur_round
        cur_round, done = stats.tolist()  # the one fetch of the chunk
        # the kernel adds the rounds it ran to `round` itself
        executed += (cur_round - prev) if fused else (round_limit - prev)
        if done:
            break
    if state.s.is_cuda:
        torch.cuda.synchronize(state.s.device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if trim is not None:
        state = trim(state)
    return RunResult(
        converged=bool(done), rounds=cur_round, wall_ms=wall_ms,
        compile_ms=compile_ms, num_nodes=num_nodes,
        algorithm=cfg.algorithm,
        final_state=PushSumState(*(t.cpu() for t in state)),
        rounds_executed=executed,
    )


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
                   initial_state: Optional[PushSumState] = None
                   ) -> RunResult:
    """Build the delivery, warm the kernels, and drive the protocol to
    convergence (or ``max_rounds``). ``initial_state`` continues from a
    given state (for example one carried across with
    :func:`gossipprotocol_tpu_torch.convert.state_from_numpy`); it runs
    the general dead-set path unless its dead set is the birth
    exclusions."""
    dev = resolve_device(cfg.device)
    state, round_core, done_fn, _ = build_protocol(
        topo, cfg, allow_all_alive=resume_allows_fast(topo, initial_state))
    if initial_state is not None:
        state = PushSumState(*(t.to(dev).clone() for t in initial_state))
    delivery = device_arrays(topo, cfg)
    if use_megakernel(cfg):
        runner = make_megakernel_chunk_runner(round_core, done_fn,
                                              cfg.rounds_per_kernel)
    else:
        runner = make_chunk_runner(round_core, done_fn)

    def step(s, start_round, round_limit):
        return runner(s, delivery, start_round, round_limit)

    t0 = time.perf_counter()
    warm_start(step, state)
    compile_ms = (time.perf_counter() - t0) * 1e3
    return _drive(cfg, state, step, topo.num_nodes, compile_ms)
