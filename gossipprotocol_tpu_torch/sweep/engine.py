"""The batched execution path: B lanes through one round program (port of
``gossipprotocol_tpu/sweep/engine.py``, single card).

The JAX package vmaps its chunk body over a leading lane axis. Here the
state itself carries the lane dimension: every field of the per-lane
states is stacked to ``[B, ...]`` (``round`` to ``[B]``), the round keys
are ``[B, 2]`` (lane i's ``fold_in(key(seed_i), round_i)``), and the
port's own round cores (``protocols/gossip.py``, ``protocols/pushsum.py``)
and chunk runner (``engine/driver.py`` :func:`~gossipprotocol_tpu_torch.
engine.driver.make_chunk_runner`) run all lanes in one pass: the
scatters add into a flattened ``[B·n]`` target at ``lane·n + target``,
and the chunk freezes each lane on its own predicate, so a converged
lane's whole state — round and counters included — stops updating
bitwise, as the JAX package's ``while_loop`` batching rule gives. One
delivery build serves every lane; each chunk makes one device-to-host
fetch with a ``[B]`` view of every stat.

Bitwise lane contract: lane *i* of a B-lane sweep equals the standalone
run with lane *i*'s config. Unswept parameters are the Python constants
the standalone round takes; swept ones enter as ``[B]`` tensors rounded
on the host exactly as the standalone run rounds them (``_lane_params``).
On the card, gossip lanes stay bitwise (integer adds); push-sum's float
``index_add_`` adds in the order of the card's atomics, so its lanes
equal their standalone card runs up to that order.

The JAX package's sharded sweep (``run_sweep_sharded``) is not ported:
the port has no sharded gossip or fanout-one push-sum to run it over.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, List, Optional

import numpy as np
import torch

from gossipprotocol_tpu_torch.obs import as_telemetry
from gossipprotocol_tpu_torch.topology.base import Topology


class SweepConfigError(ValueError):
    """A config outside the sweep envelope (structural variation, or a
    feature the batched path does not carry yet)."""


@dataclasses.dataclass
class SweepResult:
    """Rollup + per-lane outcomes of one batched sweep.

    Quacks like :class:`~gossipprotocol_tpu_torch.engine.driver.RunResult`
    for the CLI/manifest surface: ``converged`` is the ALL-lanes rollup,
    ``rounds`` the slowest lane, ``final_state`` the ``[B, ...]``-stacked
    lane states (CPU tensors)."""

    converged: bool
    rounds: int
    wall_ms: float
    compile_ms: float
    num_nodes: int
    algorithm: str
    final_state: Any
    metrics: List[dict]
    lanes: int = 0
    lane_records: List[dict] = dataclasses.field(default_factory=list)
    checkpoints: List[str] = dataclasses.field(default_factory=list)
    # round iterations the chunks ran, frozen ones included (as
    # RunResult.rounds_executed counts them on the per-round path)
    rounds_executed: int = 0
    stopped: Optional[str] = None

    def lane_state(self, lane: int):
        """Lane ``lane``'s final state, unstacked — the state a standalone
        run with that lane's config returns."""
        return type(self.final_state)(*(x[lane] for x in self.final_state))

    @property
    def estimate_error(self) -> Optional[float]:
        """Max per-lane push-sum estimate error (lanes average
        independently — a cross-lane mean would be meaningless)."""
        from gossipprotocol_tpu_torch.engine.driver import RunResult

        errs = []
        for i in range(self.lanes):
            err = RunResult(
                converged=True, rounds=0, wall_ms=0.0, compile_ms=0.0,
                num_nodes=self.num_nodes, algorithm=self.algorithm,
                final_state=self.lane_state(i), metrics=[],
            ).estimate_error
            if err is not None:
                errs.append(err)
        return max(errs) if errs else None


def _validate_envelope(topo: Topology, cfg, spec) -> None:
    """Loud rejection of configs the batched path does not carry (the JAX
    package's envelope and messages).

    The envelope is the plain round-loop: gossip (scatter or inverted
    dense) and single-target push-sum (scatter/invert), workload='avg',
    no acceleration, no host events."""
    del topo
    if cfg.algorithm not in ("gossip", "push-sum"):
        raise SweepConfigError(
            f"sweeps support algorithm 'gossip' or 'push-sum', not "
            f"{cfg.algorithm!r}"
        )
    if cfg.workload != "avg":
        raise SweepConfigError(
            f"sweeps support workload='avg' only (got {cfg.workload!r}); "
            "SGP/GALA lanes need the training state in the envelope"
        )
    if cfg.algorithm == "push-sum" and cfg.fanout != "one":
        raise SweepConfigError(
            "sweeps support fanout='one' push-sum only — the diffusion "
            "round shares its edge slabs in ways the lane axis does not "
            "thread yet"
        )
    if cfg.delivery not in ("scatter", "invert"):
        raise SweepConfigError(
            f"sweeps support delivery 'scatter' or 'invert', not "
            f"{cfg.delivery!r} — routed/pallas/megakernel plans are "
            "compiled per-run structures"
        )
    if cfg.accel != "off":
        raise SweepConfigError("sweeps do not carry accelerated gossip yet")
    if cfg.events.has_events:
        raise SweepConfigError(
            "sweeps cannot replay topology-schedule events — the event "
            "plan rewrites shared structure mid-run"
        )
    if cfg.schedule.has_strikes:
        raise SweepConfigError(
            "sweeps cannot carry kill/revive strikes yet (host events "
            "stop the chunk per lane); loss windows are fine"
        )
    if cfg.repair != "off":
        raise SweepConfigError("sweeps cannot carry repair policies")
    if cfg.checkpoint_every or cfg.checkpoint_dir:
        raise SweepConfigError("sweep runs don't checkpoint yet")
    if cfg.round_budget == "auto":
        raise SweepConfigError(
            "round_budget='auto' is per-run analytic; give sweeps an "
            "explicit integer budget"
        )
    tel = as_telemetry(cfg.telemetry)
    if tel.traces_on:
        raise SweepConfigError(
            "sweep runs don't record per-round traces yet — counters "
            "and manifests are lane-aware, traces are not"
        )
    if "drop_prob" in spec.axis_names and len(cfg.schedule.loss) > 1:
        raise SweepConfigError(
            "sweep axis 'drop_prob' needs at most one loss window on "
            "the base config"
        )
    if "activation_rate" in spec.axis_names and cfg.clock != "poisson":
        raise SweepConfigError(
            "sweep axis 'activation_rate' needs --clock poisson on the "
            "base config (the sync clock compiles activation out)"
        )


def _lane_params(spec, lane_cfgs, cfg, device) -> dict:
    """Per-lane ``[B]`` parameter tensors on ``device``, rounded on the
    host.

    The rounding discipline is the bitwise contract: the standalone
    round rounds ``1 - p`` / ``1 - exp(-r)`` from the double to float32
    ONCE, so the lane tensors come from the identical computation — never
    from rounding the inputs first. Tolerances take the state's dtype;
    a swept threshold is the standalone run's (``threshold + 1`` under
    the reference semantics)."""
    from gossipprotocol_tpu_torch.protocols.state import torch_dtype

    dt = np.dtype(str(torch_dtype(cfg.dtype)).split(".")[-1])

    def put(values, dtype):
        return torch.from_numpy(np.asarray(values, dtype)).to(device)

    params = {}
    for name in spec.traced_names:
        if name == "eps":
            params["eps"] = put([lc.eps for lc in lane_cfgs], dt)
        elif name == "tol":
            params["tol"] = put([lc.tol for lc in lane_cfgs], dt)
        elif name == "threshold":
            params["threshold"] = put(
                [lc.threshold + (1 if lc.semantics == "reference" else 0)
                 for lc in lane_cfgs], np.int32)
        elif name == "activation_rate":
            params["activation_prob"] = put(
                [np.float32(1.0 - math.exp(-lc.activation_rate))
                 for lc in lane_cfgs], np.float32)
        elif name == "drop_prob":
            params["drop_keep"] = put(
                [np.float32(1.0 - lc.schedule.loss[0].prob)
                 for lc in lane_cfgs], np.float32)
    return params


def _lane_done(cfg):
    """The supervisor predicate a lane: every healthy row settled (or
    ``alert_quorum`` rows), ``[B]``."""
    quorum = cfg.alert_quorum

    def done_fn(state):
        settled = state.converged | ~state.alive
        if quorum is None:
            return torch.all(settled, dim=-1)
        return torch.sum(settled.to(torch.int32), dim=-1) >= quorum

    return done_fn


def _lane_round(topo: Topology, cfg, spec, params, *, all_alive: bool,
                targets_alive: bool):
    """``(round_core, counter_fn, gossip_core)`` of the lanes: the
    standalone round's functions with the lanes' swept values spliced in
    (unswept ones are the template's constants)."""
    from gossipprotocol_tpu_torch.engine.driver import (
        GossipCore, effective_keep_alive, gossip_inversion_enabled,
        run_clock_spec,
    )

    n = topo.num_nodes
    traced = set(spec.traced_names)
    loss_windows = cfg.schedule.static_loss_windows()
    clock = run_clock_spec(topo, cfg)
    if "drop_prob" in traced and not loss_windows:
        # lane_config synthesized a whole-run window per lane; mirror its
        # bounds for the lane values below
        loss_windows = ((0, cfg.max_rounds, 0.0),)
    if "drop_keep" in params:
        (start, stop, _), = loss_windows
        loss_windows = ((start, stop, params["drop_keep"]),)
    if "activation_prob" in params:
        clock = ("prob", params["activation_prob"], int(clock[1]))

    if cfg.algorithm == "gossip":
        from gossipprotocol_tpu_torch.protocols.gossip import (
            gossip_message_counts,
        )

        ref = cfg.semantics == "reference"
        keep_alive = effective_keep_alive(topo, cfg)
        core = GossipCore(
            n=n,
            threshold=params.get("threshold",
                                 cfg.threshold + 1 if ref else cfg.threshold),
            keep_alive=keep_alive, all_alive=all_alive,
            invertible=(gossip_inversion_enabled(topo, cfg)
                        and not loss_windows),
            loss_windows=loss_windows, clock=clock)

        def counter_fn(old, new, nbrs, key):
            return gossip_message_counts(
                old, new, nbrs, key, n=n, keep_alive=keep_alive,
                all_alive=all_alive, loss_windows=loss_windows, clock=clock)

        return core, counter_fn, core

    from gossipprotocol_tpu_torch.protocols.pushsum import (
        pushsum_message_counts, pushsum_round_core,
    )

    pred = dict(eps=params.get("eps", cfg.eps),
                streak_target=cfg.streak_target, predicate=cfg.predicate,
                tol=params.get("tol", cfg.tol), all_alive=all_alive,
                targets_alive=targets_alive)

    def core(st, nbrs, key):
        return pushsum_round_core(
            st, nbrs, key, n=n, loss_windows=loss_windows, clock=clock,
            delivery=cfg.delivery, **pred)

    def counter_fn(old, new, nbrs, key):
        return pushsum_message_counts(
            old, nbrs, key, n=n, all_alive=all_alive,
            targets_alive=targets_alive, delivery=cfg.delivery,
            loss_windows=loss_windows, clock=clock)

    return core, counter_fn, None


def run_sweep(topo: Topology, cfg) -> SweepResult:
    """Single-card batched sweep: one delivery build, B lanes."""
    from gossipprotocol_tpu_torch.engine.driver import (
        StatsLayout, build_protocol, device_arrays, make_chunk_runner,
        resolve_device,
    )
    from gossipprotocol_tpu_torch.protocols.sampling import key_data

    spec = cfg.sweep
    template = dataclasses.replace(cfg, sweep=None)
    _validate_envelope(topo, template, spec)
    tel = as_telemetry(cfg.telemetry)
    dev = resolve_device(cfg.device)
    B = spec.lanes
    lane_cfgs = [spec.lane_config(template, i) for i in range(B)]

    with tel.span("protocol_build", engine="sweep", lanes=B):
        built = [build_protocol(topo, lc) for lc in lane_cfgs]
        _, _, _, (all_alive, targets_alive) = built[0]
        state = type(built[0][0])(*(torch.stack(fields)
                                    for fields in zip(*(b[0] for b in built))))
        del built
    with tel.span("plan_compile", engine="sweep"):
        # ONE build for the whole sweep — the shared-structure contract
        nbrs = device_arrays(topo, template, tel=tel)
    tel.event("plan_cache", provenance="sweep-shared", builds=1, lanes=B,
              design="lane-batched")

    base_key = torch.stack([key_data(lc.seed, dev) for lc in lane_cfgs])
    params = _lane_params(spec, lane_cfgs, template, dev)
    core, counter_fn, gossip_core = _lane_round(
        topo, template, spec, params, all_alive=all_alive,
        targets_alive=targets_alive)
    done_fn = _lane_done(template)
    # the chunk's one fetch: a [B] view of every per-run stat
    layout = StatsLayout(
        state, records=True, extra=2 if gossip_core is not None else 0,
        sentinel=False, mass=tel.counters_on,
        counter_width=3 * B if tel.counters_on else 0)
    runner = make_chunk_runner(
        core, done_fn,
        gossip_core.extra_stats if gossip_core is not None else None,
        base_key=base_key,
        counter_fn=counter_fn if tel.counters_on else None,
        records=True, mass=tel.counters_on)
    tel.record_compiled("chunk", None, engine="sweep", lanes=B,
                        delivery=template.delivery)

    def step(s, start_round, round_limit):
        return runner(s, nbrs, start_round, round_limit)

    def observe_state(s):
        if gossip_core is not None:
            gossip_core.observe(layout.parse(step(s, 0, 0)[1].tolist())
                                ["extra"])

    t0 = time.perf_counter()
    with tel.span("warm_start"):
        step(state, 0, 1)[1].cpu()  # the sync point; result discarded
        observe_state(state)
    compile_ms = (time.perf_counter() - t0) * 1e3
    return _drive_sweep(topo, template, spec, lane_cfgs, state, step,
                        layout, gossip_core, compile_ms, tel)


def _drive_sweep(topo, cfg, spec, lane_cfgs, state, step, layout,
                 gossip_core, compile_ms, tel) -> SweepResult:
    """Host loop over lane-stacked chunks.

    Mirrors ``engine.driver._drive`` (and shares its record helpers) with
    a ``[B]`` view of every stat: one device fetch per chunk, chunk
    advancement until every lane's predicate holds (lanes past theirs are
    frozen on device) or the round bound / budget hits. Counters fold per
    lane, then sum across lanes into the telemetry totals. As in the JAX
    package, a stall stops the sweep only when no lane spreads (the
    gossip spreader count sums over the lanes)."""
    from gossipprotocol_tpu_torch.engine.driver import (
        emit_over_budget, note_counters, note_mass_drift, record_emitter,
        round_budget_rounds,
    )

    B = spec.lanes
    n = topo.num_nodes
    budget = round_budget_rounds(cfg)
    metrics: List[dict] = []
    emit = record_emitter(cfg, tel, metrics)
    lane_counters = np.zeros((B, 3), np.int64)
    prev_rounds = np.zeros(B, np.int64)  # every lane starts at round 0
    cur_round = 0
    mass_base = None
    if tel.counters_on:
        with tel.span("mass_baseline"):
            # a chunk of no rounds: the chunk's own reduction, so a
            # lossless lane drifts by exactly 0 ULPs
            mass_base = layout.parse(step(state, 0, 0)[1].tolist())["mass"]
    done = np.zeros(B, bool)
    over_budget = stalled = False
    executed = 0

    t0 = time.perf_counter()
    while cur_round < cfg.max_rounds:
        round_limit = min(cur_round + cfg.chunk, cfg.max_rounds)
        if budget is not None:
            round_limit = min(round_limit, budget)
        chunk_start_rounds = prev_rounds
        with tel.span("chunk", round_start=cur_round,
                      round_limit=round_limit, lanes=B):
            state, stats = step(state, cur_round, round_limit)
            got = layout.parse(stats.tolist())  # the one fetch
        executed += max(0, round_limit - cur_round)
        rounds = got["round"]
        done = got["done"]
        cur_round = int(rounds.max())
        prev_rounds = rounds.copy()
        metric = got["metric"]
        rec = {
            "round": cur_round,
            "lanes": B,
            "lanes_done": int(done.sum()),
            "rounds_min": int(rounds.min()),
            "converged": int(metric["converged"].sum()),
            "alive": int(metric["alive"].sum()),
        }
        if "ratio_min" in metric:
            # lane-summed node tallies; min/max stats take the envelope
            rec["ratio_min"] = float(metric["ratio_min"].min())
            rec["ratio_max"] = float(metric["ratio_max"].max())
            rec["w_underflow"] = int(metric["w_underflow"].sum())
        if gossip_core is not None:
            rec["spreading"] = got["extra"][0]
            gossip_core.observe(got["extra"])
        ctr = got["counters"]
        if ctr is not None:
            # each lane's valid prefix: the rounds it ran before freezing
            chunk_ctr = np.stack(
                [ctr[:int(rounds[i] - chunk_start_rounds[i]), i].sum(axis=0)
                 for i in range(B)])
            lane_counters += chunk_ctr
            note_counters(rec, chunk_ctr.sum(axis=0), tel)
        if got["mass"] is not None and mass_base is not None:
            note_mass_drift(rec, got["mass"], mass_base, tel)
        no_progress = bool((rounds == chunk_start_rounds).all())
        stalled = (not done.all()) and (
            rec.get("spreading") == 0 or no_progress)
        if stalled:
            rec["stalled"] = True
        emit(rec)
        if budget is not None and not done.all() and cur_round >= budget:
            over_budget = True
            emit_over_budget(emit, tel, cfg, cur_round, budget,
                             lanes_done=int(done.sum()))
        if done.all() or stalled or over_budget:
            break
    with tel.span("device_sync"):
        if state.round.is_cuda:
            torch.cuda.synchronize(state.round.device)
    wall_ms = (time.perf_counter() - t0) * 1e3

    final_state = type(state)(*(t.cpu() for t in state))
    lane_rounds = prev_rounds
    lane_records = []
    for i in range(B):
        lr = {
            "lane": i,
            "overrides": spec.lane_overrides(i),
            "converged": bool(done[i]),
            "rounds": int(lane_rounds[i]),
            "seed": int(lane_cfgs[i].seed),
        }
        if tel.counters_on:
            lr["sent"], lr["delivered"], lr["dropped"] = (
                int(x) for x in lane_counters[i])
        lane_records.append(lr)
    q50, q95 = (float(np.quantile(lane_rounds.astype(float), q))
                for q in (0.5, 0.95))
    tel.sweep = {
        "lanes": B,
        "converged_lanes": int(done.sum()),
        "converged_fraction": float(done.mean()),
        "rounds_p50": q50,
        "rounds_p95": q95,
        "rounds_max": int(lane_rounds.max()),
        "over_budget": over_budget,
        "spec": spec.describe(),
        "per_lane": lane_records,
    }
    tel.event("sweep_rollup", lanes=B, converged_lanes=int(done.sum()),
              rounds_p50=q50, rounds_p95=q95)

    return SweepResult(
        converged=bool(done.all()),
        rounds=cur_round,
        wall_ms=wall_ms,
        compile_ms=compile_ms,
        num_nodes=n,
        algorithm=cfg.algorithm,
        final_state=final_state,
        metrics=metrics,
        lanes=B,
        lane_records=lane_records,
        rounds_executed=executed,
    )
