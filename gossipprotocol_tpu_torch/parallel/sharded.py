"""Sharded engine: diffusion push-sum over S shards with the push design
(port of the push-sum routed part of ``gossipprotocol_tpu/parallel/
sharded.py``).

Node state is one padded ``[n_padded]`` tensor per field, viewed as
``[S, local_n]``: shard k owns rows ``k*local_n .. (k+1)*local_n - 1``.
Padding rows (``n_padded - n < S``) are born dead and converged and carry
no mass, so they never influence the protocol, and they are trimmed from
the result. Each round runs :func:`~gossipprotocol_tpu_torch.ops.
sharddelivery.pushsum_diffusion_round_routed_push`: the shards' plan
passes in lockstep around one exchange, then the elementwise tail once
over all shards. The global sums of the predicate are per-shard partial
sums added in shard order (the JAX package's ``psum`` of local sums), and
the supervisor's ``global_done`` sums the per-shard unconverged counts.

The chunk loop is the single-card engine's (``engine/driver.py``): the
freeze-on-done chunk runner, the warm-up chunk and ``_drive``. All shards
live on the run's one card (``parallel/mesh.py``).

Telemetry (``cfg.telemetry``) is the single-card engine's too, with the
JAX sharded engine's additions: the message counters are counted per
shard (``ops/sharddelivery.py`` ``shard_routed_message_counts``) and
summed over shards, the per-shard rows feed the manifest's shard-balance
block (``Telemetry.add_shard_counters``), the trace rows sum in shard
order, and the exchange's bytes a round are noted beside the plans'
table bytes.
"""

from __future__ import annotations

import time
from functools import partial
from typing import List, Optional

import numpy as np
import torch

from gossipprotocol_tpu_torch.engine.driver import (
    NotPortedError,
    RunConfig,
    RunResult,
    _drive,
    compute_prediction,
    initial_alive,
    make_chunk_runner,
    note_hub_split,
    resume_allows_fast,
    sharded_unported,
    use_megakernel,
    warm_start,
)
from gossipprotocol_tpu_torch.parallel.mesh import make_mesh, padded_size
from gossipprotocol_tpu_torch.protocols.state import (
    PushSumState, pushsum_init,
)


def pad_state(state: PushSumState, n_padded: int) -> PushSumState:
    """Pad a trimmed (real-rows) state with phantom rows: dead,
    converged, zero mass — invisible to protocol and predicate."""
    n = int(state.alive.shape[0])
    if n == n_padded:
        return state

    def pad(name, x):
        if x.dim() == 0:
            return x
        fill = (torch.ones if name == "converged" else torch.zeros)(
            (n_padded - n,) + tuple(x.shape[1:]), dtype=x.dtype,
            device=x.device)
        return torch.cat([x, fill])

    return PushSumState(*(pad(f, v) for f, v in
                          zip(PushSumState._fields, state)))


def trim_state(state: PushSumState, n: int) -> PushSumState:
    """The real rows of a padded state."""
    return PushSumState(*(x if x.dim() == 0 else x[:n] for x in state))


def shard_sum(num_shards: int):
    """Sum over the node axis as the sharded engine takes it: each
    shard's partial sum, then the partials added in shard order."""
    def all_sum(x: torch.Tensor) -> torch.Tensor:
        parts = torch.sum(x.view(num_shards, -1), dim=1)
        acc = parts[0]
        for k in range(1, num_shards):
            acc = acc + parts[k]
        return acc

    return all_sum


def sharded_done(num_shards: int):
    """Supervisor predicate: the per-shard counts of healthy unconverged
    rows, summed, are zero (a bool scalar tensor on the device)."""
    def global_done(state: PushSumState) -> torch.Tensor:
        unconv = (~state.converged & state.alive).to(torch.int32)
        return torch.sum(unconv.view(num_shards, -1), dim=1).sum() == 0

    return global_done


def exchange_of(cfg: RunConfig) -> str:
    """The transport the config asks for: ``--exchange-overlap`` takes the
    ring schedule of the exchange kernel, ``--delivery pallas`` its
    start-all schedule, ``--delivery routed`` the one-permutation
    spelling (the JAX package's ``all_to_all``)."""
    if cfg.exchange_overlap:
        return "overlap"
    return "pallas" if cfg.delivery == "pallas" else "all_to_all"


def sharded_protocol(topo, cfg: RunConfig, mesh: List[torch.device],
                     allow_all_alive: bool = True):
    """``(initial padded state, round_core(state, plans), done_fn)`` of a
    run of ``topo`` on ``mesh``, over the placed push plans
    (``convert.shard_push_from_numpy``).

    With no birth exclusions and no padding the round drops its aliveness
    masks (``all_alive``); birth exclusions are whole components
    (``targets_alive``). ``allow_all_alive=False`` forces the live-degree
    path."""
    from gossipprotocol_tpu_torch.ops.sharddelivery import (
        pushsum_diffusion_round_routed_push,
    )

    n = topo.num_nodes
    num_shards = len(mesh)
    n_padded = padded_size(n, num_shards)
    alive0 = initial_alive(topo)
    all_alive = allow_all_alive and alive0 is None and n_padded == n
    targets_alive = allow_all_alive
    state = pushsum_init(n, value_mode=cfg.value_mode, device=mesh[0])
    if alive0 is not None:
        state = state._replace(alive=state.alive & torch.from_numpy(
            np.array(alive0)).to(mesh[0]))
    state = pad_state(state, n_padded)
    core = partial(
        pushsum_diffusion_round_routed_push, eps=cfg.eps,
        streak_target=cfg.streak_target, predicate=cfg.predicate,
        tol=cfg.tol, all_alive=all_alive, targets_alive=targets_alive,
        all_sum=shard_sum(num_shards), exchange=exchange_of(cfg),
        wire=cfg.payload_wire)
    return state, core, sharded_done(num_shards)


def make_sharded_chunk_runner(topo, cfg: RunConfig,
                              mesh: List[torch.device],
                              allow_all_alive: bool = True):
    """``(chunk, initial padded state, done_fn)``:
    ``chunk(state, plans, start_round, round_limit)`` advances the padded
    state (:func:`sharded_protocol`) until convergence or
    ``round_limit``, with the telemetry hub's counter and trace rows when
    ``cfg.telemetry`` has them on."""
    from gossipprotocol_tpu_torch.obs import as_telemetry

    tel = as_telemetry(cfg.telemetry)
    num_shards = len(mesh)
    n_padded = padded_size(topo.num_nodes, num_shards)
    all_alive = (allow_all_alive and initial_alive(topo) is None
                 and n_padded == topo.num_nodes)
    state, core, done_fn = sharded_protocol(topo, cfg, mesh,
                                            allow_all_alive)
    counter_fn = trace_fn = None
    if tel.counters_on:
        from gossipprotocol_tpu_torch.obs.counters import make_counter_fn

        shard_fn = make_counter_fn(topo, cfg, all_alive=all_alive,
                                   targets_alive=allow_all_alive,
                                   num_shards=num_shards)
        # the per-shard rows ride the stats only for the attribution
        counter_fn = shard_fn if tel.attribution_on else (
            lambda *a: torch.sum(shard_fn(*a), dim=0).to(torch.int32))
    if tel.traces_on:
        from gossipprotocol_tpu_torch.obs.trace import make_trace_fn

        trace_fn = make_trace_fn(topo, cfg, all_sum=shard_sum(num_shards))
    runner = make_chunk_runner(
        core, done_fn, counter_fn=counter_fn, trace_fn=trace_fn,
        records=tel.enabled or cfg.metrics_callback is not None,
        mass=tel.counters_on)
    return runner, state, done_fn


def run_simulation_sharded(topo, cfg: RunConfig,
                           num_devices: Optional[int] = None,
                           mesh: Optional[List[torch.device]] = None,
                           initial_state: Optional[PushSumState] = None,
                           ) -> RunResult:
    """Sharded ``run_simulation``: same semantics, the state split over
    ``num_devices`` shards (or the given ``mesh``) on ``cfg.device``.

    Under the f32 wire the trajectory is bitwise the single-card routed
    one (s, w, ratio at every S), for all three transports; under
    ``--predicate global`` the mean is summed in shard order, so a run can
    stop a round apart from the single-card run. ``initial_state``
    continues from a trimmed state; a dead set other than the birth
    exclusions takes the live-degree path."""
    from gossipprotocol_tpu_torch.convert import shard_push_from_numpy
    from gossipprotocol_tpu_torch.obs import as_telemetry
    from gossipprotocol_tpu_torch.ops import sharddelivery
    from gossipprotocol_tpu_torch.ops.plancache import (
        shard_push_deliveries_cached,
    )

    if use_megakernel(cfg):
        raise ValueError(
            "the round-loop megakernel is single-chip only (the in-kernel "
            "round has no exchange step) — drop --devices, or use "
            "--delivery pallas with rounds_per_kernel=1")
    if cfg.delivery not in ("routed", "pallas"):
        raise NotPortedError(
            f"delivery {cfg.delivery!r} is not ported to the sharded "
            "engine (only --delivery routed and pallas are)")
    unported = sharded_unported(cfg)
    if unported is not None:
        raise NotPortedError(
            f"option not yet ported with --devices: {unported} (these "
            "run on one shard: drop --devices)")
    if mesh is None:
        mesh = make_mesh(num_devices, cfg.device)
    tel = as_telemetry(cfg.telemetry)
    n = topo.num_nodes
    num_shards = len(mesh)
    n_padded = padded_size(n, num_shards)
    with tel.span("plan_compile", engine="sharded"):
        host, prov = shard_push_deliveries_cached(
            topo, n_padded, num_shards, cache_dir=cfg.plan_cache,
            build_workers=cfg.build_workers)
        plans = shard_push_from_numpy(host, device=mesh[0])
    if tel.enabled:
        exch = sharddelivery.push_exchange_wire_bytes_per_round(
            host, cfg.payload_wire)
        tel.event("plan_cache", provenance=prov, design="push",
                  num_shards=num_shards, exchange_bytes_per_round=exch)
        tel.note_resource("exchange_bytes_per_round", exch)
        tel.note_resource("routed_table_bytes",
                          sharddelivery.table_bytes(host))
        note_hub_split(tel, topo)
    with tel.span("topology_arrays", engine="sharded"):
        runner, state, _ = make_sharded_chunk_runner(
            topo, cfg, mesh,
            allow_all_alive=resume_allows_fast(topo, initial_state))
        if initial_state is not None:
            state = pad_state(PushSumState(*(t.to(mesh[0]).clone()
                                             for t in initial_state)),
                              n_padded)
    tel.record_compiled(
        "chunk", None, engine="sharded", num_shards=num_shards,
        delivery=cfg.delivery,
        payload_wire=(cfg.payload_wire if cfg.payload_wire != "f32"
                      else None),
        hub_split=(getattr(tel, "hub_split", None) or {}).get("classes"))

    def step(s, start_round, round_limit):
        return runner(s, plans, start_round, round_limit)

    prediction = compute_prediction(topo, cfg, tel)
    t0 = time.perf_counter()
    with tel.span("warm_start"):
        warm_start(step, state)
    compile_ms = (time.perf_counter() - t0) * 1e3
    return _drive(cfg, state, step, n, compile_ms,
                  trim=lambda s: trim_state(s, n), prediction=prediction,
                  num_shards=num_shards)
