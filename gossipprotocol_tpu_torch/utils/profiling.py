"""Where a round's time goes on the card, and what the chunk size and the
megakernel's K cost (the port's counterpart of
``gossipprotocol_tpu/utils/profiling.py``).

    python -m gossipprotocol_tpu_torch.utils.profiling \\
        --nodes 1000000 --topology imp3D [--predicate delta --eps 1e-7]
    python -m gossipprotocol_tpu_torch.utils.profiling \\
        --nodes 512000 --topology imp3D --delivery megakernel \\
        --rounds-per-kernel 16 [--predicate delta --eps 1e-7]
    python -m gossipprotocol_tpu_torch.utils.profiling \\
        --nodes 1000000 --topology power_law --delivery routed
    python -m gossipprotocol_tpu_torch.utils.profiling \\
        --nodes 1000000 --topology imp3D --delivery pallas --devices 4 \\
        [--exchange-overlap]
    python -m gossipprotocol_tpu_torch.utils.profiling \\
        --nodes 1000000 --topology imp3D --algorithm gossip
    python -m gossipprotocol_tpu_torch.utils.profiling \\
        --nodes 1000000 --topology imp3D --fanout one [--delivery invert]
    python -m gossipprotocol_tpu_torch.utils.profiling \\
        --nodes 1000000 --topology imp3D --delivery pallas \\
        --workload sgp --payload-dim 16 --sgp-samples 8 --tol 1e-3

Builds the graph and its delivery on ``cuda``, then:

  1. profiles ROUNDS rounds with ``torch.profiler`` (the per-round path
     over the pallas or the routed delivery, ROUNDS / K launches of the
     K-round kernel, with ``--devices S`` the sharded push round over S
     shards on the card, or the drawing rounds of gossip and fanout-one
     push-sum over the scatter or the inverted delivery — gossip on both
     of its branches, from the seed state and from a saturated one — with
     the predicate disabled, so every round runs; ``--workload sgp`` and
     ``--payload-dim D`` give the per-round path its learner and vector
     payload, and the table its matvec calls a round): device time per
     kernel name per round, and the host time
     spent enqueuing a round; times the same rounds with CUDA events, and
     reports the device's idle share of that window (1 - busy / event
     time); for the K-round kernel, also its phase split over the same
     rounds (the kernel's probe instantiation,
     ``ops/megakernel.py`` ``megakernel_phase_split``);
  2. runs the protocol to convergence once per setting, in mirrored
     order: per chunk size in CHUNKS (``--delivery pallas``), per K in KS
     against the per-round pallas path (``--delivery megakernel``),
     routed against pallas (``--delivery routed``), with ``--devices S``
     the sharded pallas, routed and ring-exchange runs against the
     single-card pallas and routed runs, or per chunk size in CHUNKS for
     the drawing rounds (for dense gossip then INVERSION_PAIRS
     alternating pairs with the inverted branch allowed and not, and
     what building the dense and the inverted tables costs), reporting
     the convergence time, the rounds, and the rounds executed.

Prints a table and one JSON line; ``--out FILE`` also writes the JSON
there. Needs a CUDA device.

:func:`maybe_trace` is the CLI's ``--profile-dir`` (the JAX package's
``utils/profiling.py`` ``maybe_trace``, with ``torch.profiler`` in place
of ``jax.profiler``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import contextlib
import os
import time

import torch

ROUNDS = 64
CHUNKS = (64, 16, 8)
KS = (1, 4, 16, 64)
INVERSION_PAIRS = 8  # gossip runs with and without the inverted branch


@contextlib.contextmanager
def maybe_trace(trace_dir):
    """``torch.profiler`` over the block when a directory is given (CPU
    activities, and CUDA ones where a card is present), written on exit
    as a Chrome trace ``trace_dir/trace_<pid>.json`` (Perfetto or
    chrome://tracing load it); a no-op otherwise. Yields the profiler, or
    None."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{os.getpid()}.json"))


def _kernel_table(prof, rounds):
    """``(name, calls/round, device ms/round)`` of every device-side
    event (kernels, copies, fills), slowest first."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.self_cpu_time_total == 0:
            rows.append((ev.key, ev.count / rounds, dev_us / 1e3 / rounds))
    rows.sort(key=lambda r: -r[2])
    return rows


def _profile_rounds(rounds, dev):
    """Profile, then time, ``rounds()`` (ROUNDS rounds): ``(kernel table,
    busy ms/round, CUDA-event ms/round, host enqueue ms/round, idle
    share)``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        rounds()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rounds()
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / ROUNDS
        torch.cuda.synchronize(dev)
    table = _kernel_table(prof, ROUNDS)
    busy_ms = sum(r[2] for r in table)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    rounds()
    stop.record()
    stop.synchronize()
    event_ms = start.elapsed_time(stop) / ROUNDS
    return table, busy_ms, event_ms, enqueue_ms, max(0.0, 1 - busy_ms
                                                     / event_ms)


def _profile_sharded(topo, cfg, shards: int, out_path) -> int:
    """``--devices S``: the sharded push round over S shards on the card,
    then convergence against the single-card paths."""
    from gossipprotocol_tpu_torch.convert import shard_push_from_numpy
    from gossipprotocol_tpu_torch.engine.driver import (
        _drive, build_protocol, device_arrays, make_chunk_runner,
        warm_start,
    )
    from gossipprotocol_tpu_torch.ops.plancache import (
        shard_push_deliveries_cached,
    )
    from gossipprotocol_tpu_torch.parallel import make_mesh, padded_size
    from gossipprotocol_tpu_torch.parallel.sharded import (
        exchange_of, make_sharded_chunk_runner, sharded_protocol,
        trim_state,
    )

    mesh = make_mesh(shards, "cuda")
    dev = mesh[0]
    n = topo.num_nodes
    t0 = time.perf_counter()
    host, _ = shard_push_deliveries_cached(
        topo, padded_size(n, shards), shards, cache_dir="none")
    build_s = time.perf_counter() - t0
    plans = shard_push_from_numpy(host, dev)
    # 1. the sharded round, no freeze and no stop
    state0, core, _ = sharded_protocol(topo, dataclasses.replace(
        cfg, streak_target=2**30), mesh)

    def rounds():
        st = state0
        for _ in range(ROUNDS):
            st = core(st, plans)

    table, busy_ms, event_ms, enqueue_ms, idle = _profile_rounds(rounds, dev)

    # 2. convergence: sharded pallas, routed, ring against one card
    single = {}

    def make_step(c, sharded):
        if sharded:
            runner, s0, _ = make_sharded_chunk_runner(topo, c, mesh)
            dlv = plans
        else:
            s0, rc, done_fn, _ = build_protocol(topo, c)
            runner = make_chunk_runner(rc, done_fn)
            if c.delivery not in single:
                single[c.delivery] = device_arrays(topo, c)
            dlv = single[c.delivery]

        def step(s, start_round, round_limit):
            return runner(s, dlv, start_round, round_limit)

        warm_start(step, s0)
        return s0, step

    settings = [("pallas", shards, False), ("routed", shards, False),
                ("pallas", shards, True), ("pallas", 1, False),
                ("routed", 1, False)]
    conv = []
    for dl, s_count, ring in settings + settings[::-1]:
        c = dataclasses.replace(cfg, delivery=dl, exchange_overlap=ring)
        s0, st = make_step(c, s_count > 1)
        res = _drive(c, s0, st, n, 0.0,
                     trim=(lambda s: trim_state(s, n)) if s_count > 1
                     else None)
        conv.append(dict(delivery=dl, shards=s_count,
                         exchange=exchange_of(c) if s_count > 1 else None,
                         chunk=c.chunk, wall_ms=res.wall_ms,
                         rounds=res.rounds, executed=res.rounds_executed,
                         converged=res.converged,
                         estimate_error=res.estimate_error))

    name = torch.cuda.get_device_name(dev)
    print(f"{topo.kind} {n} nodes on {name}, {ROUNDS} rounds, sharded "
          f"push round, {shards} shards on one card, exchange "
          f"{exchange_of(cfg)}; plans built in {build_s:.1f} s")
    print(f"device busy {busy_ms:.4f} ms/round (profiler), {event_ms:.4f} "
          f"ms/round by CUDA events, host enqueue {enqueue_ms:.4f} "
          f"ms/round, idle share {idle:.3f}"
          + ("" if matvecs is None else f", {matvecs} matvec calls a round")
          + (f", workload {cfg.workload} d={cfg.payload_dim}"
             if cfg.workload != "avg" or cfg.payload_dim > 1 else ""))
    _print_table(table)
    for r in conv:
        print(f"{r['delivery']:7s} shards {r['shards']} exchange "
              f"{r['exchange']}: {r['rounds']} rounds ({r['executed']} "
              f"executed), {r['wall_ms']:.3f} ms, converged "
              f"{r['converged']}, estimate error {r['estimate_error']:.3e}")
    out = dict(topology=topo.kind, nodes=n, device=name,
               delivery=cfg.delivery, shards=shards,
               exchange=exchange_of(cfg), build_s=build_s, rounds=ROUNDS,
               busy_ms_per_round=busy_ms, event_ms_per_round=event_ms,
               enqueue_ms_per_round=enqueue_ms, idle_share=idle,
               kernels=[dict(name=kk, calls_per_round=c, ms_per_round=m)
                        for kk, c, m in table],
               convergence=conv)
    print(json.dumps(out))
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


def _print_table(table):
    print(f"{'kernel':70s} {'calls/round':>11s} {'ms/round':>10s}")
    for key, calls, ms_r in table:
        print(f"{key[:70]:70s} {calls:11.2f} {ms_r:10.4f}")


def _matvec_calls(core, state, delivery) -> int:
    """The delivery's matvec calls in one round of ``core``."""
    inner = getattr(delivery, "nbrs", delivery)   # a learner's bundle
    cls = type(inner)
    orig = cls.matvec
    calls = [0]

    def counted(self, *a, **kw):
        calls[0] += 1
        return orig(self, *a, **kw)

    cls.matvec = counted
    try:
        core(state, delivery)
    finally:
        cls.matvec = orig
    return calls[0]


def _profile_drawing(topo, cfg, dev, out_path) -> int:
    """Gossip or fanout-one push-sum over the scatter delivery: the round
    profiled (gossip on each branch), then convergence per chunk size."""
    from gossipprotocol_tpu_torch.engine.driver import (
        GossipCore, _drive, build_protocol, chunk_stats, device_arrays,
        make_chunk_runner, warm_start,
    )
    from gossipprotocol_tpu_torch.protocols.gossip import inverted_dense
    from gossipprotocol_tpu_torch.protocols.sampling import (
        device_topology, key_data, round_keys, use_dense,
    )

    n = topo.num_nodes
    # dense gossip: the inverted branch is profiled and raced against the
    # scatter, although the card's runs take the scatter only
    # (gossip_inversion_enabled)
    invertible = (cfg.algorithm == "gossip" and not topo.asymmetric
                  and use_dense(topo))
    nbrs = (inverted_dense(topo, device=dev) if invertible
            else device_arrays(topo, cfg))
    base_key = key_data(cfg.seed, dev)
    keys = round_keys(base_key, torch.zeros((), dtype=torch.int32,
                                            device=dev), ROUNDS)
    state0, core, done_fn, _ = build_protocol(topo, dataclasses.replace(
        cfg, streak_target=2**30))
    gossip = isinstance(core, GossipCore)
    starts = [("scatter", state0, False)]
    if invertible:
        core.invertible = True
        saturated = state0._replace(counts=torch.ones_like(state0.counts))
        starts.append(("inverted", saturated, True))
    profiles = []
    for branch, st0, inverted in starts:
        if gossip:
            core.inverted = inverted

        def rounds(st0=st0):
            st = st0
            for i in range(ROUNDS):
                st = core(st, nbrs, keys[i])

        table, busy_ms, event_ms, enqueue_ms, idle = _profile_rounds(
            rounds, dev)
        profiles.append(dict(branch=branch, busy_ms_per_round=busy_ms,
                             event_ms_per_round=event_ms,
                             enqueue_ms_per_round=enqueue_ms,
                             idle_share=idle,
                             kernels=[dict(name=k, calls_per_round=c,
                                           ms_per_round=m)
                                      for k, c, m in table]))
    # convergence per chunk size (mirrored); for gossip with the
    # inversion table, then INVERSION_PAIRS alternating pairs at the
    # default chunk with the inverted branch allowed and not (the
    # scatter every round), same tables, same draws, same rounds
    settings = [(chunk, None) for chunk in CHUNKS + CHUNKS[::-1]]
    if invertible:
        settings += [(None, inv) for _ in range(INVERSION_PAIRS // 2)
                     for inv in (True, False, False, True)]
    conv = []
    for chunk, invertible in settings:
        c = dataclasses.replace(cfg, chunk_rounds=chunk)
        s0, rc, done_fn, _ = build_protocol(topo, c)
        if invertible is not None:
            rc.invertible = invertible
        extra = rc.extra_stats if gossip else None
        runner = make_chunk_runner(rc, done_fn, extra, base_key=base_key)
        inverted_rounds = [0]

        def step(s, start_round, round_limit, rc=rc, runner=runner,
                 inverted_rounds=inverted_rounds):
            if gossip and rc.inverted:
                inverted_rounds[0] += round_limit - start_round
            return runner(s, nbrs, start_round, round_limit)

        warm_start(step, s0)
        inverted_rounds[0] = 0
        observe = None
        if gossip:
            observe = rc.observe
            observe(chunk_stats(s0, done_fn, extra, nbrs).tolist()[2:])
        res = _drive(c, s0, step, n, 0.0, observe=observe)
        conv.append(dict(chunk=c.chunk, invertible=invertible,
                         wall_ms=res.wall_ms, rounds=res.rounds,
                         executed=res.rounds_executed,
                         inverted_rounds=inverted_rounds[0],
                         converged=res.converged,
                         estimate_error=res.estimate_error))
    # what the inversion table costs to build and place, beside the
    # plain dense table (host lexsort + copy)
    builds = {}
    if invertible:
        for name, fn in (("dense", lambda: device_topology(topo,
                                                           device=dev)),
                         ("inverted", lambda: inverted_dense(topo,
                                                             device=dev))):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            builds[name] = (time.perf_counter() - t0) * 1e3

    name = torch.cuda.get_device_name(dev)
    what = ("gossip" if gossip else
            f"push-sum --fanout one --delivery {cfg.delivery}") + \
        f", {type(nbrs).__name__ if nbrs is not None else 'implicit full'}"
    print(f"{topo.kind} {n} nodes on {name}, {ROUNDS} rounds, {what}")
    for p in profiles:
        print(f"[{p['branch']}] device busy {p['busy_ms_per_round']:.4f} "
              f"ms/round (profiler), {p['event_ms_per_round']:.4f} ms/round "
              f"by CUDA events, host enqueue {p['enqueue_ms_per_round']:.4f}"
              f" ms/round, idle share {p['idle_share']:.3f}")
        _print_table([(k["name"], k["calls_per_round"], k["ms_per_round"])
                      for k in p["kernels"]])
    for r in conv:
        inv = ("" if r["invertible"] is None else
               f" inversion {'on' if r['invertible'] else 'off'}"
               f" ({r['inverted_rounds']} rounds inverted)")
        print(f"chunk {r['chunk']:4d}{inv}: {r['rounds']} rounds "
              f"({r['executed']} executed), {r['wall_ms']:.3f} ms, "
              f"converged {r['converged']}, estimate error "
              f"{r['estimate_error']}")
    for k, ms in builds.items():
        print(f"{k} table build and placement: {ms:.1f} ms")
    out = dict(topology=topo.kind, nodes=n, device=name,
               algorithm=cfg.algorithm, fanout=cfg.fanout,
               delivery=cfg.delivery, rounds=ROUNDS, profiles=profiles,
               convergence=conv, table_build_ms=builds)
    print(json.dumps(out))
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--topology", default="imp3D")
    ap.add_argument("--predicate", default="global")
    ap.add_argument("--eps", type=float, default=1e-10)
    ap.add_argument("--algorithm", choices=["gossip", "push-sum"],
                    default="push-sum")
    ap.add_argument("--fanout", choices=["one", "all"], default="all",
                    help="push-sum sender (gossip draws one)")
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--delivery", choices=["pallas", "megakernel", "routed",
                                           "invert"],
                    default="pallas",
                    help="fanout-all delivery; with --fanout one, 'invert' "
                         "(else the drawing rounds run the scatter)")
    ap.add_argument("--workload", choices=["avg", "sgp"], default="avg")
    ap.add_argument("--payload-dim", type=int, default=1)
    ap.add_argument("--sgp-samples", type=int, default=8)
    ap.add_argument("--rounds-per-kernel", type=int, default=1)
    ap.add_argument("--devices", type=int, default=1,
                    help="shards of the push design (pallas or routed)")
    ap.add_argument("--exchange-overlap", action="store_true",
                    help="with --devices S: profile the round on the ring "
                         "schedule of the exchange kernel")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.exchange_overlap and args.devices < 2:
        ap.error("--exchange-overlap takes --devices S > 1")

    from gossipprotocol_tpu_torch.engine.driver import (
        RunConfig, _drive, build_protocol, device_arrays, draws,
        make_chunk_runner, make_megakernel_chunk_runner, resolve_device,
        use_megakernel, warm_start,
    )
    from gossipprotocol_tpu_torch.ops.megakernel import (
        format_phase_split, megakernel_phase_split, pad_state,
    )
    from gossipprotocol_tpu_torch.topology import build_topology

    dev = resolve_device("cuda")
    topo = build_topology(args.topology, args.nodes)
    fanout = "one" if args.algorithm == "gossip" else args.fanout
    if fanout == "one":
        delivery = "invert" if args.delivery == "invert" else "scatter"
    elif args.delivery == "invert":
        ap.error("--delivery invert takes --fanout one")
    else:
        delivery = args.delivery
    cfg = RunConfig(device="cuda", algorithm=args.algorithm,
                    fanout=fanout, predicate=args.predicate,
                    eps=args.eps, tol=args.tol, max_rounds=20_000,
                    delivery=delivery,
                    rounds_per_kernel=args.rounds_per_kernel,
                    exchange_overlap=args.exchange_overlap,
                    workload=args.workload, payload_dim=args.payload_dim,
                    sgp_samples=args.sgp_samples, plan_cache="none")
    if draws(cfg):
        return _profile_drawing(topo, cfg, dev, args.out)
    fused = use_megakernel(cfg)
    k = cfg.rounds_per_kernel
    if ROUNDS % k:
        ap.error(f"--rounds-per-kernel must divide {ROUNDS}")
    shards = args.devices
    if shards > 1 and fused:
        ap.error("--devices takes --delivery pallas or routed")
    if shards > 1:
        return _profile_sharded(topo, cfg, shards, args.out)
    delivery = device_arrays(topo, cfg)
    # the per-round path's deliveries by name (pallas reads the plain
    # delivery the megakernel wraps); built once each
    per_round = {"pallas": delivery.pd} if fused else {cfg.delivery: delivery}

    def per_round_delivery(c):
        if c.delivery not in per_round:
            per_round[c.delivery] = device_arrays(topo, c)
        return per_round[c.delivery]

    def make_step(c):
        state0, core, done_fn, _ = build_protocol(topo, c)
        if use_megakernel(c):
            runner = make_megakernel_chunk_runner(core, done_fn,
                                                  c.rounds_per_kernel)
            dlv = delivery
        else:
            runner = make_chunk_runner(core, done_fn)
            dlv = per_round_delivery(c)

        def step(s, start_round, round_limit):
            return runner(s, dlv, start_round, round_limit)

        warm_start(step, state0)
        return state0, step

    state0, step = make_step(cfg)
    # 1. rounds with no freeze and no stop: profiled, then timed
    _, core, _, _ = build_protocol(topo, dataclasses.replace(
        cfg, streak_target=2**30))
    if fused:
        ms = pad_state(state0)

        def rounds():
            for _ in range(ROUNDS // k):
                core(ms, delivery)
    else:
        def rounds():
            st = state0
            for _ in range(ROUNDS):
                st = core(st, delivery)

    table, busy_ms, event_ms, enqueue_ms, idle = _profile_rounds(rounds, dev)
    matvecs = None if fused else _matvec_calls(core, state0, delivery)
    split = None
    if fused:
        # where a launch's time goes: the kernel's probe instantiation
        # over the same rounds (clock64 per block at each phase boundary)
        split = megakernel_phase_split(
            pad_state(state0), delivery, n=topo.num_nodes,
            rounds_per_kernel=k, eps=cfg.eps, streak_target=2**30,
            predicate=cfg.predicate, tol=cfg.tol)

    # 2. convergence time against the chunk size, K, or the delivery
    if fused:
        settings = [("pallas", 1)] + [("megakernel", kk) for kk in KS]
    elif cfg.delivery == "routed":
        settings = [("routed", None), ("pallas", None)]
    else:
        settings = [("pallas", c) for c in CHUNKS]
    conv = []
    for dl, v in settings + settings[::-1]:
        if fused:
            c = dataclasses.replace(cfg, delivery=dl, rounds_per_kernel=v)
        elif cfg.delivery == "routed":
            c = dataclasses.replace(cfg, delivery=dl)
        else:
            c = dataclasses.replace(cfg, chunk_rounds=v)
        s0, st = (state0, step) if c == cfg else make_step(c)
        res = _drive(c, s0, st, topo.num_nodes, 0.0)
        conv.append(dict(delivery=dl, k=c.rounds_per_kernel, chunk=c.chunk,
                         wall_ms=res.wall_ms, rounds=res.rounds,
                         executed=res.rounds_executed,
                         converged=res.converged))

    name = torch.cuda.get_device_name(dev)
    what = (f"megakernel K={k}, {ROUNDS // k} launches" if fused
            else f"per-round {cfg.delivery} path")
    print(f"{args.topology} {topo.num_nodes} nodes on {name}, {ROUNDS} "
          f"rounds, {what}")
    print(f"device busy {busy_ms:.4f} ms/round (profiler), {event_ms:.4f} "
          f"ms/round by CUDA events, host enqueue {enqueue_ms:.4f} "
          f"ms/round, idle share {idle:.3f}"
          + ("" if matvecs is None else f", {matvecs} matvec calls a round")
          + (f", workload {cfg.workload} d={cfg.payload_dim}"
             if cfg.workload != "avg" or cfg.payload_dim > 1 else ""))
    _print_table(table)
    if split is not None:
        print(f"megakernel phase split, us per round, mean over "
              f"{split['grid']} blocks [least; largest]: "
              f"{format_phase_split(split)}")
    for r in conv:
        print(f"{r['delivery']:10s} K {r['k']:3d} chunk {r['chunk']:4d}: "
              f"{r['rounds']} rounds ({r['executed']} executed), "
              f"{r['wall_ms']:.3f} ms, converged {r['converged']}")
    out = dict(topology=args.topology, nodes=topo.num_nodes, device=name,
               delivery=cfg.delivery, rounds_per_kernel=k, rounds=ROUNDS,
               busy_ms_per_round=busy_ms, event_ms_per_round=event_ms,
               enqueue_ms_per_round=enqueue_ms, idle_share=idle,
               matvec_calls_per_round=matvecs, workload=cfg.workload,
               payload_dim=cfg.payload_dim,
               kernels=[dict(name=kk, calls_per_round=c, ms_per_round=m)
                        for kk, c, m in table],
               convergence=conv, phase_split=split)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
