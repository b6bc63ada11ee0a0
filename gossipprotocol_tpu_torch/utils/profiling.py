"""Where a round's time goes on the card, and what the chunk size costs
(the port's counterpart of ``gossipprotocol_tpu/utils/profiling.py``).

    python -m gossipprotocol_tpu_torch.utils.profiling \\
        --nodes 1000000 --topology imp3D [--predicate delta --eps 1e-7]

Builds the graph and its fused gather delivery on ``cuda``, then:

  1. profiles ROUNDS rounds with ``torch.profiler``: device time per
     kernel name per round, and the host time spent enqueuing a round;
     times the same rounds with CUDA events, and reports the device's
     idle share of that window (1 - busy / event time);
  2. runs the protocol to convergence once per chunk size in CHUNKS, in
     mirrored order, reporting the convergence time, the rounds, and the
     rounds executed (frozen rounds past convergence included).

Prints a table and one JSON line; ``--out FILE`` also writes the JSON
there. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

ROUNDS = 20
CHUNKS = (64, 16, 8)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--topology", default="imp3D")
    ap.add_argument("--predicate", default="global")
    ap.add_argument("--eps", type=float, default=1e-10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from torch.profiler import ProfilerActivity, profile

    from gossipprotocol_tpu_torch.engine.driver import (
        RunConfig, _drive, build_protocol, device_arrays, make_chunk_runner,
        resolve_device, warm_start,
    )
    from gossipprotocol_tpu_torch.topology import build_topology

    dev = resolve_device("cuda")
    topo = build_topology(args.topology, args.nodes)
    cfg = RunConfig(device="cuda", predicate=args.predicate, eps=args.eps,
                    max_rounds=20_000)
    state0, core, done_fn, _ = build_protocol(topo, cfg)
    delivery = device_arrays(topo, cfg)
    runner = make_chunk_runner(core, done_fn)

    def step(s, start_round, round_limit):
        return runner(s, delivery, start_round, round_limit)

    warm_start(step, state0)
    for _ in range(3):
        core(state0, delivery)
    torch.cuda.synchronize(dev)

    # 1. plain rounds (no freeze, no predicate): profiled, then timed
    st = state0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ROUNDS):
            st = core(st, delivery)
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / ROUNDS
        torch.cuda.synchronize(dev)
    table = _kernel_table(prof, ROUNDS)
    busy_ms = sum(r[2] for r in table)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    st = state0
    start.record()
    for _ in range(ROUNDS):
        st = core(st, delivery)
    stop.record()
    stop.synchronize()
    event_ms = start.elapsed_time(stop) / ROUNDS
    idle = max(0.0, 1 - busy_ms / event_ms)

    # 2. convergence time against the chunk size
    conv = []
    for c in CHUNKS + CHUNKS[::-1]:
        res = _drive(dataclasses.replace(cfg, chunk_rounds=c), state0, step,
                     topo.num_nodes, 0.0)
        conv.append(dict(chunk=c, wall_ms=res.wall_ms, rounds=res.rounds,
                         executed=res.rounds_executed,
                         converged=res.converged))

    name = torch.cuda.get_device_name(dev)
    print(f"{args.topology} {topo.num_nodes} nodes on {name}, "
          f"{ROUNDS} rounds")
    print(f"device busy {busy_ms:.4f} ms/round (profiler), {event_ms:.4f} "
          f"ms/round by CUDA events, host enqueue {enqueue_ms:.4f} "
          f"ms/round, idle share {idle:.3f}")
    print(f"{'kernel':70s} {'calls/round':>11s} {'ms/round':>10s}")
    for key, calls, ms in table:
        print(f"{key[:70]:70s} {calls:11.2f} {ms:10.4f}")
    for r in conv:
        print(f"chunk {r['chunk']:4d}: {r['rounds']} rounds "
              f"({r['executed']} executed), {r['wall_ms']:.3f} ms, "
              f"converged {r['converged']}")
    out = dict(topology=args.topology, nodes=topo.num_nodes, device=name,
               rounds=ROUNDS, busy_ms_per_round=busy_ms,
               event_ms_per_round=event_ms,
               enqueue_ms_per_round=enqueue_ms, idle_share=idle,
               kernels=[dict(name=k, calls_per_round=c, ms_per_round=m)
                        for k, c, m in table],
               convergence=conv)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
