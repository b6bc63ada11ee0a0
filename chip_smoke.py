#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # all phases, one card

Phases (each prints its lines; any failure exits non-zero):

  (a) the card (``nvidia-smi`` name and power limit) and the kernel build
      from ``gossipprotocol_tpu_torch/csrc`` (ptxas report per kernel);
  (b) each CUDA kernel against its plain PyTorch version on the card, at
      the shapes the main path gives it on the three smoke graphs —
      bitwise equal, ``class_reduce_split`` on a second call too (its
      arrival counters reset) — with its time back to back (CUDA
      events) and as CUDA-graph replays (``graph_ms``: device time
      without the host's enqueue), the bytes/operations bound, the plain
      version's time and one PyTorch library call's, back to back and by
      graph; every bucket gather also with the other evict-first hint
      choice and as the one-level resident gather over the same source
      (each bitwise equal, each timed); at imp3D 262,144's gather_pre the
      L2 random-read ceiling (``bound_l2``: uniformly random reads of a
      2 MB source at that output count, by ``x[idx]`` and the kernel, by
      graph);
  (c) the main path end to end through the CLI entry point, in process:
      1M-node imp3D and power_law (bucket gathers, both folds) and a
      262,144-node imp3D (resident gathers), each to convergence, with
      every kernel's launch count read around the run;
  (d) card against CPU: 16 rounds on ``cuda`` and the same 16 on ``cpu``
      (the plain versions), bitwise equal state and round counts, on
      imp3D, power_law and an Erdős–Rényi graph with birth exclusions
      (the masked round);
  (e) the K-round megakernel against its plain version on the card at
      imp3D 512,000 and power_law 500,000 (full-width resident-mode
      graphs: imp3D's largest cube, and power_law with hub classes),
      K = 1 and 16, 48 rounds: bitwise under the delta
      predicate; under the global one s, w, ratio bitwise and streak,
      converged and round equal (the plain version summing the mean in
      the kernel's order; the largest gap to torch.sum's mean printed).
      K = 16 against the per-round ``--delivery pallas`` path on the
      card, bitwise; the kernel's time per launch (back to back and by
      CUDA graph) and per round beside its bytes bound, the plain
      version's time and the per-round path's; the phase split of a
      K = 16 launch under both predicates (the kernel's probe
      instantiation: microseconds per round in the fold, the update and
      each barrier); the working set against the 50 MB L2;
  (f) the megakernel path end to end through the CLI (``--delivery
      megakernel --rounds-per-kernel 16``) on both graphs, to convergence:
      the megakernel launched, the per-round gather and fold kernels not;
  (g) the Clos-routed delivery (``--delivery routed``) at imp3D 1M and
      power_law 1M: the plans built once per graph through the plan cache
      (build seconds, coloring backend: the native library must run);
      the two expand kernels on every class, the stage kernel on both
      radix stages of the edge plan and the final kernel on its final
      pass, each bitwise against its plain version with its time (back
      to back and by graph), bound, plain time and one PyTorch call's time
      (both ways: a single ``x[idx]`` with the composed route index;
      ``repeat_interleave``/``repeat`` for the expands); the routed
      matvec bitwise against the pallas matvec; and
      two routed CLI runs with phase (c)'s argv, each converging in the
      pallas run's round count with the same printed estimate error and
      every routed kernel launched;
  (h) the sharded push design (``--devices 4``, every shard on the one
      card) at imp3D 1M and power_law 400,000 (the push compiler rejects
      power_law 1M and 500,000 on 4 shards, as the JAX package's does):
      the 4-shard plans built once per graph through the plan cache (build seconds, exchange bytes per
      round, table bytes, peak device memory after placement); the
      exchange kernel at the real slab shapes — f32, bf16, int8 and the
      int8 wire's [S, 1] scales, both schedules, each one launch —
      bitwise against its plain version and ``exchange_plain``, with its
      time (back to back and by graph), bytes bound, plain time and one
      PyTorch call's
      (``transpose(0, 1).contiguous()`` of the stacked slabs, both ways);
      the 4-shard matvec on every transport
      bitwise against the single-card routed matvec (phase (g)'s outputs
      kept for imp3D 1M, not rebuilt); and three CLI runs per graph with
      phase (c)'s argv plus ``--devices 4`` (``--delivery pallas``,
      ``routed``, and ``pallas --exchange-overlap``), each converging in
      the single-card pallas run's round count with its printed estimate
      error (a stop one round apart prints the gap of the global mean,
      summed in shard order), exchange launches counted (the ring run
      launching the kernel as often as the one-launch run);
  (i) the node-major hub kernels (``class_reduce_big``,
      ``class_expand_big``), which no CLI path of either package runs:
      at every hub class of power_law 1M (the first round's fold input of
      phase (b), laid out node-major from its split layout), each bitwise
      against its plain version (the reduce on a second call too: its
      arrival counters reset), with its time (back to back and by graph),
      bytes bound, plain time and one PyTorch call's, both ways
      (``view(n_c, q*64, 2).sum(1)``,
      ``view(n_c, 1, 2).expand(n_c, q*64, 2).contiguous()``), and the
      expand's launch geometry (``expand_big_geometry``); launches are
      the phase's own calls;
  (j) the reference surface (gossip and fanout-one push-sum over the
      scatter delivery, the CLI's defaults) through the CLI entry point
      at 1M nodes: gossip at imp3D 1M (dense table; the card runs the
      scatter branch only) and full 1M (implicit complete graph),
      push-sum with ``--predicate global --tol 1e-4`` at both, each
      converging; the golden gossip round counts of
      ``tests/test_golden.py`` exact on the card; card against CPU over 32
      rounds: gossip bitwise at power_law 1M (CSR) and at imp3D 1M from a
      saturated state (the CPU run on the gather-inverted branch, the
      card's on the scatter), the inverted histogram on the card equal to
      the scatter's there, push-sum at Erdős–Rényi 1M with birth
      exclusions within ``SCATTER_TOL`` (atomic float adds);
  (k) the measurement probes' five kernels (``csrc/probes.cu``), which no
      CLI path of either package runs: each at every default shape of the
      JAX probes (PERF.md §6 rows 13-20), bitwise against its plain
      version (the tile permutation also exactly against
      ``x.view(T, -1)[:, perm]``), with its time (back to back, and as
      replays of a CUDA graph of the calls: device time without host
      enqueue), bytes bound, plain time and one PyTorch call's (also
      both ways); the measured stream ceiling is the best graph-replay
      rate over 64 MiB of the streamed copy, ``torch.mul`` and ``copy_``,
      and every kernel record gets ``bound_stream_ms`` (its bytes over
      that rate) beside the nominal ``bound_ms``; for rows 15-19 the
      launch geometry the wrapper picked by size (rows 17 and 18: rows a
      block, threads, staged or read in place), and at row 16's 4,096
      rows the L2 random-read ceiling (``bound_l2``, as in (b)); the
      shared-memory wavefronts of row 17's staged gathers and of the tile
      permutation's pick (host replays); rows 15, 16, 17, 19 and
      row 6 at power_law 1M's two hub classes (seeded random pairs)
      re-timed against their library calls in alternating rounds of
      graph replays, beside an empty kernel's (the launch floor); then
      the three probe entry points in process at their default argv,
      each exiting 0;
  (l) the reference semantics (``--semantics reference``) through the
      CLI, and the walk kernel (``csrc/walk.cu``): the latency of a
      dependent load (a pointer chase through 4 and 32 MB, L2-resident),
      the walk's floor; the kernel against its plain chunk at imp3D,
      power_law and full 1M (dense, CSR and implicit layouts), one chunk
      of 4,096 hops from the initial state, bitwise in every field, with
      both times; gossip and the push-sum walk at line, full, 3D and imp3D
      of 100, 500 and 1,000 nodes (line push-sum not at 1,000:
      ``REF_SEM_SKIP``), each converging with exit 0, card against CPU
      (the same argv on ``--device cpu``) with equal round or hop counts
      and bitwise final states, the walk kernel launched on every card
      walk and no other kernel; the walk at imp3D 262,144 to convergence
      over the chunk sweep (``--chunk-rounds`` 256-65,536, the same hops
      and state at each), microseconds per hop; the walk at imp3D 1M, to
      convergence when the measured rate puts it within a minute, else
      capped (exit 1); reference gossip at imp3D 1M to convergence;
  (m) the native remainder and the curve tools: ``--check`` of the seven
      families at 1M nodes, ``--backend tpu`` (exit 2), ``experiments.
      curves`` over the Report grid (--repeats 1) with intended and with
      reference semantics (reference gossip on the full graph left out:
      it livelocks to the tool's round cap in both packages), ``experiments.
      oracle_curves`` in process, and power_law and imp3D at 10M built by
      the native path, each byte-equal to the numpy path's build (imp3D at
      10M, power_law at 2M), with each one's seconds;
  (n) faults, loss windows, repair, checkpoints, the sentinel and churn
      through the CLI on the card: (n1) imp3D 1M fanout-all push-sum with a
      10 % kill strike at round 5 and ``--repair rewire`` on ``--delivery
      pallas`` and ``routed`` (the kernels under a dead set, across a
      mid-run plan rebuild; both converging, in the same round with the
      same printed estimate error and bitwise final states; rebuild
      seconds); (n2) imp3D 1M gossip and fanout-one push-sum with
      ``--drop-prob 0.2 --drop-window 0 24`` and a kill strike at round 8,
      32 rounds on the card against 32 on the CPU (gossip bitwise,
      push-sum within ``SCATTER_TOL``); (n3) the (n1) run checkpointed
      every 2 chunks, resumed from a checkpoint in the middle: the same
      rounds and final state bitwise, and the seconds to save and load a
      1M-node state; (n4) the sentinel on 0.1 % of the nodes poisoned
      with NaN at round 6, ``quarantine`` and ``rollback``: the trip at
      the injection round, the quarantined ids ``value_fault_ids``, the
      run converging; (n5) imp3D 262,144 with ``--churn 0.001,swap,10``:
      a plan rebuild every 10 rounds, rebuild seconds, ms per round
      between rebuilds. Each run's launch counts are read around it;
  (o) the workloads through the CLI on the card: (o1) the slice's main
      path, Stochastic Gradient Push at imp3D 1M (``--workload sgp
      --payload-dim 16 --sgp-samples 8 --predicate global --tol 1e-3``)
      on ``--delivery pallas`` and ``routed``: rounds and executed rounds,
      the last chunk's train loss, estimate error, ms per executed round,
      matvec calls a round (9), the launches of rows 1, 11 (pallas) and
      1, 2, 7, 8 (routed), the two final states bitwise equal; the same on
      pallas at imp3D 262,144 (resident gathers: row 10); (o2) ``--clock
      poisson --activation-rate 1.0`` on imp3D 1M pallas push-sum and
      gossip, and gossip at 262,144 card against CPU bitwise; (o3) card
      against CPU at imp3D 32,768, 32 rounds, for every new path (the
      fanout-all scatter, GALA with ``--groups 4``, Chebyshev with
      ``--accel-lambda`` and EPD, ``--x64``, fanout-one ``--delivery
      invert`` and Poisson push-sum, SGP on pallas), each within its
      stated tolerance; (o4) ``--delivery invert`` against ``scatter`` on
      imp3D 1M fanout-one push-sum, 64 rounds each, ms per executed
      round. The phase's seconds are printed;
  (p) run telemetry through the CLI on the card, each run with
      ``--telemetry-dir`` and without it: (p1) pallas push-sum at imp3D
      1M — the same rounds and a bitwise final state, ``sent ==
      delivered == rounds × directed edges``, ``report`` exit 0 with
      ``anomalies: none``, and under ``torch.profiler`` one
      device-to-host copy a chunk with telemetry on, off and in the
      chunk as it ran before telemetry (whose kernels the chunk without
      telemetry launches, by name); routed the same, bitwise the pallas
      run; (p2) the same graph with a 10 % kill
      strike at round 0 on pallas and routed — ``delivered == rounds ×
      live-to-live directed edges`` (numpy), pallas == routed bitwise,
      the recount's extra launches of rows 1, 11 and 1, 2, 7, 8;
      (p3) gossip at imp3D 1M with trace rows and the megakernel at K =
      16 (imp3D 512,000) with counters; (p4) ``--profile-dir``: the
      trace file names the hand-written kernels. ms per executed round
      with telemetry off and on, and the phase's seconds;
  (q) batched sweeps and the capacity model, at full width: (q1) an
      imp3D 1M gossip seed sweep of 8 lanes in process (one topology
      build), each lane's rounds and state bitwise its standalone card
      run, the sweep's wall time against the 8 serial runs', ms per
      executed round of one lane alone and of the 8, and the lane round
      profiled at 1 and 8 lanes (device busy, enqueue, idle share);
      (q2) fanout-one push-sum, 8 lanes: 32 rounds with the predicate
      off within ``SCATTER_TOL`` of the standalone runs with equal alive
      sets, then to convergence beside the standalone runs' rounds;
      (q3) the README's sweeps through the CLI (4096 imp3D push-sum
      ``--sweep-seeds 64``, an eps x tol plan, a gossip threshold axis)
      with ``report``, ``watch --max-frames 1`` and ``history`` exit 0;
      (q4) the capacity model's predicted total against the card's
      measured peak (``max_memory_allocated`` over the build and 32
      rounds, less what was held before) on every path — gossip,
      fanout-one push-sum, pallas, routed (imp3D and power_law 1M),
      the megakernel (imp3D 512,000, power_law 500,000), ``--devices
      4`` (imp3D 1M, power_law 400,000) and (q1)'s sweep — never below
      it, and the CLI: ``plan 2000000000 imp3D`` exit 1 on the card's
      capacity, a 1M run under a 64 MB budget exit 2 before any plan
      build. Each sub-phase's seconds.

``slice_times`` (not a phase) times rows 12, 15-20 and 6 through
their wrappers by graph replay for whichever tree's package is first on
``sys.path``, to hold a parent tree against this one in one call.

Each end-to-end run reads the launch counts it caused (reset just before,
read just after). The plan cache lives in a temporary directory for the
run. Then one JSON line of kernel records, the card line, and last
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package next to this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
L2_BYTES = 50e6               # H100 L2

# fanout-all push-sum over the fused gather delivery (phases (a)-(h))
DIFFUSION = dict(algorithm="push-sum", fanout="all", delivery="pallas")

# (name, argv of the graph: nodes, topology, seed, builder kwargs)
GRAPHS = {
    "imp3D_1M": (1_000_000, "imp3D", {"seed": 0}),
    "power_law_1M": (1_000_000, "power_law", {"seed": 0, "m": 4}),
    "imp3D_262144": (262_144, "imp3D", {"seed": 0}),
}

# the three end-to-end runs of phase (c). The delta predicate at its
# default eps (1e-10) does not converge in float32 (the ratio keeps moving
# in its last bits), so the 1M runs take the global predicate and the
# resident-mode run the delta predicate at eps 1e-7.
CLI_RUNS = {
    "imp3D_1M": ["1000000", "imp3D", "push-sum", "--fanout", "all",
                 "--delivery", "pallas", "--seed", "0",
                 "--predicate", "global", "--tol", "1e-4"],
    "power_law_1M": ["1000000", "power_law", "push-sum", "--fanout", "all",
                     "--delivery", "pallas", "--predicate", "global",
                     "--tol", "1e-4"],
    "imp3D_262144": ["262144", "imp3D", "push-sum", "--fanout", "all",
                     "--delivery", "pallas", "--eps", "1e-7"],
}
MAX_ROUNDS = "4000"

# phase (e): full-width resident-mode graphs (both gather sources under
# the 8,192-row resident bound: 8,008 and 7,816 rows)
MK_GRAPHS = {
    "imp3D_512000": (512_000, "imp3D", {"seed": 0}),
    "power_law_500000": (500_000, "power_law", {"seed": 0, "m": 4}),
}
MK_ROUNDS = 48
MK_KS = (1, 16)
# phase (f): the megakernel path through the CLI, K = 16
MK_CLI_RUNS = {
    "imp3D_512000": ["512000", "imp3D", "push-sum", "--fanout", "all",
                     "--delivery", "megakernel", "--rounds-per-kernel", "16",
                     "--eps", "1e-7"],
    "power_law_500000": ["500000", "power_law", "push-sum", "--fanout",
                         "all", "--delivery", "megakernel",
                         "--rounds-per-kernel", "16", "--predicate",
                         "global", "--tol", "1e-4"],
}

KERNELS = {
    "class_reduce_small": ("gossipprotocol_tpu_torch/csrc/classops.cu",
                           "gossipprotocol_tpu/ops/classops.py:96"),
    "class_reduce_split": ("gossipprotocol_tpu_torch/csrc/classops.cu",
                           "gossipprotocol_tpu/ops/classops.py:183"),
    "gather_resident": ("gossipprotocol_tpu_torch/csrc/gather.cu",
                        "gossipprotocol_tpu/ops/pallasdelivery.py:115"),
    "gather_bucket": ("gossipprotocol_tpu_torch/csrc/gather.cu",
                      "gossipprotocol_tpu/ops/pallasdelivery.py:153"),
    "megakernel": ("gossipprotocol_tpu_torch/csrc/megakernel.cu",
                   "gossipprotocol_tpu/ops/megakernel.py:279"),
    "class_expand_small": ("gossipprotocol_tpu_torch/csrc/classops.cu",
                           "gossipprotocol_tpu/ops/classops.py:129"),
    "class_expand_split": ("gossipprotocol_tpu_torch/csrc/classops.cu",
                           "gossipprotocol_tpu/ops/classops.py:216"),
    "stage_call": ("gossipprotocol_tpu_torch/csrc/route.cu",
                   "gossipprotocol_tpu/ops/exec.py:154"),
    "final_call": ("gossipprotocol_tpu_torch/csrc/route.cu",
                   "gossipprotocol_tpu/ops/exec.py:193"),
    "pallas_exchange": ("gossipprotocol_tpu_torch/csrc/exchange.cu",
                        "gossipprotocol_tpu/ops/pallasdelivery.py:491"),
    "class_reduce_big": ("gossipprotocol_tpu_torch/csrc/classops.cu",
                         "gossipprotocol_tpu/ops/classops.py:228"),
    "class_expand_big": ("gossipprotocol_tpu_torch/csrc/classops.cu",
                         "gossipprotocol_tpu/ops/classops.py:280"),
    "probe_slab": ("gossipprotocol_tpu_torch/csrc/probes.cu",
                   "experiments/slab_probe.py:73, experiments/slab_probe.py:94"),
    "probe_scale2": ("gossipprotocol_tpu_torch/csrc/probes.cu",
                     "experiments/route_probe.py:158, "
                     "experiments/route_probe.py:240"),
    "probe_gather_rows": ("gossipprotocol_tpu_torch/csrc/probes.cu",
                          "experiments/route_probe.py:180"),
    "probe_gather_lanes": ("gossipprotocol_tpu_torch/csrc/probes.cu",
                           "experiments/route_probe.py:202, "
                           "experiments/route_probe.py:216"),
    "probe_tile_perm": ("gossipprotocol_tpu_torch/csrc/probes.cu",
                        "experiments/tile_perm_probe.py:141"),
    "walk_chunk": ("gossipprotocol_tpu_torch/csrc/walk.cu",
                   "gossipprotocol_tpu/protocols/walk.py:122-177 (no "
                   "pallas_call: the on-device while_loop over "
                   "pushsum_walk_round)"),
}
# phase (i): the node-major hub kernels have no CLI path in either
# package; they run at the hub classes of this graph, and their launch
# count is the phase's own
HUB_GRAPH = "power_law_1M"
# phase (b): the L2 random-read ceiling is measured at this call's output
# count (PERF.md row 10), over a 2 MB source
L2_CEILING_AT = ("imp3D_262144", "gather_pre")
L2_CEILING_ROWS = 4096
HUB_KERNELS = ("class_reduce_big", "class_expand_big")
NO_CLI_PATH = "phase (i) calls: no CLI path in either package"
# phase (k): the probes' kernels, likewise without a CLI path
PROBE_KERNELS = ("probe_slab", "probe_scale2", "probe_gather_rows",
                 "probe_gather_lanes", "probe_tile_perm")
NO_CLI_PATH_PROBES = "phase (k) calls: no CLI path in either package"
PER_ROUND_KERNELS = ("class_reduce_small", "class_reduce_split",
                     "gather_resident", "gather_bucket")
# phase (g): the routed delivery on phase (c)'s two 1M graphs, and its
# CLI runs with phase (c)'s argv
ROUTED_KERNELS = ("class_expand_small", "class_expand_split", "stage_call",
                  "final_call")
ROUTED_CLI_RUNS = {
    g: [("routed" if a == "pallas" else a) for a in CLI_RUNS[g]]
    for g in ("imp3D_1M", "power_law_1M")}


# phase (h): the sharded push design, 4 shards on the card, on imp3D 1M
# and power_law 400,000: the push compiler (the JAX package's, copied)
# rejects power_law at 1M and 500,000 on 4 shards (its plan_in routing
# concentrates, O = 5 > 4 stacked tiles), and accepts 400,000. The CLI
# runs take phase (c)'s argv (power_law's at 400,000) plus --devices 4;
# power_law 400,000 also gets its single-card pallas run, for the rounds
SHARDS = 4
SHARDED_GRAPHS = {
    "imp3D_1M": GRAPHS["imp3D_1M"],
    "power_law_400000": (400_000, "power_law", {"seed": 0, "m": 4}),
}
_SHARDED_ARGV = {
    "imp3D_1M": CLI_RUNS["imp3D_1M"],
    "power_law_400000": ["400000"] + CLI_RUNS["power_law_1M"][1:],
}
SHARDED_CLI_RUNS = {
    g: {name: [("routed" if a == "pallas" and name == "routed" else a)
               for a in argv] + ["--devices", str(SHARDS)] + extra
        for name, extra in (("pallas", []), ("routed", []),
                            ("pallas_overlap", ["--exchange-overlap"]))}
    for g, argv in _SHARDED_ARGV.items()}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(*parts):
    print(*parts, flush=True)


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` back-to-back launches
    (CUDA events; the source stays warm in L2 as in the round loop)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bitwise_equal(torch, a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
    return bool(torch.equal(a, b))


def max_abs_err(torch, a, b):
    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- (a)

def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"(a) card: {card}")
    say(f"(a) torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    from gossipprotocol_tpu_torch.ops import build

    t0 = time.perf_counter()
    logs = build.build_all()
    say(f"(a) kernels built in {time.perf_counter() - t0:.1f} s "
        f"into {build._LOADED.build_dir}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line or "spill" in line:
                say(f"(a) {name}.cu: {line.strip()}")
    return card


# ---------------------------------------------------------------- (b)

def graph_inputs(torch, name):
    """The graph's delivery on the card and the first round's shares."""
    from gossipprotocol_tpu_torch.ops.pallasdelivery import (
        build_pallas_delivery,
    )
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init
    from gossipprotocol_tpu_torch.topology import build_topology

    n, topo_name, kw = GRAPHS[name]
    t0 = time.perf_counter()
    topo = build_topology(topo_name, n, **kw)
    pd = build_pallas_delivery(topo, device="cuda")
    st = pushsum_init(topo.num_nodes, device="cuda")
    deg = pd.degree.float()
    inv = torch.ones_like(deg) / (deg + 1)
    say(f"(b) {name}: n={topo.num_nodes} edges={topo.num_directed_edges} "
        f"classes={[(c, k) for c, k, *_ in pd.classes]} "
        f"pre={pd.gather_pre.mode}{list(pd.gather_pre.rows.shape)} "
        f"out={pd.gather_out.mode}{list(pd.gather_out.rows.shape)} "
        f"(host build {time.perf_counter() - t0:.1f} s)")
    return topo, pd, st.s * inv, st.w * inv


def expected_kernels(pd):
    want = set()
    for g in (pd.gather_pre, pd.gather_out):
        want.add("gather_resident" if g.mode == "resident" else "gather_bucket")
    for c, *_ in pd.classes:
        want.add("class_reduce_small" if 2 * c <= 128 else
                 "class_reduce_split")
    return want


def check_gather(torch, records, gname, which, plan, x2d):
    from gossipprotocol_tpu_torch.ops import pallasdelivery as pdm
    from gossipprotocol_tpu_torch.probes import seconds_per_call

    lanes = pdm.LANES
    out_k = plan.gather_padded(x2d)
    if plan.mode == "resident":
        kname = "gather_resident"
        plain = lambda: pdm.gather_resident_plain(x2d, plan.idx)  # noqa: E731
        kern = lambda: pdm.gather_resident(x2d, plan.idx)  # noqa: E731
        gidx = plan.idx.reshape(-1).long()
        nbytes = plan.idx.numel() * 4 + x2d.numel() * 4 + out_k.numel() * 4
    else:
        kname = "gather_bucket"
        plain = lambda: pdm.gather_bucket_plain(x2d, plan.rows, plan.lidx)  # noqa: E731
        kern = lambda: pdm.gather_bucket(x2d, plan.rows, plan.lidx)  # noqa: E731
        tiles = plan.rows.shape[0]
        li = plan.lidx.reshape(tiles, -1).long()
        gidx = (torch.gather(plan.rows.long(), 1, li // lanes) * lanes
                + li % lanes).reshape(-1)
        # of the rows table, which is padded to the widest tile, the
        # kernel reads each tile's first max(lidx >> 7) + 1 entries
        rows_used = int((li.max(dim=1).values // lanes + 1).sum())
        say(f"(b) gather_bucket {gname} {which}: rows table "
            f"{list(plan.rows.shape)}, {rows_used} entries read "
            f"({rows_used / plan.rows.numel():.4f} of it)")
        nbytes = (plan.lidx.numel() * 4 + rows_used * 4
                  + x2d.numel() * 4 + out_k.numel() * 4)
    out_p = plain().reshape(-1)
    flat = x2d.reshape(-1)
    err = max_abs_err(torch, out_k, out_p)
    require(bitwise_equal(torch, out_k, out_p),
            f"{kname} ({gname} {which}) differs from its plain version: "
            f"max abs err {err}")
    lib = lambda: flat[gidx]  # noqa: E731
    ms = cuda_ms(torch, kern, 20)
    # device time: R calls captured once into a CUDA graph, the best of
    # three replays (no host enqueue, which back to back hides a kernel
    # of ~0.01 ms)
    g_ms = seconds_per_call(kern, x2d.device) * 1e3
    plain_ms = cuda_ms(torch, plain, 5)
    lib_ms = cuda_ms(torch, lib, 20)
    lib_g_ms = seconds_per_call(lib, x2d.device) * 1e3
    b_ms, b_by = bound(nbytes, 0)
    rec = dict(name=kname, graph=gname, call=which,
               shape=list(plan.lidx.shape if plan.mode == "bucket"
                          else plan.idx.shape),
               max_abs_err=err, ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               library_graph_ms=lib_g_ms, bytes=nbytes)
    say(f"(b) {kname:18s} {gname} {which}: bitwise ok, {ms:.4f} ms back "
        f"to back, {g_ms:.4f} ms graph (plain {plain_ms:.4f}, library "
        f"x[idx] {lib_ms:.4f}, graph {lib_g_ms:.4f}; bound {b_ms:.4f} by "
        f"{b_by}, {nbytes / 1e6:.1f} MB)")
    if (gname, which) == L2_CEILING_AT:
        rec["bound_l2_ms"] = l2_ceiling(torch, plan.idx.shape)
    if plan.mode == "bucket":
        rec.update(bucket_alternatives(torch, gname, which, plan, x2d, gidx,
                                       out_k))
        say(f"(b) gather_bucket {gname} {which} (hints "
            f"{'on' if rec['hints'] else 'off'}): graph_ms {g_ms:.4f} "
            f"{'<=' if g_ms <= lib_g_ms else '>'} x[idx] {lib_g_ms:.4f}")
    records.append(rec)
    return out_k


def l2_ceiling(torch, shape, phase="b"):
    """``bound_l2``: the CUDA-graph time of a gather of uniformly random
    4-byte values from an L2-resident 2 MB source at this call's output
    count, by ``x[idx]`` and by the resident gather's kernel (the better
    of the two). What one random L2 read per output costs the card when
    the indices have no locality; a plan's own indices can do better."""
    from gossipprotocol_tpu_torch.ops import pallasdelivery as pdm
    from gossipprotocol_tpu_torch.probes import seconds_per_call

    gen = torch.Generator(device="cuda").manual_seed(0)
    src = torch.rand(L2_CEILING_ROWS, 128, device="cuda", generator=gen)
    idx = torch.randint(0, src.numel(), tuple(shape), device="cuda",
                        generator=gen, dtype=torch.int32)
    flat, gidx = src.reshape(-1), idx.reshape(-1).long()
    require(bitwise_equal(torch, pdm.gather_resident(src, idx).reshape(-1),
                          flat[gidx]),
            "gather_resident differs on random indices")
    times = {"x[idx]": seconds_per_call(lambda: flat[gidx], src.device),
             "kernel": seconds_per_call(lambda: pdm.gather_resident(src, idx),
                                        src.device)}
    times = {k: t * 1e3 for k, t in times.items()}
    best = min(times.values())
    say(f"({phase}) L2 random-read ceiling: {idx.numel()} uniformly random "
        f"4-byte reads of a {src.numel() * 4 / 1e6:.2f} MB source by graph: "
        + ", ".join(f"{k} {t:.4f} ms" for k, t in times.items())
        + f"; bound_l2 {best:.4f} ms")
    return best


def bucket_alternatives(torch, gname, which, plan, x2d, gidx, out_k):
    """Other shapes of the same gather, timed beside the wrapper's launch
    (evict-first hints as :func:`_stream_hints` picks them): the bucket
    kernel launched directly with the other hint choice, and the one-level
    resident gather over the same source with the resident plan's table
    (the composed index ``rows[t, lidx >> 7] * 128 + (lidx & 127)``,
    which is the table ``build_gather_plan`` makes when ``resident_rows``
    covers the source). Each bitwise equal to the bucket kernel's
    output."""
    from gossipprotocol_tpu_torch.ops import build
    from gossipprotocol_tpu_torch.ops import pallasdelivery as pdm
    from gossipprotocol_tpu_torch.probes import seconds_per_call

    hints = pdm._stream_hints(plan.lidx, plan.rows)
    idx = gidx.to(torch.int32).view(-1, pdm.TILE_ROWS, pdm.LANES)
    other = torch.empty_like(out_k)

    def other_hints():
        rc = build.library("gather").gossip_gather_bucket(
            x2d.data_ptr(), plan.rows.data_ptr(), plan.lidx.data_ptr(),
            other.data_ptr(), plan.rows.shape[0], plan.rows.shape[1],
            int(not hints), build.stream_handle(x2d.device))
        build.check(build.library("gather"), rc, "gather_bucket")
        return other

    shapes = {
        f"hints {'off' if hints else 'on'}": other_hints,
        "one-level gather_resident with the resident plan's table":
            lambda: pdm.gather_resident(x2d, idx),
    }
    alt = dict(hints=hints)
    for key, (what, fn) in zip(("other_hints", "resident"), shapes.items()):
        require(bitwise_equal(torch, fn().reshape(-1), out_k),
                f"gather_bucket {gname} {which}: the {what} differs")
        alt[f"{key}_ms"] = cuda_ms(torch, fn, 20)
        alt[f"{key}_graph_ms"] = seconds_per_call(fn, x2d.device) * 1e3
        say(f"(b) gather_bucket {gname} {which}: {what} "
            f"{alt[f'{key}_ms']:.4f} ms back to back, "
            f"{alt[f'{key}_graph_ms']:.4f} graph (bitwise equal)")
    return alt


def check_folds(torch, records, gname, pd, f):
    from gossipprotocol_tpu_torch.ops import classops as co
    from gossipprotocol_tpu_torch.probes import seconds_per_call

    lanes = co.LANES
    ys = []
    for c, n_c, start, reg_rows, cap in pd.classes:
        region = f[2 * start: 2 * start + reg_rows * lanes]
        if 2 * c <= lanes:
            kname = "class_reduce_small"
            kern = lambda r=region, c=c: co.class_reduce_small(r, c)  # noqa: E731
            plain = lambda r=region, c=c: co.class_reduce_small_plain(r, c)  # noqa: E731
            lib = lambda r=region, c=c: r.view(-1, c, 2).sum(1)  # noqa: E731
        else:
            kname = "class_reduce_split"
            q = 2 * c // lanes
            kern = lambda r=region, c=c: co.class_reduce_split(r, c)  # noqa: E731
            plain = lambda r=region, c=c: co.class_reduce_split_plain(r, c)  # noqa: E731
            lib = lambda r=region, q=q, cap=cap: r.view(q, cap, 64, 2).sum((0, 2))  # noqa: E731
        out_k = kern()
        out_p = plain()
        err = max_abs_err(torch, out_k, out_p)
        require(bitwise_equal(torch, out_k, out_p),
                f"{kname} c={c} ({gname}) differs from its plain version: "
                f"max abs err {err}")
        if kname == "class_reduce_split":
            # a second call on the same region: the arrival counters the
            # first launch left must give the same bits
            require(bitwise_equal(torch, kern(), out_k),
                    f"{kname} c={c} ({gname}): a second call differs")
        ms = cuda_ms(torch, kern, 50)
        g_ms = seconds_per_call(kern, f.device) * 1e3
        plain_ms = cuda_ms(torch, plain, 3 if 2 * c > lanes else 20)
        lib_ms = cuda_ms(torch, lib, 50)
        lib_g_ms = seconds_per_call(lib, f.device) * 1e3
        nbytes = region.numel() * 4 + out_k.numel() * 4
        b_ms, b_by = bound(nbytes, region.numel() - out_k.numel())
        records.append(dict(name=kname, graph=gname, call=f"c={c}",
                            shape=[region.numel()], max_abs_err=err, ms=ms,
                            graph_ms=g_ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms,
                            library_graph_ms=lib_g_ms, bytes=nbytes))
        say(f"(b) {kname:18s} {gname} c={c} n_c={n_c} rows={reg_rows}: "
            f"bitwise ok, {ms:.4f} ms back to back, {g_ms:.4f} ms graph "
            f"(plain {plain_ms:.4f}, library sum {lib_ms:.4f}, graph "
            f"{lib_g_ms:.4f}; bound {b_ms:.4f} by {b_by})")
        if kname == "class_reduce_split":
            say(f"(b) class_reduce_split {gname} c={c}: graph_ms "
                f"{g_ms:.4f} {'<=' if g_ms <= lib_g_ms else '>'} library "
                f"{lib_g_ms:.4f}")
        ys.append(out_k[: 2 * n_c])
    return torch.cat(ys)


def hub_regions(pd, f):
    """The hub classes (2c > 128) of a delivery's fold input ``f``, each
    laid out node-major from its split layout (row j*cap + r becomes row
    r*q + j): ``[(c, n_c, cap, region)]``."""
    out = []
    for c, n_c, start, reg_rows, cap in pd.classes:
        if 2 * c > 128:
            q = 2 * c // 128
            split = f[2 * start: 2 * start + reg_rows * 128]
            out.append((c, n_c, cap, split.view(q, cap, 128).transpose(
                0, 1).contiguous().view(-1)))
    return out


def phase_kernels(torch):
    records = []
    expected = {}
    hubs = None
    for gname in GRAPHS:
        _, pd, share_s, share_w = graph_inputs(torch, gname)
        expected[gname] = expected_kernels(pd)
        n = pd.n
        x = torch.zeros(pd.gather_pre.src_rows * 128, device="cuda")
        x[:n] = share_s
        x[n: 2 * n] = share_w
        f = check_gather(torch, records, gname, "gather_pre", pd.gather_pre,
                         x.view(-1, 128))
        yf = check_folds(torch, records, gname, pd, f)
        if gname == HUB_GRAPH:
            hubs = hub_regions(pd, f)
        y = torch.zeros(pd.gather_out.src_rows * 128, device="cuda")
        y[: yf.numel()] = yf
        check_gather(torch, records, gname, "gather_out", pd.gather_out,
                     y.view(-1, 128))
        del pd, f, x, y
        torch.cuda.empty_cache()
    return records, expected, hubs


# ---------------------------------------------------------------- (c)

def phase_cli(torch, expected):
    from gossipprotocol_tpu_torch.cli import main
    from gossipprotocol_tpu_torch.ops import (
        kernel_launches, reset_kernel_launches,
    )

    totals = {k: 0 for k in PER_ROUND_KERNELS}
    results = {}
    for gname, argv in CLI_RUNS.items():
        argv = argv + ["--device", "cuda", "--max-rounds", MAX_ROUNDS]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        reset_kernel_launches()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        counts = kernel_launches()
        text = buf.getvalue()
        for line in text.splitlines():
            say(f"(c) {gname} | {line}")
        require(rc == 0, f"CLI run {gname} exited {rc}: {' '.join(argv)}")
        conv = re.search(r"Convergence Time: ([0-9.]+) ms", text)
        rounds = re.search(r"rounds: (\d+) \((\d+) executed\)", text)
        err = re.search(r"max \|s/w - mean\| = (\S+)", text)
        require(conv and rounds and err, f"CLI run {gname}: output lines "
                "missing")
        wall_ms, n_rounds = float(conv.group(1)), int(rounds.group(1))
        n_exec = int(rounds.group(2))
        est = float(err.group(1))
        limit = 2e-4 if "global" in argv else 1e-4
        require(est == est and est <= limit,
                f"CLI run {gname}: estimate error {est} above {limit}")
        peak = torch.cuda.max_memory_allocated() / 2**20
        say(f"(c) {gname}: rc 0, {n_rounds} rounds, {wall_ms:.3f} ms, "
            f"{wall_ms / max(n_rounds, 1):.4f} ms/round, {n_exec} rounds "
            f"executed ({wall_ms / max(n_exec, 1):.4f} ms each), "
            f"estimate_error "
            f"{est:.3e}, peak {peak:.1f} MiB, launches {counts}")
        for k in expected[gname]:
            require(counts[k] > 0, f"CLI run {gname}: kernel {k} was "
                    "never launched on the main path")
        for k in totals:
            totals[k] += counts[k]
        results[gname] = (n_rounds, err.group(1))
    return totals, results


# ---------------------------------------------------------------- (d)

def phase_card_vs_cpu(torch):
    from gossipprotocol_tpu_torch.engine import RunConfig, run_simulation
    from gossipprotocol_tpu_torch.topology import build_topology

    for n, name, kw in ((262_144, "imp3D", {"seed": 0}),
                        (100_000, "power_law", {"seed": 0, "m": 4}),
                        (100_000, "erdos_renyi", {"seed": 5})):
        topo = build_topology(name, n, **kw)
        res = {}
        for dev in ("cuda", "cpu"):
            res[dev] = run_simulation(topo, RunConfig(
                **DIFFUSION, device=dev, max_rounds=16, chunk_rounds=8))
        a, b = res["cuda"].final_state, res["cpu"].final_state
        for field in ("s", "w", "ratio", "streak", "converged", "round"):
            require(bitwise_equal(torch, getattr(a, field),
                                  getattr(b, field)),
                    f"card vs cpu: {name} {n} field {field} differs")
        require(res["cuda"].rounds == res["cpu"].rounds == 16,
                f"card vs cpu: {name} {n} rounds {res['cuda'].rounds} vs "
                f"{res['cpu'].rounds}")
        say(f"(d) {name} {topo.num_nodes}: 16 rounds cuda == cpu bitwise "
            "(s, w, ratio, streak, converged, round)")


# ---------------------------------------------------------------- (e)

def _fields_equal(torch, a, b):
    return [f for f, x, y in zip(a._fields, a, b)
            if not bitwise_equal(torch, x, y)]


def _state_err(torch, a, b):
    return max(max_abs_err(torch, x.float(), y.float())
               for x, y in zip(a, b))


def phase_megakernel(torch):
    from gossipprotocol_tpu_torch.engine import RunConfig, run_simulation
    from gossipprotocol_tpu_torch.engine.driver import build_protocol
    from gossipprotocol_tpu_torch.ops import megakernel as mkm
    from gossipprotocol_tpu_torch.ops.pallasdelivery import (
        build_pallas_delivery,
    )
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init
    from gossipprotocol_tpu_torch.topology import build_topology

    records = []
    for gname, (n, topo_name, kw) in MK_GRAPHS.items():
        t0 = time.perf_counter()
        topo = build_topology(topo_name, n, **kw)
        mk = mkm.build_megakernel_delivery(
            build_pallas_delivery(topo, device="cuda"))
        pd, n = mk.pd, topo.num_nodes
        grid = mkm.launch_grid(mk)
        ws = mkm.megakernel_working_set_bytes(pd)
        say(f"(e) {gname}: n={n} classes="
            f"{[(c, k) for c, k, *_ in pd.classes]} gather_pre "
            f"{pd.gather_pre.mode} {pd.gather_pre.src_rows} rows "
            f"(idx {pd.gather_pre.idx.numel()}), gather_out "
            f"{pd.gather_out.mode} {pd.gather_out.src_rows} rows; grid "
            f"{grid} blocks of {mkm.THREADS} (max {mk.scratch['max_grid']}); "
            f"working set {ws / 1e6:.1f} MB against the {L2_BYTES / 1e6:.0f} "
            f"MB L2 (host build {time.perf_counter() - t0:.1f} s)")
        # 1. kernel against plain, 48 rounds, the CLI's tolerances
        worst_err, mean_gap = 0.0, 0.0
        for predicate in ("delta", "global"):
            for k in MK_KS:
                opts = dict(n=n, rounds_per_kernel=k, eps=1e-7,
                            streak_target=3, predicate=predicate, tol=1e-4)
                ms_k = mkm.pad_state(pushsum_init(n, device="cuda"))
                ms_p = mkm.pad_state(pushsum_init(n, device="cuda"))
                for _ in range(MK_ROUNDS // k):
                    ms_k = mkm.megakernel_rounds(ms_k, mk, **opts)
                    ms_p = mkm.megakernel_rounds_plain(
                        ms_p, mk, **opts, mean_grid=grid)
                    if predicate == "global" and k == 1:
                        st = mkm.unpad_state(ms_p, torch.ones(
                            n, dtype=torch.bool, device="cuda"))
                        lib_mean = st.s.sum() / torch.clamp(st.w.sum(),
                                                            min=1e-30)
                        gap = abs(float(mkm.kernel_order_mean(
                            st.s, st.w, grid)) - float(lib_mean))
                        mean_gap = max(mean_gap, gap)
                torch.cuda.synchronize()
                err = _state_err(torch, ms_k, ms_p)
                worst_err = max(worst_err, err)
                bad = _fields_equal(torch, ms_k, ms_p)
                require(not bad, f"megakernel {gname} {predicate} K={k}: "
                        f"fields {bad} differ from the plain version "
                        f"(max abs err {err})")
                say(f"(e) megakernel {gname} {predicate} K={k}: "
                    f"{MK_ROUNDS // k} launches, round {int(ms_k.round)}, "
                    "s w ratio streak conv round bitwise equal to plain")
        say(f"(e) {gname}: largest |mean in the kernel's order - "
            f"torch.sum mean| over 48 global rounds {mean_gap:.3e}")
        # 2. K = 16 against the per-round path on the card
        for predicate, extra, fields in (
                ("delta", dict(eps=1e-7), None),
                ("global", dict(tol=1e-4, streak_target=2**30),
                 ("s", "w", "ratio"))):
            res = {}
            for dl, k in (("pallas", 1), ("megakernel", 16)):
                res[dl] = run_simulation(topo, RunConfig(
                    **dict(DIFFUSION, delivery=dl), device="cuda",
                    rounds_per_kernel=k,
                    predicate=predicate, max_rounds=MK_ROUNDS,
                    chunk_rounds=16, plan_cache="none", **extra))
            a, b = res["megakernel"], res["pallas"]
            require(a.rounds == b.rounds, f"megakernel K=16 {gname} "
                    f"{predicate}: {a.rounds} rounds, per-round path "
                    f"{b.rounds}")
            bad = [f for f in (fields or ("s", "w", "ratio", "streak",
                                          "converged", "round"))
                   if not bitwise_equal(torch, getattr(a.final_state, f),
                                        getattr(b.final_state, f))]
            require(not bad, f"megakernel K=16 {gname} {predicate}: "
                    f"fields {bad} differ from the per-round path")
            say(f"(e) {gname} {predicate}: K=16 == per-round --delivery "
                f"pallas on the card, {a.rounds} rounds, bitwise "
                f"({', '.join(fields or ('every field',))})")
        # 3. time per launch, never converging (every round runs)
        opts = dict(n=n, eps=1e-7, streak_target=2**30, predicate="delta",
                    tol=1e-4)
        state0, core, _, _ = build_protocol(topo, RunConfig(
            **DIFFUSION, device="cuda", max_rounds=MK_ROUNDS))
        per_round_ms = cuda_ms(torch, lambda: core(state0, pd), 20)
        # the bound, from what a launch must move: each input read once
        # (the n nodes' state, degree and packed-output rank, the pair
        # sources the fold reads, the class table, round), each output
        # written once (state, round); ops: every fold add and ~12 per
        # node, per round. The re-read figure (``stream``) adds, every
        # round, the pair-source table read again and the share, fold
        # output and split-partial buffers written and read once each.
        cls_rows, n_part, _, split_units, small_units = \
            mkm._class_table(pd)
        state_bytes = 5 * n * 4
        pre_bytes = (split_units + small_units) * 128 * 4
        once_bytes = (2 * state_bytes + 2 * n * 4 + len(cls_rows)
                      * mkm._CLASS_COLS * 4 + 8)
        scratch_bytes = 16 * ((n + 1) + (pd.nu + 1) + n_part)
        pair_adds = 2 * pd.m_pairs - 2 * pd.nu
        for k in MK_KS:
            kern_ms, g_ms = megakernel_times(
                torch, k, {gname: (mk, n)})[gname]
            ms = mkm.pad_state(pushsum_init(n, device="cuda"))
            plain_ms = cuda_ms(torch, lambda: mkm.megakernel_rounds_plain(
                ms, mk, rounds_per_kernel=k, **opts), 1, warmup=1)
            nbytes = once_bytes + pre_bytes
            ops = k * (pair_adds + 12 * n)
            b_ms, b_by = bound(nbytes, ops)
            stream_ms = (once_bytes + k * (pre_bytes + scratch_bytes)) \
                / HBM_BYTES_PER_S * 1e3
            records.append(dict(
                name="megakernel", graph=gname, call=f"K={k}",
                shape=[n, k], max_abs_err=worst_err, ms=kern_ms,
                graph_ms=g_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, bytes=nbytes,
                stream_bound_ms=stream_ms, ms_per_round=kern_ms / k,
                graph_ms_per_round=g_ms / k,
                per_round_path_ms=per_round_ms))
            say(f"(e) megakernel {gname} K={k}: {kern_ms:.4f} ms per launch "
                f"back to back, {g_ms:.4f} ms by graph ({g_ms / k:.4f} ms "
                f"per round; per-round pallas path {per_round_ms:.4f} ms "
                f"per round by CUDA events; plain {plain_ms:.3f} ms per "
                f"launch); bound {b_ms:.4f} ms by {b_by} (inputs once, "
                f"{nbytes / 1e6:.1f} MB), {stream_ms:.4f} ms re-reading the "
                f"pair table and moving the scratch every round "
                f"({stream_ms / g_ms:.3f} of the graph time); library: none "
                "(no single PyTorch call runs K rounds)")
        # 4. the phase split (the kernel's probe instantiation), K = 16
        k16 = next(r for r in records
                   if r["graph"] == gname and r["call"] == "K=16")
        for predicate in ("delta", "global"):
            ms = mkm.pad_state(pushsum_init(n, device="cuda"))
            popts = dict(opts, predicate=predicate)
            mkm.megakernel_rounds(ms, mk, rounds_per_kernel=16, **popts)
            split = mkm.megakernel_phase_split(ms, mk, rounds_per_kernel=16,
                                               **popts)
            require(split["executed"] == 16,
                    f"megakernel probe {gname}: {split['executed']} rounds")
            k16.setdefault("phase_split", {})[predicate] = split
            say(f"(e) megakernel {gname} {predicate} K=16 phase split "
                f"({mkm.THREADS}-thread blocks x {split['grid']}; us per "
                f"round, mean over blocks [least; largest]): "
                + mkm.format_phase_split(split))
        del mk, pd, state0
        torch.cuda.empty_cache()
    return records


def megakernel_times(torch, k=16, built=None):
    """``{graph: (ms back to back, ms by graph)}`` of K-round launches that
    never converge (every round runs): phase (e) step 3's timing.
    ``built`` maps a graph of ``MK_GRAPHS`` to its ``(delivery, n)``;
    without it every graph is built here, with whatever
    ``gossipprotocol_tpu_torch`` is first on ``sys.path``, so that two
    trees (a change and its parent) are timed by the same code in one
    call:

        python3 -c "import sys; sys.path[:0] = ['TREE', '.']; import torch,
            chip_smoke; print(chip_smoke.megakernel_times(torch))"
    """
    from gossipprotocol_tpu_torch.ops import megakernel as mkm
    from gossipprotocol_tpu_torch.ops.pallasdelivery import (
        build_pallas_delivery,
    )
    from gossipprotocol_tpu_torch.probes import seconds_per_call
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init
    from gossipprotocol_tpu_torch.topology import build_topology

    out = {}
    for gname, (n, topo_name, kw) in MK_GRAPHS.items():
        if built is not None and gname not in built:
            continue
        if built is None:
            topo = build_topology(topo_name, n, **kw)
            mk = mkm.build_megakernel_delivery(
                build_pallas_delivery(topo, device="cuda"))
            n = topo.num_nodes
        else:
            mk, n = built[gname]
        ms = mkm.pad_state(pushsum_init(n, device="cuda"))
        launch = lambda: mkm.megakernel_rounds(  # noqa: E731
            ms, mk, n=n, rounds_per_kernel=k, eps=1e-7,
            streak_target=2**30, predicate="delta", tol=1e-4)
        out[gname] = (cuda_ms(torch, launch, 20),
                      seconds_per_call(launch, ms.s.device) * 1e3)
        del ms
        if built is None:
            del mk
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- (f)

def phase_megakernel_cli(torch):
    from gossipprotocol_tpu_torch.cli import main
    from gossipprotocol_tpu_torch.ops import (
        kernel_launches, reset_kernel_launches,
    )

    total = 0
    for gname, argv in MK_CLI_RUNS.items():
        argv = argv + ["--device", "cuda", "--max-rounds", MAX_ROUNDS]
        torch.cuda.empty_cache()
        buf = io.StringIO()
        reset_kernel_launches()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        counts = kernel_launches()
        text = buf.getvalue()
        for line in text.splitlines():
            say(f"(f) {gname} | {line}")
        require(rc == 0, f"CLI run {gname} exited {rc}: {' '.join(argv)}")
        conv = re.search(r"Convergence Time: ([0-9.]+) ms", text)
        rounds = re.search(r"rounds: (\d+) \((\d+) executed\)", text)
        err = re.search(r"max \|s/w - mean\| = (\S+)", text)
        require(conv and rounds and err, f"CLI run {gname}: output lines "
                "missing")
        wall_ms, n_rounds = float(conv.group(1)), int(rounds.group(1))
        est = float(err.group(1))
        limit = 2e-4 if "global" in argv else 1e-4
        require(est == est and est <= limit,
                f"CLI run {gname}: estimate error {est} above {limit}")
        require(counts["megakernel"] > 0,
                f"CLI run {gname}: the megakernel was never launched")
        stray = {k: counts[k] for k in PER_ROUND_KERNELS if counts[k]}
        require(not stray, f"CLI run {gname}: per-round kernels launched "
                f"on the megakernel path: {stray}")
        say(f"(f) {gname}: rc 0, {n_rounds} rounds, {wall_ms:.3f} ms, "
            f"{wall_ms / max(n_rounds, 1):.4f} ms/round, estimate_error "
            f"{est:.3e}, launches {counts}")
        total += counts["megakernel"]
    return total


# ---------------------------------------------------------------- (g)

def _record(torch, records, name, gname, call, shape, err, nbytes, kern,
            plain, lib, lib_what, plain_iters=3):
    """Time a kernel checked bitwise: back to back and as CUDA-graph
    replays (device time), beside its plain version and one library
    call (both ways); append its record and return it."""
    from gossipprotocol_tpu_torch.probes import seconds_per_call

    dev = torch.device("cuda")
    ms, g_ms = cuda_ms(torch, kern, 20), seconds_per_call(kern, dev) * 1e3
    plain_ms = cuda_ms(torch, plain, plain_iters)
    lib_ms = cuda_ms(torch, lib, 20)
    lib_g_ms = seconds_per_call(lib, dev) * 1e3
    b_ms, b_by = bound(nbytes, 0)
    rec = dict(name=name, graph=gname, call=call, shape=shape,
               max_abs_err=err, ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               library_graph_ms=lib_g_ms, bytes=nbytes)
    records.append(rec)
    say(f"(g) {name:18s} {gname} {call}: bitwise ok, {ms:.4f} ms back to "
        f"back, {g_ms:.4f} ms graph (plain {plain_ms:.4f}, library "
        f"{lib_what} {lib_ms:.4f}, graph {lib_g_ms:.4f}; bound {b_ms:.4f} "
        f"by {b_by}, {nbytes / 1e6:.1f} MB)")
    return rec


def check_expands(torch, records, gname, rd, cls_pairs):
    """Both expand kernels on every class of the graph, on the first
    round's class-ordered shares; returns the expanded slab."""
    from gossipprotocol_tpu_torch.ops import classops as co

    segs, off = [], 0
    for c, n_c, _start, _rows, cap in rd.classes:
        packed = torch.nn.functional.pad(cls_pairs[2 * off: 2 * (off + n_c)],
                                         (0, 2 * (cap - n_c)))
        off += n_c
        if 2 * c <= co.LANES:
            name = "class_expand_small"
            kern = lambda x=packed, c=c: co.class_expand_small(x, c)  # noqa: E731
            plain = lambda x=packed, c=c: co.class_expand_small_plain(x, c)  # noqa: E731
            rows = packed.numel() * c // co.LANES
            lib = lambda x=packed, c=c, r=rows: x.view(r, 64 // c, 2).repeat_interleave(c, dim=1)  # noqa: E731
            lib_what = "repeat_interleave"
        else:
            name = "class_expand_split"
            kern = lambda x=packed, c=c: co.class_expand_split(x, c)  # noqa: E731
            plain = lambda x=packed, c=c: co.class_expand_split_plain(x, c)  # noqa: E731
            q = 2 * c // co.LANES
            lib = lambda x=packed, q=q, cap=cap: x.view(1, cap, 1, 2).repeat(q, 1, 64, 1)  # noqa: E731
            lib_what = "repeat"
        out_k, out_p = kern(), plain()
        err = max_abs_err(torch, out_k, out_p)
        require(bitwise_equal(torch, out_k, out_p),
                f"{name} c={c} ({gname}) differs from its plain version: "
                f"max abs err {err}")
        require(bitwise_equal(torch, lib().reshape(-1), out_k),
                f"{name} c={c} ({gname}): library call differs")
        _record(torch, records, name, gname, f"c={c}", [packed.numel()], err,
                (packed.numel() + out_k.numel()) * 4, kern, plain, lib,
                lib_what, plain_iters=10)
        segs.append(out_k)
    return torch.cat(segs)


def check_route(torch, records, gname, dp, x):
    """The stage kernel on every radix stage of plan ``dp`` and the final
    kernel on its final pass, fed the plan's real input ``x``; returns
    the routed output."""
    from gossipprotocol_tpu_torch.ops import exec as ex

    unit, lanes, tile = dp.unit, ex.LANES, ex.TILE
    cur = x.view(dp.nt_in, lanes, lanes)
    for si, st in enumerate(dp.stages):
        tiles = st.p * st.tau_in
        out_k = ex.stage_call(st, cur, unit)
        out_p = ex.stage_call_plain(st, cur, unit)
        got = ex.stage_rows_written(st, out_k)
        want = ex.stage_rows_written(st, out_p)
        err = max_abs_err(torch, got, want)
        require(bitwise_equal(torch, got, want),
                f"stage_call {si} ({gname}) differs from its plain "
                f"version: max abs err {err}")
        # the library yardstick: one gather with the composed index
        ci = ex.composed_route_index(st.idx, unit)
        src = (torch.arange(tiles, device=x.device).view(-1, 1, 1, 1)
               * tile + ci).reshape(tiles, st.o * lanes, lanes)
        gidx = src[:, : st.b * st.cr].reshape(
            st.p, st.tau_in, st.b, st.cr, lanes).transpose(1, 2).contiguous()
        flat = cur.reshape(-1)
        del ci, src
        require(bitwise_equal(torch, flat[gidx], got.contiguous()),
                f"stage_call {si} ({gname}): composed-index gather differs")
        nbytes = (cur.numel() * 4 + st.idx.numel()
                  + st.p * st.b * st.tau_in * st.cr * lanes * 4)
        _record(torch, records, "stage_call", gname,
                f"plan_m stage {si} {tuple(st[:6])}", list(st.idx.shape),
                err, nbytes, lambda: ex.stage_call(st, cur, unit),
                lambda: ex.stage_call_plain(st, cur, unit),
                lambda: flat[gidx], "x[idx]")
        del gidx, out_p
        cur = out_k
    fin, nt_out = dp.final, dp.nt_out
    out_k = ex.final_call(fin, nt_out, cur, unit)
    out_p = ex.final_call_plain(fin, nt_out, cur, unit)
    err = max_abs_err(torch, out_k, out_p)
    require(bitwise_equal(torch, out_k, out_p),
            f"final_call ({gname}) differs from its plain version: max abs "
            f"err {err}")
    ci = ex.composed_route_index(fin.idx, unit)
    bits = ex.final_bits(fin.mask)
    base = torch.arange(nt_out * fin.k, device=x.device).view(
        nt_out, fin.k, 1, 1) * tile
    x_ext = torch.cat([cur[: nt_out * fin.k].reshape(-1),
                       torch.zeros(1, device=x.device)])
    sel = torch.full((nt_out, lanes, lanes), x_ext.numel() - 1,
                     dtype=torch.long, device=x.device)
    for kk in range(fin.k):
        sel = torch.where(bits[:, kk], base[:, kk] + ci[:, kk], sel)
    del ci, bits, base
    require(bitwise_equal(torch, x_ext[sel], out_k),
            f"final_call ({gname}): composed-index gather differs")
    nbytes = (nt_out * fin.k * tile * 4 + fin.idx.numel()
              + fin.mask.numel() + out_k.numel() * 4)
    rec = _record(torch, records, "final_call", gname,
                  f"plan_m final k={fin.k}", list(fin.idx.shape), err, nbytes,
                  lambda: ex.final_call(fin, nt_out, cur, unit),
                  lambda: ex.final_call_plain(fin, nt_out, cur, unit),
                  lambda: x_ext[sel], "x[idx]")
    say(f"(g) final_call {gname}: graph_ms {rec['graph_ms']:.4f} "
        f"{'<=' if rec['graph_ms'] <= rec['library_graph_ms'] else '>'} "
        f"x[idx] {rec['library_graph_ms']:.4f}")
    return out_k.reshape(-1)


def phase_routed(torch, pallas_runs):
    from gossipprotocol_tpu_torch import native
    from gossipprotocol_tpu_torch.cli import main
    from gossipprotocol_tpu_torch.ops import (
        kernel_launches, reset_kernel_launches,
    )
    from gossipprotocol_tpu_torch.ops.delivery import _apply_chain
    from gossipprotocol_tpu_torch.ops.plancache import (
        pallas_delivery_cached, routed_delivery_cached,
    )
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init
    from gossipprotocol_tpu_torch.topology import build_topology

    records = []
    matvecs = {}
    for gname in ROUTED_CLI_RUNS:
        n, topo_name, kw = GRAPHS[gname]
        topo = build_topology(topo_name, n, **kw)
        t0 = time.perf_counter()
        rd, prov = routed_delivery_cached(topo, device="cuda")
        build_s = time.perf_counter() - t0
        require(native.backend() == "native" and native._LIB.lib is not None,
                "the routed plans were not colored by the native library")
        geo = {g: [(tuple(st[:6]), p.final.k) for p in getattr(rd, g)
                   for st in p.stages] for g in ("plan_in", "plan_m",
                                                 "plan_out")}
        say(f"(g) {gname}: routed plans {prov} in {build_s:.1f} s "
            f"(coloring backend: native {native._LIB.path.parent.name}/"
            f"{native._LIB.path.name}, {native.threads_note()}); "
            f"m_pairs={rd.m_pairs} classes="
            f"{[(c, k) for c, k, *_ in rd.classes]}; stages {geo}")
        # the first round's shares, as the round computes them
        st = pushsum_init(topo.num_nodes, device="cuda")
        deg = rd.degree.float()
        inv = torch.ones_like(deg) / (deg + 1)
        share_s, share_w = st.s * inv, st.w * inv
        flat = torch.cat([share_s, share_w])
        cls_pairs = _apply_chain(rd.plan_in, flat, take_f32=2 * rd.nu)
        e1 = check_expands(torch, records, gname, rd, cls_pairs) * rd.realmask
        p0, p1 = rd.plan_m
        x1 = _apply_chain((p0,), e1)
        x1 = torch.nn.functional.pad(x1, (0, p1.m_in_f32 - x1.numel()))[
            : p1.m_in_f32]
        check_route(torch, records, gname, p1, x1)
        del e1, x1, cls_pairs
        # the routed matvec against the pallas matvec, bitwise
        pd, _ = pallas_delivery_cached(topo, device="cuda")
        a = rd.matvec(share_s, share_w)
        b = pd.matvec(share_s, share_w)
        for u, v, what in zip(a, b, ("s", "w")):
            require(bitwise_equal(torch, u, v),
                    f"routed matvec ({gname}) differs from the pallas "
                    f"matvec in {what}: max abs err {max_abs_err(torch, u, v)}")
        r_ms = cuda_ms(torch, lambda: rd.matvec(share_s, share_w), 10)
        p_ms = cuda_ms(torch, lambda: pd.matvec(share_s, share_w), 10)
        say(f"(g) {gname}: routed matvec == pallas matvec bitwise (s, w); "
            f"{r_ms:.4f} ms per routed matvec, {p_ms:.4f} ms per pallas "
            "matvec (CUDA events, host-paced)")
        matvecs[gname] = (share_s, share_w, a, r_ms)
        del rd, pd, b
        torch.cuda.empty_cache()
    totals = {k: 0 for k in ROUTED_KERNELS}
    for gname, argv in ROUTED_CLI_RUNS.items():
        argv = argv + ["--device", "cuda", "--max-rounds", MAX_ROUNDS]
        buf = io.StringIO()
        reset_kernel_launches()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        counts = kernel_launches()
        text = buf.getvalue()
        for line in text.splitlines():
            say(f"(g) {gname} | {line}")
        require(rc == 0, f"routed CLI run {gname} exited {rc}: "
                f"{' '.join(argv)}")
        conv = re.search(r"Convergence Time: ([0-9.]+) ms", text)
        rounds = re.search(r"rounds: (\d+) \((\d+) executed\)", text)
        err = re.search(r"max \|s/w - mean\| = (\S+)", text)
        require(conv and rounds and err, f"routed CLI run {gname}: output "
                "lines missing")
        n_rounds, n_exec = int(rounds.group(1)), int(rounds.group(2))
        want_rounds, want_err = pallas_runs[gname]
        require(n_rounds == want_rounds,
                f"routed CLI run {gname}: {n_rounds} rounds, the pallas run "
                f"{want_rounds}")
        require(err.group(1) == want_err,
                f"routed CLI run {gname}: estimate error {err.group(1)}, the "
                f"pallas run {want_err}")
        for k in ROUTED_KERNELS:
            if k == "class_expand_split" and gname == "imp3D_1M":
                continue  # imp3D has no hub class
            require(counts[k] > 0, f"routed CLI run {gname}: kernel {k} "
                    "was never launched")
        wall_ms = float(conv.group(1))
        say(f"(g) {gname}: rc 0, {n_rounds} rounds (= pallas), {wall_ms:.3f} "
            f"ms, {wall_ms / max(n_exec, 1):.4f} ms per executed round "
            f"({n_exec}), estimate_error {err.group(1)} (= pallas), "
            f"launches {counts}")
        for k in totals:
            totals[k] += counts[k]
    return records, totals, matvecs


# ---------------------------------------------------------------- (h)

def _as_bytes(torch, t):
    return t.contiguous().view(torch.int8)


def exchange_kernel_ms(torch, slabs, overlap, iters=50):
    """Time of one exchange launch (either schedule), back to back and as
    CUDA-graph replays: the launcher called straight with prebuilt pointer
    tables, since the wrapper's checks and allocation take longer on the
    host than the copy takes on the card."""
    import ctypes

    from gossipprotocol_tpu_torch.ops import build
    from gossipprotocol_tpu_torch.probes import seconds_per_call

    ns, block = slabs[0].shape
    out = torch.empty((ns, ns, block), dtype=slabs[0].dtype, device="cuda")
    src = (ctypes.c_void_p * ns)(*[t.data_ptr() for t in slabs])
    dst = (ctypes.c_void_p * ns)(*[out[d].data_ptr() for d in range(ns)])
    lib = build.library("exchange")
    row = block * slabs[0].element_size()

    def launch():  # on the current stream: the capture stream, when captured
        lib.gossip_exchange(src, dst, ns, row, int(overlap),
                            build.stream_handle(out.device))

    return (cuda_ms(torch, launch, iters),
            seconds_per_call(launch, out.device) * 1e3)


def check_exchange(torch, records, gname, slabs, wire):
    """The exchange kernel on one wire's real slabs, both schedules,
    against its plain version and the one-permutation spelling."""
    from gossipprotocol_tpu_torch.ops import pallasdelivery as pdm
    from gossipprotocol_tpu_torch.probes import seconds_per_call

    ns, block = slabs[0].shape
    nbytes = 2 * ns * ns * block * slabs[0].element_size()
    stacked = torch.stack(slabs)
    lib = lambda: stacked.transpose(0, 1).contiguous()  # noqa: E731
    perm = pdm.exchange_plain(slabs)
    for overlap in (False, True):
        got = pdm.pallas_exchange(slabs, overlap=overlap)
        plain = pdm.pallas_exchange_plain(slabs, overlap=overlap)
        for d in range(ns):
            for other, what in ((plain, "its plain version"),
                                (perm, "exchange_plain")):
                require(torch.equal(_as_bytes(torch, got[d]),
                                    _as_bytes(torch, other[d])),
                        f"pallas_exchange ({gname} {wire}, overlap "
                        f"{overlap}) differs from {what} at shard {d}")
        sched = "ring" if overlap else "all"
        ms, g_ms = exchange_kernel_ms(torch, slabs, overlap)
        wrapper_ms = cuda_ms(torch, lambda: pdm.pallas_exchange(
            slabs, overlap=overlap), 20)
        plain_ms = cuda_ms(torch, lambda: pdm.pallas_exchange_plain(
            slabs, overlap=overlap), 5)
        lib_ms = cuda_ms(torch, lib, 20)
        lib_g_ms = seconds_per_call(lib, stacked.device) * 1e3
        b_ms, b_by = bound(nbytes, 0)
        records.append(dict(name="pallas_exchange", graph=gname,
                            call=f"{wire} {sched}", shape=[ns, ns, block],
                            max_abs_err=0.0, ms=ms, graph_ms=g_ms,
                            wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                            library_graph_ms=lib_g_ms, bytes=nbytes))
        say(f"(h) pallas_exchange    {gname} {wire} {sched} "
            f"[{ns}, {ns}, {block}] {slabs[0].dtype}: bitwise ok, "
            f"{ms:.4f} ms (1 launch; through the wrapper "
            f"{wrapper_ms:.4f}, host-paced), "
            f"{g_ms:.4f} graph, plain {plain_ms:.4f}, library "
            f"transpose(0,1).contiguous() {lib_ms:.4f}, graph "
            f"{lib_g_ms:.4f}, bound {b_ms:.4f} by {b_by}, "
            f"{nbytes / 1e6:.2f} MB")


def _run_cli(argv):
    """``(rc, stdout, stderr, launch counts)`` of one in-process CLI run."""
    from gossipprotocol_tpu_torch.cli import main
    from gossipprotocol_tpu_torch.ops import (
        kernel_launches, reset_kernel_launches,
    )

    buf, ebuf = io.StringIO(), io.StringIO()
    reset_kernel_launches()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(ebuf):
        rc = main(argv)
    return rc, buf.getvalue(), ebuf.getvalue(), kernel_launches()


def _routed_matvec(torch, topo):
    """The single-card routed matvec on the first round's shares, for a
    graph phase (g) did not build: ``(share_s, share_w, (in_s, in_w),
    ms)``."""
    from gossipprotocol_tpu_torch.ops.plancache import routed_delivery_cached
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init

    rd, _ = routed_delivery_cached(topo, device="cuda")
    st = pushsum_init(topo.num_nodes, device="cuda")
    deg = rd.degree.float()
    inv = torch.ones_like(deg) / (deg + 1)
    share_s, share_w = st.s * inv, st.w * inv
    out = rd.matvec(share_s, share_w)
    ms = cuda_ms(torch, lambda: rd.matvec(share_s, share_w), 10)
    del rd
    torch.cuda.empty_cache()
    return share_s, share_w, out, ms


def _mean_gap(torch, topo, argv):
    """|mean summed in shard order - torch.sum's mean| on the final state
    of the sharded run of ``argv``'s delivery, run again."""
    from gossipprotocol_tpu_torch.engine import RunConfig
    from gossipprotocol_tpu_torch.parallel import run_simulation_sharded
    from gossipprotocol_tpu_torch.parallel.sharded import shard_sum

    res = run_simulation_sharded(topo, RunConfig(
        **dict(DIFFUSION, delivery=argv[argv.index("--delivery") + 1]),
        device="cuda", predicate="global", tol=1e-4), num_devices=SHARDS)
    st = res.final_state
    s, w = st.s.cuda(), st.w.cuda()
    pad = (-s.numel()) % SHARDS
    s = torch.nn.functional.pad(s, (0, pad))
    w = torch.nn.functional.pad(w, (0, pad))
    mine = shard_sum(SHARDS)(s) / torch.clamp(shard_sum(SHARDS)(w),
                                              min=1e-30)
    lib = s.sum() / torch.clamp(w.sum(), min=1e-30)
    return abs(float(mine) - float(lib))


def phase_sharded(torch, pallas_runs, matvecs):
    from gossipprotocol_tpu_torch.convert import shard_push_from_numpy
    from gossipprotocol_tpu_torch.ops import sharddelivery as sdm
    from gossipprotocol_tpu_torch.ops.plancache import (
        shard_push_deliveries_cached,
    )
    from gossipprotocol_tpu_torch.parallel import padded_size
    from gossipprotocol_tpu_torch.topology import build_topology

    records = []
    topos = {}
    for gname, (n, topo_name, kw) in SHARDED_GRAPHS.items():
        topo = topos[gname] = build_topology(topo_name, n, **kw)
        if gname not in matvecs:
            matvecs[gname] = _routed_matvec(torch, topo)
        n_padded = padded_size(topo.num_nodes, SHARDS)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        host, prov = shard_push_deliveries_cached(topo, n_padded, SHARDS)
        build_s = time.perf_counter() - t0
        plans = shard_push_from_numpy(host, "cuda")
        wire_bytes = {w: sdm.push_exchange_wire_bytes_per_round(host, w)
                      for w in sdm.WIRES}
        say(f"(h) {gname}: {SHARDS}-shard push plans {prov} in {build_s:.1f}"
            f" s (workers {sdm.resolve_build_workers(None, SHARDS)}); "
            f"local_n {host.local_n}, block_pairs {host.block_pairs}, "
            f"m_pairs {host.m_pairs}, classes "
            f"{[(c, k) for c, k, *_ in host.classes]}; exchange bytes per "
            f"shard per round {wire_bytes}; tables "
            f"{sdm.table_bytes(host) / 1e6:.1f} MB; peak device memory "
            f"after placement {torch.cuda.max_memory_allocated() / 2**20:.1f}"
            " MiB")
        share_s, share_w, routed, routed_ms = matvecs[gname]
        # the exchange kernel at the real slab shapes
        f_locals, slabs = plans.send(share_s, share_w)
        qs, scales = sdm.quantize_int8(slabs)
        for wire, payload in (("f32", slabs),
                              ("bf16", [x.to(torch.bfloat16)
                                        for x in slabs]),
                              ("int8", qs), ("int8-scales", scales)):
            check_exchange(torch, records, gname, payload, wire)
        del f_locals, slabs, qs, scales
        # the sharded matvec against (g)'s single-card routed matvec,
        # timed in mirrored order
        for exchange in sdm.EXCHANGES + sdm.EXCHANGES[::-1]:
            got = plans.matvec(share_s, share_w, exchange=exchange)
            for u, v, what in zip(got, routed, ("s", "w")):
                require(bitwise_equal(torch, u, v),
                        f"{SHARDS}-shard matvec ({gname}, {exchange}) "
                        f"differs from the single-card routed matvec in "
                        f"{what}: max abs err {max_abs_err(torch, u, v)}")
            ms = cuda_ms(torch, lambda: plans.matvec(
                share_s, share_w, exchange=exchange), 10)
            say(f"(h) {gname}: {SHARDS}-shard matvec ({exchange}) == "
                f"single-card routed matvec bitwise (s, w); {ms:.4f} ms "
                f"per matvec against {routed_ms:.4f} single-card (CUDA "
                "events, host-paced)")
        for wire in ("bf16", "int8"):
            got = plans.matvec(share_s, share_w, exchange="pallas",
                               wire=wire)
            err = max(max_abs_err(torch, u, v)
                      for u, v in zip(got, routed))
            rel = err / float(routed[0].abs().max())
            say(f"(h) {gname}: {wire} wire matvec, max abs err against f32 "
                f"{err:.3e} ({rel:.3e} of the largest in_s)")
        del plans, host, got
        torch.cuda.empty_cache()
    totals = {"pallas_exchange": 0}
    for gname, runs in SHARDED_CLI_RUNS.items():
        if gname not in pallas_runs:
            argv = _SHARDED_ARGV[gname] + ["--device", "cuda",
                                          "--max-rounds", MAX_ROUNDS]
            rc, text, _, _ = _run_cli(argv)
            for line in text.splitlines():
                say(f"(h) {gname} single-card pallas | {line}")
            rounds = re.search(r"rounds: (\d+) \((\d+) executed\)", text)
            err = re.search(r"max \|s/w - mean\| = (\S+)", text)
            require(rc == 0 and rounds and err, f"single-card pallas CLI "
                    f"run {gname} failed (rc {rc})")
            pallas_runs[gname] = (int(rounds.group(1)), err.group(1))
        want_rounds, want_err = pallas_runs[gname]
        exch_runs = {}
        for name, argv in runs.items():
            argv = argv + ["--device", "cuda", "--max-rounds", MAX_ROUNDS]
            rc, text, etext, counts = _run_cli(argv)
            for line in (etext + text).splitlines():
                say(f"(h) {gname} {name} | {line}")
            require(rc == 0, f"sharded CLI run {gname} {name} exited {rc}: "
                    f"{' '.join(argv)}")
            require(f"{SHARDS} shards on 1 card" in etext,
                    f"sharded CLI run {gname} {name}: no placement line")
            conv = re.search(r"Convergence Time: ([0-9.]+) ms", text)
            rounds = re.search(r"rounds: (\d+) \((\d+) executed\)", text)
            err = re.search(r"max \|s/w - mean\| = (\S+)", text)
            require(conv and rounds and err, f"sharded CLI run {gname} "
                    f"{name}: output lines missing")
            n_rounds, n_exec = int(rounds.group(1)), int(rounds.group(2))
            est = float(err.group(1))
            require(est == est and est <= 2e-4, f"sharded CLI run {gname} "
                    f"{name}: estimate error {est} above 2e-4")
            if n_rounds == want_rounds:
                require(err.group(1) == want_err,
                        f"sharded CLI run {gname} {name}: estimate error "
                        f"{err.group(1)}, the pallas run {want_err}")
                note = "= pallas"
            else:
                require(abs(n_rounds - want_rounds) == 1,
                        f"sharded CLI run {gname} {name}: {n_rounds} rounds, "
                        f"the pallas run {want_rounds}")
                gap = _mean_gap(torch, topos[gname], argv)
                note = (f"one round from pallas's {want_rounds}; gap of the "
                        f"shard-order mean to torch.sum's {gap:.3e}")
            exch = counts["pallas_exchange"]
            if name == "routed":
                require(exch == 0, f"sharded CLI run {gname} routed: the "
                        "exchange kernel ran on the all_to_all transport")
            else:
                require(exch > 0, f"sharded CLI run {gname} {name}: the "
                        "exchange kernel was never launched")
            for k in ("stage_call", "final_call", "class_expand_small",
                      "class_reduce_small"):
                require(counts[k] > 0, f"sharded CLI run {gname} {name}: "
                        f"kernel {k} was never launched")
            wall_ms = float(conv.group(1))
            say(f"(h) {gname} {name}: rc 0, {n_rounds} rounds ({note}), "
                f"{wall_ms:.3f} ms, {wall_ms / max(n_exec, 1):.4f} ms per "
                f"executed round ({n_exec}), estimate_error {err.group(1)}, "
                f"launches {counts}")
            totals["pallas_exchange"] += exch
            exch_runs[name] = (n_exec, exch)
        # one launch per exchange on both schedules: the ring run, bitwise
        # the pallas run, launches the kernel as often
        require(exch_runs["pallas_overlap"] == exch_runs["pallas"],
                f"sharded CLI runs {gname}: (executed rounds, exchange "
                f"launches) ring {exch_runs['pallas_overlap']}, one-launch "
                f"{exch_runs['pallas']}")
        say(f"(h) {gname}: exchange launches, one-launch "
            f"{exch_runs['pallas'][1]}, ring {exch_runs['pallas_overlap'][1]}"
            " (one launch per exchange on both schedules)")
    return records, totals


# ---------------------------------------------------------------- (i)

def phase_hub_kernels(torch, hubs):
    """``class_reduce_big`` and ``class_expand_big`` at every hub class of
    power_law 1M, node-major regions of the first round's fold input."""
    from gossipprotocol_tpu_torch.ops import classops as co
    from gossipprotocol_tpu_torch.ops import (
        kernel_launches, reset_kernel_launches,
    )
    from gossipprotocol_tpu_torch.probes import seconds_per_call

    records = []
    require(hubs, f"{HUB_GRAPH} has no hub class")
    reset_kernel_launches()
    firsts = []
    for c, _, _, region in hubs:
        red = co.class_reduce_big(region, c)
        firsts.append((red, co.class_expand_big(red, c)))
    launches = kernel_launches()
    counts = {k: launches[k] for k in HUB_KERNELS}
    for (c, n_c, cap, region), (pairs, exp) in zip(hubs, firsts):
        q = 2 * c // co.LANES
        say(f"(i) class_expand_big c={c}: {expand_geometry(exp)}")
        for name, got, plain, kern, lib, lib_what, nbytes in (
                ("class_reduce_big", pairs,
                 lambda: co.class_reduce_big_plain(region, c),
                 lambda: co.class_reduce_big(region, c),
                 lambda: region.view(cap, q * 64, 2).sum(1),
                 "view(n_c, q*64, 2).sum(1)",
                 region.numel() * 4 + pairs.numel() * 4),
                ("class_expand_big", exp,
                 lambda: co.class_expand_big_plain(pairs, c),
                 lambda: co.class_expand_big(pairs, c),
                 lambda: pairs.view(cap, 1, 2).expand(
                     cap, q * 64, 2).contiguous(),
                 "view(n_c,1,2).expand(n_c,q*64,2).contiguous()",
                 pairs.numel() * 4 + exp.numel() * 4)):
            want = plain()
            err = max_abs_err(torch, got, want)
            require(bitwise_equal(torch, got, want),
                    f"{name} c={c} ({HUB_GRAPH}) differs from its plain "
                    f"version: max abs err {err}")
            lib_out = lib().reshape(-1)
            lib_err = max_abs_err(torch, lib_out, got)
            if name == "class_expand_big":
                require(bitwise_equal(torch, lib_out, got),
                        f"class_expand_big c={c}: library call differs")
            if name == "class_reduce_big":
                # a second call: the arrival counters the first launch
                # left must give the same bits
                require(bitwise_equal(torch, kern(), got),
                        f"class_reduce_big c={c}: a second call differs")
            ms = cuda_ms(torch, kern, 50)
            g_ms = seconds_per_call(kern, region.device) * 1e3
            plain_ms = cuda_ms(torch, plain, 3)
            lib_ms = cuda_ms(torch, lib, 50)
            lib_g_ms = seconds_per_call(lib, region.device) * 1e3
            b_ms, b_by = bound(nbytes, region.numel()
                               if name == "class_reduce_big" else 0)
            records.append(dict(
                name=name, graph=HUB_GRAPH, call=f"c={c}",
                shape=[cap, q, 128], max_abs_err=err, ms=ms, graph_ms=g_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, library_graph_ms=lib_g_ms,
                bytes=nbytes))
            say(f"(i) {name:16s} {HUB_GRAPH} c={c} q={q} n_c={cap} "
                f"({n_c} real nodes): bitwise ok, {ms:.4f} ms back to "
                f"back, {g_ms:.4f} ms graph (plain {plain_ms:.4f}, library "
                f"{lib_what} {lib_ms:.4f}, graph {lib_g_ms:.4f} "
                f"[max |diff| {lib_err:.3e}], bound {b_ms:.4f} by {b_by}, "
                f"{nbytes / 1e6:.2f} MB)")
            if name == "class_reduce_big":
                say(f"(i) class_reduce_big c={c}: graph_ms {g_ms:.4f} "
                    f"{'<=' if g_ms <= lib_g_ms else '>'} library "
                    f"{lib_g_ms:.4f}")
        split = co.class_reduce_split(region.view(cap, q, 128).transpose(
            0, 1).contiguous().view(-1), c)
        say(f"(i) c={c}: node-major reduce against the split layout's "
            f"reduce of the same values, max |diff| "
            f"{max_abs_err(torch, pairs, split):.3e} (another summation "
            "order)")
    say(f"(i) launches {counts} ({NO_CLI_PATH})")
    return records, counts


# ---------------------------------------------------------------- (j)

# phase (j): the reference surface (gossip, fanout-one push-sum) through
# the CLI at 1M nodes. line and 3D are left out: gossip there needs
# O(n^(1/3)) to O(n) rounds. The golden graphs are tests/test_golden.py's
REF_CLI_RUNS = {
    "gossip imp3D_1M": ["1000000", "imp3D", "gossip"],
    "gossip full_1M": ["1000000", "full", "gossip"],
    "push-sum imp3D_1M": ["1000000", "imp3D", "push-sum", "--predicate",
                          "global", "--tol", "1e-4"],
    "push-sum full_1M": ["1000000", "full", "push-sum", "--predicate",
                         "global", "--tol", "1e-4"],
}
GOLDEN_GOSSIP = {            # tests/test_golden.py, exact on every backend
    ("line", 64): 113,
    ("full", 128): 28,
    ("3D", 64): 29,
    ("imp3D", 64): 25,
    ("erdos_renyi", 128): 49,
    ("power_law", 128): 575,
}
CARD_CPU_ROUNDS = 32
# push-sum scatter, card against CPU: the float adds are atomics on the
# card, so the two runs agree up to accumulation order; held to this
# bound on |s|, |w| (32 rounds, values <= 1) and to equal alive sets
SCATTER_TOL = 1e-5


def _count_inverted(torch):
    """Wrap the gossip round core to count the rounds that took the
    gather-inverted branch; returns (counter dict, restore)."""
    from gossipprotocol_tpu_torch.engine import driver as drv

    seen = {"inverted": 0, "scatter": 0}
    orig = drv.GossipCore.__call__

    def counted(self, state, nbrs, key):
        seen["inverted" if self.inverted else "scatter"] += 1
        return orig(self, state, nbrs, key)

    drv.GossipCore.__call__ = counted
    return seen, lambda: setattr(drv.GossipCore, "__call__", orig)


def _inverted_hits_on_card(torch, topo):
    """The gather-inverted histogram computed on the card equals the
    scatter's on a saturated state (every node spreads), for 4 round
    keys: the branch the card's runs do not take, still right there."""
    from gossipprotocol_tpu_torch.protocols.gossip import (
        hits_by_inversion, inverted_dense,
    )
    from gossipprotocol_tpu_torch.protocols.sampling import (
        fold_in, key_data, sample_neighbors,
    )

    nbrs = inverted_dense(topo, device="cuda")
    n = topo.num_nodes
    for r in range(4):
        key = fold_in(key_data(7, "cuda"), r)
        targets, valid = sample_neighbors(nbrs, n, key)
        scatter = torch.zeros(n, dtype=torch.int32, device="cuda")
        scatter.index_add_(0, targets, valid.to(torch.int32))
        require(torch.equal(hits_by_inversion(nbrs, key), scatter),
                f"inverted histogram on the card, round {r}: differs "
                "from the scatter's")
    return "inverted histogram on the card == scatter's (4 keys)"


def phase_reference(torch):
    from gossipprotocol_tpu_torch.engine import RunConfig, run_simulation
    from gossipprotocol_tpu_torch.protocols.state import gossip_init
    from gossipprotocol_tpu_torch.topology import build_topology

    for name, argv in REF_CLI_RUNS.items():
        argv = argv + ["--device", "cuda", "--max-rounds", MAX_ROUNDS]
        seen, restore = _count_inverted(torch)
        try:
            rc, text, etext, counts = _run_cli(argv)
        finally:
            restore()
        for line in (etext + text).splitlines():
            say(f"(j) {name} | {line}")
        require(rc == 0, f"reference CLI run {name} exited {rc}: "
                f"{' '.join(argv)}")
        banner = "Gossip Starts" if "gossip" in argv else "Push Sum Starts"
        require(text.startswith(banner + "\n"), f"{name}: no banner")
        conv = re.search(r"Convergence Time: ([0-9.]+) ms", text)
        rounds = re.search(r"rounds: (\d+) \((\d+) executed\)", text)
        require(conv and rounds and "converged: True" in text,
                f"reference CLI run {name}: output lines missing")
        wall_ms, n_rounds = float(conv.group(1)), int(rounds.group(1))
        n_exec = int(rounds.group(2))
        note = ""
        if "push-sum" in argv:
            err = re.search(r"max \|s/w - mean\| = (\S+)", text)
            require(err and float(err.group(1)) <= 2e-4,
                    f"{name}: estimate error above 2e-4")
            note = f", estimate_error {err.group(1)}"
        else:
            note = (f", rounds on the inverted branch {seen['inverted']}, "
                    f"on the scatter branch {seen['scatter']}")
            require(seen["inverted"] == 0, f"{name}: the card took the "
                    "inverted branch")
        say(f"(j) {name}: rc 0, {n_rounds} rounds ({n_exec} executed), "
            f"{wall_ms:.3f} ms, {wall_ms / max(n_rounds, 1):.4f} ms/round, "
            f"{wall_ms / max(n_exec, 1):.4f} ms per executed round{note}")
    # the golden gossip counts, exact on the card
    for (gname, n), want in GOLDEN_GOSSIP.items():
        res = run_simulation(build_topology(gname, n, seed=11), RunConfig(
            algorithm="gossip", seed=42, device="cuda"))
        require(res.converged and res.rounds == want,
                f"golden gossip {gname} {n}: {res.rounds} rounds on the "
                f"card, golden {want}")
        say(f"(j) golden gossip {gname} {n}: {res.rounds} rounds == golden "
            f"{want}, {res.wall_ms:.3f} ms")
    # card against CPU, 32 rounds
    for gname, n, kw, cfg, saturated in (
            ("power_law", 1_000_000, {"seed": 0, "m": 4},
             dict(algorithm="gossip"), False),
            ("imp3D", 1_000_000, {"seed": 0}, dict(algorithm="gossip"),
             True),
            ("erdos_renyi", 1_000_000, {"seed": 5},
             dict(algorithm="push-sum", predicate="global", tol=1e-4),
             False)):
        topo = build_topology(gname, n, **kw)
        start = None
        if saturated:
            start = gossip_init(topo.num_nodes, 0, device="cpu")
            start = start._replace(counts=torch.ones_like(start.counts))
        res = {}
        seen, restore = _count_inverted(torch)
        try:
            for dev in ("cuda", "cpu"):
                t0 = time.perf_counter()
                res[dev] = run_simulation(topo, RunConfig(
                    device=dev, max_rounds=CARD_CPU_ROUNDS, chunk_rounds=8,
                    **cfg), initial_state=start)
                res[dev + "_s"] = time.perf_counter() - t0
        finally:
            restore()
        a, b = res["cuda"].final_state, res["cpu"].final_state
        require(res["cuda"].rounds == res["cpu"].rounds,
                f"card vs cpu {gname}: rounds {res['cuda'].rounds} vs "
                f"{res['cpu'].rounds}")
        if cfg.get("algorithm") == "gossip":
            bad = [f for f in a._fields if not torch.equal(
                getattr(a, f), getattr(b, f))]
            require(not bad, f"card vs cpu gossip {gname}: fields {bad} "
                    "differ")
            what = "bitwise (counts, converged, alive, round)"
            if saturated:
                require(seen["inverted"] >= CARD_CPU_ROUNDS - 8,
                        f"card vs cpu {gname}: the inverted branch ran "
                        f"{seen['inverted']} rounds on the cpu")
                what += (f", the cpu run {seen['inverted']} rounds on the "
                         "inverted branch, the card's on the scatter; "
                         + _inverted_hits_on_card(torch, topo))
        else:
            require(torch.equal(a.alive, b.alive), "scatter: alive differs")
            errs = {f: max_abs_err(torch, getattr(a, f), getattr(b, f))
                    for f in ("s", "w", "ratio")}
            require(errs["s"] <= SCATTER_TOL and errs["w"] <= SCATTER_TOL,
                    f"card vs cpu push-sum scatter {gname}: {errs} above "
                    f"{SCATTER_TOL}")
            bits = sum(int((getattr(a, f).view(torch.int32)
                            != getattr(b, f).view(torch.int32)).sum())
                       for f in ("s", "w"))
            what = (f"within {SCATTER_TOL} (max |diff| s {errs['s']:.3e}, "
                    f"w {errs['w']:.3e}, ratio {errs['ratio']:.3e}; {bits} "
                    "of the s and w values differ in some bit: atomic "
                    "accumulation order)")
        say(f"(j) card vs cpu {gname} {topo.num_nodes}, "
            f"{CARD_CPU_ROUNDS} rounds: {what}; card "
            f"{res['cuda'].wall_ms:.3f} ms, cpu {res['cpu'].wall_ms:.3f} ms "
            f"(host {res['cuda_s']:.1f} s / {res['cpu_s']:.1f} s with the "
            "build)")


# ---------------------------------------------------------------- (k)

# the JAX probes' default shapes (PERF.md §6 rows 13-20)
SLAB_T, SLAB_B, SLAB_CR = 512, 102, 1
RESIDENT_MB = (2, 4, 8, 12, 16)
GATHER_ROWS = (8, 256, 1024, 4096)
GATHER_COLS = (128, 512, 4096)
GRID_T = 8_000_000 // (4096 * 128)        # route_probe's T at --e 8000000
STREAM_ROWS, STREAM_TILE_ROWS = 64 * 2**20 // 512, 1024
PERM_T = 488
# phase (k)'s lane-gather inputs, kept for the bank-conflict replay
LANE_INPUTS = []


def probe_cases(torch, dev="cuda", rows=None):
    """``[(kernel, row, call, kern, plain, lib, lib_what, nbytes,
    exact)]`` at every default shape, inputs on ``dev``; ``exact`` a
    second reference the kernel must equal (row 20: the flattened
    permutation). ``rows``, if given, limits the cases built (and the
    inputs made) to those PERF.md rows."""
    import numpy as np

    from gossipprotocol_tpu_torch.ops import probes as pr
    from gossipprotocol_tpu_torch.probes.tile_perm_probe import (
        route_tile_perm_cached, tile_planes,
    )

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    def ints(hi, shape):
        return torch.from_numpy(rng.integers(0, hi, shape).astype(
            np.int32)).to(dev)

    def wanted(row):
        """Whether to build ``row``; each row draws from its own seed,
        so a case's inputs do not depend on which others are built."""
        nonlocal rng
        rng = np.random.default_rng(row)
        return rows is None or row in rows

    rng = None
    cases = []
    # the kernel reads and writes only the first B*CR rows of each tile;
    # slab_probe's GB/s line keeps the JAX count, a read of every row
    slab_bytes = 2 * SLAB_T * SLAB_B * SLAB_CR * 512
    for row, bm in ((13, True), (14, False)):
        if not wanted(row):
            continue
        x = randn(SLAB_T, 128, 128)
        y = torch.empty(SLAB_T, SLAB_B * SLAB_CR, 128, device=dev)
        cases.append((
            "probe_slab", row, "bucket-major" if bm else "tile-major",
            lambda x=x, bm=bm: pr.probe_slab(x, SLAB_B, SLAB_CR, bm),
            lambda x=x, bm=bm: pr.probe_slab_plain(x, SLAB_B, SLAB_CR, bm),
            (lambda x=x: (x[:, :SLAB_B * SLAB_CR] * 2).view(
                SLAB_T, SLAB_B, SLAB_CR, 128).transpose(0, 1).contiguous())
            if bm else
            (lambda x=x, y=y: torch.mul(x[:, :SLAB_B * SLAB_CR], 2, out=y)),
            "mul then transpose(0, 1).contiguous()" if bm
            else "torch.mul(x[:, :B*CR], 2, out=y)", slab_bytes, None))
    for mb in RESIDENT_MB if wanted(15) else ():
        xb = randn(mb * 2**20 // 512, 128)
        yb = torch.empty_like(xb)
        cases.append(("probe_scale2", 15, f"{mb} MB one tile",
                      lambda xb=xb: pr.probe_scale2(xb),
                      lambda xb=xb: pr.probe_scale2_plain(xb),
                      lambda xb=xb, yb=yb: torch.mul(xb, 2, out=yb),
                      "torch.mul(x, 2, out=y)", 2 * xb.numel() * 4, None))
    for n in GATHER_ROWS if wanted(16) else ():
        xg, ig = randn(n, 128), ints(n, (n, 128))
        ig64 = ig.long()
        cases.append(("probe_gather_rows", 16, f"rows={n}",
                      lambda xg=xg, ig=ig: pr.probe_gather_rows(xg, ig),
                      lambda xg=xg, ig=ig: pr.probe_gather_rows_plain(xg, ig),
                      lambda xg=xg, ig=ig64: torch.gather(xg, 0, ig),
                      "torch.gather(x, 0, idx)", n * 128 * 12, None))
    for cols in GATHER_COLS if wanted(17) else ():
        xg, ig = randn(128, cols), ints(cols, (128, cols))
        if rows is None:
            LANE_INPUTS.append((xg, ig, 17, f"[128, {cols}]"))
        ig64 = ig.long()
        cases.append(("probe_gather_lanes", 17, f"[128, {cols}]",
                      lambda xg=xg, ig=ig: pr.probe_gather_lanes(xg, ig),
                      lambda xg=xg, ig=ig: pr.probe_gather_lanes_plain(xg,
                                                                       ig),
                      lambda xg=xg, ig=ig64: torch.gather(xg, 1, ig),
                      "torch.gather(x, 1, idx)", 128 * cols * 12, None))
    if wanted(18):
        xt, it = randn(GRID_T, 4096, 128), ints(128, (GRID_T, 4096, 128))
        if rows is None:
            LANE_INPUTS.append((xt, it, 18, f"[{GRID_T}, 4096, 128]"))
        it64 = it.long()
        cases.append(("probe_gather_lanes", 18,
                      f"[{GRID_T}, 4096, 128] tiled",
                      lambda: pr.probe_gather_lanes(xt, it),
                      lambda: pr.probe_gather_lanes_plain(xt, it),
                      lambda: torch.gather(xt, 2, it64),
                      "torch.gather(x, 2, idx)", xt.numel() * 12, None))
    if wanted(19):
        xs = randn(STREAM_ROWS, 128)
        ys = torch.empty_like(xs)
        cases.append(("probe_scale2", 19, "64 MiB in 1,024-row tiles",
                      lambda: pr.probe_scale2(xs, STREAM_TILE_ROWS),
                      lambda: pr.probe_scale2_plain(xs),
                      lambda: torch.mul(xs, 2, out=ys),
                      "torch.mul(x, 2, out=y)", 2 * xs.numel() * 4, None))
    if wanted(20):
        perm = np.random.default_rng(0).permutation(128 * 128)
        (planes, route_s) = route_tile_perm_cached(perm)
        say(f"(k) tile permutation routed on the host in {route_s:.1f} s "
            "(pure-Python matchings, once per process)")
        xp = randn(PERM_T, 128, 128)
        i1, i2, i3 = tile_planes(planes, PERM_T, dev)
        perm_t = torch.from_numpy(perm).to(dev)
        flat = xp.view(PERM_T, -1)
        cases.append(("probe_tile_perm", 20, f"[{PERM_T}, 128, 128]",
                      lambda: pr.probe_tile_perm(xp, i1, i2, i3),
                      lambda: pr.probe_tile_perm_plain(xp, i1, i2, i3),
                      lambda: flat.index_select(1, perm_t),
                      "x.view(T, -1).index_select(1, perm)",
                      xp.numel() * 11,
                      lambda: flat[:, perm_t].view(PERM_T, 128, 128)))
    return cases


def probe_geometry(name, t):
    """The launch geometry the wrapper picks for the output ``t`` of
    ``name`` (rows 15, 16, 19): ``ops/probes.py`` ``scale2_geometry`` /
    ``gather_rows_geometry``."""
    from gossipprotocol_tpu_torch.ops import probes as pr

    sms, l2 = pr._card(t.device.index)
    if name == "probe_scale2":
        blocks, stream = pr.scale2_geometry(t.numel() // 4, sms, l2)
        return (f"flat, {blocks} blocks of {pr.SCALE2_THREADS} threads, "
                + ("streamed (evict-first loads)" if stream
                   else "L2-resident (grid-stride)")
                + f", on {sms} SMs and {l2 / 2**20:g} MiB of L2")
    if name == "probe_gather_lanes":
        cols = t.shape[-1]
        rows = t.numel() // cols
        rpb, threads, staged = pr.gather_lanes_geometry(
            rows, cols, sms, pr._smem_optin(t.device.index))
        return (f"{-(-rows // rpb)} blocks of {threads} threads, {rpb} "
                f"row(s) of {cols} lanes a block, "
                + (f"staged in {rpb * cols * 4} bytes of shared memory"
                   if staged else "read in place (the direct branch)"))
    chunk = pr.gather_rows_geometry(t.shape[0], sms)
    return (f"{pr.GATHER_BANDS} bands of 16 columns x "
            f"{-(-t.shape[0] // chunk)} chunks of {chunk} rows")


def expand_geometry(out):
    """The launch geometry ``class_expand_big`` picks for its output
    ``out`` (row 6): ``ops/classops.py`` ``expand_big_geometry``."""
    from gossipprotocol_tpu_torch.ops import classops as co

    n4 = out.numel() // 4
    blocks = co.expand_big_geometry(n4, co._sms(out.device.index))
    steps = -(-n4 // (blocks * co.EXPAND_BIG_THREADS))
    return (f"{blocks} blocks of {co.EXPAND_BIG_THREADS} threads, "
            f"{steps} float4 store(s) a thread at most, evict-first")


def lane_wavefronts(x, idx):
    """Shared-memory wavefronts of row 17/18's staged gather on ``idx``
    at the geometry the wrapper picks (host replay,
    ``route_probe.lane_gather_wavefronts``); None where the rows are read
    in place."""
    from gossipprotocol_tpu_torch.ops import probes as pr
    from gossipprotocol_tpu_torch.probes.route_probe import (
        lane_gather_wavefronts,
    )

    cols = x.shape[-1]
    rpb, threads, staged = pr.gather_lanes_geometry(
        x.numel() // cols, cols, pr._card(x.device.index)[0],
        pr._smem_optin(x.device.index))
    return (lane_gather_wavefronts(idx.cpu().numpy(), rpb, threads)
            if staged else None)


def perm_wavefronts():
    """Shared-memory wavefronts a tile of row 20's pick on the probe's
    routed tile (the host replay): the kept layout, idx2 row-major, and
    the transpose."""
    import numpy as np

    from gossipprotocol_tpu_torch.probes.tile_perm_probe import (
        pick_wavefronts, route_tile_perm_cached, transpose_wavefronts,
    )

    planes, _ = route_tile_perm_cached(
        np.random.default_rng(0).permutation(128 * 128))
    return {"picks": pick_wavefronts(*planes)["total"],
            "picks_row_major": pick_wavefronts(
                *planes, transposed=False)["total"],
            "transpose": transpose_wavefronts()}


# rows 15, 16, 17, 19 and 6 against their library calls: rounds of
# CUDA-graph replays, kernel and call in turns
ALTERNATE_ROWS = (15, 16, 17, 19)
ALTERNATE_ROUNDS = 6
# row 6's two hub classes of power_law 1M: (c, node slots)
HUB_EXPAND_CLASSES = ((512, 1024), (131_072, 8))


def hub_expand_cases(torch):
    """``[(name, row, call, kern, plain, lib, lib_what)]`` of
    ``class_expand_big`` at ``HUB_EXPAND_CLASSES``, from seeded random
    pairs (the copy moves bytes whatever their values)."""
    from gossipprotocol_tpu_torch.ops import classops as co

    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = []
    for c, cap in HUB_EXPAND_CLASSES:
        q = 2 * c // co.LANES
        p = torch.randn(2 * cap, device="cuda", generator=gen)
        cases.append((
            "class_expand_big", 6, f"c={c} cap={cap}",
            lambda p=p, c=c: co.class_expand_big(p, c),
            lambda p=p, c=c: co.class_expand_big_plain(p, c),
            lambda p=p, cap=cap, q=q: p.view(cap, 1, 2).expand(
                cap, q * 64, 2).contiguous(),
            "view(n_c,1,2).expand(n_c,q*64,2).contiguous()"))
    return cases


def _spread(ms):
    ms = sorted(ms)
    return ms[len(ms) // 2], ms[0], ms[-1]


def alternate_small_calls(torch):
    """Rows 15, 16, 17, 19 and 6 re-timed finely enough to decide whether a
    kernel loses to its library call: ``ALTERNATE_ROUNDS`` rounds of
    graph replays, kernel then call and call then kernel in turns, ms to
    5 decimals as median [least; largest]. A kernel loses only where its
    least time lies above the call's largest. Beside them the launch
    floor: an empty kernel's graph replay (``torch.cuda._sleep(0)``)."""
    from gossipprotocol_tpu_torch.probes import seconds_per_call

    dev = torch.device("cuda")
    g = lambda fn: seconds_per_call(fn, dev) * 1e3  # noqa: E731
    cases = probe_cases(torch, rows=ALTERNATE_ROWS) + hub_expand_cases(torch)
    floor = [g(lambda: torch.cuda._sleep(0))
             for _ in range(ALTERNATE_ROUNDS)]
    say("(k) launch floor, an empty kernel by graph replay: "
        "%.5f [%.5f; %.5f] ms" % _spread(floor))
    for name, row, call, kern, _, lib, lib_what, *_ in cases:
        ks, ls = [], []
        for rnd in range(ALTERNATE_ROUNDS):
            pair = ((ks, kern), (ls, lib))
            for out, fn in (pair if rnd % 2 == 0 else pair[::-1]):
                out.append(g(fn))
        km, kl, kh = _spread(ks)
        lm, ll, lh = _spread(ls)
        verdict = ("kernel slower beyond the spread" if kl > lh else
                   "call slower beyond the spread" if ll > kh else
                   "within the spread")
        say(f"(k) row {row} {name} {call}: kernel {km:.5f} [{kl:.5f}; "
            f"{kh:.5f}] ms, {lib_what} {lm:.5f} [{ll:.5f}; {lh:.5f}] ms "
            f"by graph over {ALTERNATE_ROUNDS} rounds: {verdict}")
    del cases
    torch.cuda.empty_cache()


def phase_probes(torch):
    """Phase (k): the probes' kernels at the JAX probes' default shapes,
    then the three probe entry points in process."""
    from gossipprotocol_tpu_torch.ops import (
        kernel_launches, reset_kernel_launches,
    )
    from gossipprotocol_tpu_torch.probes import (
        route_probe, seconds_per_call, slab_probe, tile_perm_probe,
    )

    cases = probe_cases(torch)
    reset_kernel_launches()
    firsts = [case[3]() for case in cases]
    launches = kernel_launches()
    counts = {k: launches[k] for k in PROBE_KERNELS}
    records = []
    stream = None
    for (name, row, call, kern, plain, lib, lib_what, nbytes, exact), got \
            in zip(cases, firsts):
        want = plain()
        err = max_abs_err(torch, got, want)
        require(bitwise_equal(torch, got, want),
                f"{name} (row {row}, {call}) differs from its plain "
                f"version: max abs err {err}")
        if exact is not None:
            require(torch.equal(got, exact()), f"{name} (row {row}): not "
                    "the permutation x.view(T, -1)[:, perm]")
        lib_out = lib()
        lib_same = (lib_out.numel() == got.numel() and bool(torch.equal(
            lib_out.reshape(-1), got.reshape(-1))))
        ms = cuda_ms(torch, kern, 20)
        # device time: the probes' timing, R calls captured once into a
        # CUDA graph, the best of three replays
        g_ms = seconds_per_call(kern, torch.device("cuda")) * 1e3
        plain_ms = cuda_ms(torch, plain, 5)
        lib_ms = cuda_ms(torch, lib, 20)
        # the library call's device time alike, so that kernel and call
        # compare without the host's enqueue on either side
        lib_g_ms = seconds_per_call(lib, torch.device("cuda")) * 1e3
        b_ms, b_by = bound(nbytes, 0)
        extra = {}
        if name in ("probe_scale2", "probe_gather_rows",
                    "probe_gather_lanes"):
            say(f"(k) row {row} {name} {call}: kept design "
                f"{probe_geometry(name, got)}, {g_ms:.5f} ms by graph")
        if name == "probe_gather_rows" and got.shape[0] == GATHER_ROWS[-1]:
            # as many reads, in the resident gather's [tiles, 8, 128] shape
            extra["bound_l2_ms"] = l2_ceiling(
                torch, (got.numel() // 1024, 8, 128), "k")
        if row == 19:
            # the ceiling is the best graph-replay rate of the kernel and
            # two library streams over the same 64 MiB, so that row 19 is
            # not held to a ceiling it set alone
            dst = torch.empty_like(got)
            rates = {
                "probe_scale2": g_ms * 1e-3,
                lib_what: lib_g_ms * 1e-3,
                "y.copy_(x)": seconds_per_call(lambda: dst.copy_(got),
                                               got.device)}
            for what, secs in rates.items():
                say(f"(k) stream 64 MiB by graph replay, {what}: "
                    f"{secs * 1e3:.4f} ms, {nbytes / secs / 1e12:.4f} TB/s")
            stream = max((nbytes / secs, what) for what, secs in rates.items())
            del dst
        records.append(dict(
            name=name, graph=f"row {row}", call=call, shape=list(got.shape),
            max_abs_err=err, ms=ms, graph_ms=g_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library_graph_ms=lib_g_ms, bytes=nbytes, row=row, **extra))
        say(f"(k) row {row} {name:18s} {call}: bitwise ok, {ms:.4f} ms "
            f"back to back, {g_ms:.4f} ms graph replay "
            f"({nbytes / g_ms / 1e6:.1f} GB/s), plain {plain_ms:.4f}, "
            f"library {lib_what} {lib_ms:.4f} back to back, {lib_g_ms:.4f} "
            f"graph (same values: {lib_same}), bound {b_ms:.4f} by {b_by}, "
            f"{nbytes / 1e6:.2f} MB)")
    for xg, ig, row, call in LANE_INPUTS:
        wf = lane_wavefronts(xg, ig)
        if wf is None:
            say(f"(k) row {row} probe_gather_lanes {call}: read in place, "
                "no shared memory")
            continue
        say(f"(k) row {row} probe_gather_lanes {call}: {wf['wavefronts']} "
            f"shared-memory wavefronts over {wf['requests']} warp "
            f"requests, {wf['wavefronts'] / wf['requests']:.3f} a request "
            "(1: conflict-free; host replay, "
            "route_probe.lane_gather_wavefronts)")
    LANE_INPUTS.clear()
    del cases, firsts
    torch.cuda.empty_cache()
    require(stream, "row 19 (the stream copy) was not measured")
    stream_rate, stream_by = stream
    say(f"(k) measured stream ceiling (64 MiB, graph replay, set by "
        f"{stream_by}): {stream_rate / 1e12:.4f} TB/s = "
        f"{stream_rate / HBM_BYTES_PER_S:.4f} of the nominal "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    say(f"(k) launches {counts} ({NO_CLI_PATH_PROBES})")
    wf = perm_wavefronts()
    say(f"(k) row 20 pick layout: idx2 staged transposed, {wf['picks']} "
        f"shared-memory wavefronts a tile ({wf['picks_row_major']} with "
        f"idx2 row-major) + {wf['transpose']} for the transpose "
        "(host replay, tile_perm_probe.pick_wavefronts)")
    for r in records:
        if r["row"] == 20:
            r["wavefronts"] = wf
    alternate_small_calls(torch)
    for mod in (slab_probe, route_probe, tile_perm_probe):
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main([])
        name = mod.__name__.rsplit(".", 1)[1]
        for line in buf.getvalue().splitlines():
            say(f"(k) {name} | {line}")
        require(rc == 0, f"python -m gossipprotocol_tpu_torch.probes."
                f"{name} exited {rc}")
        say(f"(k) {name}: exit 0 in {time.perf_counter() - t1:.1f} s")
    return records, counts, stream_rate


# ------------------------------------------------- tree against tree

# rows that slice_times times at phase (k)'s shapes besides 12 and 20
# (and row 6 at HUB_EXPAND_CLASSES)
SLICE_PROBE_ROWS = (15, 16, 17, 18, 19)


def slice_times(torch, rounds=3):
    """Rows 12, 15-20 and 6 through their wrappers, by CUDA-graph
    replay (the wrapper's host work is not captured): ``pallas_exchange``
    on both schedules at phase (h)'s power_law 400,000 slab shape (random
    slabs: the copy moves bytes) at every wire and the int8 wire's [S, 1]
    scales, the tile permutation on phase (k)'s 488 routed tiles, the x2
    copy, the row and lane gathers at every phase (k) shape and the hub
    expand at ``HUB_EXPAND_CLASSES``, each checked first and each beside
    its library call.
    Times whatever ``gossipprotocol_tpu_torch`` is first on ``sys.path``,
    so one call can hold a parent tree against this one, in turns."""
    import numpy as np

    from gossipprotocol_tpu_torch.ops import pallasdelivery as pdm
    from gossipprotocol_tpu_torch.ops import probes as pr
    from gossipprotocol_tpu_torch.probes import seconds_per_call
    from gossipprotocol_tpu_torch.probes.tile_perm_probe import (
        route_tile_perm_cached, tile_planes,
    )

    dev = torch.device("cuda")
    say(f"(t) timing the package at {os.path.dirname(os.path.dirname(pr.__file__))}")
    g = lambda fn: seconds_per_call(fn, dev) * 1e3  # noqa: E731
    gen = torch.Generator(device=dev).manual_seed(0)
    f32 = [torch.randn(SHARDS, 667_008, device=dev, generator=gen)
           for _ in range(SHARDS)]
    wires = {"f32": f32, "bf16": [t.to(torch.bfloat16) for t in f32],
             "int8": [(t * 40).to(torch.int8) for t in f32],
             "int8-scales": [t[:, :1].contiguous() for t in f32]}
    for wire, slabs in wires.items():
        stacked = torch.stack(slabs)
        for overlap in (False, True):
            got = pdm.pallas_exchange(slabs, overlap=overlap)
            want = pdm.exchange_plain(slabs)
            require(all(torch.equal(a.view(torch.int8), b.view(torch.int8))
                        for a, b in zip(got, want)),
                    f"pallas_exchange {wire} overlap {overlap} wrong")
            ms = [g(lambda: pdm.pallas_exchange(slabs, overlap=overlap))
                  for _ in range(rounds)]
            lib = [g(lambda: stacked.transpose(0, 1).contiguous())
                   for _ in range(rounds)]
            say(f"(t) pallas_exchange {wire} "
                f"{'ring' if overlap else 'all'} [{SHARDS}, {SHARDS}, "
                f"{slabs[0].shape[1]}]: "
                f"{' '.join('%.5f' % m for m in ms)} ms by graph; "
                f"library {' '.join('%.5f' % m for m in lib)}")
        del stacked
    del f32, wires
    perm = np.random.default_rng(0).permutation(128 * 128)
    planes, _ = route_tile_perm_cached(perm)
    x = torch.randn(PERM_T, 128, 128, device=dev, generator=gen)
    i1, i2, i3 = tile_planes(planes, PERM_T, dev)
    flat = x.view(PERM_T, -1)
    perm_t = torch.from_numpy(perm).to(dev)
    want = flat[:, perm_t].view(PERM_T, 128, 128)
    got = pr.probe_tile_perm(x, i1, i2, i3)
    require(torch.equal(got, want) and bitwise_equal(
        torch, got, pr.probe_tile_perm_plain(x, i1, i2, i3)),
        "probe_tile_perm wrong")
    ms = [g(lambda: pr.probe_tile_perm(x, i1, i2, i3)) for _ in range(rounds)]
    say(f"(t) probe_tile_perm [{PERM_T}, 128, 128]: "
        f"{' '.join('%.5f' % m for m in ms)} ms by graph")
    lib = [g(lambda: flat.index_select(1, perm_t)) for _ in range(rounds)]
    say(f"(t) x.view(T, -1).index_select(1, perm): "
        f"{' '.join('%.5f' % m for m in lib)} ms by graph")
    del x, i1, i2, i3, flat, want, got
    for name, row, call, kern, plain, lib_fn, lib_what, *_ in probe_cases(
            torch, rows=SLICE_PROBE_ROWS) + hub_expand_cases(torch):
        require(bitwise_equal(torch, kern(), plain()),
                f"{name} (row {row}, {call}) wrong")
        ms = [g(kern) for _ in range(rounds)]
        lib = [g(lib_fn) for _ in range(rounds)]
        say(f"(t) row {row} {name} {call}: "
            f"{' '.join('%.5f' % m for m in ms)} ms by graph; {lib_what} "
            f"{' '.join('%.5f' % m for m in lib)}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- (l)

REF_SEM_SIZES = (100, 500, 1000)
REF_SEM_TOPOLOGIES = ("line", "full", "3D", "imp3D")
# (topology, nodes, algorithm) left out of (l): the line walk at 1,000
# nodes does not converge within the default 1,000,000 hops in the JAX
# package either
REF_SEM_SKIP = {("line", 1000, "push-sum")}
REF_GOSSIP_1M = ["1000000", "imp3D", "gossip", "--semantics", "reference"]
# the walk kernel against its plain chunk: one chunk of WALK_CHECK_HOPS
# hops from the initial state on each neighbour layout at 1M nodes
WALK_CHECK_GRAPHS = {
    "imp3D_1M": (1_000_000, "imp3D", {"seed": 0}),           # dense table
    "power_law_1M": (1_000_000, "power_law", {"seed": 0, "m": 4}),  # CSR
    "full_1M": (1_000_000, "full", {}),                       # implicit
}
WALK_CHECK_HOPS = 4096
WALK_MAIN_GRAPH = "imp3D_1M"   # the kernels line's shape
# the walk through the CLI to convergence (the JAX package's oracle, seed
# 17: ~5.2M hops at imp3D 262,144, ~2.1e7 at 1M), and the chunk sweep
WALK_CLI_262144 = ["262144", "imp3D", "push-sum", "--semantics",
                   "reference", "--max-rounds", "50000000"]
WALK_CHUNKS = (256, 1024, 4096, 16384, 65536)
WALK_CLI_1M = ["1000000", "imp3D", "push-sum", "--semantics", "reference"]
WALK_1M_HOPS = 2.1e7
WALK_1M_BUDGET_S = 60.0
# the dependent-load chain behind the walk's floor: a pointer chase
# through uniformly random cycles of these sizes (L2-resident)
CHASE_BYTES = (4 << 20, 32 << 20)
CHASE_STEPS = 1_000_000


def _capture_results():
    """Wrap the engine's run_simulation to keep each run's RunResult;
    returns (list, restore)."""
    from gossipprotocol_tpu_torch.engine import driver as drv

    got = []
    orig = drv.run_simulation

    def kept(*args, **kwargs):
        res = orig(*args, **kwargs)
        got.append(res)
        return res

    drv.run_simulation = kept
    return got, lambda: setattr(drv, "run_simulation", orig)


def _ref_cli(argv):
    """``(rc, stdout, RunResult)`` of one in-process reference CLI run."""
    got, restore = _capture_results()
    try:
        rc, text, etext, counts = _run_cli(argv)
    finally:
        restore()
    require(len(got) == 1, f"{' '.join(argv)}: {len(got)} engine runs")
    return rc, text, etext, counts, got[0]


def _walk_counts_ok(counts, walk):
    """Only the walk kernel launched (at least once) when ``walk``, and
    nothing at all otherwise."""
    others = {k: v for k, v in counts.items() if k != "walk_chunk" and v}
    return not others and ((counts["walk_chunk"] > 0) == walk)


def pointer_chase_ns(torch, nbytes):
    """ns per dependent load, following one uniformly random cycle
    through ``nbytes`` of int32 (warmed into L2 by a full pass first)."""
    from gossipprotocol_tpu_torch.ops import walk as ow

    m = nbytes // 4
    perm = torch.randperm(m, generator=torch.Generator().manual_seed(0))
    nxt = torch.empty(m, dtype=torch.int32)
    nxt[perm] = perm.roll(-1).to(torch.int32)
    nxt = nxt.cuda()
    ow.pointer_chase(nxt, m)
    ms = cuda_ms(torch, lambda: ow.pointer_chase(nxt, CHASE_STEPS), 3,
                 warmup=1)
    return ms * 1e6 / CHASE_STEPS


def walk_kernel_checks(torch, chase_ns):
    """The walk kernel against its plain chunk on the card at 1M nodes on
    each layout: one chunk from the initial state, bitwise in every field
    and the settled count; the kernel's time per launch (CUDA events, a
    fresh copy of the state each launch) and the plain chunk's."""
    from gossipprotocol_tpu_torch.ops import walk as ow
    from gossipprotocol_tpu_torch.protocols import sampling as ts
    from gossipprotocol_tpu_torch.protocols import walk as tw
    from gossipprotocol_tpu_torch.topology import build_topology

    records = []
    for gname, (n, kind, kw) in WALK_CHECK_GRAPHS.items():
        topo = build_topology(kind, n, **kw)
        nbrs = ts.device_topology(topo, device="cuda")
        lay = ow.walk_layout(nbrs, n)
        key = ts.key_data(0, "cuda")
        st = tw.pushsum_walk_init(n, 0, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = tw.walk_chunk_plain(tw.WalkDraws(nbrs, n, key.device), st, key,
                                   WALK_CHECK_HOPS, n, 3)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        copies = [type(st)(*(t.clone() for t in st)) for _ in range(6)]
        torch.cuda.synchronize()
        settled = ow.walk_chunk(lay, copies[0], key, WALK_CHECK_HOPS, n, 3)
        got = copies[0]
        bad = [f for f in got._fields
               if not bitwise_equal(torch, getattr(got, f).reshape(-1),
                                    getattr(want, f).reshape(-1))]
        require(not bad, f"(l) walk kernel {gname}: fields {bad} differ "
                f"from the plain chunk")
        want_settled = int(torch.sum(want.converged | ~want.alive))
        require(int(settled) == want_settled, f"(l) walk kernel {gname}: "
                f"settled {int(settled)} against {want_settled}")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(10)]
        for i, c in enumerate(copies[1:]):
            ev[2 * i].record()
            ow.walk_chunk(lay, c, key, WALK_CHECK_HOPS, n, 3)
            ev[2 * i + 1].record()
        torch.cuda.synchronize()
        ms = min(ev[2 * i].elapsed_time(ev[2 * i + 1]) for i in range(5))
        hops = int(got.round) - int(st.round)
        # a hop's loads and stores: the holder's degree (and CSR start)
        # and table entry, the receiver's s, w, streak, converged read and
        # s, w, ratio, streak written (the non-relay rule); and its five
        # threefry hashes (~110 integer operations each) and the draw
        per_hop = {ow.LAYOUT_FULL: 0, ow.LAYOUT_DENSE: 8,
                   ow.LAYOUT_CSR: 16}[lay.layout] + 13 + 16
        nbytes, ops = hops * per_hop, hops * (5 * 110 + 80)
        b_ms, b_by = bound(nbytes, ops)
        floor_ms = hops * 3 * chase_ns * 1e-6
        records.append(dict(
            name="walk_chunk", graph=gname, call=f"{WALK_CHECK_HOPS} hops",
            shape=[n, hops], max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, bytes=nbytes, latency_floor_ms=floor_ms,
            ms_per_hop=ms / hops, plain_ms_per_hop=plain_ms / hops))
        say(f"(l) walk kernel {gname} ({['full', 'dense', 'CSR'][lay.layout]}"
            f"), one chunk of {WALK_CHECK_HOPS} hops from the start "
            f"({hops} run, {int(settled)} settled): bitwise the plain "
            f"chunk in every field; kernel {ms:.4f} ms "
            f"({ms / hops * 1e3:.4f} us a hop), plain {plain_ms:.1f} ms "
            f"({plain_ms / hops:.4f} ms a hop), floor {floor_ms:.4f} ms "
            f"(3 x {chase_ns:.1f} ns a hop), bound {b_ms:.6f} ms "
            f"({b_by}); library: none (no PyTorch call walks)")
        del nbrs, lay, copies, want, got
        torch.cuda.empty_cache()
    return records


def phase_reference_semantics(torch):
    """Phase (l); returns the walk kernel's records and its launches on
    the phase's CLI runs on the card."""
    chase = {b: pointer_chase_ns(torch, b) for b in CHASE_BYTES}
    for b, ns in chase.items():
        say(f"(l) pointer chase through {b >> 20} MB of int32 (one random "
            f"cycle, L2-resident): {ns:.1f} ns a dependent load")
    chase_ns = min(chase.values())
    records = walk_kernel_checks(torch, chase_ns)
    walk_launches = 0
    per = {"gossip": [0.0, 0, 0], "push-sum": [0.0, 0, 0]}
    for topo in REF_SEM_TOPOLOGIES:
        for n in REF_SEM_SIZES:
            for algo in ("gossip", "push-sum"):
                if (topo, n, algo) in REF_SEM_SKIP:
                    continue
                argv = [str(n), topo, algo, "--semantics", "reference"]
                res = {}
                for dev in ("cuda", "cpu"):
                    rc, text, etext, counts, r = _ref_cli(
                        argv + ["--device", dev])
                    require(rc == 0 and r.converged,
                            f"(l) {' '.join(argv)} on {dev}: exit {rc}: "
                            f"{etext.strip()}")
                    walk = dev == "cuda" and algo == "push-sum"
                    require(_walk_counts_ok(counts, walk),
                            f"(l) {' '.join(argv)} on {dev}: kernels "
                            f"launched {counts}")
                    walk_launches += counts["walk_chunk"] if walk else 0
                    res[dev] = (text, r, counts["walk_chunk"])
                text, a, launches = res["cuda"]
                b = res["cpu"][1]
                require(a.rounds == b.rounds, f"(l) {' '.join(argv)}: "
                        f"{a.rounds} rounds on the card, {b.rounds} on cpu")
                bad = [f for f in a.final_state._fields
                       if not bitwise_equal(torch, getattr(a.final_state, f),
                                            getattr(b.final_state, f))]
                require(not bad, f"(l) {' '.join(argv)}: card against cpu, "
                        f"fields {bad} differ")
                per[algo][0] += a.wall_ms
                per[algo][1] += a.rounds_executed
                per[algo][2] += a.rounds
                note = text.splitlines()[0] if text.startswith("note") \
                    else ""
                est = re.search(r"max \|s/w - mean\| = (\S+)", text)
                unit = "hops" if algo == "push-sum" else "rounds"
                say(f"(l) {' '.join(argv)}: rc 0, {a.rounds} {unit} "
                    f"({a.rounds_executed} executed), card {a.wall_ms:.3f} "
                    f"ms ({a.wall_ms / max(a.rounds, 1):.5f} ms a "
                    f"{unit[:-1]}"
                    + (f", {launches} walk launches" if launches else "")
                    + f"), cpu {b.wall_ms:.3f} ms; card == cpu: counts "
                    f"equal, state bitwise"
                    + (f"; estimate error {est.group(1)}" if est else "")
                    + (f" [{note}]" if note else ""))
    for algo, (ms, executed, rounds) in per.items():
        say(f"(l) {algo} on the card, all runs above: {ms:.1f} ms over "
            f"{rounds} {'hops' if algo == 'push-sum' else 'rounds'} "
            f"({executed} executed) = {ms / max(rounds, 1):.5f} ms each")
    # the walk at imp3D 262,144 to convergence, over the chunk sweep
    sweep = {}
    for chunk in WALK_CHUNKS:
        argv = WALK_CLI_262144 + ["--chunk-rounds", str(chunk),
                                  "--device", "cuda"]
        rc, text, etext, counts, r = _ref_cli(argv)
        require(rc == 0 and r.converged and _walk_counts_ok(counts, True),
                f"(l) {' '.join(argv)}: exit {rc}, launches {counts}: "
                f"{etext.strip()[-300:]}")
        walk_launches += counts["walk_chunk"]
        sweep[chunk] = r
        say(f"(l) walk imp3D 262,144 --chunk-rounds {chunk}: rc 0, "
            f"{r.rounds} hops in {r.wall_ms:.1f} ms = "
            f"{r.wall_ms / r.rounds * 1e3:.4f} us a hop, "
            f"{counts['walk_chunk']} launches (one a chunk, the warm-up's "
            f"included)")
    first = sweep[WALK_CHUNKS[0]]
    for chunk, r in sweep.items():
        require(r.rounds == first.rounds and all(
            bitwise_equal(torch, x, y) for x, y in zip(
                r.final_state, first.final_state)),
            f"(l) walk imp3D 262,144: chunk {chunk} ends elsewhere than "
            f"chunk {WALK_CHUNKS[0]}")
    from gossipprotocol_tpu_torch.engine.driver import WALK_CHUNK_HOPS

    us_hop = sweep[WALK_CHUNK_HOPS].wall_ms / first.rounds * 1e3
    say(f"(l) walk imp3D 262,144: every chunk size ends in the same "
        f"{first.rounds} hops and state; the default chunk "
        f"({WALK_CHUNK_HOPS}) {us_hop:.4f} us a hop")
    # imp3D 1M: to convergence if that fits the budget at this rate
    predicted = us_hop * 1e-6 * WALK_1M_HOPS
    if predicted <= WALK_1M_BUDGET_S:
        argv, want_rc = WALK_CLI_1M + ["--max-rounds", "200000000"], 0
        say(f"(l) walk imp3D 1M: {us_hop:.4f} us x {WALK_1M_HOPS:.2g} hops "
            f"= {predicted:.1f} s <= {WALK_1M_BUDGET_S:.0f} s: to "
            f"convergence")
    else:
        cap = int(WALK_1M_BUDGET_S / (us_hop * 1e-6))
        argv, want_rc = WALK_CLI_1M + ["--max-rounds", str(cap)], 1
        say(f"(l) walk imp3D 1M: {us_hop:.4f} us x {WALK_1M_HOPS:.2g} hops "
            f"= {predicted:.1f} s > {WALK_1M_BUDGET_S:.0f} s: capped at "
            f"{cap} hops (exit 1 expected)")
    rc, text, etext, counts, r = _ref_cli(argv + ["--device", "cuda"])
    require(rc == want_rc and _walk_counts_ok(counts, True),
            f"(l) {' '.join(argv)}: exit {rc} (expected {want_rc}), "
            f"launches {counts}")
    walk_launches += counts["walk_chunk"]
    say(f"(l) walk imp3D 1M: rc {rc}, {r.rounds} hops in {r.wall_ms:.1f} "
        f"ms = {r.wall_ms / max(r.rounds, 1) * 1e3:.4f} us a hop, "
        f"{counts['walk_chunk']} launches, converged {r.converged}")
    rc, text, etext, counts, r = _ref_cli(REF_GOSSIP_1M + ["--device",
                                                           "cuda"])
    for line in (etext + text).splitlines():
        say(f"(l) gossip imp3D_1M reference | {line}")
    require(rc == 0 and r.converged, f"(l) {' '.join(REF_GOSSIP_1M)} exited "
            f"{rc}")
    say(f"(l) reference gossip imp3D 1M: {r.rounds} rounds "
        f"({r.rounds_executed} executed), {r.wall_ms:.3f} ms, "
        f"{r.wall_ms / max(r.rounds_executed, 1):.4f} ms per executed "
        f"round, {r.num_nodes} rows (the isolated extra actor included)")
    say(f"(l) walk kernel launches on the phase's card runs: "
        f"{walk_launches}")
    return records, walk_launches


# ---------------------------------------------------------------- (m)

# --check at 1M nodes for the seven families (the CLI's default builder
# arguments)
CHECK_FAMILIES = ("line", "full", "3D", "imp3D", "erdos_renyi", "power_law",
                  "small_world")
# the curve tools over the Report grid (100-1,000 nodes x line, full, 3D,
# imp3D x gossip, push-sum), --repeats 1: (label, argv, rows). Reference
# gossip on the full graph (keep-alive off, every node to converge)
# livelocks to the tool's 500,000-round cap in both packages (the last
# spreader never hears again; the JAX tool on the CPU prints 500000 rounds
# at every size), which at ~3 ms a drawing round is ~25 minutes a point:
# those five points are left out
CURVE_RUNS = (
    ("intended", [], 40),
    ("reference walk", ["--semantics", "reference", "--algorithms",
                        "push-sum"], 20),
    ("reference gossip", ["--semantics", "reference", "--algorithms",
                          "gossip", "--topologies", "line,3D,imp3D"], 15),
)
# the 10M builds, native against numpy. The numpy builds take minutes, so
# each runs in a process of its own, started when the phase starts, while
# the phase's other work runs (the native builds too: their seconds are
# taken beside the two numpy builds). The numpy power_law build is held
# at 2M (its 10M build took 153-232 s, PERF.md PR 13), where the native
# build is compared with it too, so the phase keeps inside the time the
# other phases leave it; the native builds stay timed at 10M
BUILD_10M = (("power_law", {"seed": 0, "m": 4}), ("imp3D", {"seed": 0}))
BUILD_10M_NODES = 10_000_000
BUILD_NUMPY_NODES = {"power_law": 2_000_000, "imp3D": BUILD_10M_NODES}


def timed_build(kind, kw, nodes, use_native):
    """``(seconds, digest of offsets and indices, nodes, directed edges)``
    of one topology build in this process, by the native library or the
    numpy path (a spawned worker runs this for the numpy builds)."""
    import hashlib

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if not use_native:
        os.environ["GOSSIP_TPU_NATIVE"] = "0"
    from gossipprotocol_tpu_torch import native
    from gossipprotocol_tpu_torch.topology import build_topology

    if native.backend() != ("native" if use_native else "numpy"):
        raise RuntimeError(f"(m) {kind}: the {native.backend()} path ran")
    t0 = time.perf_counter()
    topo = build_topology(kind, nodes, **kw)
    seconds = time.perf_counter() - t0
    h = hashlib.blake2b(digest_size=16)
    for a in (topo.offsets, topo.indices):
        h.update(str(a.dtype).encode())
        h.update(memoryview(a))
    return seconds, h.hexdigest(), topo.num_nodes, topo.num_directed_edges


def phase_native_and_curves(torch):
    """Phase (m): --check, --backend, the curve tools, the 10M builds."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        max_workers=len(BUILD_10M),
        mp_context=multiprocessing.get_context("spawn"))
    try:
        plain = {kind: pool.submit(timed_build, kind, kw,
                                   BUILD_NUMPY_NODES[kind], False)
                 for kind, kw in BUILD_10M}
        _checks_and_curves()
        for kind, kw in BUILD_10M:
            t_native, digest, nodes, edges = timed_build(
                kind, kw, BUILD_10M_NODES, True)
            at = BUILD_NUMPY_NODES[kind]
            if at != BUILD_10M_NODES:
                _, digest, *_ = timed_build(kind, kw, at, True)
            t_numpy, want, *_ = plain[kind].result(timeout=1200)
            require(digest == want, f"(m) {kind} {at}: the native and "
                    "numpy builds differ")
            say(f"(m) {kind} 10M ({nodes} nodes, {edges} directed edges): "
                f"native {t_native:.2f} s; numpy at {at:,} nodes "
                f"{t_numpy:.2f} s (in a process of its own, beside the "
                f"phase's other work), byte-equal to the native build "
                "there")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _checks_and_curves():
    """Phase (m)'s --check, --backend and curve-tool runs."""
    import csv

    from gossipprotocol_tpu_torch.experiments import curves, oracle_curves

    for name in CHECK_FAMILIES:
        t1 = time.perf_counter()
        rc, text, etext, counts = _run_cli(["1000000", name, "gossip",
                                            "--check"])
        last = (text.strip().splitlines() or [""])[-1]
        require(rc == 0 and last.startswith("topology ok: kind=")
                and not any(counts.values()),
                f"(m) --check {name} 1M: exit {rc}: {etext.strip()}")
        say(f"(m) --check {name} 1M: rc 0, {last} "
            f"({time.perf_counter() - t1:.1f} s)")
    rc, text, etext, _ = _run_cli(["1000", "imp3D", "gossip", "--backend",
                                   "tpu"])
    require(rc == 2 and etext.startswith("backend 'tpu' unavailable: "),
            f"(m) --backend tpu: exit {rc}: {etext.strip()}")
    say(f"(m) --backend tpu: rc 2, {etext.strip()}")
    rc, text, etext, _ = _run_cli(["1000", "imp3D", "gossip", "--backend",
                                   "gpu", "--check"])
    require(rc == 0, f"(m) --backend gpu --check: exit {rc}")
    say("(m) --backend gpu --check: rc 0 (the card)")
    with tempfile.TemporaryDirectory(prefix="curves_") as out_dir:
        for label, extra, want_rows in CURVE_RUNS:
            out = os.path.join(out_dir, f"{label.replace(' ', '_')}.csv")
            t1 = time.perf_counter()
            ebuf = io.StringIO()
            with contextlib.redirect_stderr(ebuf):
                rc = curves.main(["--repeats", "1", "--out", out] + extra)
            with open(out, newline="") as fh:
                rows = list(csv.DictReader(fh))
            require(rc == 0 and len(rows) == want_rows,
                    f"(m) curves {label}: exit {rc}, {len(rows)} rows of "
                    f"{want_rows}: {ebuf.getvalue()[-300:]}")
            conv = sum(r["converged"] == "True" for r in rows)
            say(f"(m) curves {label}: rc 0, {len(rows)} rows ({conv} "
                f"converged; {sum(int(r['rounds']) for r in rows)} rounds "
                f"in all), {time.perf_counter() - t1:.1f} s")
            for r in rows:
                if r["converged"] != "True":
                    say(f"(m)   not converged: {r['algorithm']} "
                        f"{r['topology']} {r['nodes_requested']}: "
                        f"{r['rounds']} rounds")
        say("(m) curves reference gossip on full: left out (livelocks to the "
            "500,000-round cap in both packages)")
        t1 = time.perf_counter()
        ebuf = io.StringIO()
        with contextlib.redirect_stderr(ebuf):
            rc = oracle_curves.main(["--out", os.path.join(
                out_dir, "oracle_curves.csv")])
        require(rc == 0, f"(m) oracle_curves: exit {rc}: "
                f"{ebuf.getvalue()[-300:]}")
        say(f"(m) oracle_curves: rc 0, {time.perf_counter() - t1:.1f} s; "
            f"{ebuf.getvalue().strip().splitlines()[-1]}")


# ---------------------------------------------------------------- (n)

# phase (n): faults, loss windows, repair, checkpoints, the sentinel and
# churn on the card, at the full width of the 1M graphs (churn at 262,144)
FAULT_N = 1_000_000
FAULT_ARGV = ["1000000", "imp3D", "push-sum", "--fanout", "all",
              "--delivery", "pallas", "--predicate", "global", "--tol",
              "1e-4", "--fail-fraction", "0.1", "--fail-round", "5",
              "--repair", "rewire", "--device", "cuda",
              "--max-rounds", MAX_ROUNDS]
# (n2): loss windows and a kill strike on the drawing rounds, card vs CPU
LOSS_ROUNDS = 32
LOSS_FLAGS = ["--drop-prob", "0.2", "--drop-window", "0", "24",
              "--fail-fraction", "0.1", "--fail-round", "8",
              "--max-rounds", str(LOSS_ROUNDS), "--chunk-rounds", "8"]
LOSS_RUNS = {
    "gossip": ["1000000", "imp3D", "gossip"],
    "push-sum": ["1000000", "imp3D", "push-sum", "--predicate", "global",
                 "--tol", "1e-4"],
}
# (n4): 0.1 % of the nodes poisoned with NaN at round 6
VALUE_FAULT = ("0.001", "nan", "6")
SENTINEL_ARGV = FAULT_ARGV[:FAULT_ARGV.index("--fail-fraction")] + [
    "--repair", "rewire", "--device", "cuda", "--max-rounds", MAX_ROUNDS,
    "--value-faults", ",".join(VALUE_FAULT)]
CHURN_ARGV = ["262144", "imp3D", "push-sum", "--fanout", "all",
              "--delivery", "pallas", "--predicate", "global", "--tol",
              "1e-4", "--churn", "0.001,swap,10", "--max-rounds", "60",
              "--device", "cuda"]
PALLAS_IMP3D_KERNELS = ("gather_bucket", "class_reduce_small")
ROUTED_IMP3D_KERNELS = ("class_expand_small", "stage_call", "final_call",
                        "class_reduce_small")


def _fault_cli(tag, argv, rcs=(0,)):
    """One in-process CLI run of phase (n), its lines printed: ``(text,
    launch counts, RunResult, (rounds, executed, wall ms, printed
    estimate error or None))``."""
    rc, text, etext, counts, res = _ref_cli(argv)
    for line in (etext + text).splitlines():
        say(f"(n) {tag} | {line}")
    require(rc in rcs, f"(n) {tag}: exit {rc}, want {rcs}: {' '.join(argv)}")
    conv = re.search(r"Convergence Time: ([0-9.]+) ms", text)
    rounds = re.search(r"rounds: (\d+) \((\d+) executed\)", text)
    err = re.search(r"max \|s/w - mean\| = (\S+)", text)
    require(conv and rounds, f"(n) {tag}: output lines missing")
    return text, counts, res, (int(rounds.group(1)), int(rounds.group(2)),
                               float(conv.group(1)),
                               err.group(1) if err else None)


def _events(res, kind):
    return [m for m in res.metrics if m.get("event") == kind]


def _states_bitwise(torch, a, b):
    return [f for f in a._fields
            if not bitwise_equal(torch, getattr(a, f), getattr(b, f))]


def _need_launches(tag, counts, kernels):
    missing = [k for k in kernels if not counts[k]]
    require(not missing, f"(n) {tag}: kernels {missing} never launched")


def phase_faults(torch, totals):
    """Phase (n); adds the launches of its pallas and routed runs to
    ``totals``."""
    from gossipprotocol_tpu_torch.engine import RunConfig
    from gossipprotocol_tpu_torch.events import plan as events_plan
    from gossipprotocol_tpu_torch.utils import checkpoint as ckpt


    def count(counts):
        for k, v in counts.items():
            if k in totals:
                totals[k] += v

    # (n1) a 10 % kill strike at round 5, rewired, on the kernels
    runs = {}
    for delivery in ("pallas", "routed"):
        argv = [("routed" if a == "pallas" else a) for a in FAULT_ARGV] \
            if delivery == "routed" else FAULT_ARGV
        _, counts, res, nums = _fault_cli(f"n1 {delivery}", argv)
        rounds, executed, wall_ms, err = nums
        require(float(err) < 2e-4, f"(n1) {delivery}: estimate error {err}")
        dead = int((~res.final_state.alive).sum())
        rep = _events(res, "repair")
        require(len(rep) == 1 and rep[0]["changed"] and dead > 0,
                f"(n1) {delivery}: no repair rebuild, or no dead rows")
        _need_launches(f"n1 {delivery}", counts,
                       PALLAS_IMP3D_KERNELS if delivery == "pallas"
                       else ROUTED_IMP3D_KERNELS)
        count(counts)
        runs[delivery] = (res, nums)
        between = wall_ms - 1e3 * (rep[0]["event_s"]
                                   - rep[0].get("warm_s", 0.0))
        say(f"(n1) {delivery}: rc 0, {rounds} rounds ({executed} executed), "
            f"{wall_ms:.3f} ms with the strike's host events "
            f"({rep[0]['event_s']:.2f} s: kill, repair, partition rule, "
            f"plan rebuild; its warm-up chunk "
            f"{rep[0].get('warm_s', 0.0):.2f} s not in the time), "
            f"{between / max(executed, 1):.4f} ms per executed round "
            "without them, "
            f"estimate_error {err}; {dead} rows dead, repair: "
            f"{rep[0]['edges_dropped']} edges dropped, "
            f"{rep[0]['edges_spliced']} spliced, plan rebuilt in "
            f"{rep[0]['plan_patch_s']:.2f} s; launches {counts}")
    (rp, np_), (rr, nr) = runs["pallas"], runs["routed"]
    require(np_[0] == nr[0] and np_[3] == nr[3],
            f"(n1) routed ended at round {nr[0]} with error {nr[3]}, pallas "
            f"at {np_[0]} with {np_[3]}")
    diff = _states_bitwise(torch, rp.final_state, rr.final_state)
    require(not diff, f"(n1) routed vs pallas final state: {diff} differ")
    say(f"(n1) routed == pallas: round {nr[0]}, error {nr[3]}, final state "
        "bitwise")

    # (n2) loss windows + a kill strike on the drawing rounds, card vs cpu
    for algo, head in LOSS_RUNS.items():
        res = {}
        for dev in ("cuda", "cpu"):
            t1 = time.perf_counter()
            _, counts, res[dev], nums = _fault_cli(
                f"n2 {algo} {dev}", head + LOSS_FLAGS + ["--device", dev],
                rcs=(0, 1))
            res[dev + "_s"] = time.perf_counter() - t1
        a, b = res["cuda"].final_state, res["cpu"].final_state
        require(res["cuda"].rounds == res["cpu"].rounds,
                f"(n2) {algo}: rounds {res['cuda'].rounds} on the card, "
                f"{res['cpu'].rounds} on the cpu")
        if algo == "gossip":
            diff = _states_bitwise(torch, a, b)
            require(not diff, f"(n2) gossip card vs cpu: {diff} differ")
            what = "bitwise (counts, converged, alive, round)"
        else:
            require(torch.equal(a.alive, b.alive), "(n2) alive differs")
            errs = {f: max_abs_err(torch, getattr(a, f), getattr(b, f))
                    for f in ("s", "w", "ratio")}
            require(errs["s"] <= SCATTER_TOL and errs["w"] <= SCATTER_TOL,
                    f"(n2) push-sum card vs cpu: {errs} above {SCATTER_TOL}")
            what = (f"within {SCATTER_TOL} (max |diff| s {errs['s']:.3e}, "
                    f"w {errs['w']:.3e}, ratio {errs['ratio']:.3e})")
        say(f"(n2) {algo} imp3D 1M, drop 0.2 over rounds [0, 24), 10 % "
            f"killed at round 8, {res['cuda'].rounds} rounds: card vs cpu "
            f"{what}; {int((~a.alive).sum())} rows dead; card "
            f"{res['cuda'].wall_ms:.3f} ms, cpu {res['cpu'].wall_ms:.3f} ms "
            f"(host {res['cuda_s']:.1f} s / {res['cpu_s']:.1f} s with the "
            "build)")

    with tempfile.TemporaryDirectory(prefix="ckpt_") as ck:
        # (n3) the (n1) run checkpointed every 2 chunks, then resumed from
        # a checkpoint in the middle
        full_dir = os.path.join(ck, "full")
        _, counts, full, nums = _fault_cli(
            "n3 checkpointed", FAULT_ARGV + ["--checkpoint-every", "2",
                                             "--checkpoint-dir", full_dir])
        count(counts)
        diff = _states_bitwise(torch, full.final_state, rp.final_state)
        require(not diff and full.rounds == rp.rounds,
                f"(n3) the checkpointed run differs from (n1): {diff}")
        before = [c for c in full.checkpoints
                  if int(ckpt.peek_meta(c)["round"]) < full.rounds]
        require(before, "(n3) no checkpoint before the last round")
        mid = before[len(before) // 2]
        _, counts, resumed, rnums = _fault_cli(
            "n3 resumed", FAULT_ARGV + ["--resume", mid])
        count(counts)
        diff = _states_bitwise(torch, resumed.final_state, full.final_state)
        require(not diff and resumed.rounds == full.rounds,
                f"(n3) resumed from {mid}: rounds {resumed.rounds} vs "
                f"{full.rounds}, fields {diff} differ")
        t1 = time.perf_counter()
        path = ckpt.save(os.path.join(ck, "timed"), full.final_state,
                         RunConfig(**DIFFUSION, device="cuda"), "imp3D")
        save_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        st, _meta = ckpt.load(path)
        load_s = time.perf_counter() - t1
        require(not _states_bitwise(torch, st, full.final_state),
                "(n3) a saved and loaded state differs")
        mid_round = int(ckpt.peek_meta(mid)["round"])
        say(f"(n3) {len(full.checkpoints)} checkpoints; resumed from "
            f"{os.path.basename(mid)} at round {mid_round} to round "
            f"{resumed.rounds}: final state bitwise the "
            f"uninterrupted run's; save {save_s:.2f} s, load {load_s:.2f} s "
            f"for a 1M-node state ({os.path.getsize(path) / 2**20:.1f} MiB)")

        # (n4) the sentinel: NaN at round 6 on 0.1 % of the nodes
        spec = events_plan.ValueFaultSpec(rate=float(VALUE_FAULT[0]),
                                          model=VALUE_FAULT[1],
                                          round=int(VALUE_FAULT[2]))
        want = events_plan.value_fault_ids(FAULT_N, spec, run_seed=0)
        for mode, extra in (
                ("quarantine", []),
                ("rollback", ["--checkpoint-every", "1", "--checkpoint-dir",
                              os.path.join(ck, "rollback"),
                              "--chunk-rounds", "4"])):
            _, counts, res, nums = _fault_cli(
                f"n4 {mode}", SENTINEL_ARGV + ["--sentinel", mode] + extra)
            count(counts)
            trips, quars = _events(res, "sentinel_trip"), _events(
                res, "quarantine")
            require(len(trips) == 1 and trips[0]["round"] == spec.round
                    and trips[0]["cause"] == "nonfinite",
                    f"(n4) {mode}: trips {trips}")
            require(quars and quars[0]["nodes"] == want.size
                    and quars[0]["ids"] == want[:64].tolist(),
                    f"(n4) {mode}: quarantined {quars} != value_fault_ids")
            require(float(nums[3]) < 2e-4, f"(n4) {mode}: error {nums[3]}")
            rb = _events(res, "rollback")
            if mode == "rollback":
                require(len(rb) == 1 and rb[0]["round"] < spec.round,
                        f"(n4) rollback: {rb}")
            say(f"(n4) {mode}: tripped at round {trips[0]['round']} (the "
                f"injection round), {quars[0]['nodes']} rows quarantined == "
                f"value_fault_ids"
                + (f", rolled back to round {rb[0]['round']}" if rb else "")
                + f"; converged in {nums[0]} rounds, {nums[2]:.3f} ms, "
                f"estimate_error {nums[3]}")

    # (n5) churn: swap 0.1 % of the edges every 10 rounds at 262,144
    _, counts, res, nums = _fault_cli("n5 churn", CHURN_ARGV, rcs=(0, 1))
    count(counts)
    churn = _events(res, "churn")
    require(len(churn) >= 2 and all(c["changed"] for c in churn)
            and all(c["round"] % 10 == 0 for c in churn),
            f"(n5) churn rebuilds: {churn}")
    rebuild_s = [c["rebuild_s"] for c in churn]
    in_rounds_ms = nums[2] - 1e3 * sum(c["event_s"] - c.get("warm_s", 0.0)
                                       for c in churn)
    say(f"(n5) churn imp3D 262,144: {len(churn)} rebuilds at rounds "
        f"{[c['round'] for c in churn]}, "
        f"{[c['edges_swapped'] for c in churn]} edges swapped, event s "
        f"{[round(c['event_s'], 2) for c in churn]}, rebuild s "
        f"{[round(x, 2) for x in rebuild_s]} (plan "
        f"{[round(c['plan_patch_s'], 2) for c in churn]}); {nums[0]} rounds "
        f"({nums[1]} executed), {nums[2]:.3f} ms, "
        f"{in_rounds_ms / max(nums[1], 1):.4f} ms per executed round "
        f"between rebuilds")


# ---------------------------------------------------------------- (o)

# (o1) the slice's main path: SGP at the port's 1M graph, d = 16, m = 8
SGP_ARGV = ["1000000", "imp3D", "push-sum", "--fanout", "all", "--delivery",
            "pallas", "--workload", "sgp", "--payload-dim", "16",
            "--sgp-samples", "8", "--predicate", "global", "--tol", "1e-3",
            "--max-rounds", "400", "--device", "cuda"]
SGP_RESIDENT_ARGV = ["262144"] + SGP_ARGV[1:]
SGP_MATVECS = 9            # ceil((16 + 1) / 2)
PALLAS_RESIDENT_KERNELS = ("gather_resident", "class_reduce_small")
# (o2) Poisson clocks at 1M
CLOCK_FLAGS = ["--clock", "poisson", "--activation-rate", "1.0"]
CLOCK_RUNS = {
    "pallas push-sum": ["1000000", "imp3D", "push-sum", "--fanout", "all",
                        "--delivery", "pallas", "--predicate", "global",
                        "--tol", "1e-4", "--max-rounds", "400"],
    "gossip": ["1000000", "imp3D", "gossip", "--max-rounds", "400"],
}
# (o3) card against CPU, small graph, fixed rounds; (tag, argv tail,
# tolerance on s, w, ratio: 0 = bitwise)
O3_HEAD = ["32768", "imp3D", "push-sum", "--max-rounds", "32",
           "--chunk-rounds", "8"]
O3_RUNS = (
    ("fanout-all scatter", ["--fanout", "all", "--delivery", "scatter"],
     SCATTER_TOL),
    ("GALA --groups 4 poisson", ["--fanout", "all", "--delivery", "scatter",
                                 "--workload", "gala", "--groups", "4",
                                 "--payload-dim", "8", "--predicate",
                                 "global", "--clock", "poisson"], 1e-4),
    ("Chebyshev --accel-lambda 0.9", ["--fanout", "all", "--accel",
                                      "chebyshev", "--accel-lambda", "0.9"],
     SCATTER_TOL),
    ("EPD", ["--fanout", "all", "--accel", "epd"], SCATTER_TOL),
    ("--x64 fanout-all scatter", ["--fanout", "all", "--delivery",
                                  "scatter", "--x64"], 1e-12),
    ("--delivery invert", ["--delivery", "invert"], 0.0),
    ("fanout-one poisson d=3", ["--clock", "poisson", "--payload-dim", "3"],
     SCATTER_TOL),
    ("SGP pallas", ["--fanout", "all", "--delivery", "pallas", "--workload",
                    "sgp", "--payload-dim", "16", "--predicate", "global"],
     1e-4),
)
# (o4) the inverted fanout-one delivery against the scatter, imp3D 1M
INVERT_ARGV = ["1000000", "imp3D", "push-sum", "--eps", "0", "--max-rounds",
               "64", "--chunk-rounds", "16", "--device", "cuda"]


def _count_matvecs():
    """Count the calls of both deliveries' matvec; returns (counter,
    restore)."""
    from gossipprotocol_tpu_torch.ops.delivery import RoutedDelivery
    from gossipprotocol_tpu_torch.ops.pallasdelivery import PallasDelivery

    calls = {"n": 0}
    origs = {cls: cls.matvec for cls in (PallasDelivery, RoutedDelivery)}

    def wrap(orig):
        def counted(self, *a, **kw):
            calls["n"] += 1
            return orig(self, *a, **kw)
        return counted

    for cls, orig in origs.items():
        cls.matvec = wrap(orig)

    def restore():
        for cls, orig in origs.items():
            cls.matvec = orig

    return calls, restore


def _workload_cli(tag, argv, rcs=(0,)):
    """One in-process CLI run of phase (o): ``(RunResult, launch counts,
    (rounds, executed, wall ms, estimate error or None), matvec calls,
    seconds)``."""
    calls, restore = _count_matvecs()
    t1 = time.perf_counter()
    try:
        rc, text, etext, counts, res = _ref_cli(argv)
    finally:
        restore()
    secs = time.perf_counter() - t1
    for line in (etext + text).splitlines():
        say(f"(o) {tag} | {line}")
    require(rc in rcs, f"(o) {tag}: exit {rc}, want {rcs}: {' '.join(argv)}")
    conv = re.search(r"Convergence Time: ([0-9.]+) ms", text)
    rounds = re.search(r"rounds: (\d+) \((\d+) executed\)", text)
    err = re.search(r"max \|s/w - mean\| = (\S+)", text)
    require(conv and rounds, f"(o) {tag}: output lines missing")
    return res, counts, (int(rounds.group(1)), int(rounds.group(2)),
                         float(conv.group(1)),
                         err.group(1) if err else None), calls["n"], secs


def phase_workloads(torch, totals):
    """Phase (o); adds the launches of its SGP runs to ``totals``."""
    from gossipprotocol_tpu_torch.engine import RunConfig, run_simulation
    from gossipprotocol_tpu_torch.topology import build_topology

    def count(counts):
        for k, v in counts.items():
            if k in totals:
                totals[k] += v

    # (o1) SGP at 1M on pallas and routed, then at 262,144 (resident)
    runs = {}
    for delivery, argv, need in (
            ("pallas", SGP_ARGV, PALLAS_IMP3D_KERNELS),
            ("routed", [("routed" if a == "pallas" else a)
                        for a in SGP_ARGV], ROUTED_IMP3D_KERNELS),
            ("pallas 262,144", SGP_RESIDENT_ARGV, PALLAS_RESIDENT_KERNELS)):
        res, counts, nums, calls, secs = _workload_cli(
            f"o1 sgp {delivery}", argv, rcs=(0, 1))
        rounds, executed, wall_ms, err = nums
        # the JAX CLI's rule: 0 converged, 1 stopped at --max-rounds
        require((res.converged and rounds < 400) or (not res.converged
                                                     and rounds == 400),
                f"(o1) {delivery}: converged {res.converged} at {rounds}")
        missing = [k for k in need if not counts[k]]
        require(not missing, f"(o1) {delivery}: {missing} never launched")
        # the warm-up chunk runs one round besides the executed ones
        per_round = calls / (executed + 1)
        require(calls == SGP_MATVECS * (executed + 1),
                f"(o1) {delivery}: {calls} matvec calls for {executed} + 1 "
                f"rounds, want {SGP_MATVECS} a round")
        loss = [m["train_loss"] for m in res.metrics if "train_loss" in m]
        require(loss and math.isfinite(loss[-1]) and float(err) < 1e-3,
                f"(o1) {delivery}: train loss {loss[-1:]}, error {err}")
        count(counts)
        runs[delivery] = res
        say(f"(o1) sgp {delivery}: rc {0 if res.converged else 1}, "
            f"{rounds} rounds ({executed} executed), {wall_ms:.3f} ms, "
            f"{wall_ms / max(executed, 1):.4f} ms per executed round, "
            f"train_loss {loss[-1]:.6e}, estimate_error {err}, "
            f"{per_round:.1f} matvec calls a round, launches {counts}, "
            f"{secs:.1f} s with the data and plan build")
    a, b = runs["pallas"].final_state, runs["routed"].final_state
    diff = _states_bitwise(torch, a, b)
    require(not diff and runs["pallas"].rounds == runs["routed"].rounds,
            f"(o1) pallas vs routed final state: {diff} differ")
    say(f"(o1) sgp routed == pallas at 1M: round {runs['pallas'].rounds}, "
        "final state bitwise (s, w, ratio, streak, converged, alive, round, "
        "loss)")

    # (o2) Poisson clocks at 1M; gossip card vs CPU at 262,144
    for tag, argv in CLOCK_RUNS.items():
        res, counts, nums, _calls, secs = _workload_cli(
            f"o2 poisson {tag}", argv + CLOCK_FLAGS + ["--device", "cuda"])
        if "pallas" in tag:
            missing = [k for k in PALLAS_IMP3D_KERNELS if not counts[k]]
            require(not missing, f"(o2) {tag}: {missing} never launched")
        say(f"(o2) poisson rate 1.0 {tag} imp3D 1M: {nums[0]} rounds "
            f"({nums[1]} executed), {nums[2]:.3f} ms, "
            f"{nums[2] / max(nums[1], 1):.4f} ms per executed round, "
            f"estimate_error {nums[3]}, {secs:.1f} s in all")
    topo = build_topology("imp3D", 262_144, seed=0)
    got = {dev: run_simulation(topo, RunConfig(
        algorithm="gossip", clock="poisson", device=dev, max_rounds=400))
        for dev in ("cuda", "cpu")}
    diff = _states_bitwise(torch, got["cuda"].final_state,
                           got["cpu"].final_state)
    require(not diff and got["cuda"].rounds == got["cpu"].rounds,
            f"(o2) poisson gossip card vs cpu: {diff} differ")
    say(f"(o2) poisson gossip imp3D 262,144: card == cpu bitwise, "
        f"{got['cuda'].rounds} rounds")

    # (o3) card against CPU for every new path
    for tag, tail, tol in O3_RUNS:
        res = {}
        for dev in ("cuda", "cpu"):
            res[dev] = _workload_cli(f"o3 {tag} {dev}",
                                     O3_HEAD + tail + ["--device", dev],
                                     rcs=(0, 1))[0]
        a, b = res["cuda"].final_state, res["cpu"].final_state
        require(res["cuda"].rounds == res["cpu"].rounds
                 and torch.equal(a.alive, b.alive),
                 f"(o3) {tag}: rounds {res['cuda'].rounds} vs "
                 f"{res['cpu'].rounds}")
        errs = {f: max_abs_err(torch, getattr(a, f).double(),
                               getattr(b, f).double())
                for f in ("s", "w", "ratio")}
        require(all(e <= tol for e in errs.values()),
                f"(o3) {tag}: card vs cpu {errs} above {tol}")
        say(f"(o3) {tag}: {res['cuda'].rounds} rounds, card vs cpu max "
            f"|diff| s {errs['s']:.3e}, w {errs['w']:.3e}, ratio "
            f"{errs['ratio']:.3e} (bound {tol})")

    # (o4) invert against scatter at imp3D 1M
    got = {}
    for delivery in ("scatter", "invert", "scatter", "invert"):
        res, counts, nums, _calls, _secs = _workload_cli(
            f"o4 {delivery}", INVERT_ARGV + ["--delivery", delivery],
            rcs=(0, 1))
        require(not any(counts.values()),
                f"(o4) {delivery}: kernels launched {counts}")
        got.setdefault(delivery, []).append(
            (res, nums[2] / max(nums[1], 1)))
    a, b = got["scatter"][0][0].final_state, got["invert"][0][0].final_state
    errs = {f: max_abs_err(torch, getattr(a, f), getattr(b, f))
            for f in ("s", "w")}
    require(all(e <= SCATTER_TOL for e in errs.values()),
            f"(o4) invert vs scatter {errs} above {SCATTER_TOL}")
    say(f"(o4) fanout-one push-sum imp3D 1M, 64 rounds: ms per executed "
        f"round scatter {[round(t, 4) for _, t in got['scatter']]}, "
        f"invert {[round(t, 4) for _, t in got['invert']]}; invert vs "
        f"scatter max |diff| s {errs['s']:.3e}, w {errs['w']:.3e}")


# ---------------------------------------------------------------- (p)

# phase (p): run telemetry on the card at the 1M graphs' full width, each
# run with --telemetry-dir and without it. (p1) the main path: pallas
# push-sum at imp3D 1M; (p2) the same graph with a 10 % kill strike at
# round 0 on pallas and routed (the recount's extra matvec); (p3) gossip
# at imp3D 1M (trace rows) and the megakernel at K = 16 (phase (f)'s
# graph); (p4) a short run with --profile-dir
TEL_ARGV = CLI_RUNS["imp3D_1M"] + ["--max-rounds", MAX_ROUNDS,
                                   "--device", "cuda"]
TEL_DEAD_FLAGS = ["--fail-fraction", "0.1", "--fail-round", "0"]
TEL_GOSSIP_ARGV = ["1000000", "imp3D", "gossip", "--max-rounds", "400",
                   "--device", "cuda"]
TEL_MK_ARGV = MK_CLI_RUNS["imp3D_512000"] + ["--max-rounds", MAX_ROUNDS,
                                             "--device", "cuda"]
TEL_PROFILE_ARGV = TEL_ARGV[:-4] + ["--max-rounds", "16", "--device",
                                    "cuda"]
# chunks of 16 rounds whose device-to-host copies are counted
FETCH_CHUNKS = 4
# the launches the recount adds under a dead set, per delivery
RECOUNT_KERNELS = {"pallas": ("gather_bucket", "class_reduce_small"),
                   "routed": ROUTED_IMP3D_KERNELS}


def _tel_cli(tag, argv, tel_dir=None, rcs=(0,)):
    """One in-process CLI run of phase (p), with ``--telemetry-dir
    tel_dir`` when given: ``(RunResult, launch counts, ms per executed
    round, manifest or None)``."""
    argv = list(argv) + (["--telemetry-dir", tel_dir] if tel_dir else [])
    rc, text, etext, counts, res = _ref_cli(argv)
    for line in (etext + text).splitlines():
        if "rounds:" in line or "Convergence" in line or "error" in line:
            say(f"(p) {tag} | {line}")
    require(rc in rcs, f"(p) {tag}: exit {rc}, want {rcs}: {' '.join(argv)}")
    conv = re.search(r"Convergence Time: ([0-9.]+) ms", text)
    rounds = re.search(r"rounds: (\d+) \((\d+) executed\)", text)
    require(conv and rounds, f"(p) {tag}: output lines missing")
    ms = float(conv.group(1)) / max(int(rounds.group(2)), 1)
    man = None
    if tel_dir:
        with open(os.path.join(tel_dir, "run.json")) as fh:
            man = json.load(fh)
        chunks = man["phases"].get("chunk", {})
        say(f"(p) {tag} | phases {man['phases']}; {chunks.get('count')} "
            f"chunk spans, "
            f"{1e3 * chunks.get('total_s', 0) / max(chunks.get('count', 1), 1):.3f}"
            " ms each (enqueue, the card's work and the one fetch)")
    return res, counts, ms, man


def _report(tel_dir):
    """``(exit code, text)`` of ``report tel_dir``, in process."""
    from gossipprotocol_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["report", tel_dir])
    return rc, buf.getvalue()


def _fetches_and_kernels(torch, topo):
    """The main path's chunk (imp3D 1M, pallas) without telemetry, with
    it, and as the engine ran it before telemetry existed, each run for
    FETCH_CHUNKS chunks of 16 rounds under ``torch.profiler``: the
    device-to-host copies a chunk and the kernels a chunk by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gossipprotocol_tpu_torch.engine import RunConfig
    from gossipprotocol_tpu_torch.engine import driver as drv
    from gossipprotocol_tpu_torch.obs.counters import make_counter_fn
    from gossipprotocol_tpu_torch.obs.trace import make_trace_fn

    cfg = RunConfig(**DIFFUSION, predicate="global", tol=1e-4,
                    device="cuda")
    state, core, done, flags = drv.build_protocol(topo, cfg)
    delivery = drv.device_arrays(topo, cfg)

    def pre(st, d, start, limit):
        for _ in range(max(0, limit - start)):
            active = ~done(st)
            st = drv._freeze(active, core(st, d), st)
        return st, torch.stack([st.round, done(st).to(torch.int32)])

    runners = {
        "off": drv.make_chunk_runner(core, done),
        "on": drv.make_chunk_runner(
            core, done,
            counter_fn=make_counter_fn(topo, cfg, all_alive=flags[0],
                                       targets_alive=flags[1]),
            trace_fn=make_trace_fn(topo, cfg), records=True, mass=True),
        "pre-telemetry": pre,
    }
    def profiled(run):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            st, r = state, 0
            for _ in range(FETCH_CHUNKS):
                st, stats = run(st, delivery, r, r + 16)
                stats.tolist()
                r += 16
            torch.cuda.synchronize()
        return prof

    out = {}
    for name, run in runners.items():
        run(state, delivery, 0, 1)[1].tolist()
        torch.cuda.synchronize()
        if not out:
            # the profiler's first run (CUPTI starting up) is thrown
            # away
            profiled(run)
        d2h, kernels = 0, {}
        # the card's events only: a host op whose self time rounds to 0
        # is not a kernel
        for ev in profiled(run).key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            if "DtoH" in ev.key:
                d2h += ev.count
            elif "Memcpy" not in ev.key and "Memset" not in ev.key:
                kernels[ev.key] = ev.count
        out[name] = (d2h / FETCH_CHUNKS, kernels)
    return out


def phase_telemetry(torch, totals):
    """Phase (p); adds the launches of its runs with telemetry to
    ``totals``."""
    import numpy as np

    from gossipprotocol_tpu_torch.topology import build_topology

    def count(counts):
        for k, v in counts.items():
            if k in totals:
                totals[k] += v

    timings = {}
    t_sub = [time.perf_counter()]

    def sub_lap(name):
        t_sub.append(time.perf_counter())
        say(f"({name}) seconds {t_sub[-1] - t_sub[-2]:.1f}")

    with tempfile.TemporaryDirectory(prefix="telemetry_") as td:
        # (p1) the main path, off and on
        off, c_off, ms_off, _ = _tel_cli("p1 off", TEL_ARGV)
        d1 = os.path.join(td, "p1")
        on, c_on, ms_on, man = _tel_cli("p1 on", TEL_ARGV, d1)
        count(c_on)
        diff = _states_bitwise(torch, on.final_state, off.final_state)
        require(on.rounds == off.rounds and not diff,
                f"(p1) telemetry changed the run: rounds {on.rounds} vs "
                f"{off.rounds}, fields {diff}")
        edges = man["topology"]["num_directed_edges"]
        c = man["counters"]
        require(c["sent"] == c["delivered"] == on.rounds * edges
                and c["dropped"] == 0,
                f"(p1) counters {c} against {on.rounds} rounds x {edges} "
                "directed edges")
        rc, text = _report(d1)
        require(rc == 0 and "anomalies: none" in text,
                f"(p1) report exit {rc}: {text[-400:]}")
        timings["pallas"] = (ms_off, ms_on)
        say(f"(p1) pallas imp3D 1M: {on.rounds} rounds bitwise with and "
            f"without telemetry; counters {c} = rounds x {edges} directed "
            f"edges; mass drift {man['max_mass_drift_ulps']} / "
            f"{man['max_w_drift_ulps']} ULPs; trace {man['trace']}; "
            "report exit 0, anomalies: none; ms per executed round "
            f"{ms_off:.4f} off, {ms_on:.4f} on; launches on {c_on}")
        routed_argv = [("routed" if a == "pallas" else a) for a in TEL_ARGV]
        roff, _c, rms_off, _ = _tel_cli("p1 routed off", routed_argv)
        ron, rc_on, rms_on, rman = _tel_cli(
            "p1 routed on", routed_argv, os.path.join(td, "p1_routed"))
        count(rc_on)
        diff = _states_bitwise(torch, ron.final_state, on.final_state)
        require(ron.rounds == roff.rounds == on.rounds and not diff
                and not _states_bitwise(torch, ron.final_state,
                                        roff.final_state)
                and rman["counters"] == c,
                f"(p1) routed: rounds {ron.rounds}/{roff.rounds}, fields "
                f"{diff}, counters {rman['counters']} vs pallas {c}")
        timings["routed"] = (rms_off, rms_on)
        say(f"(p1) routed imp3D 1M: {ron.rounds} rounds, bitwise the "
            "pallas run and the run without telemetry, the same counters; "
            f"ms per executed round {rms_off:.4f} off, {rms_on:.4f} on")
        topo = build_topology("imp3D", 1_000_000, seed=0)
        fetch = _fetches_and_kernels(torch, topo)
        for name, (d2h, kernels) in fetch.items():
            require(d2h == 1, f"(p1) {name}: {d2h} device-to-host copies "
                    "a chunk, want 1")
        k_off, k_pre = fetch["off"][1], fetch["pre-telemetry"][1]
        require(k_off == k_pre,
                "(p1) the chunk without telemetry launches other kernels "
                "than before telemetry: "
                + str({k: (k_off.get(k), k_pre.get(k))
                       for k in set(k_off) | set(k_pre)
                       if k_off.get(k) != k_pre.get(k)}))
        say(f"(p1) torch.profiler, {FETCH_CHUNKS} chunks of 16 rounds: 1 "
            "device-to-host copy a chunk off, on and before telemetry; "
            "kernels a chunk off "
            f"{sum(fetch['off'][1].values()) / FETCH_CHUNKS:.1f} (= before "
            "telemetry, by name), on "
            f"{sum(fetch['on'][1].values()) / FETCH_CHUNKS:.1f}")
        sub_lap("p1")

        # (p2) the dead-set recount on pallas and routed
        offsets = np.asarray(topo.offsets, np.int64)
        src = np.repeat(np.arange(topo.num_nodes), np.diff(offsets))
        dst = np.asarray(topo.indices, np.int64)
        deg = np.asarray(topo.degree, np.int64)
        runs = {}
        for delivery in ("pallas", "routed"):
            base = [("routed" if a == "pallas" else a) for a in TEL_ARGV] \
                if delivery == "routed" else TEL_ARGV
            argv = base + TEL_DEAD_FLAGS
            off, c_off, ms_off, _ = _tel_cli(f"p2 {delivery} off", argv)
            d2 = os.path.join(td, f"p2_{delivery}")
            on, c_on, ms_on, man = _tel_cli(f"p2 {delivery} on", argv, d2)
            count(c_on)
            diff = _states_bitwise(torch, on.final_state, off.final_state)
            require(on.rounds == off.rounds and not diff,
                    f"(p2) {delivery}: telemetry changed the run ({diff})")
            alive = on.final_state.alive.numpy()
            live = int((alive[src] & alive[dst]).sum())
            c = man["counters"]
            require(c["delivered"] == on.rounds * live
                    and c["sent"] == on.rounds * int(deg[alive].sum())
                    and c["dropped"] == 0,
                    f"(p2) {delivery}: counters {c} against {on.rounds} "
                    f"rounds x {live} live-to-live directed edges")
            extra = {k: c_on[k] - c_off[k] for k in
                     RECOUNT_KERNELS[delivery]}
            require(all(v > 0 for v in extra.values()),
                    f"(p2) {delivery}: no recount launches {extra}")
            runs[delivery] = (on, c)
            timings[f"{delivery} dead set"] = (ms_off, ms_on)
            say(f"(p2) {delivery} 10 % dead: {on.rounds} rounds bitwise "
                f"with and without telemetry; counters {c}, delivered = "
                f"rounds x {live} live-to-live directed edges "
                f"({int((~alive).sum())} rows dead); the recount's extra "
                f"launches {extra} (on {c_on}, off {c_off}); ms per "
                f"executed round {ms_off:.4f} off, {ms_on:.4f} on")
        (rp, cp), (rr, cr) = runs["pallas"], runs["routed"]
        diff = _states_bitwise(torch, rp.final_state, rr.final_state)
        require(rp.rounds == rr.rounds and not diff and cp == cr,
                f"(p2) pallas vs routed: rounds {rp.rounds} vs "
                f"{rr.rounds}, fields {diff}, counters {cp} vs {cr}")
        sub_lap("p2")

        # (p3) gossip with trace rows, the megakernel with counters
        for tag, argv in (("gossip", TEL_GOSSIP_ARGV),
                          ("megakernel K=16", TEL_MK_ARGV)):
            off, _c, ms_off, _ = _tel_cli(f"p3 {tag} off", argv)
            d3 = os.path.join(td, "p3_" + tag.split()[0])
            on, c_on, ms_on, man = _tel_cli(f"p3 {tag} on", argv, d3)
            count(c_on)
            diff = _states_bitwise(torch, on.final_state, off.final_state)
            require(on.rounds == off.rounds and not diff
                    and on.rounds_executed == off.rounds_executed,
                    f"(p3) {tag}: telemetry changed the run ({diff})")
            c = man["counters"]
            if tag == "gossip":
                require(man["trace"]["rows_written"] == on.rounds
                        and c["sent"] >= c["delivered"] > 0,
                        f"(p3) gossip: trace {man['trace']}, counters {c}")
            else:
                edges = man["topology"]["num_directed_edges"]
                require(c["sent"] == c["delivered"] == on.rounds * edges,
                        f"(p3) megakernel: counters {c} against "
                        f"{on.rounds} rounds x {edges}")
            timings[tag] = (ms_off, ms_on)
            say(f"(p3) {tag}: {on.rounds} rounds bitwise with and without "
                f"telemetry; counters {c}; trace {man['trace']}; ms per "
                f"executed round {ms_off:.4f} off, {ms_on:.4f} on")

        sub_lap("p3")

        # (p4) --profile-dir
        d4 = os.path.join(td, "p4")
        rc, text, etext, counts, _res = _ref_cli(
            TEL_PROFILE_ARGV + ["--profile-dir", d4])
        require(rc in (0, 1), f"(p4) exit {rc}")
        files = [f for f in os.listdir(d4) if f.endswith(".json")]
        require(files, "(p4) no trace file in --profile-dir")
        with open(os.path.join(d4, files[0])) as fh:
            trace = fh.read()
        names = [k for k in ("gather_bucket_kernel", "reduce_small_kernel")
                 if k in trace]
        require(len(names) == 2, f"(p4) the trace names {names} only")
        say(f"(p4) --profile-dir: {files[0]} ({len(trace)} bytes) names "
            f"{names}; launches {counts}")
    say("(p) ms per executed round, telemetry off / on: " + "; ".join(
        f"{k} {a:.4f} / {b:.4f} (+{(b - a) / a * 100:.1f} %)"
        for k, (a, b) in timings.items()))


# ---------------------------------------------------------------- (q)

SWEEP_N = 1_000_000
SWEEP_LANES = 8
# (q2): rounds held to the standalone card runs with the predicate off
SWEEP_PS_ROUNDS = 32
SWEEP_PS_ARGV = dict(algorithm="push-sum", predicate="global", tol=1e-4)
# (q3): the README's sweeps through the CLI
SWEEP_README_ARGV = ["4096", "imp3D", "push-sum", "--sweep-seeds", "64"]
SWEEP_TRACED_PLANS = {
    "push-sum eps x tol": (["4096", "imp3D", "push-sum"],
                           {"axes": {"eps": [1e-6, 1e-8],
                                     "tol": [1e-3, 1e-4]}}),
    "gossip threshold": (["4096", "imp3D", "gossip"],
                         {"axes": {"threshold": [3, 5, 10]}}),
}
# (q4): each path of the port against the capacity model: (label,
# topology, nodes, config, shards); 32 rounds each (the first chunks
# reach the round's high-water mark)
CAPACITY_ROUNDS = 32
CAPACITY_RUNS = (
    ("gossip", "imp3D", 1_000_000, dict(algorithm="gossip"), 1),
    ("gossip", "power_law", 1_000_000, dict(algorithm="gossip"), 1),
    ("fanout-one push-sum", "imp3D", 1_000_000, dict(SWEEP_PS_ARGV), 1),
    ("fanout-one push-sum", "power_law", 1_000_000, dict(SWEEP_PS_ARGV), 1),
    ("pallas", "imp3D", 1_000_000, dict(DIFFUSION, predicate="global"), 1),
    ("pallas", "power_law", 1_000_000, dict(DIFFUSION, predicate="global"),
     1),
    ("routed", "imp3D", 1_000_000,
     dict(DIFFUSION, delivery="routed", predicate="global"), 1),
    ("routed", "power_law", 1_000_000,
     dict(DIFFUSION, delivery="routed", predicate="global"), 1),
    ("megakernel K=16", "imp3D", 512_000,
     dict(DIFFUSION, delivery="megakernel", rounds_per_kernel=16), 1),
    ("megakernel K=16", "power_law", 500_000,
     dict(DIFFUSION, delivery="megakernel", rounds_per_kernel=16), 1),
    ("--devices 4 pallas", "imp3D", 1_000_000,
     dict(DIFFUSION, predicate="global"), 4),
    ("--devices 4 pallas", "power_law", 400_000,
     dict(DIFFUSION, predicate="global"), 4),
    ("8-lane gossip sweep (q1)", "imp3D", 1_000_000,
     dict(algorithm="gossip"), 1),
)
# a prediction more than this many times the measured peak is printed
# (and written down with its reason)
CAPACITY_SLACK = 1.5


def _lane_round_profile(torch, topo, cfg, lanes):
    """``(busy, event, enqueue ms/round, idle share)`` of the lane round
    (``utils/profiling.py``'s profiler over ROUNDS rounds) for ``lanes``
    seed lanes of ``cfg``'s round on the card."""
    import dataclasses

    from gossipprotocol_tpu_torch.engine.driver import (
        build_protocol, device_arrays,
    )
    from gossipprotocol_tpu_torch.protocols.sampling import (
        key_data, round_keys,
    )
    from gossipprotocol_tpu_torch.sweep import SweepSpec
    from gossipprotocol_tpu_torch.sweep.engine import _lane_round
    from gossipprotocol_tpu_torch.utils import profiling

    spec = SweepSpec.from_seeds(lanes)
    cfg = dataclasses.replace(cfg, streak_target=2**30)
    built = [build_protocol(topo, spec.lane_config(cfg, i))
             for i in range(lanes)]
    state = type(built[0][0])(*(torch.stack(f) for f in
                                zip(*(b[0] for b in built))))
    all_alive, targets_alive = built[0][3]
    core, _, _ = _lane_round(topo, cfg, spec, {}, all_alive=all_alive,
                             targets_alive=targets_alive)
    nbrs = device_arrays(topo, cfg)
    base = torch.stack([key_data(i, "cuda") for i in range(lanes)])
    keys = round_keys(base, state.round, profiling.ROUNDS)

    def rounds():
        st = state
        for i in range(profiling.ROUNDS):
            st = core(st, nbrs, keys[i])

    _, busy, event, enqueue, idle = profiling._profile_rounds(
        rounds, torch.device("cuda"))
    return busy, event, enqueue, idle


def _lane_equal(torch, lane, solo):
    return all(bitwise_equal(torch, getattr(lane, f).reshape(-1),
                             getattr(solo, f).reshape(-1))
               for f in lane._fields)


def _sweep_cli(tag, argv):
    """One in-process CLI sweep: ``(rc, stdout)``; prints the closing
    lines."""
    rc, text, etext, _ = _run_cli(argv)
    for line in (etext + text).splitlines():
        if line.startswith(("rounds:", "sweep:", "Convergence")):
            say(f"(q3) {tag} | {line}")
    require(rc == 0, f"(q3) {tag}: exit {rc}: {' '.join(argv)}\n{etext}")
    require("sweep: " in text, f"(q3) {tag}: no sweep line")
    return rc, text


def phase_sweeps(torch):
    """Phase (q): batched sweeps on the card and the capacity model
    against the card's measured peaks."""
    import dataclasses

    from gossipprotocol_tpu_torch.engine.driver import (
        RunConfig, run_simulation,
    )
    from gossipprotocol_tpu_torch.sweep import SweepSpec
    from gossipprotocol_tpu_torch.topology import build_topology

    t_sub = [time.perf_counter()]

    def sub_lap(name):
        t_sub.append(time.perf_counter())
        say(f"({name}) seconds {t_sub[-1] - t_sub[-2]:.1f}")

    spec = SweepSpec.from_seeds(SWEEP_LANES)
    topo = build_topology("imp3D", SWEEP_N, seed=0)
    # (q1) the gossip seed sweep: lanes bitwise their standalone runs
    cfg = RunConfig(algorithm="gossip", device="cuda")
    sweep = run_simulation(topo, dataclasses.replace(cfg, sweep=spec))
    solos = [run_simulation(topo, spec.lane_config(cfg, i))
             for i in range(SWEEP_LANES)]
    for i, solo in enumerate(solos):
        require(sweep.lane_records[i]["rounds"] == solo.rounds
                and _lane_equal(torch, sweep.lane_state(i),
                                solo.final_state),
                f"(q1) gossip lane {i}: {sweep.lane_records[i]['rounds']} "
                f"rounds against its standalone {solo.rounds}, or its "
                "state differs")
    serial = sum(s.wall_ms for s in solos)
    one = solos[0].wall_ms / max(solos[0].rounds_executed, 1)
    eight = sweep.wall_ms / max(sweep.rounds_executed, 1)
    say(f"(q1) imp3D 1M gossip, {SWEEP_LANES} seed lanes: every lane's "
        f"rounds and state bitwise its standalone card run (rounds "
        f"{[s.rounds for s in solos]}); sweep {sweep.wall_ms:.1f} ms "
        f"({sweep.rounds_executed} executed rounds) against "
        f"{serial:.1f} ms for the {SWEEP_LANES} serial runs "
        f"(ratio {sweep.wall_ms / serial:.4f}); ms per executed round "
        f"{one:.4f} one lane alone, {eight:.4f} the {SWEEP_LANES} "
        f"together ({eight / one:.3f}x for {SWEEP_LANES}x the lanes)")
    for lanes in (1, SWEEP_LANES):
        busy, event, enq, idle = _lane_round_profile(torch, topo, cfg, lanes)
        say(f"(q1) gossip round, {lanes} lane(s) (utils/profiling.py's "
            f"profiler): device busy {busy:.4f} ms/round, CUDA events "
            f"{event:.4f}, host enqueue {enq:.4f}, idle share {idle:.3f}")
    del sweep, solos
    sub_lap("q1")

    # (q2) the fanout-one push-sum seed sweep: 32 rounds with the
    # predicate off held to the standalone runs, then to convergence
    cfg = RunConfig(**SWEEP_PS_ARGV, device="cuda")
    held = dataclasses.replace(cfg, streak_target=2**30,
                               max_rounds=SWEEP_PS_ROUNDS)
    sweep = run_simulation(topo, dataclasses.replace(held, sweep=spec))
    worst = {"s": 0.0, "w": 0.0}
    for i in range(SWEEP_LANES):
        solo = run_simulation(topo, spec.lane_config(held, i)).final_state
        lane = sweep.lane_state(i)
        require(torch.equal(lane.alive, solo.alive)
                and int(lane.round) == int(solo.round) == SWEEP_PS_ROUNDS,
                f"(q2) lane {i}: alive sets or rounds differ")
        for f in ("s", "w"):
            worst[f] = max(worst[f], max_abs_err(torch, getattr(lane, f),
                                                 getattr(solo, f)))
    require(worst["s"] <= SCATTER_TOL and worst["w"] <= SCATTER_TOL,
            f"(q2) lanes against their standalone runs {worst} over "
            f"{SCATTER_TOL}")
    say(f"(q2) imp3D 1M fanout-one push-sum, {SWEEP_LANES} seed lanes, "
        f"{SWEEP_PS_ROUNDS} rounds predicate off: max |diff| against the "
        f"standalone card runs s {worst['s']:.3e}, w {worst['w']:.3e} "
        f"(within {SCATTER_TOL}), equal alive sets")
    sweep = run_simulation(topo, dataclasses.replace(cfg, sweep=spec))
    solos = [run_simulation(topo, spec.lane_config(cfg, i))
             for i in range(SWEEP_LANES)]
    require(sweep.converged and all(s.converged for s in solos),
            "(q2) a push-sum lane or run did not converge")
    serial = sum(s.wall_ms for s in solos)
    say(f"(q2) to convergence (--predicate global --tol 1e-4): lane "
        f"rounds {[lr['rounds'] for lr in sweep.lane_records]}, standalone "
        f"{[s.rounds for s in solos]}; estimate error sweep "
        f"{sweep.estimate_error:.3e}; sweep {sweep.wall_ms:.1f} ms against "
        f"{serial:.1f} ms serial (ratio {sweep.wall_ms / serial:.4f}); ms "
        f"per executed round "
        f"{solos[0].wall_ms / max(solos[0].rounds_executed, 1):.4f} one "
        f"lane, {sweep.wall_ms / max(sweep.rounds_executed, 1):.4f} the "
        f"{SWEEP_LANES}")
    for lanes in (1, SWEEP_LANES):
        busy, event, enq, idle = _lane_round_profile(torch, topo, cfg, lanes)
        say(f"(q2) push-sum round, {lanes} lane(s): device busy "
            f"{busy:.4f} ms/round, CUDA events {event:.4f}, host enqueue "
            f"{enq:.4f}, idle share {idle:.3f}")
    del sweep, solos
    sub_lap("q2")

    with tempfile.TemporaryDirectory(prefix="sweeps_") as td:
        # (q3) the README's sweeps through the CLI, report, watch, history
        dirs = []
        d = os.path.join(td, "artifacts", "seeds64")
        _sweep_cli("--sweep-seeds 64", SWEEP_README_ARGV
                   + ["--telemetry-dir", d])
        dirs.append(d)
        for tag, (argv, plan) in SWEEP_TRACED_PLANS.items():
            path = os.path.join(td, tag.replace(" ", "_") + ".json")
            with open(path, "w") as fh:
                json.dump(plan, fh)
            d = os.path.join(td, "artifacts", tag.replace(" ", "_"))
            _sweep_cli(tag, argv + ["--sweep", path, "--telemetry-dir", d])
            dirs.append(d)
        from gossipprotocol_tpu_torch.cli import main as cli_main

        for d in dirs:
            rc, text = _report(d)
            require(rc == 0 and "sweep:" in text,
                    f"(q3) report {d}: exit {rc}")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(["watch", d, "--max-frames", "1"])
            require(rc == 0 and "FINISHED" in buf.getvalue(),
                    f"(q3) watch {d}: exit {rc}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["history", td, "--no-write"])
        require(rc == 0 and "indexed sweeps (3)" in buf.getvalue(),
                f"(q3) history {td}: exit {rc}")
        say(f"(q3) report, watch --max-frames 1 exit 0 on the 3 sweep "
            f"dirs; history over them exit 0: "
            f"{buf.getvalue().splitlines()[-3:]}")
    sub_lap("q3")
    capacity_on_card(torch, spec)
    sub_lap("q4")


def capacity_on_card(torch, spec):
    """(q4): the capacity model's predicted total against the card's
    measured peak on every path, and the CLI's plan and preflight."""
    import dataclasses

    from gossipprotocol_tpu_torch.engine.driver import (
        RunConfig, run_simulation,
    )
    from gossipprotocol_tpu_torch.obs.capacity import estimate_for_topology
    from gossipprotocol_tpu_torch.ops import (
        kernel_launches, reset_kernel_launches,
    )
    from gossipprotocol_tpu_torch.parallel import (
        make_mesh, run_simulation_sharded,
    )
    from gossipprotocol_tpu_torch.topology import build_topology

    graphs = {}
    rows = []
    for label, kind, n, kw, shards in CAPACITY_RUNS:
        if (kind, n) not in graphs:
            graphs = {(kind, n): build_topology(kind, n, seed=0, m=4)}
        g = graphs[(kind, n)]
        cfg = RunConfig(**kw, device="cuda", max_rounds=CAPACITY_ROUNDS)
        if "sweep" in label:
            cfg = dataclasses.replace(cfg, sweep=spec)
        predicted = estimate_for_topology(g, cfg, shards)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launches()
        if shards > 1:
            run_simulation_sharded(g, cfg, mesh=make_mesh(
                shards, torch.device("cuda")))
        else:
            run_simulation(g, cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        launches = {k: v for k, v in kernel_launches().items() if v}
        total = predicted["per_device"]["total_bytes"]
        ratio = total / max(peak, 1)
        rows.append((label, kind, n, total, peak, ratio))
        say(f"(q4) {label} {kind} {n}: predicted {total} B (state "
            f"{predicted['per_device']['state_bytes']}, delivery "
            f"{predicted['per_device']['delivery_bytes']}, temp "
            f"{predicted['per_device']['temp_bytes']}) against measured "
            f"peak {peak} B: {ratio:.3f}x; launches {launches}")
        require(total >= peak, f"(q4) {label} {kind} {n}: predicted {total} "
                f"B below the measured peak {peak} B")
        if ratio > CAPACITY_SLACK:
            say(f"(q4) over {CAPACITY_SLACK}x: {label} {kind} {n} "
                f"({ratio:.3f}x)")
    del graphs
    # the CLI: plan over the card's capacity, and the run preflight
    rc, text, etext, _ = _run_cli(["plan", "2000000000", "imp3D"])
    require(rc == 1 and "torch.cuda total_memory" in text
            and "OVER CAPACITY" in text,
            f"(q4) plan 2000000000 imp3D: exit {rc}\n{text}{etext}")
    say("(q4) plan 2000000000 imp3D | " + " | ".join(
        ln.strip() for ln in text.splitlines()
        if "capacity:" in ln or "verdict" in ln or "feasible" in ln))
    os.environ["GOSSIP_TPU_HBM_BYTES"] = "64000000"
    try:
        from gossipprotocol_tpu_torch.engine import driver as drv

        real, built = drv.device_arrays, []
        drv.device_arrays = lambda *a, **k: built.append(1) or real(*a, **k)
        try:
            rc, text, etext, _ = _run_cli(["1000000", "imp3D", "push-sum"])
        finally:
            drv.device_arrays = real
    finally:
        del os.environ["GOSSIP_TPU_HBM_BYTES"]
    require(rc == 2 and not built and "max feasible n" in etext,
            f"(q4) imp3D 1M under a 64 MB budget: exit {rc}, "
            f"{len(built)} plan builds\n{etext}")
    say(f"(q4) imp3D 1M under GOSSIP_TPU_HBM_BYTES=64000000: exit 2 before "
        f"any plan build | {etext.strip()}")


def summarize(records, totals, stream_rate):
    """One record per kernel: its largest main-path call, with its bytes
    over the measured stream rate (``bound_stream_ms``) beside the
    nominal bound."""
    out = []
    for kname, (source, replaces) in KERNELS.items():
        mine = [r for r in records if r["name"] == kname]
        require(mine, f"kernel {kname} was not measured")
        # the megakernel's main path runs K = 16; the walk's, the CLI's
        # imp3D graph
        if kname == "walk_chunk":
            mine = [r for r in mine if r["graph"] == WALK_MAIN_GRAPH]
        big = max((r for r in mine if r["call"] != "K=1"),
                  key=lambda r: r["bytes"])
        extra = {"launches_from": NO_CLI_PATH} if kname in HUB_KERNELS \
            else {}
        if kname in PROBE_KERNELS:
            extra = {"launches_from": NO_CLI_PATH_PROBES, "row": big["row"]}
        for key in ("graph_ms", "library_graph_ms", "bound_l2_ms",
                    "latency_floor_ms", "ms_per_hop", "plain_ms_per_hop"):
            if key in big:
                extra[key] = big[key]
        out.append(dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=totals[kname], **extra,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=big["ms"], plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
            bound_by=big["bound_by"], library_ms=big["library_ms"],
            bound_stream_ms=big["bytes"] / stream_rate * 1e3,
            shape=f"{big['graph']} {big['call']}"))
    return out


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(
        argv)
    try:
        import torch
    except ImportError:
        print("FAIL: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import gossipprotocol_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the gossipprotocol_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="plan_cache_") as cache:
        os.environ["GOSSIP_TPU_PLAN_CACHE"] = cache
        laps = [time.perf_counter()]

        def lap(phases):
            laps.append(time.perf_counter())
            say(f"({phases}) seconds {laps[-1] - laps[-2]:.1f}")

        try:
            card = phase_card(torch)
            lap("a")
            records, expected, hubs = phase_kernels(torch)
            lap("b")
            totals, pallas_runs = phase_cli(torch, expected)
            lap("c")
            phase_card_vs_cpu(torch)
            lap("d")
            records += phase_megakernel(torch)
            lap("e")
            totals["megakernel"] = phase_megakernel_cli(torch)
            lap("f")
            routed_records, routed_totals, matvecs = phase_routed(
                torch, pallas_runs)
            records += routed_records
            totals.update(routed_totals)
            lap("g")
            sharded_records, sharded_totals = phase_sharded(
                torch, pallas_runs, matvecs)
            del matvecs
            records += sharded_records
            totals.update(sharded_totals)
            lap("h")
            hub_records, hub_totals = phase_hub_kernels(torch, hubs)
            del hubs
            records += hub_records
            totals.update(hub_totals)
            lap("i")
            phase_reference(torch)
            lap("j")
            probe_records, probe_totals, stream_rate = phase_probes(torch)
            records += probe_records
            totals.update(probe_totals)
            lap("k")
            walk_records, totals["walk_chunk"] = phase_reference_semantics(
                torch)
            records += walk_records
            lap("l")
            phase_native_and_curves(torch)
            lap("m")
            phase_faults(torch, totals)
            lap("n")
            phase_workloads(torch, totals)
            lap("o")
            phase_telemetry(torch, totals)
            lap("p")
            phase_sweeps(torch)
            lap("q")
            kernels = summarize(records, totals, stream_rate)
        except SmokeFailure as e:
            # on both streams: a caller that keeps only one still sees why
            print(f"FAIL: {e}", flush=True)
            print(f"FAIL: {e}", file=sys.stderr, flush=True)
            return 1
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_kernels.json"),
              "w") as fh:
        json.dump({"card": card, "records": records, "kernels": kernels,
                   "stream_bytes_per_s": stream_rate}, fh, indent=1)
    say(f"total {time.perf_counter() - t0:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
