"""Reproduce the reference's benchmark curves (Report.pdf p.1-2) with the
port (a copy of ``gossipprotocol_tpu/experiments/curves.py``).

The reference's published evidence is two hand-made graphs: convergence
time vs node count for the four topologies, one graph per algorithm. This
tool sweeps the same grid through the port's ``run_simulation`` and emits
a CSV (plus an optional JSON summary):

    python -m gossipprotocol_tpu_torch.experiments.curves \\
        --nodes 100,250,500,750,1000 --out curves.csv [--device cpu]

Columns, flags and defaults are the JAX tool's, plus ``--device`` (cuda
by default; cpu runs the plain PyTorch versions): algorithm, topology,
nodes_requested, nodes_actual, rounds, wall_ms, compile_ms, converged,
estimate_error, global_rounds, global_converged, global_estimate_error.
The runs take the port's chunk sizes (the JAX tool fixes 4,096 rounds a
fetch, a TPU dispatch size; on the port's per-round paths a chunk runs to
its limit), which changes no round count.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys

DEFAULT_NODES = "100,250,500,750,1000"
DEFAULT_TOPOLOGIES = "line,full,3D,imp3D"
DEFAULT_ALGORITHMS = "gossip,push-sum"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="curves")
    p.add_argument("--nodes", default=DEFAULT_NODES)
    p.add_argument("--topologies", default=DEFAULT_TOPOLOGIES)
    p.add_argument("--algorithms", default=DEFAULT_ALGORITHMS)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeats", type=int, default=3,
                   help="runs per point; wall_ms reports the minimum (the "
                        "engine's warm-up chunk already keeps the kernel "
                        "build out of wall_ms; repeats guard the residue)")
    p.add_argument("--global-check", action="store_true",
                   help="push-sum rows: also run --predicate global "
                        "(sound, mass-conservation-based) and record its "
                        "rounds/error next to the delta-predicate row, so "
                        "the artifact can't present the delta rule's early "
                        "firing on slow mixers as converged success")
    p.add_argument("--global-max-rounds", type=int, default=200_000,
                   help="round budget for the --global-check runs (the "
                        "sound predicate needs the true mixing time, which "
                        "is O(n^2 log 1/tol) on the line graph — far past "
                        "where the delta rule fires)")
    p.add_argument("--semantics", choices=["intended", "reference"],
                   default="intended")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the runs execute: cuda (the hand-written "
                        "kernels) or cpu (their plain PyTorch versions)")
    p.add_argument("--out", default="curves.csv")
    p.add_argument("--json-out", default=None)
    args = p.parse_args(argv)

    from gossipprotocol_tpu_torch import (
        RunConfig, build_topology, run_simulation,
    )

    nodes_list = [int(x) for x in args.nodes.split(",")]
    topologies = args.topologies.split(",")
    algorithms = args.algorithms.split(",")

    rows = []
    for algo in algorithms:
        for topo_name in topologies:
            for n in nodes_list:
                topo = build_topology(topo_name, n, seed=args.seed)
                best = None
                # same seed every repeat: min-of-repeats removes timing
                # noise only if each repeat is the same computation
                cfg = RunConfig(algorithm=algo, seed=args.seed,
                                semantics=args.semantics,
                                max_rounds=500_000, device=args.device)
                for _ in range(args.repeats):
                    res = run_simulation(topo, cfg)
                    if best is None or res.wall_ms < best.wall_ms:
                        best = res
                row = {
                    "algorithm": algo,
                    "topology": topo_name,
                    "nodes_requested": n,
                    "nodes_actual": topo.num_nodes,
                    "rounds": best.rounds,
                    "wall_ms": round(best.wall_ms, 3),
                    "compile_ms": round(best.compile_ms, 1),
                    "converged": best.converged,
                    "estimate_error": best.estimate_error,
                    "global_rounds": None,
                    "global_converged": None,
                    "global_estimate_error": None,
                }
                # predicate="global" is incompatible with reference
                # semantics (the accidental rule ignores the estimate), so
                # the comparison columns only exist for intended runs
                if (args.global_check and algo == "push-sum"
                        and args.semantics == "intended"):
                    gres = run_simulation(topo, RunConfig(
                        algorithm=algo, seed=args.seed, predicate="global",
                        semantics=args.semantics,
                        max_rounds=args.global_max_rounds,
                        device=args.device))
                    row.update(
                        global_rounds=gres.rounds,
                        global_converged=gres.converged,
                        global_estimate_error=gres.estimate_error,
                    )
                rows.append(row)
                print(f"{algo:9s} {topo_name:6s} n={n:7d} -> "
                      f"{row['wall_ms']:10.1f} ms  ({row['rounds']} rounds)",
                      file=sys.stderr)

    with open(args.out, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(rows, fh, indent=2)
    print(f"wrote {len(rows)} points to {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
