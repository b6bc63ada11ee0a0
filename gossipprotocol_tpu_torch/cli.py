"""Command-line entry point of the PyTorch port.

    python -m gossipprotocol_tpu_torch N TOPOLOGY push-sum \\
        --fanout all --delivery pallas|routed|megakernel
        [--rounds-per-kernel K]
        [--plan-cache DIR|none] [--device cuda|cpu]

The positional surface and the output follow the JAX package's CLI (the
reference's ``N topology algorithm`` → ``Convergence Time: %f ms``). Exit
codes: 0 converged, 1 not converged (``--max-rounds`` reached), 2 bad
input. Every flag and combination the port does not have yet exits 2
and names itself; nothing falls back quietly to another path.
"""

from __future__ import annotations

import argparse
import sys

_ALGO_ALIASES = {
    "gossip": "gossip",
    "push-sum": "push-sum",
    "push_sum": "push-sum",
    "pushsum": "push-sum",
    "push sum": "push-sum",
}

# flags of the JAX package's CLI that this port does not have yet
UNPORTED_FLAGS = (
    "--backend", "--devices", "--threshold", "--semantics",
    "--routed-design", "--payload-wire",
    "--exchange-overlap", "--build-workers", "--build",
    "--build-memory-budget", "--value-mode", "--payload-dim", "--workload", "--clock",
    "--activation-rate", "--groups", "--accel", "--accel-lambda", "--lr",
    "--local-steps", "--sgp-samples", "--loss-tol", "--x64",
    "--no-keep-alive", "--seed-node", "--edge-chunks", "--metrics-out",
    "--checkpoint-dir", "--checkpoint-every", "--resume", "--auto-resume",
    "--restarted", "--fail-fraction", "--fail-round", "--revive-round",
    "--drop-prob", "--drop-window", "--fault-plan", "--event-plan",
    "--churn", "--value-faults", "--sentinel", "--repair", "--profile-dir",
    "--telemetry-dir", "--sweep", "--sweep-seeds", "--round-budget",
    "--trace-cap", "--compile-cache", "--request-id", "--admission-json",
    "--check",
)

# subcommands of the JAX package's CLI that this port does not have yet
UNPORTED_SUBCOMMANDS = ("report", "watch", "history", "plan", "serve",
                        "submit", "status")


def _positive_int(text: str) -> int:
    v = int(text)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gossipprotocol_tpu_torch",
        description="PyTorch/CUDA port of the gossip / push-sum simulator "
                    "(fanout-all push-sum over the fused gather delivery, "
                    "the Clos-routed delivery and the K-round megakernel)",
    )
    p.add_argument("num_nodes", type=int)
    p.add_argument("topology", type=str)
    p.add_argument("algorithm", type=str)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the run executes: cuda (the hand-written "
                        "kernels; fails without a card) or cpu (their "
                        "plain PyTorch versions)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eps", type=float, default=1e-10,
                   help="push-sum: |Δ(s/w)| tolerance (Program.fs:116)")
    p.add_argument("--streak", type=int, default=3,
                   help="push-sum: consecutive small-delta rounds "
                        "(Program.fs:121)")
    p.add_argument("--predicate", choices=["delta", "global"],
                   default="delta",
                   help="push-sum convergence rule: local delta streak, or "
                        "the sound global |s/w - mean| <= tol test")
    p.add_argument("--tol", type=float, default=1e-4,
                   help="tolerance for --predicate global")
    p.add_argument("--fanout", choices=["one", "all"], default="one",
                   help="push-sum sender; only 'all' (diffusion) is ported")
    p.add_argument("--delivery",
                   choices=["scatter", "invert", "routed", "pallas",
                            "megakernel"],
                   default="scatter",
                   help="fanout-all delivery; 'routed' (expand, Clos "
                        "routing plans, class folds), 'pallas' (the routed "
                        "pipeline fused into two gathers around the class "
                        "folds) and 'megakernel' (the pallas path with the "
                        "whole protocol round fused into one persistent "
                        "kernel, running --rounds-per-kernel rounds per "
                        "launch; all-alive, resident gather plans) are "
                        "ported")
    p.add_argument("--rounds-per-kernel", type=_positive_int, default=1,
                   metavar="K",
                   help="protocol rounds fused into one kernel launch "
                        "(requires --delivery pallas or megakernel; "
                        "--delivery megakernel with K=1 is bitwise the "
                        "pallas path per round). Amortizes launch and "
                        "host enqueue overhead; convergence trajectories "
                        "are identical for every K because the in-kernel "
                        "loop stops once the predicate fires")
    p.add_argument("--plan-cache", type=str, default=None, metavar="DIR",
                   help="delivery plan cache directory (default "
                        "$GOSSIP_TPU_PLAN_CACHE or "
                        "~/.cache/gossipprotocol_tpu/routed-plans, shared "
                        "with the JAX package; 'none' disables). Plans are "
                        "keyed by the adjacency digest; a hit loads bitwise "
                        "the tables a build would produce")
    p.add_argument("--max-rounds", type=int, default=1_000_000)
    p.add_argument("--chunk-rounds", type=int, default=None,
                   help="rounds per host fetch (default 16, rounded up "
                        "to a multiple of --rounds-per-kernel)")
    p.add_argument("--avg-degree", type=float, default=8.0,
                   help="erdos_renyi mean degree")
    p.add_argument("--attach", type=int, default=4,
                   help="power_law edges per new node (BA m)")
    p.add_argument("--ws-k", type=int, default=6,
                   help="small_world ring-lattice degree (even)")
    p.add_argument("--ws-beta", type=float, default=0.1,
                   help="small_world rewiring probability in [0, 1]")
    p.add_argument("--quiet", action="store_true",
                   help="suppress everything except the convergence metric")
    return p


def _unported(argv) -> str | None:
    """The first flag or subcommand of ``argv`` the port lacks, if any."""
    if argv and argv[0] in UNPORTED_SUBCOMMANDS:
        return argv[0]
    for tok in argv:
        flag = tok.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            return flag
    return None


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    bad = _unported(argv)
    if bad is not None:
        print(f"option not yet ported: {bad} (the PyTorch port runs "
              "push-sum --fanout all --delivery pallas|routed|megakernel; use "
              "python -m gossipprotocol_tpu for the rest)", file=sys.stderr)
        return 2
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:  # argparse's usage errors are exit 2
        return int(e.code or 0)

    algo = _ALGO_ALIASES.get(args.algorithm.lower())
    if algo is None:
        print(f"option invalid: unknown algorithm {args.algorithm!r} "
              f"(valid: gossip, push-sum)", file=sys.stderr)
        return 2
    if algo != "push-sum":
        print(f"option not yet ported: algorithm {algo!r} (the PyTorch "
              "port runs push-sum --fanout all --delivery "
              "pallas|routed|megakernel)", file=sys.stderr)
        return 2
    if args.fanout != "all":
        print(f"option not yet ported: --fanout {args.fanout} (only "
              "--fanout all is ported)", file=sys.stderr)
        return 2
    if args.delivery not in ("pallas", "routed", "megakernel"):
        print(f"option not yet ported: --delivery {args.delivery} (only "
              "--delivery pallas, routed and megakernel are ported)",
              file=sys.stderr)
        return 2

    from gossipprotocol_tpu_torch.engine.driver import (
        RunConfig, resolve_device, run_simulation,
    )
    from gossipprotocol_tpu_torch.ops.delivery import RoutedConfigError
    from gossipprotocol_tpu_torch.topology import build_topology
    from gossipprotocol_tpu_torch.utils.metrics import (
        print_convergence_time, print_start_banner,
    )

    try:
        device = resolve_device(args.device)
        cfg = RunConfig(
            algorithm=algo, seed=args.seed, eps=args.eps,
            streak_target=args.streak, predicate=args.predicate,
            tol=args.tol, fanout=args.fanout, delivery=args.delivery,
            max_rounds=args.max_rounds,
            chunk_rounds=args.chunk_rounds,
            rounds_per_kernel=args.rounds_per_kernel,
            plan_cache=args.plan_cache, device=args.device,
        )
        topo = build_topology(
            args.topology, args.num_nodes, seed=args.seed,
            avg_degree=args.avg_degree, m=args.attach, k=args.ws_k,
            beta=args.ws_beta,
        )
        if topo.implicit_full:
            raise ValueError(
                f"delivery='{cfg.delivery}' needs an explicit edge list; "
                "the complete graph has none (diffusion on K_n mixes in "
                "one round via two reductions) — use delivery='scatter'")
    except (ValueError, RuntimeError, NotImplementedError) as e:
        print(str(e), file=sys.stderr)
        return 2
    if not args.quiet and topo.num_nodes != args.num_nodes:
        print(f"note: {args.topology} rounds {args.num_nodes} up to "
              f"{topo.num_nodes} nodes (Program.fs:239-240 semantics)")
    if not args.quiet:
        print_start_banner(algo)
    try:
        result = run_simulation(topo, cfg)
    except RoutedConfigError as e:
        print(str(e), file=sys.stderr)
        return 2

    print_convergence_time(result.wall_ms)
    if not args.quiet:
        print(f"rounds: {result.rounds} ({result.rounds_executed} executed)"
              f"  converged: {result.converged}  "
              f"nodes: {result.num_nodes}  compile: "
              f"{result.compile_ms:.1f} ms  device: {device}")
        err = result.estimate_error
        if err is not None:
            print(f"push-sum max |s/w - mean| = {err:.3e}")
    return 0 if result.converged else 1


if __name__ == "__main__":
    raise SystemExit(main())
