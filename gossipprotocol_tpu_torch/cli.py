"""Command-line entry point of the PyTorch port.

    python -m gossipprotocol_tpu_torch N TOPOLOGY gossip|push-sum
        [--threshold H] [--no-keep-alive] [--seed-node I]
        [--predicate delta|global] [--eps E] [--tol T] [--streak S]
        [--value-mode scaled|index] [--semantics intended|reference]
        [--device cuda|cpu] [--backend auto|cpu|gpu|cuda] [--check]
    python -m gossipprotocol_tpu_torch N TOPOLOGY push-sum \\
        --fanout all --delivery pallas|routed|megakernel
        [--rounds-per-kernel K]
        [--devices S [--exchange-overlap] [--payload-wire f32|bf16|int8]
         [--build-workers W] [--routed-design push]]
        [--plan-cache DIR|none] [--device cuda|cpu]

With no flags it runs what the JAX package's CLI runs by default (the
reference's own surface): gossip, or push-sum with one random target per
node per round (``--fanout one --delivery scatter``). ``--semantics
reference`` runs the reference's accidental rules: its N+1-actor
population (:func:`_build_run_topology`), gossip at threshold + 1 and
push-sum as the single-token walk.

The positional surface and the output follow the JAX package's CLI (the
reference's ``N topology algorithm`` → ``Convergence Time: %f ms``). Exit
codes: 0 converged, 1 not converged (``--max-rounds`` reached, or a
gossip run whose rumor died out), 2 bad input. ``--check`` builds and
validates the topology, prints its shape and exits 0 (2 if invalid)
without simulating. ``--backend`` is the JAX CLI's platform flag mapped
onto ``--device`` (:func:`resolve_backend`). Every flag and combination
the port does not have yet exits 2 and names itself; nothing falls back
quietly to another path.
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
    "--build",
    "--build-memory-budget", "--payload-dim", "--workload", "--clock",
    "--activation-rate", "--groups", "--accel", "--accel-lambda", "--lr",
    "--local-steps", "--sgp-samples", "--loss-tol", "--x64",
    "--edge-chunks", "--metrics-out",
    "--checkpoint-dir", "--checkpoint-every", "--resume", "--auto-resume",
    "--restarted", "--fail-fraction", "--fail-round", "--revive-round",
    "--drop-prob", "--drop-window", "--fault-plan", "--event-plan",
    "--churn", "--value-faults", "--sentinel", "--profile-dir",
    "--telemetry-dir", "--sweep", "--sweep-seeds", "--round-budget",
    "--trace-cap", "--compile-cache", "--request-id", "--admission-json",
)

# --backend names and the --device each selects ("auto": --device's own)
BACKEND_DEVICES = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}

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
                    "(gossip and fanout-one push-sum over the scatter "
                    "delivery; fanout-all push-sum over the fused gather "
                    "delivery, the Clos-routed delivery and the K-round "
                    "megakernel)",
    )
    p.add_argument("num_nodes", type=int)
    p.add_argument("topology", type=str)
    p.add_argument("algorithm", type=str)
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the run executes: cuda (the default: the "
                        "hand-written kernels; fails without a card) or "
                        "cpu (their plain PyTorch versions)")
    p.add_argument("--backend", default="auto",
                   help="the JAX CLI's platform flag: auto (whatever "
                        "--device says), cpu (--device cpu), gpu or cuda "
                        "(--device cuda); any other, or one that "
                        "contradicts --device, exits 2")
    p.add_argument("--devices", type=int, default=1,
                   help="shard the node state over this many shards (the "
                        "push design; every shard lives on the --device "
                        "card, run in lockstep)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threshold", type=int, default=10,
                   help="gossip: hearings to converge (README.md:2)")
    p.add_argument("--semantics", choices=["intended", "reference"],
                   default="intended",
                   help="'reference': the F# simulator's accidental rules "
                        "(its N+1-actor population and imp3D wiring quirks, "
                        "gossip's 11th hearing, push-sum as a single-token "
                        "walk whose rounds are hops)")
    p.add_argument("--repair", choices=["off", "prune", "rewire"],
                   default="off",
                   help="topology repair at fault events ('prune' and "
                        "'rewire' are not yet ported: faults are not)")
    p.add_argument("--no-keep-alive", action="store_true",
                   help="gossip: a node stops spreading at its threshold "
                        "(the reference's per-node stop rule; a run can "
                        "stall, and then exits 1)")
    p.add_argument("--seed-node", type=int, default=None,
                   help="gossip start node (default: drawn from --seed)")
    p.add_argument("--value-mode", choices=["scaled", "index"],
                   default="scaled",
                   help="push-sum init: i/N or the reference's s_i = i")
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
                   help="push-sum sender: one random neighbor per round "
                        "(the reference's send) or fanout-all diffusion")
    p.add_argument("--delivery",
                   choices=["scatter", "invert", "routed", "pallas",
                            "megakernel"],
                   default="scatter",
                   help="push-sum delivery. fanout one: 'scatter' (an "
                        "index_add_ of the halves; 'invert' is not yet "
                        "ported). fanout all: 'routed' (expand, Clos "
                        "routing plans, class folds), 'pallas' (the routed "
                        "pipeline fused into two gathers around the class "
                        "folds) and 'megakernel' (the pallas path with the "
                        "whole protocol round fused into one persistent "
                        "kernel, running --rounds-per-kernel rounds per "
                        "launch; all-alive, resident gather plans) are "
                        "ported")
    p.add_argument("--routed-design", choices=["pull", "push"], default=None,
                   help="sharded routed delivery variant (requires "
                        "--delivery routed or pallas with --devices N). "
                        "'push' (default): owner-computes — each shard "
                        "expands only its owned rows and one exchange "
                        "moves the edge shares, every table O(E/S + "
                        "local_n). 'pull' is not yet ported")
    p.add_argument("--payload-wire", choices=["f32", "bf16", "int8"],
                   default="f32",
                   help="wire format of the sharded push exchange "
                        "(requires --devices N with --delivery "
                        "routed/pallas). bf16 halves and int8 quarters "
                        "the exchange bytes; accumulation stays f32. f32 "
                        "(default) is the bitwise path")
    p.add_argument("--exchange-overlap", action="store_true",
                   help="the sharded push exchange on the ring schedule "
                        "(one exchange-kernel launch per ring offset) "
                        "instead of every copy in one launch (requires "
                        "--devices N with --delivery routed/pallas; the "
                        "same bytes move)")
    p.add_argument("--build-workers", type=int, default=None, metavar="N",
                   help="processes for cold sharded-plan builds (default "
                        "min(num_shards, cpu_count)); plans are "
                        "bitwise-identical for every N. 1 forces the "
                        "serial builder")
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
    p.add_argument("--check", action="store_true",
                   help="build and validate the topology, print its shape "
                        "summary, and exit without simulating")
    p.add_argument("--quiet", action="store_true",
                   help="suppress everything except the convergence metric")
    return p


def resolve_backend(backend: str, device) -> str:
    """The run's device from ``--backend`` and ``--device`` (None when not
    given): ``auto`` takes ``--device`` (default cuda), ``cpu`` and
    ``gpu``/``cuda`` select that device. Raises ValueError (exit 2) for a
    backend this port or this machine lacks, in the JAX CLI's words, and
    for a pair that contradicts itself."""
    if backend == "auto":
        return device or "cuda"
    want = BACKEND_DEVICES.get(backend)
    if want is None:
        raise ValueError(
            f"backend {backend!r} unavailable: the PyTorch port runs on "
            "cpu or cuda (--backend cpu, gpu or cuda)")
    if device is not None and device != want:
        raise ValueError(
            f"--backend {backend} contradicts --device {device} (--backend "
            f"{backend} runs on {want}; give one of the two)")
    if want == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise ValueError(
                f"backend {backend!r} unavailable: "
                "torch.cuda.is_available() is False")
    return want


def _unported(argv) -> str | None:
    """The first flag or subcommand of ``argv`` the port lacks, if any."""
    if argv and argv[0] in UNPORTED_SUBCOMMANDS:
        return argv[0]
    for tok in argv:
        flag = tok.split("=", 1)[0]
        if flag in UNPORTED_FLAGS:
            return flag
    return None


def _build_run_topology(args):
    """argv -> (Topology, alert_quorum) with the reference-mode
    population (the JAX package's CLI rule).

    ``--semantics reference`` renders the reference's N+1-actor quirk
    (``Program.fs:169-176`` spawns actors ``0..nodes``; the supervisor
    exits at ``nodes`` Alerts, ``Program.fs:53``):

      * line/full: the wiring loops cover all ``nodes+1`` actors, so the
        graph is built one node larger and the run converges at ``nodes``
        settled — all but one;
      * 3D/imp3D: ``nodes`` is first rounded to the cube; the wiring
        covers cube indices only, so the extra actor is one edge-less row,
        which the birth-exclusion rule keeps out of the predicate;
      * imp3D draws its extra neighbor with the reference's off-by-one,
        directed, self/duplicate-allowing rule
        (:func:`~gossipprotocol_tpu_torch.topology.builders.
        build_imp3d_reference_quirks`).

    Intended mode and the other topologies are untouched."""
    from gossipprotocol_tpu_torch.topology import build_topology
    from gossipprotocol_tpu_torch.topology.builders import (
        add_isolated_rows, build_imp3d_reference_quirks,
    )
    from gossipprotocol_tpu_torch.topology.registry import canonical_name

    name = canonical_name(args.topology)
    if args.semantics == "reference":
        if name in ("line", "full"):
            return build_topology(name, args.num_nodes + 1), args.num_nodes
        if name == "imp3D":
            return add_isolated_rows(build_imp3d_reference_quirks(
                args.num_nodes, seed=args.seed)), None
        if name == "3D":
            return add_isolated_rows(
                build_topology(name, args.num_nodes)), None
    return build_topology(
        args.topology, args.num_nodes, seed=args.seed,
        avg_degree=args.avg_degree, m=args.attach, k=args.ws_k,
        beta=args.ws_beta), None


def _check_sharding(args, cfg) -> None:
    """The JAX CLI's rejections of the sharding flags (its messages),
    raised as ValueError (exit 2), and the sharded runs not yet ported."""
    from gossipprotocol_tpu_torch.engine.driver import (
        NotPortedError, is_walk,
    )

    if args.devices > 1 and is_walk(cfg):
        raise ValueError(
            "semantics='reference' push-sum is the single-token walk "
            "(one MainPushSum in flight, Program.fs:128) — a serial "
            "process that cannot shard; drop --devices")
    if args.devices > 1 and (cfg.algorithm == "gossip"
                             or cfg.fanout == "one"):
        raise NotPortedError(
            "option not yet ported: --devices with gossip or push-sum "
            "--fanout one (the sharded push design runs --fanout all)")
    if args.routed_design is not None and (
            cfg.delivery not in ("routed", "pallas") or args.devices <= 1):
        raise ValueError(
            "--routed-design selects between the sharded routed "
            "delivery variants — it needs --delivery routed (or "
            "pallas, push-only) AND --devices N (got delivery=%r, "
            "devices=%d)" % (cfg.delivery, args.devices))
    if args.devices > 1 and (
            cfg.delivery == "megakernel" or cfg.rounds_per_kernel > 1):
        raise ValueError(
            "the round-loop megakernel is single-chip only (the "
            "in-kernel round has no exchange step) — drop --devices "
            "or --rounds-per-kernel")
    if cfg.payload_wire != "f32" and args.devices <= 1:
        raise ValueError(
            "--payload-wire compresses the sharded edge-share "
            "exchange; a single-chip run has no wire — drop the flag "
            "or add --devices N")
    if cfg.exchange_overlap and args.devices <= 1:
        raise ValueError(
            "--exchange-overlap rewrites the sharded exchange; a "
            "single-chip run has no exchange — drop the flag or add "
            "--devices N")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    bad = _unported(argv)
    if bad is not None:
        print(f"option not yet ported: {bad} (the PyTorch port runs "
              "gossip and push-sum --fanout one --delivery scatter, "
              "--semantics reference, push-sum --fanout all --delivery "
              "pallas|routed|megakernel (with --devices S on one card), "
              "--check and --backend; use python -m gossipprotocol_tpu for "
              "the rest)", file=sys.stderr)
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

    from gossipprotocol_tpu_torch.engine.driver import (
        DELIVERIES, NotPortedError, RunConfig, resolve_device,
        run_simulation,
    )
    from gossipprotocol_tpu_torch.ops.delivery import RoutedConfigError
    from gossipprotocol_tpu_torch.utils.metrics import (
        print_convergence_time, print_start_banner,
    )

    try:
        if args.routed_design == "pull":
            raise NotPortedError(
                "option not yet ported: --routed-design pull (the "
                "sharded push design is ported)")
        if args.devices < 1:
            raise ValueError(f"--devices must be >= 1, got {args.devices}")
        args.device = resolve_backend(args.backend, args.device)
        device = resolve_device(args.device)
        topo, alert_quorum = _build_run_topology(args)
    except (ValueError, RuntimeError, NotImplementedError) as e:
        print(str(e), file=sys.stderr)
        return 2
    if not args.quiet and topo.num_nodes != args.num_nodes:
        if args.semantics == "reference":
            quorum_note = (f", supervisor exits at {alert_quorum} Alerts"
                           if alert_quorum else "")
            print(f"note: reference population is {topo.num_nodes} actors "
                  f"for {args.num_nodes} requested nodes "
                  f"(Program.fs:169-176,239-240{quorum_note})")
        else:
            print(f"note: {args.topology} rounds {args.num_nodes} up to "
                  f"{topo.num_nodes} nodes (Program.fs:239-240 semantics)")
    if args.check:
        try:
            topo.validate()
        except AssertionError as e:
            print(f"topology invalid: {e}", file=sys.stderr)
            return 2
        deg = topo.degree
        print(f"topology ok: kind={topo.kind} nodes={topo.num_nodes} "
              f"directed_edges={topo.num_directed_edges} "
              f"degree min/mean/max = {int(deg.min())}/"
              f"{float(deg.mean()):.2f}/{int(deg.max())}")
        return 0
    try:
        if args.repair != "off" and args.semantics == "reference":
            raise ValueError(
                "repair applies to faulted runs; semantics='reference' "
                "rejects fault schedules entirely, so there is nothing "
                "to repair")
        if args.repair != "off":
            raise NotPortedError(
                "option not yet ported: --repair (faults and topology "
                "repair are not ported; only --repair off runs)")
        cfg = RunConfig(
            algorithm=algo, seed=args.seed, threshold=args.threshold,
            keep_alive=not args.no_keep_alive, seed_node=args.seed_node,
            semantics=args.semantics, alert_quorum=alert_quorum,
            eps=args.eps, streak_target=args.streak,
            predicate=args.predicate, tol=args.tol, fanout=args.fanout,
            delivery=args.delivery, value_mode=args.value_mode,
            max_rounds=args.max_rounds,
            chunk_rounds=args.chunk_rounds,
            rounds_per_kernel=args.rounds_per_kernel,
            plan_cache=args.plan_cache, device=args.device,
            routed_design=args.routed_design or "push",
            payload_wire=args.payload_wire,
            exchange_overlap=args.exchange_overlap,
            build_workers=args.build_workers,
        )
        _check_sharding(args, cfg)
        if cfg.delivery in DELIVERIES and topo.implicit_full:
            raise ValueError(
                f"delivery='{cfg.delivery}' needs an explicit edge list; "
                "the complete graph has none (diffusion on K_n mixes in "
                "one round via two reductions) — use delivery='scatter'")
        if cfg.seed_node is not None \
                and not 0 <= cfg.seed_node < topo.num_nodes:
            raise ValueError(
                f"--seed-node {cfg.seed_node} is not a node of the "
                f"{topo.num_nodes}-node graph")
        if args.devices > 1:
            from gossipprotocol_tpu_torch.parallel import (
                make_mesh, placement_line,
            )

            mesh = make_mesh(args.devices, device)
            print(placement_line(mesh), file=sys.stderr)
    except (ValueError, RuntimeError, NotImplementedError) as e:
        print(str(e), file=sys.stderr)
        return 2
    if not args.quiet:
        print_start_banner(algo)
    try:
        if args.devices > 1:
            from gossipprotocol_tpu_torch.parallel import (
                run_simulation_sharded,
            )

            result = run_simulation_sharded(topo, cfg, mesh=mesh)
        else:
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
