"""Command-line entry point of the PyTorch port.

    python -m gossipprotocol_tpu_torch N TOPOLOGY gossip|push-sum
        [--threshold H] [--no-keep-alive] [--seed-node I]
        [--predicate delta|global] [--eps E] [--tol T] [--streak S]
        [--value-mode scaled|index] [--semantics intended|reference]
        [--device cuda|cpu] [--backend auto|cpu|gpu|cuda] [--check]
    python -m gossipprotocol_tpu_torch N TOPOLOGY push-sum \\
        [--fanout one --delivery scatter|invert]
        [--fanout all --delivery scatter|pallas|routed|megakernel]
        [--rounds-per-kernel K] [--edge-chunks K] [--x64]
        [--payload-dim D] [--workload avg|sgp|gala [--lr LR]
         [--local-steps K] [--sgp-samples M] [--loss-tol T] [--groups G]]
        [--clock sync|poisson [--activation-rate R]]
        [--accel off|chebyshev|epd [--accel-lambda G]]
        [--devices S [--exchange-overlap] [--payload-wire f32|bf16|int8]
         [--build-workers W] [--routed-design push]]
        [--plan-cache DIR|none] [--device cuda|cpu]
    ... [--fail-fraction F --fail-round R [--revive-round R2]]
        [--drop-prob P [--drop-window A B]] [--fault-plan FILE]
        [--event-plan FILE] [--churn RATE,MODEL[,PERIOD]]
        [--value-faults RATE,MODEL[,ROUND]] [--repair off|prune|rewire]
        [--sentinel [on|quarantine|rollback]]
        [--checkpoint-dir DIR --checkpoint-every C] [--resume PATH]
        [--auto-resume N]
    ... [--telemetry-dir DIR [--trace-cap ROWS]] [--round-budget N|auto]
        [--metrics-out FILE] [--profile-dir DIR]
    ... [--sweep PLAN.json | --sweep-seeds B]
    python -m gossipprotocol_tpu_torch report DIR [--compare BASE
        [--threshold F]]
    python -m gossipprotocol_tpu_torch watch DIR | --queue-dir D
        [--interval S] [--max-frames N]
    python -m gossipprotocol_tpu_torch history [ROOT] [--metric SUBSTR]
        [--no-write]
    python -m gossipprotocol_tpu_torch plan N TOPOLOGY [ALGO] [--devices S]
        [--fanout one|all] [--delivery D] [--payload-dim D] [--x64]
        [--hbm-bytes B] [--safety F] [--json]

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
onto ``--device`` (:func:`resolve_backend`). The faults, events,
repair, checkpoint and sentinel flags print the JAX CLI's lines and exit
codes; a resume refuses a checkpoint of another run ("checkpoint
mismatch: ...") or of the JAX package, with exit 2, and ``--auto-resume
N`` re-executes the CLI from the newest resumable checkpoint when the
CUDA context dies (:func:`_is_runtime_death`). The workload flags (vector
payloads, SGP and GALA, Poisson clocks, acceleration, ``--x64``,
``--edge-chunks``) print the JAX CLI's rejections with exit 2.

Observability, as in the JAX CLI: ``--telemetry-dir DIR`` writes the run's
host spans (``events.jsonl``, a Chrome-trace ``trace.json``), its message
counters, per-round trace rows (``trace.jsonl``, downsampled past
``--trace-cap`` rows), ``resources.json`` and the manifest ``run.json``,
which ``report DIR`` renders (exit 0; 2 for a missing or newer-schema
dir; 3 when ``--compare`` finds a regression); a dir holding another
run's manifest (:class:`~gossipprotocol_tpu_torch.obs.telemetry.
TelemetryDirCollision`) exits 2. ``--round-budget N|auto`` stops a run
at N rounds (or 8x the analytic prediction) with an ``over_budget``
record and exit 1; ``--metrics-out FILE`` streams every chunk record as
JSONL (appending under ``--resume`` and recovery re-execs);
``--profile-dir DIR`` wraps the run in ``torch.profiler`` and writes its
Chrome trace there. A run stopped by an installed stop check
(``engine.driver.install_stop_check``) exits 3.

Sweeps, as in the JAX CLI: ``--sweep PLAN.json`` or ``--sweep-seeds B``
run B lanes through one round program (``sweep/``; exactly one of the
two, no ``--resume``, no ``--devices``, per-round traces off) and print a
closing ``sweep:`` line; a config outside the sweep envelope exits 2
with the JAX message. Before any plan build the capacity preflight
(``obs/capacity.py``) refuses a run the card cannot hold (exit 2; silent
on the CPU unless ``$GOSSIP_TPU_HBM_BYTES`` is set). ``watch DIR`` tails
a telemetry dir (``--queue-dir``: a serve queue dir's journal),
``history`` indexes bench records, manifests, sweeps and journals, and
``plan`` prices a request against the card's memory (exit 0 fits, 1 over
capacity, 2 bad input). Every flag and combination the port does not
have yet exits 2 and names itself (``--build``, ``--build-memory-budget``,
``--compile-cache``, ``--request-id``, ``--admission-json``, ``serve``,
``submit``, ``status``); nothing falls back quietly to another path.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
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
    "--build", "--build-memory-budget", "--compile-cache", "--request-id",
    "--admission-json",
)

# --backend names and the --device each selects ("auto": --device's own)
BACKEND_DEVICES = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}

# subcommands of the JAX package's CLI that this port does not have yet
UNPORTED_SUBCOMMANDS = ("serve", "submit", "status")

# subcommands dispatched before argparse (the run parser has three
# required positionals): name -> (module, function)
SUBCOMMANDS = {
    "report": ("gossipprotocol_tpu_torch.obs.report", "main"),
    "watch": ("gossipprotocol_tpu_torch.obs.watch", "main"),
    "history": ("gossipprotocol_tpu_torch.obs.history", "main"),
    "plan": ("gossipprotocol_tpu_torch.obs.capacity", "main"),
}


# CUDA errors after which the context is unusable (sticky): every later
# call on it fails, so recovery is a fresh process (cudaGetErrorString's
# words, as torch and the kernel launchers report them)
STICKY_CUDA_ERRORS = (
    "an illegal memory access was encountered",
    "unspecified launch failure",
    "the launch timed out and was terminated",
    "an illegal instruction was encountered",
    "misaligned address",
    "invalid program counter",
    "hardware stack error",
    "device-side assert triggered",
    "uncorrectable ECC error encountered",
    "operation not supported on global/shared address space",
)


def _positive_int(text: str) -> int:
    v = int(text)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def _unit_fraction(s: str) -> float:
    """argparse type for probabilities/fractions in [0, 1) (the JAX
    CLI's): range errors are argparse usage errors, exit 2."""
    try:
        v = float(s)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{s!r} is not a number")
    if not 0.0 <= v < 1.0:
        raise argparse.ArgumentTypeError(
            f"{v!r} is out of range — must be in [0.0, 1.0) "
            "(1.0 would kill/drop everything, which nothing survives)"
        )
    return v


def _at_least_one(s: str) -> int:
    """argparse type for integer knobs that must be >= 1 (--payload-dim,
    --local-steps, --sgp-samples, --groups; the JAX CLI's)."""
    try:
        v = int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{s!r} is not an integer")
    if v < 1:
        raise argparse.ArgumentTypeError(
            f"{v!r} is out of range — must be >= 1")
    return v


def _positive_float(s: str) -> float:
    """argparse type for strictly-positive float knobs (--lr, --loss-tol,
    --activation-rate; the JAX CLI's)."""
    try:
        v = float(s)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{s!r} is not a number")
    if not v > 0.0:
        raise argparse.ArgumentTypeError(
            f"{v!r} is out of range — must be > 0")
    return v


def _open_unit(s: str) -> float:
    """argparse type for --accel-lambda: a spectral bound strictly inside
    (0, 1) (the JAX CLI's)."""
    try:
        v = float(s)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{s!r} is not a number")
    if not 0.0 < v < 1.0:
        raise argparse.ArgumentTypeError(
            f"{v!r} is out of range — must be strictly in (0.0, 1.0)")
    return v


def resume_argv(argv, checkpoint_dir, attempts_left):
    """argv rewritten for a recovery exec (the JAX CLI's rule): any prior
    --resume/--auto-resume removed, --resume pinned to the run's own
    checkpoint dir (omitted when no checkpoint landed before the crash —
    restart from scratch), and --auto-resume set to the remaining attempt
    budget. Pure, for tests."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in ("--resume", "--auto-resume"):
            skip = True
            continue
        if a.startswith(("--resume=", "--auto-resume=")) or a == "--restarted":
            continue
        out.append(a)
    if checkpoint_dir is not None:
        out += ["--resume", checkpoint_dir]
    return out + ["--auto-resume", str(attempts_left), "--restarted"]


def _is_runtime_death(e: BaseException) -> bool:
    """The CUDA context is gone (not a program error): a sticky CUDA
    error (:data:`STICKY_CUDA_ERRORS`), after which every call on this
    context fails the same way. Anything else is a program error and is
    raised, never retried."""
    text = str(e)
    return isinstance(e, RuntimeError) and any(
        m in text for m in STICKY_CUDA_ERRORS)


def _reexec(new_argv) -> int:
    """Replace this process with a fresh CLI invocation (a new process
    gets a new CUDA context). Never returns in production (os.execv);
    the return type exists so tests can monkeypatch it and assert on
    ``new_argv``."""
    os.execv(sys.executable,
             [sys.executable, "-m", "gossipprotocol_tpu_torch", *new_argv])
    return 1  # pragma: no cover — execv does not return


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gossipprotocol_tpu_torch",
        description="PyTorch/CUDA port of the gossip / push-sum simulator "
                    "(gossip and fanout-one push-sum over the scatter "
                    "delivery; fanout-all push-sum over the fused gather "
                    "delivery, the Clos-routed delivery and the K-round "
                    "megakernel; faults, loss windows, topology events, "
                    "repair, checkpoints and the health sentinel; vector "
                    "payloads, SGP and GALA, Poisson clocks and "
                    "accelerated averaging)",
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
                   help="self-healing topology repair at fault events. "
                        "'prune' drops dead endpoints from the adjacency "
                        "(the majority-partition rule still applies, with "
                        "identical victims); 'rewire' additionally splices "
                        "the orphaned endpoints of dead nodes to each "
                        "other deterministically from --seed (degree-"
                        "preserving; leftovers draw a random live peer), "
                        "so previously-stranded survivors stay in the "
                        "computation. Repair never touches protocol state "
                        "— push-sum mass is conserved across every rewire")
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="chunks between checkpoints (0 = off)")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint file (or dir) to resume from (a "
                        "checkpoint of this package; the JAX package's "
                        "are refused)")
    p.add_argument("--auto-resume", type=int, default=0, metavar="N",
                   help="elastic recovery: if the CUDA context dies mid-run "
                        "(a sticky CUDA error) re-exec this CLI from the "
                        "latest checkpoint, at most N times. With "
                        "--checkpoint-dir/--checkpoint-every the run "
                        "resumes from the latest checkpoint; without, it "
                        "restarts from scratch. A program error is raised, "
                        "never retried")
    p.add_argument("--restarted", action="store_true",
                   help=argparse.SUPPRESS)  # set by recovery re-execs only
    p.add_argument("--fail-fraction", type=_unit_fraction, default=0.0,
                   help="fault injection: kill this fraction of nodes "
                        "(in [0, 1))")
    p.add_argument("--fail-round", type=int, default=0,
                   help="round at which the failures strike")
    p.add_argument("--revive-round", type=int, default=None, metavar="R",
                   help="churn: the --fail-fraction victims rejoin at round "
                        "R with fresh-born state (requires --fail-fraction; "
                        "R must be after --fail-round). Rejoiners count "
                        "toward convergence only once reattached to the "
                        "majority component")
    p.add_argument("--drop-prob", type=_unit_fraction, default=0.0,
                   help="message loss: per-send Bernoulli drop probability "
                        "in [0, 1). Mass-conserving for push-sum (a dropped "
                        "send keeps its (s,w) share at the sender), so "
                        "sum(s)/sum(w) == mean survives any loss rate")
    p.add_argument("--drop-window", type=int, nargs=2, default=None,
                   metavar=("START", "STOP"),
                   help="restrict --drop-prob to rounds [START, STOP) "
                        "(default: the whole run)")
    p.add_argument("--fault-plan", type=str, default=None, metavar="FILE",
                   help="declarative fault schedule (JSON): "
                        '{"kill": [{"round": R, "ids": [...]} | '
                        '{"round": R, "fraction": F, "seed": S}], '
                        '"revive": [{"round": R, "ids": [...]}], '
                        '"loss": [{"start": A, "stop": B, "prob": P}]}. '
                        "Merged with the --fail-*/--revive-*/--drop-* sugar")
    p.add_argument("--event-plan", type=str, default=None, metavar="FILE",
                   help="declarative topology schedule (JSON): "
                        '{"add_edges": [{"round": R, "edges": [[u, v], '
                        '...]}], "remove_edges": [...], "swap_neighbors": '
                        '[{"round": R, "pairs": [[[u1,v1],[u2,v2]], ...]}], '
                        '"churn": {"rate": F, "model": "edge"|"swap", '
                        '"period": P}} — may also carry the kill/revive/'
                        "loss keys of --fault-plan (one document for the "
                        "whole schedule). Events fire at chunk boundaries, "
                        "conserve push-sum mass across every rebuild, and "
                        "replay bitwise across checkpoint resume")
    p.add_argument("--churn", type=str, default=None,
                   metavar="RATE,MODEL[,PERIOD]",
                   help="seeded synthetic churn sugar: every PERIOD rounds "
                        "(default 10) touch RATE of the current edges — "
                        "model 'edge' removes/adds that many edges "
                        "(membership churn), 'swap' crosses edge pairs "
                        "degree-preservingly (mobility). Deterministic from "
                        "--seed; combines with --event-plan")
    p.add_argument("--value-faults", type=str, default=None,
                   metavar="RATE,MODEL[,ROUND]",
                   help="seeded data-fault sugar: at round ROUND (default "
                        "10) corrupt the push-sum s of RATE of the nodes — "
                        "model 'nan'/'inf' poisons them outright, 'stuck' "
                        "resets them to their initial value, 'scale:K' "
                        "multiplies by K. Victims draw deterministically "
                        "from --seed; combines with --event-plan (the "
                        "'value_faults' JSON key). Push-sum only. Pair with "
                        "--sentinel to detect/contain")
    p.add_argument("--sentinel", nargs="?", const="on", default="off",
                   choices=("off", "on", "quarantine", "rollback"),
                   help="health sentinel folded through the chunk loop: an "
                        "all-finite check on (s, w), w-positivity, and a "
                        "host mass-drift tripwire. 'on' detects and stops; "
                        "'quarantine' additionally kills the offending rows "
                        "through the host events (--repair rewire reknits "
                        "survivors) and continues; 'rollback' restores the "
                        "newest checkpoint predating the trip (needs "
                        "--checkpoint-dir/-every) and replays with the "
                        "quarantine inserted. Off: the chunk launches what "
                        "it launches without the sentinel")
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
                        "index_add_ of the halves) or 'invert' (the "
                        "receivers recompute their neighbours' draws and "
                        "gather; bounded degree, no faults, synchronous "
                        "clock, scalar payload). fanout all: 'scatter' (an "
                        "index_add_ over the edge list), 'routed' (expand, "
                        "Clos routing plans, class folds), 'pallas' (the "
                        "routed pipeline fused into two gathers around the "
                        "class folds) and 'megakernel' (the pallas path "
                        "with the whole protocol round fused into one "
                        "persistent kernel, running --rounds-per-kernel "
                        "rounds per launch; all-alive, resident gather "
                        "plans)")
    p.add_argument("--edge-chunks", type=int, default=1,
                   help="fanout-all scatter delivery in K sequential edge "
                        "slices (K-fold smaller per-edge intermediates)")
    p.add_argument("--payload-dim", type=_at_least_one, default=1,
                   metavar="D",
                   help="push-sum payload width: 1 (default) is the scalar "
                        "(s, w) protocol; D > 1 averages a per-node [D] "
                        "vector through the same delivery plans (w stays "
                        "one weight per node; ceil((D+1)/2) matvec calls a "
                        "round on pallas and routed). Requires push-sum "
                        "with intended semantics; delivery='invert' is "
                        "scalar-only")
    p.add_argument("--workload", choices=["avg", "sgp", "gala"],
                   default="avg",
                   help="what the push-sum payload carries: 'avg' (plain "
                        "averaging), 'sgp' — Stochastic Gradient Push "
                        "(arXiv:1811.10792): each node takes --local-steps "
                        "gradient steps on its synthetic least-squares "
                        "shard between mixing rounds, and the run "
                        "converges on consensus distance AND a train-loss "
                        "plateau (push-sum, --predicate global; --delivery "
                        "scatter, routed or pallas) — or 'gala' "
                        "(arXiv:1906.04585): SGP learners in --groups "
                        "groups, exactly averaged inside each group and "
                        "mixed between groups by push-sum gossip "
                        "(--delivery scatter)")
    p.add_argument("--clock", choices=["sync", "poisson"], default="sync",
                   help="execution clock: 'sync' (default) activates every "
                        "node every round; 'poisson' activates each node "
                        "i.i.d. with P = 1 - exp(-rate) a round (the "
                        "thinned continuous-time gossip of "
                        "arXiv:2011.02379; receivers stay passive), drawn "
                        "from the run's counter-based key on global ids. "
                        "Incompatible with --accel, --semantics reference "
                        "and --delivery invert")
    p.add_argument("--activation-rate", type=_positive_float, default=1.0,
                   metavar="R",
                   help="poisson clock rate r > 0 (ignored under --clock "
                        "sync)")
    p.add_argument("--groups", type=_at_least_one, default=1, metavar="G",
                   help="GALA learner-group count (>= 2, must divide the "
                        "node count; requires --workload gala). Groups "
                        "share one activation clock under --clock poisson")
    p.add_argument("--accel", choices=["off", "chebyshev", "epd"],
                   default="off",
                   help="accelerated averaging for --fanout all --delivery "
                        "scatter (fixed mixing matrix: no faults, loss, "
                        "events or repair): 'chebyshev' semi-iterative "
                        "weights (bound from --accel-lambda or a host "
                        "power-iteration estimate) or 'epd' (the "
                        "parameter-free Euler-Poisson-Darboux scheme, "
                        "arXiv:2202.10742)")
    p.add_argument("--accel-lambda", type=_open_unit, default=None,
                   metavar="G",
                   help="Chebyshev spectral bound |lambda_2(W)| strictly in "
                        "(0, 1); unset = host power-iteration estimate")
    p.add_argument("--lr", type=_positive_float, default=0.05,
                   help="SGP local gradient step size (> 0)")
    p.add_argument("--local-steps", type=_at_least_one, default=1,
                   metavar="K",
                   help="SGP gradient steps per mixing round (>= 1)")
    p.add_argument("--sgp-samples", type=_at_least_one, default=8,
                   metavar="M",
                   help="SGP least-squares rows per node shard (>= 1; m < "
                        "payload-dim keeps per-node problems "
                        "under-determined so nodes genuinely disagree)")
    p.add_argument("--loss-tol", type=_positive_float, default=1e-5,
                   help="SGP loss-plateau tolerance: converge only when "
                        "|delta mean train loss| <= this on top of the "
                        "consensus predicate")
    p.add_argument("--x64", action="store_true",
                   help="push-sum state in float64 (the scatter "
                        "deliveries; pallas, routed and megakernel route "
                        "f32 lanes)")
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
    p.add_argument("--metrics-out", type=str, default=None,
                   help="JSONL file for per-chunk metrics records")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="emit a torch.profiler trace here (a Chrome trace "
                        "of the host and the card's kernels)")
    p.add_argument("--telemetry-dir", type=str, default=None, metavar="DIR",
                   help="unified run telemetry: host spans -> DIR/events.jsonl"
                        " + a Chrome-trace DIR/trace.json, message counters "
                        "folded through every chunk, and a run manifest "
                        "DIR/run.json; render with 'python -m "
                        "gossipprotocol_tpu_torch report DIR'. Unset = zero "
                        "cost (the chunks launch what they launch without "
                        "it); set, convergence results are STILL bitwise "
                        "identical — counters ride alongside and never feed "
                        "back")
    p.add_argument("--sweep", type=str, default=None, metavar="PLAN.json",
                   help="batched-sweep plan (JSON): {\"axes\": {\"seed\": "
                        "[...], \"eps\": [...], ...}, \"mode\": "
                        "\"product\"|\"zip\"}. Expands axes that vary only "
                        "values the round treats as data (seed, seed_node, "
                        "eps, tol, threshold, activation_rate, drop_prob) "
                        "into B lanes run through ONE round program with a "
                        "leading lane dimension — one delivery build, one "
                        "fetch a chunk, per-lane convergence freezing. Lane "
                        "i is the standalone run with lane i's config "
                        "(bitwise on the CPU; on the card gossip bitwise, "
                        "push-sum up to the float atomics' order). "
                        "Structural axes (topology, algorithm, delivery, "
                        "...) are rejected with exit 2; so is --devices N")
    p.add_argument("--sweep-seeds", type=_positive_int, default=None,
                   metavar="B",
                   help="seed-sweep sugar: B lanes with seeds --seed, "
                        "--seed+1, ... --seed+B-1 (equivalent to --sweep "
                        "with a seed axis; mutually exclusive with it)")
    p.add_argument("--round-budget", type=str, default=None, metavar="N|auto",
                   help="cap the run at N rounds with a structured "
                        "over_budget record instead of grinding to "
                        "--max-rounds; 'auto' derives the cap from the "
                        "analytic round prediction (obs/predict.py): "
                        "budget = 8x the spectral bound for push-sum, 8x "
                        "the log-spread heuristic for gossip")
    p.add_argument("--trace-cap", type=int, default=None, metavar="ROWS",
                   help="per-round trace downsampling cap (default 4096, "
                        "or $GOSSIP_TPU_TRACE_CAP): whenever another ROWS "
                        "trace rows land in DIR/trace.jsonl the round "
                        "stride doubles, bounding the file at "
                        "ROWS*(1+log2(rounds/ROWS)) lines; needs "
                        "--telemetry-dir")
    p.add_argument("--check", action="store_true",
                   help="build and validate the topology, print its shape "
                        "summary, and exit without simulating")
    p.add_argument("--quiet", action="store_true",
                   help="suppress everything except the convergence metric")
    return p


def _round_budget(text):
    """``--round-budget`` -> None, an int or ``"auto"`` (the JAX CLI's
    rule); ValueError (exit 2) for anything else. The int's range is
    checked by ``RunConfig``."""
    if text is None or text == "auto":
        return text
    try:
        return int(text)
    except ValueError:
        raise ValueError(
            f"option invalid: --round-budget must be a positive integer "
            f"or 'auto', got {text!r}")


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


def _slice_flag(args):
    """The first flag of faults, events, repair, checkpoints or the
    sentinel that ``args`` sets, or None."""
    for flag, given in (
            ("--fail-fraction", args.fail_fraction > 0),
            ("--revive-round", args.revive_round is not None),
            ("--drop-prob", args.drop_prob > 0),
            ("--drop-window", args.drop_window is not None),
            ("--fault-plan", args.fault_plan is not None),
            ("--event-plan", args.event_plan is not None),
            ("--churn", args.churn is not None),
            ("--value-faults", args.value_faults is not None),
            ("--repair", args.repair != "off"),
            ("--sentinel", args.sentinel != "off"),
            ("--checkpoint-dir", args.checkpoint_dir is not None),
            ("--checkpoint-every", bool(args.checkpoint_every)),
            ("--resume", args.resume is not None),
            ("--auto-resume", args.auto_resume > 0)):
        if given:
            return flag
    return None


def _workload_flag(args):
    """The first flag of vector payloads, the learning workloads, clocks,
    acceleration, float64 or the fanout-all scatter that ``args`` sets, or
    None."""
    for flag, given in (
            ("--payload-dim", args.payload_dim != 1),
            ("--workload", args.workload != "avg"),
            ("--groups", args.groups != 1),
            ("--clock", args.clock != "sync"),
            ("--accel", args.accel != "off"),
            ("--x64", args.x64),
            ("--delivery scatter with --fanout all",
             args.fanout == "all" and args.delivery == "scatter")):
        if given:
            return flag
    return None


def _check_sharding(args, cfg) -> None:
    """The JAX CLI's rejections of the sharding flags (its messages),
    raised as ValueError (exit 2), and the sharded runs not yet ported."""
    from gossipprotocol_tpu_torch.engine.driver import (
        NotPortedError, is_walk,
    )

    if cfg.delivery == "invert" and args.devices > 1:
        raise ValueError(
            "delivery='invert' is single-chip only — drop --devices "
            "or use delivery='scatter'")
    if args.devices > 1 and (args.sweep is not None
                             or args.sweep_seeds is not None):
        raise NotPortedError(
            "option not yet ported with --devices: "
            f"{'--sweep' if args.sweep is not None else '--sweep-seeds'} "
            "(the batched sweep runs on one card: drop --devices)")
    if args.devices > 1:
        flag = _slice_flag(args)
        if flag is not None:
            raise NotPortedError(
                f"option not yet ported with --devices: {flag} (faults, "
                "events, repair, checkpoints and the sentinel run on one "
                "shard: drop --devices)")
        flag = _workload_flag(args)
        if flag is not None:
            raise NotPortedError(
                f"option not yet ported with --devices: {flag} (vector "
                "payloads, the learning workloads, clocks, acceleration, "
                "float64 and the fanout-all scatter run on one shard: "
                "drop --devices)")
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
    if argv and argv[0] in SUBCOMMANDS:
        # subcommand dispatch before argparse: the run parser has three
        # required positionals and would reject `report DIR`
        import importlib

        module, func = SUBCOMMANDS[argv[0]]
        return getattr(importlib.import_module(module), func)(argv[1:])
    bad = _unported(argv)
    if bad is not None:
        print(f"option not yet ported: {bad} (the PyTorch port runs "
              "gossip and push-sum --fanout one --delivery scatter|invert, "
              "--semantics reference, push-sum --fanout all --delivery "
              "scatter|pallas|routed|megakernel (pallas and routed with "
              "--devices S on one card), faults, loss, events, repair, "
              "checkpoints and the sentinel, vector payloads, SGP and "
              "GALA, Poisson clocks, acceleration, --x64, --check, "
              "--backend, telemetry, sweeps, report, watch, history and "
              "plan; use python -m gossipprotocol_tpu for the rest)",
              file=sys.stderr)
        return 2
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:  # argparse's usage errors are exit 2
        return int(e.code or 0)

    from gossipprotocol_tpu_torch.obs import NULL, Telemetry

    # sweep runs keep counters + manifests but not per-round traces
    # (the trace rows have no lane story yet — the engine would reject)
    sweeping = args.sweep is not None or args.sweep_seeds is not None
    try:
        tel = (Telemetry(args.telemetry_dir, trace_cap=args.trace_cap,
                         traces=False if sweeping else None)
               if args.telemetry_dir else NULL)
    except ValueError as e:  # TelemetryDirCollision
        print(str(e), file=sys.stderr)
        return 2
    try:
        return _main(args, argv, tel)
    finally:
        tel.close()  # idempotent: the run path closes it before the manifest


def _main(args, argv, tel) -> int:
    """The run of :func:`main` after the flags are parsed and the
    telemetry hub made."""
    algo = _ALGO_ALIASES.get(args.algorithm.lower())
    if algo is None:
        print(f"option invalid: unknown algorithm {args.algorithm!r} "
              f"(valid: gossip, push-sum)", file=sys.stderr)
        return 2

    from gossipprotocol_tpu_torch.engine.driver import (
        DELIVERIES, NotPortedError, RunConfig, require_invertible,
        resolve_device, resume_simulation, run_simulation,
    )
    from gossipprotocol_tpu_torch.obs import write_manifest
    from gossipprotocol_tpu_torch.ops.delivery import RoutedConfigError
    from gossipprotocol_tpu_torch.sweep.engine import SweepConfigError
    from gossipprotocol_tpu_torch.utils.metrics import (
        JsonlMetricsWriter, print_convergence_time, print_start_banner,
    )
    from gossipprotocol_tpu_torch.utils.profiling import maybe_trace

    try:
        if args.routed_design == "pull":
            raise NotPortedError(
                "option not yet ported: --routed-design pull (the "
                "sharded push design is ported)")
        if args.devices < 1:
            raise ValueError(f"--devices must be >= 1, got {args.devices}")
        args.device = resolve_backend(args.backend, args.device)
        device = resolve_device(args.device)
        with tel.span("topology_build", topology=args.topology,
                      requested_nodes=args.num_nodes):
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

    from gossipprotocol_tpu_torch.utils import checkpoint as ckpt
    from gossipprotocol_tpu_torch.utils import faults

    try:
        schedule = faults.build_schedule(
            topo.num_nodes,
            plan_file=args.fault_plan,
            fail_fraction=args.fail_fraction,
            fail_round=args.fail_round,
            revive_round=args.revive_round,
            drop_prob=args.drop_prob,
            drop_window=tuple(args.drop_window) if args.drop_window else None,
            seed=args.seed,
            max_rounds=args.max_rounds,
        )
    except (ValueError, OSError) as e:
        print(f"fault schedule invalid: {e}", file=sys.stderr)
        return 2
    try:
        event_plan, schedule = _event_plan(args, topo, schedule, faults)
    except (ValueError, OSError, KeyError) as e:
        print(f"event plan invalid: {e}", file=sys.stderr)
        return 2

    try:
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
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
            fault_schedule=schedule, event_plan=event_plan,
            repair=args.repair, sentinel=args.sentinel,
            edge_chunks=args.edge_chunks, payload_dim=args.payload_dim,
            workload=args.workload, clock=args.clock,
            activation_rate=args.activation_rate, groups=args.groups,
            accel=args.accel, accel_lambda=args.accel_lambda, lr=args.lr,
            local_steps=args.local_steps, sgp_samples=args.sgp_samples,
            loss_tol=args.loss_tol,
            dtype="float64" if args.x64 else "float32",
            telemetry=tel if tel.enabled else None,
            round_budget=_round_budget(args.round_budget),
        )
        if cfg.delivery == "invert":
            # the engine's build-time precondition as a clean input error
            require_invertible(topo)
        _check_sharding(args, cfg)
        if cfg.delivery in DELIVERIES and topo.implicit_full:
            raise ValueError(
                f"delivery='{cfg.delivery}' needs an explicit edge list; "
                "the complete graph has none (diffusion on K_n mixes in "
                "one round via two reductions) — use delivery='scatter'")
        if cfg.workload == "gala" and topo.num_nodes % cfg.groups:
            raise ValueError(
                f"--workload gala splits {topo.num_nodes} nodes into "
                f"{cfg.groups} equal groups — the node count must be "
                "divisible by --groups")
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
        if args.sweep is not None or args.sweep_seeds is not None:
            if args.sweep is not None and args.sweep_seeds is not None:
                raise ValueError(
                    "--sweep and --sweep-seeds are two spellings of one "
                    "sweep plan — give exactly one"
                )
            if args.resume:
                raise ValueError(
                    "sweep runs cannot resume from a checkpoint — lanes "
                    "have no per-lane checkpoint story yet"
                )
            from gossipprotocol_tpu_torch.sweep import SweepSpec

            spec = (SweepSpec.from_file(args.sweep)
                    if args.sweep is not None
                    else SweepSpec.from_seeds(args.sweep_seeds,
                                              base_seed=args.seed))
            # riding RunConfig means the capacity preflight below prices
            # device memory as lanes x per-run state automatically
            cfg = dataclasses.replace(cfg, sweep=spec)
    except (ValueError, RuntimeError, NotImplementedError) as e:
        print(str(e), file=sys.stderr)
        return 2

    # capacity preflight: refuse a run whose predicted per-device footprint
    # cannot fit, before any plan build (silent where capacity is unknown,
    # i.e. the CPU without $GOSSIP_TPU_HBM_BYTES)
    from gossipprotocol_tpu_torch.obs.capacity import (
        CapacityError, preflight as capacity_preflight,
    )

    try:
        capacity_preflight(topo, cfg, args.devices, tel)
    except CapacityError as e:
        print(str(e), file=sys.stderr)
        return 2

    if (args.auto_resume > 0 and not args.resume
            and not (args.checkpoint_every and args.checkpoint_dir)):
        print(
            "warning: --auto-resume has no usable checkpoint config "
            "(need both --checkpoint-dir and --checkpoint-every) — a "
            "recovery will RESTART FROM SCRATCH",
            file=sys.stderr,
        )

    state = None
    resume_src = resume_round = None
    if args.resume:
        try:
            state, cfg, resume_src, resume_round = _load_resume(
                args, cfg, topo, ckpt, tel)
        except _ResumeRefused as e:
            print(str(e), file=sys.stderr)
            return 2

    # append when resuming (or re-executed by a recovery): the file keeps
    # covering the whole logical run, at-least-once — chunks after the
    # last checkpoint replay — so a marker record separates the attempts
    writer = (JsonlMetricsWriter(
        args.metrics_out,
        mode="a" if (args.resume or args.restarted) else "w",
        stamp_version=tel.enabled) if args.metrics_out else None)
    if writer:
        cfg = dataclasses.replace(cfg, metrics_callback=writer)
        if state is not None:
            writer({
                "event": "resumed",
                "from_round": resume_round,
                "note": "records after this marker may replay rounds "
                        "already present above (at-least-once)",
            })
        elif args.restarted:
            writer({
                "event": "restarted_from_scratch",
                "note": "recovery without a checkpoint: every round "
                        "replays; records above are the crashed attempt",
            })
    manifest_kw = dict(device=str(device), num_devices=args.devices,
                       resumed_from=resume_src, resume_round=resume_round)

    if not args.quiet:
        print_start_banner(algo)
    try:
        # `with tel` closes the hub (trace flush, end marker) on every
        # path; the manifest is written afterwards from its totals
        with tel:
            if args.profile_dir and tel.enabled:
                # recorded so report and manifest point at the trace;
                # mark_span (depth 1) keeps the phase rollup honest
                tel.profile_dir = args.profile_dir
            prof_start = tel.wall_s()
            with maybe_trace(args.profile_dir):
                if args.devices > 1:
                    from gossipprotocol_tpu_torch.parallel import (
                        run_simulation_sharded,
                    )

                    result = run_simulation_sharded(topo, cfg, mesh=mesh)
                elif state is not None:
                    result = resume_simulation(topo, cfg, state)
                else:
                    result = run_simulation(topo, cfg)
            if args.profile_dir:
                tel.mark_span("profiler_trace", prof_start,
                              tel.wall_s() - prof_start,
                              trace_dir=args.profile_dir)
    except (RoutedConfigError, SweepConfigError) as e:
        # build-time rejections and sweep-envelope violations the engine
        # can only raise once it sees the whole config: the same loud
        # exit 2 as the checks above
        if writer:
            writer.close()
        write_manifest(tel, cfg, topo, None, error=str(e), **manifest_kw)
        print(str(e), file=sys.stderr)
        return 2
    except Exception as e:
        if not (_is_runtime_death(e) and args.auto_resume > 0):
            raise
        if writer:
            writer.close()
        write_manifest(tel, cfg, topo, None,
                       error=f"accelerator runtime died: {type(e).__name__}",
                       **manifest_kw)
        return _recover(args, argv, cfg, topo, ckpt, e)

    if writer:
        writer.close()
    manifest_path = write_manifest(tel, cfg, topo, result, **manifest_kw)
    print_convergence_time(result.wall_ms)
    if not args.quiet:
        print(f"rounds: {result.rounds} ({result.rounds_executed} executed)"
              f"  converged: {result.converged}  "
              f"nodes: {result.num_nodes}  compile: "
              f"{result.compile_ms:.1f} ms  device: {device}")
        lanes = getattr(result, "lanes", 0)
        if lanes:
            done = sum(1 for lr in result.lane_records if lr["converged"])
            rounds = sorted(lr["rounds"] for lr in result.lane_records)
            print(f"sweep: {lanes} lanes, {done} converged, lane rounds "
                  f"{rounds[0]}..{rounds[-1]}  "
                  f"(amortized {result.wall_ms / lanes:.2f} ms/lane)")
        err = result.estimate_error
        if err is not None:
            print(f"push-sum max |s/w - mean| = {err:.3e}")
        if manifest_path:
            print(f"telemetry: {tel.dir} (render: python -m "
                  f"gossipprotocol_tpu_torch report {tel.dir})")
    if result.stopped == "drain":
        # paused with a checkpoint (or none configured), not finished
        print(f"drained at round {result.rounds} (checkpoint "
              f"{'saved' if result.checkpoints else 'not configured'})",
              file=sys.stderr)
        return 3
    return 0 if result.converged else 1


def _event_plan(args, topo, schedule, faults):
    """``(event plan or None, schedule)`` from ``--event-plan``,
    ``--churn`` and ``--value-faults`` (the JAX CLI's rules: the plan's
    kill/revive/loss keys merge into the schedule; a generator or value
    faults given twice is an error)."""
    from gossipprotocol_tpu_torch.events import (
        EventPlan, parse_churn_arg, parse_event_plan, parse_value_faults_arg,
    )

    event_plan = None
    if args.event_plan is not None:
        event_plan, plan_sched = parse_event_plan(
            args.event_plan, topo.num_nodes, seed=args.seed)
        schedule = faults.merge_schedules(schedule, plan_sched)
    if args.churn is not None:
        spec = parse_churn_arg(args.churn)
        if event_plan is not None and event_plan.churn is not None:
            raise ValueError(
                "--churn and an event-plan 'churn' generator both "
                "given — configure one")
        event_plan = dataclasses.replace(
            event_plan if event_plan is not None else EventPlan(),
            churn=spec)
    if args.value_faults is not None:
        vf = parse_value_faults_arg(args.value_faults)
        if event_plan is not None and event_plan.value_faults:
            raise ValueError(
                "--value-faults and an event-plan 'value_faults' list "
                "both given — configure one")
        event_plan = dataclasses.replace(
            event_plan if event_plan is not None else EventPlan(),
            value_faults=(vf,))
    if event_plan is not None and topo.implicit_full:
        raise ValueError(
            "event plans need an explicit edge list; the implicit "
            "complete graph has no CSR to rewrite")
    return event_plan, schedule


class _ResumeRefused(Exception):
    """A resume the CLI refuses with exit 2 (the message says why)."""


def _load_resume(args, cfg, topo, ckpt, tel):
    """``(state, cfg, path, round)`` for ``--resume``: the newest
    readable checkpoint of a directory (falling back past unreadable
    ones, as the JAX CLI does) or the named file, loaded inside the
    telemetry hub's ``resume_load`` span, checked against this run's
    trajectory fields, topology kind and adjacency fingerprint; ``cfg``
    gains the checkpoint's logged quarantines. A checkpoint of the JAX
    package is refused at once."""
    import zipfile

    cands = (ckpt.candidates(args.resume)
             if os.path.isdir(args.resume) else [args.resume])
    if not cands:
        raise _ResumeRefused(f"no checkpoint found in {args.resume}")
    state = meta = None
    with tel.span("resume_load", target=args.resume):
        for path in cands:
            try:
                ckpt.check_package(ckpt.peek_meta(path), path)
                state, meta = ckpt.load(path)
                break
            except ckpt.ForeignCheckpointError as e:
                raise _ResumeRefused(str(e))
            except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
                print(
                    f"warning: checkpoint {path} unreadable "
                    f"({type(e).__name__}: {e}); falling back to the "
                    "previous published checkpoint",
                    file=sys.stderr,
                )
    if state is None:
        raise _ResumeRefused(f"no readable checkpoint in {args.resume}")
    resume_round = int(meta.get("round", -1))
    tel.event("resume_loaded", checkpoint=path, round=resume_round)
    problems = [
        f"{k} {ckpt.stored_value(meta, k)!r} != {v!r}"
        for k, v in ckpt.trajectory_meta(cfg).items()
        if not ckpt.field_matches(meta, k, v)
    ]
    if meta.get("topology") not in (None, topo.kind):
        problems.append(
            f"topology {meta.get('topology')!r} != {topo.kind!r}")
    fp = ckpt.topology_fingerprint(topo)
    if meta.get("adjacency") not in (None, fp):
        problems.append(
            f"adjacency {meta.get('adjacency')!r} != {fp!r} "
            "(different graph, e.g. --avg-degree/--attach changed)")
    if state.alive.shape[0] != topo.num_nodes:
        problems.append(f"checkpoint has {state.alive.shape[0]} nodes, "
                        f"run has {topo.num_nodes}")
    if problems:
        raise _ResumeRefused("checkpoint mismatch: " + "; ".join(problems))
    if meta.get("quarantines"):
        cfg = dataclasses.replace(cfg, quarantine_log=tuple(
            (int(r), tuple(int(i) for i in ids))
            for r, ids in meta["quarantines"]))
    return state, cfg, path, resume_round


def _recover(args, argv, cfg, topo, ckpt, e) -> int:
    """Elastic recovery after the CUDA context died: re-exec from the
    furthest-along compatible checkpoint — the newest in
    ``--checkpoint-dir`` or the one ``--resume`` named — or from scratch
    (the JAX CLI's choice)."""
    traj = ckpt.trajectory_meta(cfg)
    fp = ckpt.topology_fingerprint(topo)

    def round_of(path_or_dir):
        if not path_or_dir:
            return None
        paths = (ckpt.candidates(path_or_dir)
                 if os.path.isdir(path_or_dir) else [path_or_dir])
        for path in paths:
            if not os.path.exists(path):
                continue
            try:
                m = ckpt.peek_meta(path)
            except Exception:
                continue
            compatible = (
                m.get(ckpt.PACKAGE_KEY) == ckpt.PACKAGE_TAG
                and all(ckpt.field_matches(m, k, v) for k, v in traj.items())
                and m.get("topology") in (None, topo.kind)
                and m.get("adjacency") in (None, fp)
            )
            # the first readable candidate decides
            return int(m.get("round", -1)) if compatible else None
        return None

    candidates = [(r, target)
                  for target in (args.checkpoint_dir, args.resume)
                  if (r := round_of(target)) is not None]
    resume_target = (max(candidates, key=lambda t: t[0])[1]
                     if candidates else None)
    effective = list(sys.argv[1:]) if argv is None else list(argv)
    new_argv = resume_argv(effective, resume_target, args.auto_resume - 1)
    print(
        f"accelerator runtime died ({type(e).__name__}); "
        + (f"resuming from {resume_target}" if resume_target
           else "no checkpoint yet — restarting from scratch")
        + f", {args.auto_resume - 1} recovery attempts left",
        file=sys.stderr,
    )
    return _reexec(new_argv)


if __name__ == "__main__":
    raise SystemExit(main())
