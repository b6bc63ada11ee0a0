"""Fault injection: the fault-schedule model (port of
``gossipprotocol_tpu/utils/faults.py``; numpy only, as there).

A :class:`FaultSchedule` is a declarative timeline of three event kinds:

* ``kill``   — node ids die at a round: they neither send nor receive, the
  supervisor's predicate ignores them, and their ``(s, w)`` mass strands.
* ``revive`` — node ids rejoin at a round **with fresh-born state**:
  gossip counts reset to 0, push-sum ``(s, w)`` to the init values.
  After every strike batch :func:`kill_disconnected` re-runs, so a revived
  node only counts once it is reattached to the majority component.
* ``loss``   — link-level message loss windows ``[start, stop)`` with a
  per-message Bernoulli drop probability. Drops are mass-conserving for
  push-sum: a dropped send keeps its ``(s, w)`` share at the sender. The
  draws are counter-based on the run's threefry stream
  (``protocols/sampling.py`` :func:`drop_mask`).

Kills and revives are host events, fired between chunks by
:class:`gossipprotocol_tpu_torch.events.engine.HostEvents`; loss windows
are device events: the round reads its drop probability from
``state.round`` against the static window table. ``digest()`` gives the
JAX package's string byte for byte (it goes into checkpoint metadata).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from gossipprotocol_tpu_torch.topology.base import kill_disconnected


def random_fault_plan(
    num_nodes: int,
    fraction: float,
    at_round: int,
    seed: int = 0,
) -> Dict[int, np.ndarray]:
    """Kill a uniform-random ``fraction`` of nodes at ``at_round``."""
    if not 0.0 <= fraction < 1.0:
        raise ValueError("fraction must be in [0, 1)")
    rng = np.random.default_rng(seed)
    k = int(round(num_nodes * fraction))
    ids = rng.choice(num_nodes, size=k, replace=False)
    return {int(at_round): np.sort(ids)}


@dataclasses.dataclass(frozen=True)
class LossWindow:
    """Per-message Bernoulli loss over rounds ``[start, stop)``."""

    start: int
    stop: int     # exclusive
    prob: float   # in [0, 1)


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Declarative timeline of kill / revive / link-loss events.

    ``kills``/``revives`` map a round number to the (sorted, unique) node
    ids struck at that round. Treated as immutable after construction.
    """

    kills: Mapping[int, np.ndarray] = dataclasses.field(default_factory=dict)
    revives: Mapping[int, np.ndarray] = dataclasses.field(default_factory=dict)
    loss: Tuple[LossWindow, ...] = ()

    # ---- queries -------------------------------------------------------

    @property
    def has_strikes(self) -> bool:
        """Any aliveness-changing event (kill or revive)? These disable
        the engine's static liveness fast paths; loss windows alone do
        not (drops change delivery, never aliveness)."""
        return bool(self.kills) or bool(self.revives)

    @property
    def has_loss(self) -> bool:
        return bool(self.loss)

    def __bool__(self) -> bool:
        return self.has_strikes or self.has_loss

    def static_loss_windows(self) -> Tuple[Tuple[int, int, float], ...]:
        """Hashable ``(start, stop, prob)`` tuple for jit static args."""
        return tuple((w.start, w.stop, float(w.prob)) for w in self.loss)

    # ---- validation ----------------------------------------------------

    def validate(self, num_nodes: Optional[int] = None) -> "FaultSchedule":
        """Structural validation; raises ValueError with the bad entry
        named. Returns self so call sites can chain."""
        for name, events in (("kill", self.kills), ("revive", self.revives)):
            for r, ids in events.items():
                if int(r) < 0:
                    raise ValueError(f"{name} round {r} is negative")
                a = np.asarray(ids)
                if a.size and (a < 0).any():
                    raise ValueError(f"{name}@{r}: negative node id")
                if num_nodes is not None and a.size and (a >= num_nodes).any():
                    raise ValueError(
                        f"{name}@{r}: node id {int(a.max())} out of range "
                        f"for {num_nodes} nodes"
                    )
        for r in self.kills:
            if r in self.revives:
                both = np.intersect1d(
                    np.asarray(self.kills[r]), np.asarray(self.revives[r])
                )
                if both.size:
                    raise ValueError(
                        f"round {r}: node(s) {both.tolist()} appear in both "
                        "kill and revive — same-round kill+revive of one "
                        "node is order-ambiguous; schedule them one round "
                        "apart"
                    )
        for w in self.loss:
            if not 0.0 <= w.prob < 1.0:
                raise ValueError(
                    f"loss window [{w.start}, {w.stop}): prob {w.prob} "
                    "must be in [0, 1) — prob 1.0 drops every message "
                    "forever, which no protocol can survive"
                )
            if w.start < 0 or w.stop <= w.start:
                raise ValueError(
                    f"loss window [{w.start}, {w.stop}) is empty or "
                    "negative (stop is exclusive and must exceed start)"
                )
        return self

    # ---- construction --------------------------------------------------

    @classmethod
    def from_events(
        cls,
        kills: Optional[Mapping[int, object]] = None,
        revives: Optional[Mapping[int, object]] = None,
        loss: Tuple[LossWindow, ...] = (),
    ) -> "FaultSchedule":
        norm = lambda ev: {  # noqa: E731
            int(r): np.unique(np.asarray(ids, dtype=np.int64))
            for r, ids in (ev or {}).items()
        }
        return cls(kills=norm(kills), revives=norm(revives), loss=tuple(loss))

    @classmethod
    def from_json(
        cls, obj, num_nodes: Optional[int] = None, seed: int = 0
    ) -> "FaultSchedule":
        """Parse the ``--fault-plan`` JSON document.

        Format (every key optional)::

            {
              "kill":   [{"round": 10, "ids": [1, 2]},
                         {"round": 12, "fraction": 0.1, "seed": 7}],
              "revive": [{"round": 30, "ids": [1, 2]}],
              "loss":   [{"start": 5, "stop": 25, "prob": 0.2}]
            }

        ``fraction`` kills draw uniform-random ids (like
        ``--fail-fraction``); their ``seed`` defaults to the run seed so
        the schedule stays reproducible without repeating it.
        """
        if isinstance(obj, str):
            with open(obj) as f:
                obj = json.load(f)
        if not isinstance(obj, dict):
            raise ValueError("fault plan must be a JSON object")
        unknown = set(obj) - {"kill", "revive", "loss"}
        if unknown:
            raise ValueError(
                f"fault plan: unknown key(s) {sorted(unknown)} "
                "(valid: kill, revive, loss)"
            )
        kills: Dict[int, np.ndarray] = {}
        for ev in obj.get("kill", ()):
            r = int(ev["round"])
            if "ids" in ev:
                ids = np.asarray(ev["ids"], dtype=np.int64)
            elif "fraction" in ev:
                if num_nodes is None:
                    raise ValueError(
                        "fraction kill events need the node count"
                    )
                ids = random_fault_plan(
                    num_nodes, float(ev["fraction"]), r,
                    seed=int(ev.get("seed", seed)),
                )[r]
            else:
                raise ValueError(f"kill@{r}: needs 'ids' or 'fraction'")
            kills[r] = np.union1d(kills.get(r, np.empty(0, np.int64)), ids)
        revives: Dict[int, np.ndarray] = {}
        for ev in obj.get("revive", ()):
            r = int(ev["round"])
            ids = np.asarray(ev["ids"], dtype=np.int64)
            revives[r] = np.union1d(
                revives.get(r, np.empty(0, np.int64)), ids
            )
        loss = tuple(
            LossWindow(int(w["start"]), int(w["stop"]), float(w["prob"]))
            for w in obj.get("loss", ())
        )
        return cls.from_events(kills, revives, loss).validate(num_nodes)

    # ---- identity ------------------------------------------------------

    def digest(self) -> str:
        """Stable content hash, for checkpoint trajectory metadata.

        The schedule shapes the trajectory exactly like the PRNG seed
        does, so resume validation must compare it; the digest keeps the
        metadata record small and order-canonical. ``"none"`` for the
        empty schedule so a no-fault resume of a no-fault checkpoint
        matches without wildcarding."""
        if not self:
            return "none"
        doc = {
            "kill": {str(r): np.asarray(v).tolist()
                     for r, v in sorted(self.kills.items())},
            "revive": {str(r): np.asarray(v).tolist()
                       for r, v in sorted(self.revives.items())},
            "loss": [[w.start, w.stop, w.prob] for w in self.loss],
        }
        blob = json.dumps(doc, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def as_schedule(
    fault_schedule: Optional[FaultSchedule],
    fault_plan: Optional[Mapping[int, object]] = None,
) -> FaultSchedule:
    """Normalize RunConfig's fault fields into one FaultSchedule.

    ``fault_plan`` is the legacy one-shot kill mapping ``{round: ids}``;
    it merges into the schedule's kills so every pre-schedule call site
    (tests, notebooks) keeps working unchanged.
    """
    sched = fault_schedule or FaultSchedule()
    if not fault_plan:
        return sched
    kills = {int(r): np.asarray(v) for r, v in sched.kills.items()}
    for r, ids in fault_plan.items():
        r = int(r)
        ids = np.asarray(ids, dtype=np.int64)
        kills[r] = np.union1d(kills.get(r, np.empty(0, np.int64)), ids)
    return FaultSchedule.from_events(kills, sched.revives, sched.loss)


def merge_schedules(*schedules: Optional[FaultSchedule],
                    ) -> Optional[FaultSchedule]:
    """Union several fault schedules (per-round id unions, loss windows
    concatenated in argument order).

    The CLI merges the legacy ``--fault-plan``/``--fail-*`` schedule with
    the fault keys an ``--event-plan`` document carries — both compile
    down to the same engine. Returns None when every input is empty, so
    plain runs keep the static fast paths.
    """
    live = [s for s in schedules if s]
    if not live:
        return None
    if len(live) == 1:
        return live[0]
    kills: Dict[int, np.ndarray] = {}
    revives: Dict[int, np.ndarray] = {}
    loss: list = []
    for s in live:
        for dst, src in ((kills, s.kills), (revives, s.revives)):
            for r, ids in src.items():
                r = int(r)
                dst[r] = np.union1d(
                    dst.get(r, np.empty(0, np.int64)),
                    np.asarray(ids, np.int64))
        loss.extend(s.loss)
    return FaultSchedule.from_events(kills, revives, tuple(loss))


def build_schedule(
    num_nodes: int,
    plan_file: Optional[str] = None,
    fail_fraction: float = 0.0,
    fail_round: int = 0,
    revive_round: Optional[int] = None,
    drop_prob: float = 0.0,
    drop_window: Optional[Tuple[int, int]] = None,
    seed: int = 0,
    max_rounds: int = 1_000_000,
) -> Optional[FaultSchedule]:
    """CLI sugar + optional JSON plan -> one validated FaultSchedule.

    Sugar renders to the same event model the JSON carries:
    ``--fail-fraction F --fail-round R`` is a fraction kill at R,
    ``--revive-round R2`` revives exactly those killed ids at R2, and
    ``--drop-prob P [--drop-window A B]`` is one loss window (the whole
    run when no window is given). Returns None when nothing is scheduled,
    so a plain run keeps the engine's static fast paths.
    """
    sched = (FaultSchedule.from_json(plan_file, num_nodes, seed=seed)
             if plan_file else FaultSchedule())
    kills = dict(sched.kills)
    revives = dict(sched.revives)
    loss = list(sched.loss)
    sugar_ids = None
    if fail_fraction > 0:
        plan = random_fault_plan(num_nodes, fail_fraction, fail_round,
                                 seed=seed)
        sugar_ids = plan[int(fail_round)]
        kills[int(fail_round)] = np.union1d(
            kills.get(int(fail_round), np.empty(0, np.int64)), sugar_ids
        )
    if revive_round is not None:
        if sugar_ids is None:
            raise ValueError(
                "--revive-round revives the --fail-fraction victims; it "
                "needs --fail-fraction > 0 (schedule explicit revives "
                "via --fault-plan)"
            )
        if revive_round <= fail_round:
            raise ValueError(
                f"--revive-round {revive_round} must come after "
                f"--fail-round {fail_round}"
            )
        revives[int(revive_round)] = np.union1d(
            revives.get(int(revive_round), np.empty(0, np.int64)), sugar_ids
        )
    if drop_window is not None and drop_prob <= 0:
        raise ValueError("--drop-window needs --drop-prob > 0")
    if drop_prob > 0:
        start, stop = drop_window if drop_window else (0, max_rounds)
        loss.append(LossWindow(int(start), int(stop), float(drop_prob)))
    out = FaultSchedule.from_events(kills, revives, tuple(loss))
    out.validate(num_nodes)
    return out if out else None


def apply_partition_rule(topo, alive: np.ndarray,
                         repair_policy: str = "off") -> np.ndarray:
    """Policy-conditional majority-partition rule.

    ``off`` and ``prune`` run :func:`kill_disconnected` with today's
    victim set: the engine hands in the birth adjacency (``off``) or the
    pruned one (``prune`` — dropping dead endpoints never changes the
    component structure *among live nodes*, the rule masks dead
    endpoints itself, so the victims match ``off`` bitwise).  Stranded
    survivors still die.

    ``rewire`` is the policy under which survivors are supposed to stay
    in the computation: the engine hands in the *repaired* adjacency,
    where the deterministic splice has already re-attached every orphan,
    so the rule is normally a no-op.  It still runs as a safety net for
    the rare fragment the pairing closed on itself (two stubs of one
    detached island pairing with each other) — such an island would
    otherwise hang a sound global predicate forever, exactly the hazard
    documented on :func:`kill_disconnected`.
    """
    from gossipprotocol_tpu_torch.topology import repair as repair_mod

    repair_mod.validate_policy(repair_policy)
    return kill_disconnected(topo, alive)
