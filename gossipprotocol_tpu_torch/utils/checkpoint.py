"""Checkpoint / resume (port of ``gossipprotocol_tpu/utils/checkpoint.py``).

A checkpoint is one compressed npz file: the state's tensors as numpy
arrays under their field names, plus a JSON ``__meta__`` record with
enough config metadata to validate a resume — the same array names,
dtypes and ``__meta__`` keys as the JAX package's, so the two formats can
be compared field by field. The file format is single-process.

The port's metadata carries one key more, :data:`PACKAGE_TAG`
(``"package": "gossipprotocol_tpu_torch"``). :func:`load` refuses a file
without it — a JAX checkpoint — with :class:`ForeignCheckpointError`,
naming the JAX package (the CLI exits 2): the two engines are held to
each other by the tests, not spliced into one trajectory quietly.
"""

from __future__ import annotations

import json
import os
import time
from typing import Tuple

import numpy as np
import torch

# The key and value that mark a checkpoint written by this package.
PACKAGE_KEY = "package"
PACKAGE_TAG = "gossipprotocol_tpu_torch"


class ForeignCheckpointError(ValueError):
    """The checkpoint was not written by this package (a JAX checkpoint)."""


def _state_types():
    from gossipprotocol_tpu_torch.protocols.state import (
        AccelState, GossipState, PushSumState, SGPState,
    )
    from gossipprotocol_tpu_torch.protocols.walk import WalkState

    return {"GossipState": GossipState, "PushSumState": PushSumState,
            "WalkState": WalkState, "SGPState": SGPState,
            "AccelState": AccelState}


# Every RunConfig field that influences the trajectory. Saved in checkpoint
# metadata and compared generically on resume — resuming under a different
# convergence rule (or PRNG seed) would continue on a plausible-looking but
# different run, which must be an error, not a silent acceptance.
TRAJECTORY_FIELDS = (
    "algorithm", "seed", "semantics", "threshold", "eps", "streak_target",
    "keep_alive", "predicate", "tol", "value_mode", "dtype",
    # the stop rule is part of the trajectory: splicing a quorum run onto
    # an all-nodes run (or vice versa) would change when the world stops
    "alert_quorum",
    # sender/delivery variants change the trajectory too: fanout="all" is a
    # different protocol; delivery="invert" sums received mass in a
    # different float order than the scatter (both docstrings say so)
    "fanout", "delivery",
    # per-chunk partial sums change the delivery's float accumulation
    # order, exactly like delivery="invert" — a resume under a different
    # chunking silently continues a different-accumulation-order trajectory
    "edge_chunks",
    # the fault schedule is part of the trajectory: resuming a faulted run
    # under a different --fail-fraction (or a plain run under a fault plan)
    # would splice two different worlds. Stored as a stable content digest
    # — the schedule itself can be large (trajectory_meta normalizes it)
    "fault_schedule",
    # the repair policy rewrites the adjacency at strike rounds, so it is
    # as trajectory-defining as the schedule itself: resuming a rewire run
    # under prune (or off) would replay different topologies from the same
    # checkpoint — refused, like any other trajectory-field mismatch
    "repair",
    # the decentralized-learning knobs: payload width changes every state
    # shape, the workload swaps the round function entirely, and the SGP /
    # acceleration hyperparameters steer each round's arithmetic — a
    # resume under any other value continues a different trajectory
    "payload_dim", "workload", "accel", "accel_lambda", "lr",
    "local_steps", "sgp_samples", "loss_tol",
    # the execution clock: a poisson run activates a different sender
    # subset every round than a sync run, and the rate/grouping select
    # which subset — resuming under any other clock splices trajectories
    "clock", "activation_rate", "groups",
    # the topology-schedule event plan (events/) rewrites the adjacency
    # mid-run exactly like repair: resume replays the remaining events
    # bitwise only against the same plan. Stored as a content digest —
    # explicit edge lists can be large (trajectory_meta normalizes it)
    "event_plan",
    # kernel/wire execution shape: rounds_per_kernel changes the chunk
    # super-step granularity (trace rows, counter folding, round-limit
    # overshoot inside a super-step) and payload_wire changes the
    # sharded exchange's float values — resuming under a different K or
    # wire format splices trajectories and is refused. exchange_overlap
    # is deliberately NOT here: it moves identical bytes in an identical
    # order, bitwise-equal to the start-all-then-wait transport.
    "rounds_per_kernel", "payload_wire",
    # seeded value-fault injections (events/plan.py) corrupt protocol
    # state at their rounds: resuming under a different fault plan would
    # splice two different corruption histories. Stored as the plan's
    # dedicated value-fault digest ("none" for injection-free runs), so
    # it pins independently of the topology-event portion. The sentinel
    # mode itself is deliberately NOT a trajectory field: like telemetry
    # it only observes (quarantines it *performs* are recorded per-
    # checkpoint in the "quarantines" metadata and replayed from there).
    "value_faults",
)


# Fields a pre-upgrade checkpoint lacks but whose value is nevertheless
# known: the knob did not exist when the checkpoint was written, so the run
# necessarily used the default. Distinct from genuinely-unknowable absent
# fields which resume validation must wildcard — pre-upgrade eps/tol, and
# edge_chunks, whose CLI knob predates its trajectory-field status: a
# missing-key checkpoint may have run with ANY chunking, so pinning it
# would falsely reject the matching resume and silently accept chunking=1.
LEGACY_FIELD_DEFAULTS = {"fanout": "one", "delivery": "scatter",
                         # pre-repair checkpoints necessarily ran with the
                         # only behavior that existed: no repair
                         "repair": "off",
                         # pre-learn checkpoints are the scalar averaging
                         # protocol: one payload column, no workload, no
                         # acceleration (the SGP/accel hyperparameters are
                         # moot under those and wildcard like eps/tol)
                         "payload_dim": 1, "workload": "avg",
                         "accel": "off",
                         # pre-async checkpoints ran the only clock that
                         # existed: synchronous, ungrouped (the rate is
                         # moot under sync but its default is pinned so
                         # resumes never wildcard a poisson rate onto it)
                         "clock": "sync", "activation_rate": 1.0,
                         "groups": 1,
                         # pre-events checkpoints ran on a static (or
                         # repair-only) adjacency: no event plan
                         "event_plan": "none",
                         # pre-megakernel checkpoints ran one round per
                         # kernel on the uncompressed f32 wire — the only
                         # behavior that existed
                         "rounds_per_kernel": 1, "payload_wire": "f32",
                         # pre-sentinel checkpoints never injected value
                         # faults (the knob did not exist)
                         "value_faults": "none"}

# Sentinel written for alert_quorum=None (the all-nodes stop rule). None
# cannot be stored raw: resume validation could not tell "all-nodes run"
# from "field absent, value unknowable", and splicing a quorum run onto an
# all-nodes run must be an error (see field_matches).
_QUORUM_ALL = "all"


def field_matches(meta: dict, field: str, value) -> bool:
    """Resume validation for one trajectory field.

    Missing fields wildcard (pre-upgrade checkpoint, value unknowable) —
    except those in :data:`LEGACY_FIELD_DEFAULTS`, where missing means
    "the default": resuming an old single-target/scatter checkpoint under
    ``--fanout all`` or ``--delivery invert`` must be a mismatch, not a
    silent splice of two different trajectories.

    ``alert_quorum`` is special: ``None`` is a *real value* there (the
    all-nodes stop rule), so a stored null — written by checkpoints that
    predate the :data:`_QUORUM_ALL` sentinel — means "all nodes", not
    "unknowable"; only a checkpoint whose metadata lacks the key entirely
    wildcards.
    """
    stored = stored_value(meta, field)
    if stored is None:
        return True
    if field == "alert_quorum" and value is None:
        value = _QUORUM_ALL
    return stored == value


def stored_value(meta: dict, field: str):
    """The normalized stored value resume validation compares against,
    or ``None`` when the field wildcards (genuinely unknowable).

    Shared by :func:`field_matches` and the CLI's mismatch message so the
    reported value is always the one the comparison used — a raw ``meta``
    read would print ``None`` for a legacy pinned default or for
    alert_quorum's null encoding, both of which read as
    "unknowable/wildcard" to a user who just learned the wildcarding rules.
    """
    if field == "alert_quorum":
        if field not in meta:
            return None  # pre-quorum checkpoint
        return _QUORUM_ALL if meta[field] is None else meta[field]
    stored = meta.get(field)
    if stored is None:
        stored = LEGACY_FIELD_DEFAULTS.get(field)
    return stored


def trajectory_meta(cfg) -> dict:
    """JSON-able dict of every trajectory-affecting config field: the
    single source of truth for both sides of resume validation (``save``
    embeds it, the CLI compares against it)."""
    meta = {f: getattr(cfg, f, None) for f in TRAJECTORY_FIELDS}
    if meta["alert_quorum"] is None:
        meta["alert_quorum"] = _QUORUM_ALL
    # the schedule and the event plan are stored as content digests:
    # stable across spellings, small, "none" for runs without them
    meta["fault_schedule"] = cfg.schedule.digest()
    plan = cfg.events
    meta["event_plan"] = plan.digest()
    # the value-fault portion pins separately (see TRAJECTORY_FIELDS)
    meta["value_faults"] = plan.value_fault_digest()
    return meta


def topology_fingerprint(topo) -> str:
    """Cheap content hash of the adjacency itself.

    Comparing builder *inputs* on resume (kind, node count) misses knobs
    like --avg-degree/--attach that yield a different graph from the same
    kind and size; hashing the CSR catches every such mismatch. crc32 runs
    at GB/s, so this costs well under a second even at 10M nodes.
    """
    import zlib

    if topo.implicit_full:
        return f"full/{topo.num_nodes}"
    crc = zlib.crc32(topo.indices.tobytes())
    crc = zlib.crc32(topo.offsets.tobytes(), crc)
    return f"{topo.num_nodes}/{topo.num_directed_edges}/{crc:08x}"


def fetch_host(state):
    """Owned numpy copies of a state's tensors, in field order (a tensor
    on the CPU is copied too: ``.numpy()`` alone would view it)."""
    return [t.detach().cpu().numpy().copy() for t in state]


def save(directory: str, state, cfg, topo_kind: str,
         adjacency: str | None = None,
         extra_meta: dict | None = None) -> str:
    """Write ``state`` to ``directory/ckpt_round{R}.npz``; returns the
    path. ``adjacency``: :func:`topology_fingerprint` of the run's graph
    (computed once per run). ``extra_meta``: additional JSON-able
    metadata (the drive loop records sentinel quarantines here). The
    file is written under a temporary name and published by
    ``os.replace``."""
    os.makedirs(directory, exist_ok=True)
    arrays = dict(zip(type(state)._fields, fetch_host(state)))
    meta = {
        "state_type": type(state).__name__,
        "round": int(arrays["round"]),
        "topology": topo_kind,
        "adjacency": adjacency,
        "saved_at": time.time(),
        PACKAGE_KEY: PACKAGE_TAG,
        **(extra_meta or {}),
        **trajectory_meta(cfg),
    }
    path = os.path.join(directory, f"ckpt_round{meta['round']:09d}.npz")
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, __meta__=json.dumps(meta), **arrays)
    os.replace(tmp, path)
    _sweep_stale_tmps(directory, meta["round"])
    return path


def _sweep_stale_tmps(directory: str, published_round: int) -> None:
    """Remove tmp debris left by crashed saves.

    A crash between ``savez`` and ``os.replace`` leaves a
    ``ckpt_round*.npz.tmp.npz`` behind; once a checkpoint at the same or
    a later round publishes, that tmp can never be promoted and would
    otherwise accumulate forever. Saves are single-writer, so a tmp at
    ``round <= published_round`` is guaranteed dead — tmps for *later*
    rounds (a crashed save from a run that got further than this one
    before restarting) are left alone until a publish catches up.
    """
    prefix, suffix = "ckpt_round", ".npz.tmp.npz"
    for f in os.listdir(directory):
        if not (f.startswith(prefix) and f.endswith(suffix)):
            continue
        try:
            r = int(f[len(prefix):-len(suffix)])
        except ValueError:
            continue
        if r <= published_round:
            try:
                os.unlink(os.path.join(directory, f))
            except OSError:
                pass


def load(path: str) -> Tuple[object, dict]:
    """Load a checkpoint: ``(state on the CPU, metadata)``. Raises
    :class:`ForeignCheckpointError` for a file this package did not
    write (a JAX checkpoint has no :data:`PACKAGE_KEY`)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        check_package(meta, path)
        cls = _state_types()[meta["state_type"]]
        fields = [torch.from_numpy(np.array(z[f])) for f in cls._fields]
    return cls(*fields), meta


def check_package(meta: dict, path: str) -> None:
    """Raise :class:`ForeignCheckpointError` unless ``meta`` carries the
    port's tag."""
    if meta.get(PACKAGE_KEY) != PACKAGE_TAG:
        raise ForeignCheckpointError(
            f"checkpoint {path} was not written by {PACKAGE_TAG} (no "
            f"{PACKAGE_KEY!r}: {PACKAGE_TAG!r} in its metadata): a "
            "checkpoint of the JAX package gossipprotocol_tpu is not "
            "resumed by the PyTorch port — resume it with python -m "
            "gossipprotocol_tpu, or start the run afresh")


def candidates(directory: str) -> list:
    """Published checkpoint paths in ``directory``, newest first.

    The resume fallback chain walks this list: a *published* checkpoint
    can still be unreadable (bitrot, or a torn write on a filesystem
    where rename is not atomic), so callers probe each entry with
    :func:`peek_meta`/:func:`load` and fall back to the next on failure.

    ``.tmp.npz`` files are in-flight writes (``save`` publishes via
    ``os.replace``): a crash mid-save can leave a truncated one behind,
    and it must never shadow the last *published* checkpoint — published
    files are atomic-renamed and therefore normally complete.
    """
    if not os.path.isdir(directory):
        return []
    cands = sorted(
        (f for f in os.listdir(directory)
         if f.startswith("ckpt_round") and f.endswith(".npz")
         and not f.endswith(".tmp.npz")),
        reverse=True,
    )
    return [os.path.join(directory, f) for f in cands]


def latest(directory: str) -> str | None:
    """Path of the newest checkpoint in ``directory``, or None.

    (Head of :func:`candidates` — kept as the single-checkpoint entry
    point for callers that do not want the fallback chain.)
    """
    cands = candidates(directory)
    return cands[0] if cands else None


def latest_resumable(directory: str) -> Tuple[str, int] | None:
    """``(path, round)`` of the newest *readable* checkpoint, or None.

    Stronger than :func:`latest`: each candidate's metadata is actually
    read, so a published-but-corrupt head entry falls through to the
    next instead of being promised to a caller.
    """
    for path in candidates(directory):
        try:
            meta = peek_meta(path)
            return path, int(meta.get("round", -1))
        except Exception:
            continue
    return None


def peek_meta(path: str) -> dict:
    """Metadata only, without materializing the state arrays.

    npz members load lazily, so this reads one small zip entry — cheap
    even for a 10M-node checkpoint (whose arrays are ~hundreds of MB).
    Used by recovery-target selection, which must compare the *rounds* of
    candidate checkpoints before committing to one.
    """
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))
