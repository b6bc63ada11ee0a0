"""The unified host-event engine (port of
``gossipprotocol_tpu/events/engine.py``): one chunk-boundary pipeline
for fault strikes, overlay repair, topology-schedule (churn) events and
value-fault injections, executed in one pass per event round:

1. **strikes** — due kills then due revives flip the host alive mask;
2. **edge events** — explicit ``add/remove/swap`` entries plus generated
   churn, applied per due round in ascending order against the *current*
   adjacency;
3. **repair** — the configured policy responds to the post-event graph
   (``topology/repair.py``);
4. **one partition-rule pass** — unreachable-from-majority == dead,
   against the final adjacency;
5. **rebirth + device diff + rebuild** — revived rows reset to
   fresh-born state on the device, the alive diff is scattered onto the
   device mask (new tensors: nothing the next chunk reads is a host
   buffer), and any adjacency change goes through the engine's
   ``rebuild`` hook under the float64 mass-conservation assertion;
6. **value faults** last, filtered by the final alive mask.

Resume: :func:`replay_topology_events` reconstructs the adjacency a
checkpoint lived through by replaying the same steps per event round —
bitwise, because explicit events are literal, generated churn and repair
key their rngs per round, and the CSR rebuilds are canonical.

The JAX engine's telemetry spans are not ported here (they belong to the
observability slice): the engine takes no telemetry object.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

import torch

from gossipprotocol_tpu_torch.events import plan as plan_mod
from gossipprotocol_tpu_torch.topology.base import Topology


def _due_churn_rounds(plan, start: Optional[int], upto: int):
    """Churn rounds in ``[start, upto]`` (ascending); ``start`` is the
    engine's next-unfired churn pointer."""
    if plan.churn is None or start is None or start > upto:
        return []
    return list(range(start, upto + 1, int(plan.churn.period)))


def _apply_round_edge_events(run_topo, plan, r: int, *, run_seed: int,
                             consume=None):
    """Apply round ``r``'s edge events (explicit + generated churn) to
    ``run_topo``. The single source of truth shared by the live engine
    and the resume replay — they cannot drift apart.

    ``consume`` optionally maps the mutable (adds, removes, swaps) dicts
    the live engine pops fired events from; the replay passes None and
    reads the plan directly. Returns ``(new_topo, stats, generated)``.
    """
    if consume is not None:
        adds, removes, swaps = consume
        ex_add = adds.pop(r, None)
        ex_rem = removes.pop(r, None)
        ex_swp = swaps.pop(r, None)
    else:
        ex_add = plan.adds.get(r)
        ex_rem = plan.removes.get(r)
        ex_swp = plan.swaps.get(r)
    generated = False
    if plan.churn is not None and r >= plan.churn.period \
            and r % int(plan.churn.period) == 0:
        g_rem, g_add, g_swp = plan_mod.generate_churn(
            run_topo, plan.churn, run_seed=run_seed, event_round=r)
        generated = bool(g_rem.size or g_add.size or g_swp.size)

        def cat(ex, gen):
            if ex is None:
                return gen if gen.size else None
            ex = np.asarray(ex, np.int64).reshape(-1, gen.shape[1])
            return np.concatenate([ex, gen]) if gen.size else ex

        ex_rem = cat(ex_rem, g_rem)
        ex_add = cat(ex_add, g_add)
        ex_swp = cat(ex_swp, g_swp)
    return (*plan_mod.apply_edge_events(
        run_topo, removes=ex_rem, adds=ex_add, swaps=ex_swp), generated)


class HostEvents:
    """All chunk-boundary host events of one run, in firing order.

    Constructed at drive-loop entry with the resume round: strictly-past
    events are pruned exactly like the legacy driver did (a checkpoint at
    round C reflects every event with r < C, never r == C — re-firing a
    kill could re-kill a node revived since, and a revive reset is not
    idempotent). The drive loop asks :meth:`next_round` to stop each
    chunk at the next event and calls :meth:`fire` between chunks.
    """

    def __init__(self, topo: Topology, cfg, start_round: int, tel=None):
        from gossipprotocol_tpu_torch.obs import as_telemetry

        sched = cfg.schedule
        self.tel = as_telemetry(tel)
        self.plan = cfg.events
        if self.plan.has_events and topo.implicit_full:
            raise ValueError(
                "event plans need an explicit edge list; the implicit "
                "complete graph has no CSR to rewrite")
        self.plan.validate(topo.num_nodes)
        self.topo = topo
        self.cfg = cfg
        keep = lambda ev: {  # noqa: E731
            int(r): np.asarray(v, dtype=np.int64)
            for r, v in ev.items() if int(r) >= start_round
        }
        self.kills = keep(sched.kills)
        self.revives = keep(sched.revives)
        self.adds = keep(self.plan.adds)
        self.removes = keep(self.plan.removes)
        self.swaps = keep(self.plan.swaps)
        # value-fault injections by round (a checkpoint at C reflects the
        # corruption of every fault with r < C — it is in the state)
        self.value_faults: dict = {}
        for vf in self.plan.value_faults:
            if int(vf.round) >= start_round:
                self.value_faults.setdefault(int(vf.round), []).append(vf)
        # next unfired churn round (None without a generator); a resumed
        # run starts at the first multiple of the period >= start_round
        self._churn_next = self.plan.next_churn_round(start_round)

    # ---- scheduling ----------------------------------------------------

    def next_round(self, default: int) -> int:
        """Round of the next pending event; the drive loop stops each
        chunk exactly here so no event can be skipped."""
        cands = [*self.kills, *self.revives, *self.adds, *self.removes,
                 *self.swaps, *self.value_faults]
        if self._churn_next is not None:
            cands.append(self._churn_next)
        return min(cands, default=default)

    def due(self, cur_round: int) -> bool:
        return self.next_round(cur_round + 1) <= cur_round

    # ---- execution -----------------------------------------------------

    def fire(self, state, run_topo, cur_round: int, rebuild):
        """Fire everything due at ``cur_round`` through the unified
        pipeline, inside the telemetry hub's ``fault_event`` span. Returns
        ``(state, run_topo, new_step_or_None, records, reborn_count)`` —
        ``new_step`` is what ``rebuild`` returned when the adjacency
        changed (the caller swaps it in and re-anchors its mass baseline
        if ``reborn_count``)."""
        due = lambda ev: sum(1 for r in ev if r <= cur_round)  # noqa: E731
        attrs = dict(round=cur_round, kills=due(self.kills),
                     revives=due(self.revives))
        edge = len({r for ev in (self.adds, self.removes, self.swaps)
                    for r in ev if r <= cur_round}
                   | set(_due_churn_rounds(self.plan, self._churn_next,
                                           cur_round)))
        if edge:
            attrs["edge_events"] = edge
        if due(self.value_faults):
            attrs["value_faults"] = due(self.value_faults)
        with self.tel.span("fault_event", **attrs):
            return self._fire(state, run_topo, cur_round, rebuild)

    def _fire(self, state, run_topo, cur_round: int, rebuild):
        from gossipprotocol_tpu_torch.engine.driver import (
            _mass_snapshot, inject_value_fault, revive_rows,
        )
        from gossipprotocol_tpu_torch.topology import repair as repair_mod
        from gossipprotocol_tpu_torch.utils import faults as faults_mod

        cfg, topo = self.cfg, self.topo
        t_fire = time.perf_counter()
        due_k = sorted(r for r in self.kills if r <= cur_round)
        due_r = sorted(r for r in self.revives if r <= cur_round)
        due_e = sorted({r for ev in (self.adds, self.removes, self.swaps)
                        for r in ev if r <= cur_round}
                       | set(_due_churn_rounds(self.plan, self._churn_next,
                                               cur_round)))
        due_v = sorted(r for r in self.value_faults if r <= cur_round)
        # an owned host copy: on the CPU .numpy() would view the tensor
        alive_host = state.alive.cpu().numpy().copy()
        before = alive_host.copy()
        req_revive = (np.concatenate([self.revives[r] for r in due_r])
                      if due_r else np.empty(0, np.int64))
        for r in due_k:
            alive_host[self.kills.pop(r)] = False
        for r in due_r:
            alive_host[self.revives.pop(r)] = True

        # edge events per due round in ascending order, against the
        # evolving adjacency — identical to the resume replay's per-round
        # loop (they share _apply_round_edge_events)
        edge_stats = {"changed": False, "edges_added": 0,
                      "edges_removed": 0, "edges_swapped": 0,
                      "edges_skipped": 0}
        generated = False
        for r in due_e:
            run_topo, st, gen = _apply_round_edge_events(
                run_topo, self.plan, r, run_seed=cfg.seed,
                consume=(self.adds, self.removes, self.swaps))
            generated |= gen
            edge_stats["changed"] |= st["changed"]
            for k in ("edges_added", "edges_removed", "edges_swapped",
                      "edges_skipped"):
                edge_stats[k] += st[k]
        if due_e and self._churn_next is not None:
            self._churn_next = self.plan.next_churn_round(cur_round + 1)

        repair_stats = None
        if cfg.repair != "off":
            # self-healing: prune dead endpoints from the CSR (rewire
            # additionally re-splices survivors), responding to the
            # post-churn graph
            run_topo, repair_stats = repair_mod.repair_topology(
                run_topo, alive_host[: topo.num_nodes], cfg.repair,
                run_seed=cfg.seed, event_round=cur_round,
                revived=req_revive,
            )
        if due_k or due_r or edge_stats["changed"]:
            # the single partition-rule pass, against the final adjacency
            alive_host[: topo.num_nodes] = faults_mod.apply_partition_rule(
                run_topo, alive_host[: topo.num_nodes], cfg.repair
            )
        alive_host[topo.num_nodes:] = False  # padding rows never live
        # nodes that actually (re)joined — revive ids that survived the
        # majority rule — restart from fresh-born state, on the device
        reborn = np.flatnonzero(alive_host & ~before)
        if reborn.size:
            state = revive_rows(state, reborn, cfg, topo.num_nodes)
        newly_dead = np.flatnonzero(before & ~alive_host)
        alive_dev = state.alive
        dev = alive_dev.device
        if newly_dead.size:
            alive_dev = alive_dev.index_put(
                (torch.from_numpy(newly_dead).to(dev),),
                torch.zeros((), dtype=torch.bool, device=dev))
        if reborn.size:
            alive_dev = alive_dev.index_put(
                (torch.from_numpy(reborn).to(dev),),
                torch.ones((), dtype=torch.bool, device=dev))
        state = state._replace(alive=alive_dev)

        # one rebuild serves every adjacency change in the batch, under
        # the conservation assertion: events never touch protocol state,
        # so push-sum mass over every row is conserved exactly across it
        new_step = None
        info: dict = {}
        rebuild_s = 0.0
        changed = bool(edge_stats["changed"]
                       or (repair_stats and repair_stats["changed"]))
        if changed:
            if rebuild is None:
                raise RuntimeError(
                    "topology event fired but the engine supplied no "
                    "rebuild hook"
                )
            mass0 = _mass_snapshot(state)
            t0r = time.perf_counter()
            new_step, state, info = rebuild(run_topo, state)
            rebuild_s = time.perf_counter() - t0r
            mass1 = _mass_snapshot(state)
            # NaN/Inf mass (a prior sentinel-off value fault) makes the
            # equality meaningless — the state was poisoned before it
            finite = (mass0 is None
                      or all(np.isfinite(v) for v in mass0))
            if finite and mass0 != mass1:
                raise AssertionError(
                    f"event rebuild changed protocol mass: "
                    f"{mass0} -> {mass1} (policy={cfg.repair}, "
                    f"round={cur_round})"
                )

        # the host seconds of the whole batch (strikes, edge events,
        # repair, the partition rule and the rebuild)
        event_s = time.perf_counter() - t_fire
        records = []
        if repair_stats is not None:
            rec = {
                "event": "repair",
                "round": cur_round,
                "policy": cfg.repair,
                "rebuild_s": 0.0 if due_e else rebuild_s,
                "event_s": 0.0 if due_e else event_s,
                **{k: v for k, v in repair_stats.items()},
                **({} if due_e else info),
            }
            records.append(rec)
        if due_e:
            records.append({
                "event": "churn",
                "round": cur_round,
                "generated": generated,
                "rebuild_s": rebuild_s,
                "event_s": event_s,
                **edge_stats,
                **info,
            })

        # value-fault injection LAST: the corruption must never leak into
        # the rebuild's conservation snapshot, and the sample is filtered
        # by the final alive mask so already-quarantined (dead) rows stay
        # untouched — what makes a post-rollback replay of the fault a
        # no-op
        for r in due_v:
            for vf in self.value_faults.pop(r):
                drawn = plan_mod.value_fault_ids(
                    topo.num_nodes, vf, run_seed=cfg.seed)
                hit = drawn[alive_host[drawn]]
                if hit.size:
                    state = inject_value_fault(state, hit, vf, cfg,
                                               topo.num_nodes)
                records.append({
                    "event": "value_fault",
                    "round": cur_round,
                    "fault_round": int(vf.round),
                    "model": str(vf.model),
                    "rate": float(vf.rate),
                    "drawn": int(drawn.size),
                    "nodes": int(hit.size),
                })
        return state, run_topo, new_step, records, int(reborn.size)

    def quarantine(self, state, run_topo, cur_round: int, ids, rebuild):
        """Quarantine ``ids`` at ``cur_round``: a synthetic kill through
        the normal pipeline, with one twist — the offending rows' mass is
        zeroed on device FIRST, so the poison (NaN/Inf/adversarial mass)
        leaves the network the instant the nodes do and the rebuild's
        conservation snapshot stays finite.

        Everything due at ``cur_round`` co-fires in the same pipeline
        pass (exactly how the resume replay merges a logged quarantine
        into the scheduled kills of the same round), so live and replayed
        topology sequences stay bitwise-identical. Returns
        ``(state, run_topo, new_step_or_None, records)``.
        """
        from gossipprotocol_tpu_torch.engine.driver import quarantine_rows

        ids = np.sort(np.asarray(ids, np.int64).reshape(-1))
        state = quarantine_rows(state, ids)
        prev = self.kills.get(cur_round)
        self.kills[cur_round] = (
            ids if prev is None
            else np.unique(np.concatenate([prev, ids])))
        state, run_topo, new_step, records, _reborn = self.fire(
            state, run_topo, cur_round, rebuild)
        records.append({
            "event": "quarantine",
            "round": cur_round,
            "nodes": int(ids.size),
            "ids": ids[:64].tolist(),
            "policy": self.cfg.repair,
        })
        return state, run_topo, new_step, records


def replay_topology_events(topo: Topology, schedule, plan, policy: str,
                           run_seed: int, upto_round: int,
                           quarantines=None) -> Topology:
    """Reconstruct the adjacency in force at a resume point.

    A checkpoint at round ``C`` reflects every event with ``r < C`` (the
    engine fires events at the top of the chunk loop and prunes
    strictly-past events on resume). Replaying those rounds in order —
    kills, revives, edge events, repair, partition rule, exactly as
    :meth:`HostEvents.fire` batches them — reproduces the live topology
    sequence bitwise: explicit events are literal, churn and repair key
    their rngs per event round, and the CSR rebuilds are canonical.

    ``quarantines`` maps a round to the node ids the sentinel quarantined
    there (checkpoint ``quarantines`` metadata): dynamic kills a pure
    replay could never re-derive, merged into the scheduled kills of
    their round exactly as :meth:`HostEvents.quarantine` co-fired them.
    """
    from gossipprotocol_tpu_torch.topology import repair as repair_mod
    from gossipprotocol_tpu_torch.utils import faults as faults_mod

    repair_mod.validate_policy(policy)
    plan = plan_mod.as_plan(plan)
    quarantines = {int(r): np.asarray(v, np.int64)
                   for r, v in dict(quarantines or {}).items()}
    if policy == "off" and not plan.has_events and not quarantines:
        return topo
    birth = topo.birth_alive()
    alive = (np.ones(topo.num_nodes, bool) if birth is None
             else np.asarray(birth, bool).copy())
    rounds = set(schedule.kills) | set(schedule.revives)
    rounds |= set(plan.explicit_rounds())
    rounds |= set(quarantines)
    if plan.churn is not None and upto_round > plan.churn.period:
        rounds |= set(range(int(plan.churn.period), int(upto_round),
                            int(plan.churn.period)))
    out = topo
    for r in sorted(rounds):
        if r >= upto_round:
            break
        kills = schedule.kills.get(r)
        qids = quarantines.get(r)
        if qids is not None:
            kills = (qids if kills is None else
                     np.unique(np.concatenate(
                         [np.asarray(kills, np.int64), qids])))
        strikes = kills is not None
        if kills is not None:
            alive[np.asarray(kills, np.int64)] = False
        revs = schedule.revives.get(r)
        strikes |= revs is not None
        revived = (np.asarray(revs, np.int64) if revs is not None
                   else np.empty(0, np.int64))
        alive[revived] = True
        out, estats, _ = _apply_round_edge_events(
            out, plan, r, run_seed=run_seed)
        if policy != "off":
            out, _ = repair_mod.repair_topology(
                out, alive, policy, run_seed=run_seed, event_round=r,
                revived=revived)
        if strikes or estats["changed"]:
            alive = faults_mod.apply_partition_rule(out, alive, policy)
    return out


def replay_topology(topo: Topology, cfg, upto_round: int) -> Topology:
    """Config-level wrapper over :func:`replay_topology_events` — the
    engines' resume entry point."""
    return replay_topology_events(
        topo, cfg.schedule, cfg.events, cfg.repair, cfg.seed, upto_round,
        quarantines=dict(getattr(cfg, "quarantine_log", ()) or ()))
