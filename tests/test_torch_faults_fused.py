"""PyTorch port, fanout-all push-sum over the pallas and routed
deliveries under kill and revive strikes: the live-degree matvec of the
dead-set path after the strike and fresh-born rows after the revive,
bitwise the JAX routed run (Pallas interpreter). The JAX scatter and
routed runs are not bitwise equal to each other on this CPU (XLA fuses
the scatter into the add), so the port's fused deliveries are held to
JAX routed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.utils import faults as jf

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.utils import faults as tf


@pytest.fixture(scope="module", autouse=True)
def _one_openmp_thread():
    """This module's OpenMP code (torch's CPU kernels) runs on one
    thread, restored afterwards: once a process has run a parallel region
    on several threads, GNU OpenMP waits forever in a child forked from
    it, and the JAX package's shard builds fork their workers, so a later
    test of that kind in this test worker would hang."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_FIELDS = ("s", "w", "ratio", "streak", "converged", "alive")


_FANOUT_ALL = dict(algorithm="push-sum", fanout="all", seed=0,
                   max_rounds=40, predicate="global", plan_cache="none")


@pytest.fixture(scope="module")
def routed_kill_run():
    """The JAX routed run (Pallas interpreter) with a 10 % kill strike at
    round 5 and a revive at 12 on imp3D 216, capped at 40 rounds."""
    tj = jx.build_topology("imp3D", 216, seed=4)
    sj = jf.build_schedule(tj.num_nodes, fail_fraction=0.1, fail_round=5,
                           revive_round=12, seed=0)
    return jx.run_simulation(tj, jx.RunConfig(
        fault_schedule=sj, delivery="routed", **_FANOUT_ALL))


@pytest.mark.parametrize("delivery", ["pallas", "routed"])
def test_fanout_all_kill_bitwise_with_jax_routed(delivery, routed_kill_run):
    """The fused deliveries under a dead set: the live-degree matvec path
    of every round after the strike, and fresh-born rows after the
    revive."""
    tt = tx.build_topology("imp3D", 216, seed=4)
    st = tf.build_schedule(tt.num_nodes, fail_fraction=0.1, fail_round=5,
                           revive_round=12, seed=0)
    rt = tx.run_simulation(tt, tx.RunConfig(
        device="cpu", fault_schedule=st, delivery=delivery, **_FANOUT_ALL))
    assert int((~rt.final_state.alive).sum()) == 0  # all revived
    rj = routed_kill_run
    assert (rt.rounds, rt.converged) == (rj.rounds, rj.converged)
    for f in _FIELDS:
        a = getattr(rt.final_state, f).numpy()
        b = np.asarray(getattr(rj.final_state, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


def test_dead_rows_stay_frozen_between_strike_and_revive():
    """Between the kill and the revive the dead rows keep their values
    (neither send nor receive) and the survivors conserve their mass
    exactly over a chunk without events."""
    tt = tx.build_topology("imp3D", 216, seed=4)
    st = tf.build_schedule(tt.num_nodes, fail_fraction=0.1, fail_round=5,
                           revive_round=30, seed=0)
    cfg = dict(_FANOUT_ALL, max_rounds=8)
    at8 = tx.run_simulation(tt, tx.RunConfig(
        device="cpu", fault_schedule=st, delivery="pallas", **cfg))
    at20 = tx.run_simulation(tt, tx.RunConfig(
        device="cpu", fault_schedule=st, delivery="pallas",
        **dict(cfg, max_rounds=20)))
    dead = ~at8.final_state.alive
    assert int(dead.sum()) > 0
    for f in ("s", "w"):
        assert torch.equal(getattr(at8.final_state, f)[dead],
                           getattr(at20.final_state, f)[dead])
    live8 = at8.final_state.w[~dead].double().sum()
    live20 = at20.final_state.w[~dead].double().sum()
    assert abs(float(live8 - live20)) < 1e-4


