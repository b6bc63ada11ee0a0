"""PyTorch port, Poisson activation clocks (``async_/clock.py``): the
clock specs and the activation mask bitwise the JAX package's, and gossip
and fanout-one push-sum under ``--clock poisson`` bitwise the JAX rounds
and runs on the CPU (tolerance 0: the same bits, the same rounds); the
config's clock rejections carry the JAX package's messages."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.async_ import clock as jc
from gossipprotocol_tpu.protocols import gossip as jg
from gossipprotocol_tpu.protocols import pushsum as jp
from gossipprotocol_tpu.protocols import state as jst
from gossipprotocol_tpu.protocols.sampling import device_topology as jdt

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.async_ import clock as tc
from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.protocols import gossip as tg
from gossipprotocol_tpu_torch.protocols import pushsum as tp
from gossipprotocol_tpu_torch.protocols import state as tst
from gossipprotocol_tpu_torch.protocols.sampling import (
    device_topology, fold_in, key_data,
)


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


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


_GRAPHS = {"imp3D": ("imp3D", 216, {"seed": 4}),      # dense table
           "powerlaw": ("powerlaw", 300, {"seed": 2}),  # CSR
           "full": ("full", 64, {})}                   # implicit


@pytest.mark.parametrize("clock,rate,div", [("sync", 1.0, 1),
                                            ("poisson", 0.7, 1),
                                            ("poisson", 2.0, 8)])
def test_spec_and_probability(clock, rate, div):
    a = tc.clock_spec(clock, rate, id_div=div)
    assert a == jc.clock_spec(clock, rate, id_div=div)
    assert tc.activation_probability(a) == jc.activation_probability(a)
    with pytest.raises(ValueError, match="unknown clock model"):
        tc.clock_spec("lamport", 1.0)


@pytest.mark.parametrize("spec", [(1.0, 1), (0.3, 1), (2.0, 8), (0.5, 4)])
@pytest.mark.parametrize("rnd", [0, 17])
def test_activation_mask_bitwise(spec, rnd):
    gids = np.arange(5000)
    a = tc.activation_mask(fold_in(key_data(9, "cpu"), rnd), spec,
                           torch.from_numpy(gids))
    b = jc.activation_mask(jax.random.fold_in(jax.random.key(9), rnd),
                           spec, jnp.asarray(gids, jnp.int32))
    assert _same(a, b)
    p = tc.activation_probability(spec)
    assert abs(float(a.float().mean()) - p) < 0.03


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_gossip_round_bitwise(graph):
    name, n, kw = _GRAPHS[graph]
    tj, tt = jx.build_topology(name, n, **kw), tx.build_topology(
        name, n, **kw)
    n = tt.num_nodes
    nj, nt = jdt(tj), device_topology(tt, device="cpu")
    sj = jst.gossip_init(n, 3)
    st = tst.gossip_init(n, 3, device="cpu")
    for _ in range(25):
        sj = jg.gossip_round(sj, nj, jax.random.key(2), n=n, all_alive=True,
                             clock=(0.7, 1))
        st = tg.gossip_round(st, nt, key_data(2, "cpu"), n=n,
                             all_alive=True, clock=(0.7, 1))
        for f in ("counts", "converged"):
            assert _same(getattr(st, f), getattr(sj, f)), f


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_pushsum_round_bitwise(graph, d):
    name, n, kw = _GRAPHS[graph]
    tj, tt = jx.build_topology(name, n, **kw), tx.build_topology(
        name, n, **kw)
    n = tt.num_nodes
    nj, nt = jdt(tj), device_topology(tt, device="cpu")
    sj = jst.pushsum_init(n, payload_dim=d)
    st = tst.pushsum_init(n, device="cpu", payload_dim=d)
    for _ in range(25):
        sj = jp.pushsum_round(sj, nj, jax.random.key(7), n=n,
                              all_alive=True, clock=(0.4, 1))
        st = tp.pushsum_round(st, nt, key_data(7, "cpu"), n=n,
                              all_alive=True, clock=(0.4, 1))
        for f in ("s", "w", "ratio", "streak", "converged"):
            assert _same(getattr(st, f), getattr(sj, f)), f


_RUNS = {
    "gossip": dict(algorithm="gossip", clock="poisson",
                   activation_rate=0.5),
    "pushsum": dict(algorithm="push-sum", clock="poisson",
                    activation_rate=1.5, eps=1e-6),
}


@pytest.mark.parametrize("run", list(_RUNS))
def test_run_matches_jax(run):
    """Engine runs under ``--clock poisson``: same rounds, bitwise final
    state (imp3D 216, the dense table)."""
    kw = dict(_RUNS[run], seed=3, max_rounds=400)
    rj = jx.run_simulation(jx.build_topology("imp3D", 216, seed=4),
                           jx.RunConfig(**kw))
    rt = tx.run_simulation(tx.build_topology("imp3D", 216, seed=4),
                           tx.RunConfig(device="cpu", **kw))
    assert rt.rounds == rj.rounds and rt.converged == rj.converged
    for f in rt.final_state._fields:
        assert _same(getattr(rt.final_state, f),
                     getattr(rj.final_state, f)), f


def test_poisson_gossip_never_inverts():
    """The gather-inverted gossip branch is off under a Poisson clock (the
    JAX package's rule)."""
    from gossipprotocol_tpu_torch.engine.driver import (
        gossip_inversion_enabled,
    )

    topo = tx.build_topology("imp3D", 64)
    assert gossip_inversion_enabled(topo, tx.RunConfig(device="cpu"))
    assert not gossip_inversion_enabled(topo, tx.RunConfig(
        device="cpu", clock="poisson"))


@pytest.mark.parametrize("kw", [
    dict(algorithm="push-sum", fanout="all", delivery="scatter",
         clock="poisson", accel="epd"),
    dict(algorithm="gossip", clock="poisson", semantics="reference"),
    dict(algorithm="push-sum", delivery="invert", clock="poisson"),
    dict(algorithm="push-sum", fanout="all", delivery="megakernel",
         clock="poisson"),
    dict(algorithm="gossip", activation_rate=0.0),
    dict(algorithm="gossip", clock="lamport"),
])
def test_config_rejections_match_jax(kw):
    with pytest.raises(ValueError) as ej:
        jx.RunConfig(**kw)
    with pytest.raises(ValueError) as et:
        tx.RunConfig(device="cpu", **kw)
    assert str(et.value) == str(ej.value)


def test_cli_poisson_runs(capsys):
    rc = torch_main(["216", "imp3D", "gossip", "--clock", "poisson",
                     "--activation-rate", "0.5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "converged: True" in out


@pytest.mark.parametrize("flag", [["--activation-rate", "0"],
                                  ["--clock", "lamport"]])
def test_cli_bad_clock_flags_exit_2(flag, capsys):
    assert torch_main(["64", "imp3D", "gossip", "--device", "cpu",
                       *flag]) == 2
    assert flag[0] in capsys.readouterr().err
