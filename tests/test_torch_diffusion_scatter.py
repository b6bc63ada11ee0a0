"""PyTorch port, the fanout-all round by scatter over the edge list
(``--fanout all --delivery scatter``): ``diffusion_edges`` equal to the
JAX package's; the round bitwise the JAX round on the CPU (tolerance 0)
with scalar and vector payloads, an arbitrary dead set, per-edge loss
windows, a Poisson clock and two edge slices; the contract "equal up to
float accumulation order" where XLA's order is not replayed (three edge
slices, the implicit complete graph's sums: relative 1e-5); engine runs
with the same rounds and bitwise state; ``--x64`` on the scatter paths;
the config's rejections with the JAX package's messages."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.protocols import diffusion as jd
from gossipprotocol_tpu.protocols import state as jst

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.protocols import diffusion as td
from gossipprotocol_tpu_torch.protocols import state as tst
from gossipprotocol_tpu_torch.protocols.sampling import fold_in, key_data


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


@contextlib.contextmanager
def jax_x64():
    """The JAX package's float64 runs need ``jax_enable_x64``; restored
    afterwards, so later tests in this worker see the default."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.uint32)
    if a.dtype == np.float64:
        return a.view(np.uint64)
    return a


def _same(a, b) -> bool:
    a, b = _bits(a), _bits(b)
    return a.shape == b.shape and np.array_equal(a, b)


_GRAPHS = {"imp3D": ("imp3D", 216, {"seed": 4}),
           "line": ("line", 64, {}),
           "powerlaw": ("powerlaw", 300, {"seed": 2}),
           "full": ("full", 64, {})}
_FIELDS = ("s", "w", "ratio", "streak", "converged")


def _pair(graph):
    name, n, kw = _GRAPHS[graph]
    return jx.build_topology(name, n, **kw), tx.build_topology(name, n, **kw)


@pytest.mark.parametrize("graph", ["imp3D", "powerlaw", "full"])
def test_diffusion_edges_equal(graph):
    tj, tt = _pair(graph)
    a, b = td.diffusion_edges(tt, device="cpu"), jd.diffusion_edges(tj)
    if tt.implicit_full:
        assert a is None and b is None
        return
    for f in ("src", "dst", "degree"):
        assert np.array_equal(getattr(a, f).numpy(),
                              np.asarray(getattr(b, f))), f


_VARIANTS = {
    "plain": dict(),
    "dead": dict(dead=True),
    "loss": dict(loss_windows=((0, 12, 0.3),)),
    "clock": dict(clock=(1.0, 1)),
    "chunks2": dict(edge_chunks=2),
    "all": dict(dead=True, loss_windows=((2, 9, 0.2),), clock=(0.5, 1),
                edge_chunks=2),
}


def _rounds(graph, variant, d, rounds=10, dtype=jnp.float32):
    """Both packages' rounds from the same state: yields (port, JAX)."""
    kw = dict(_VARIANTS[variant])
    dead = kw.pop("dead", False)
    tj, tt = _pair(graph)
    n = tt.num_nodes
    sj = jst.pushsum_init(n, payload_dim=d, dtype=dtype)
    st = tst.pushsum_init(n, device="cpu", payload_dim=d,
                          dtype=str(np.dtype(dtype)))
    if dead:
        alive = np.random.default_rng(1).random(n) > 0.2
        sj = sj._replace(alive=jnp.asarray(alive))
        st = st._replace(alive=torch.from_numpy(alive))
    ej, et = jd.diffusion_edges(tj), td.diffusion_edges(tt, device="cpu")
    kj, kt = jax.random.key(3), key_data(3, "cpu")
    for _ in range(rounds):
        sj = jd.pushsum_diffusion_round(sj, ej, kj, n=n, **kw)
        st = td.pushsum_diffusion_round(st, et, fold_in(kt, st.round), n=n,
                                        **kw)
        yield st, sj


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("variant", list(_VARIANTS))
@pytest.mark.parametrize("graph", ["imp3D", "line", "powerlaw"])
def test_round_bitwise(graph, variant, d):
    for st, sj in _rounds(graph, variant, d):
        for f in _FIELDS:
            assert _same(getattr(st, f), getattr(sj, f)), f


@pytest.mark.parametrize("graph,variant", [("imp3D", "chunks3"),
                                           ("full", "plain"),
                                           ("full", "dead"),
                                           ("full", "clock")])
def test_round_within_accumulation_order(graph, variant):
    """Three edge slices (XLA's order of the partial sums is not
    replayed) and the implicit complete graph (its Σ share is
    ``torch.sum``): relative 1e-5 on s, w and the ratio."""
    _VARIANTS.setdefault("chunks3", dict(edge_chunks=3))
    for st, sj in _rounds(graph, variant, 3, rounds=10):
        for f in ("s", "w", "ratio"):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       np.asarray(getattr(sj, f)),
                                       rtol=1e-5, atol=1e-7)


def test_run_matches_jax():
    kw = dict(algorithm="push-sum", fanout="all", delivery="scatter",
              eps=1e-7, max_rounds=500, seed=2)
    tj, tt = _pair("imp3D")
    rj = jx.run_simulation(tj, jx.RunConfig(**kw))
    rt = tx.run_simulation(tt, tx.RunConfig(device="cpu", **kw))
    assert rt.rounds == rj.rounds and rt.converged
    for f in rt.final_state._fields:
        assert _same(getattr(rt.final_state, f), getattr(rj.final_state, f))


def test_run_with_faults_and_loss_matches_jax():
    from gossipprotocol_tpu.utils import faults as jf

    from gossipprotocol_tpu_torch.utils import faults as tf

    kw = dict(algorithm="push-sum", fanout="all", delivery="scatter",
              predicate="global", tol=1e-4, max_rounds=200, seed=2,
              chunk_rounds=8)
    sk = dict(fail_fraction=0.1, fail_round=3, drop_prob=0.2,
              drop_window=(0, 10), seed=2, max_rounds=200)
    tj, tt = _pair("imp3D")
    rj = jx.run_simulation(tj, jx.RunConfig(
        fault_schedule=jf.build_schedule(216, **sk), **kw))
    rt = tx.run_simulation(tt, tx.RunConfig(
        device="cpu", fault_schedule=tf.build_schedule(216, **sk), **kw))
    assert rt.rounds == rj.rounds
    for f in ("s", "w", "ratio", "alive"):
        assert _same(getattr(rt.final_state, f), getattr(rj.final_state, f))


@pytest.mark.parametrize("variant", ["plain", "dead", "loss"])
def test_x64_round_within_tolerance(variant):
    """float64 state on the fanout-all scatter: the port rounds ``s -
    share*deg`` twice where XLA contracts it (no wider type holds the
    product), so held to relative 1e-13 over 10 rounds."""
    with jax_x64():
        for st, sj in _rounds("imp3D", variant, 3, dtype=jnp.float64):
            assert st.s.dtype == torch.float64
            for f in ("s", "w", "ratio"):
                np.testing.assert_allclose(getattr(st, f).numpy(),
                                           np.asarray(getattr(sj, f)),
                                           rtol=1e-13, atol=1e-15)


def test_x64_fanout_one_run_bitwise():
    """float64 fanout-one push-sum (halves and the scatter only): bitwise
    the JAX package's run."""
    kw = dict(algorithm="push-sum", eps=1e-9, max_rounds=300, seed=5)
    tj, tt = _pair("imp3D")
    with jax_x64():
        rj = jx.run_simulation(tj, jx.RunConfig(dtype=jnp.float64, **kw))
        rt = tx.run_simulation(tt, tx.RunConfig(device="cpu",
                                                dtype="float64", **kw))
        assert rt.final_state.s.dtype == torch.float64
        assert rt.rounds == rj.rounds
        for f in ("s", "w", "ratio", "streak"):
            assert _same(getattr(rt.final_state, f),
                         getattr(rj.final_state, f)), f


def test_cli_runs(capsys):
    for extra in ([], ["--edge-chunks", "2"], ["--x64"],
                  ["--payload-dim", "3"]):
        rc = torch_main(["216", "imp3D", "push-sum", "--fanout", "all",
                         "--delivery", "scatter", "--predicate", "global",
                         "--device", "cpu", *extra])
        out = capsys.readouterr().out
        assert rc == 0 and "converged: True" in out, extra


@pytest.mark.parametrize("kw", [
    dict(algorithm="push-sum", fanout="all", delivery="pallas",
         edge_chunks=2),
    dict(algorithm="push-sum", fanout="one", edge_chunks=2),
    dict(algorithm="push-sum", fanout="all", delivery="scatter",
         edge_chunks=0),
    dict(algorithm="push-sum", fanout="all", delivery="routed",
         dtype="float64"),
    dict(algorithm="push-sum", fanout="all", delivery="megakernel",
         payload_dim=2),
    dict(algorithm="gossip", payload_dim=2),
    dict(algorithm="push-sum", delivery="invert", payload_dim=2),
])
def test_config_rejections_match_jax(kw):
    jkw = dict(kw)
    if jkw.get("dtype") == "float64":
        jkw["dtype"] = jnp.float64
    with pytest.raises(ValueError) as ej:
        jx.RunConfig(**jkw)
    with pytest.raises(ValueError) as et:
        tx.RunConfig(device="cpu", **kw)
    assert str(et.value) == str(ej.value)


def test_loss_on_implicit_full_rejected():
    from gossipprotocol_tpu_torch.utils import faults as tf

    with pytest.raises(ValueError, match="explicit edge list"):
        tx.run_simulation(tx.build_topology("full", 32), tx.RunConfig(
            device="cpu", algorithm="push-sum", fanout="all",
            fault_schedule=tf.build_schedule(32, drop_prob=0.1)))
