"""PyTorch port, the learning workloads (``learn/``): the data shards byte
for byte the JAX package's; the per-node loss and gradient within
relative 1e-5 of XLA's batched products (their float order is XLA CPU's
library dot, not replayed); the SGP and GALA cores' mixing step bitwise
the JAX core's given the same ``x_half``; whole SGP and GALA runs with
equal rounds (or one apart at the ``tol``/``loss_tol`` border), the
parameters within 1e-5 and the train loss within relative 1e-4; the
converters and the config's rejections with the JAX package's
messages."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gossipprotocol_tpu as jx
from gossipprotocol_tpu import learn as jl
from gossipprotocol_tpu.protocols import diffusion as jd

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch import learn as tl
from gossipprotocol_tpu_torch.cli import main as torch_main
from gossipprotocol_tpu_torch.convert import (
    sgp_bundle_from_numpy, sgp_state_from_numpy,
)
from gossipprotocol_tpu_torch.protocols import diffusion as td


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


def _same(a, b) -> bool:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


_SGP_FIELDS = ("s", "w", "ratio", "streak", "converged", "alive", "round",
               "loss")


def _carry(js):
    return sgp_state_from_numpy(*[np.asarray(getattr(js, f))
                                  for f in _SGP_FIELDS], device="cpu")


@pytest.mark.parametrize("rows", [None, 260])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_least_squares_equal(dtype, rows):
    a = tl.make_least_squares(250, 6, 3, seed=11, dtype=dtype, rows=rows)
    b = jl.make_least_squares(250, 6, 3, seed=11, dtype=dtype, rows=rows)
    for x, y in zip(a, b):
        assert _same(x, y)


@pytest.mark.parametrize("m,d", [(8, 16), (3, 5)])
def test_loss_and_grad_within_tolerance(m, d):
    a, b, _ = jl.make_least_squares(500, d, m, seed=3)
    z = np.random.default_rng(0).standard_normal((500, d)).astype(
        np.float32)
    ta, tb, tz = (torch.from_numpy(x) for x in (a, b, z))
    np.testing.assert_allclose(
        tl.lsq_node_grad(ta, tb, tz).numpy(),
        np.asarray(jl.lsq_node_grad(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(z))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tl.lsq_node_loss(ta, tb, tz).numpy(),
        np.asarray(jl.lsq_node_loss(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(z))), rtol=1e-5, atol=1e-6)


def _cores(workload):
    """The two packages' learning cores over the fanout-all scatter."""
    n = 216
    tj = jx.build_topology("imp3D", n, seed=4)
    tt = tx.build_topology("imp3D", n, seed=4)

    def jmix(st, nbrs, key, **kw):
        return jd.pushsum_diffusion_round(st, nbrs, key, n=n,
                                          predicate="global", tol=1e-3)

    def tmix(st, nbrs, key=None):
        return td.pushsum_diffusion_round(st, nbrs, key, n=n,
                                          predicate="global", tol=1e-3)

    opts = dict(lr=0.05, local_steps=2, loss_tol=1e-5)
    if workload == "sgp":
        cj, ct = jl.make_sgp_core(jmix, **opts), tl.make_sgp_core(tmix,
                                                                   **opts)
    else:
        g = dict(num_groups=4, group_size=n // 4, **opts)
        cj, ct = jl.make_gala_core(jmix, **g), tl.make_gala_core(tmix, **g)
    a, b, _ = jl.make_least_squares(n, 6, 4, seed=1)
    bj = jl.SGPBundle(nbrs=jd.diffusion_edges(tj), A=jnp.asarray(a),
                      b=jnp.asarray(b))
    bt = sgp_bundle_from_numpy(td.diffusion_edges(tt, device="cpu"), a, b,
                               device="cpu")
    return cj, ct, bj, bt, jmix, tmix


@pytest.mark.parametrize("rows,groups,size,dim", [
    (4 * 8192, 4, 8192, None), (4 * 8192, 4, 8192, 8),
    (260, 4, 54, 3),    # rows past the last full group join the last
    (100, 4, 54, None),  # fewer rows than groups × size: empty groups
])
def test_card_group_sum_nearer_exact_than_ascending(rows, groups, size, dim):
    """``learn/gala.py`` ``contiguous_group_sum`` (the card's group sum)
    sums the rows that the clamped group ids give each group: within
    relative 1e-6 of the float64 sum, and no farther from it than
    ``index_add_`` in ascending row order (the CPU's)."""
    rng = np.random.default_rng(7)
    shape = (rows,) if dim is None else (rows, dim)
    x = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))
    ids = torch.clamp(torch.arange(rows) // size, 0, groups - 1)
    zeros = torch.zeros((groups,) + shape[1:], dtype=torch.float64)
    exact = zeros.index_add_(0, ids, x.double())
    ascending = zeros.float().index_add_(0, ids, x)
    got = tl.gala.contiguous_group_sum(x, groups, size)
    assert got.dtype == torch.float32 and got.shape == exact.shape
    err = (got.double() - exact).abs()
    assert float((err / exact.abs().clamp(min=1)).max()) <= 1e-6
    assert float(err.max()) <= float((ascending.double() - exact).abs().max())


@pytest.mark.parametrize("workload", ["sgp", "gala"])
def test_core_mixing_bitwise_learner_within_tolerance(workload):
    """Ten core rounds from the same state. Each round the port's mixing
    core, fed the JAX core's own ``x_half`` state, gives the JAX mix
    bitwise; the port's whole core stays within 1e-5 of the JAX core."""
    cj, ct, bj, bt, jmix, tmix = _cores(workload)
    js = jl.sgp_init(216, 6)
    ts = _carry(js)
    key = jax.random.key(0)
    for _ in range(10):
        # the JAX core's x_half, through both mixing cores
        seen = {}

        def spy(st, nbrs, k, **kw):
            seen["in"] = st
            seen["out"] = jmix(st, nbrs, k, **kw)
            return seen["out"]

        spy_core = (jl.make_sgp_core(spy, lr=0.05, local_steps=2,
                                     loss_tol=1e-5) if workload == "sgp"
                    else jl.make_gala_core(spy, num_groups=4, group_size=54,
                                           lr=0.05, local_steps=2,
                                           loss_tol=1e-5))
        nxt = spy_core(js, bj, key)
        mixed = tmix(_carry(seen["in"]), bt.nbrs)
        for f in ("s", "w", "ratio", "streak"):
            assert _same(getattr(mixed, f), getattr(seen["out"], f)), f
        ts = ct(ts, bt)
        js = nxt
        for f in ("s", "w", "ratio"):
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(ts.loss), float(js.loss),
                                   rtol=1e-5)


_RUNS = {
    "sgp_scatter": dict(workload="sgp", delivery="scatter", payload_dim=4),
    "sgp_one": dict(workload="sgp", fanout="one", payload_dim=4,
                    tol=1e-2),
    "gala_poisson": dict(workload="gala", delivery="scatter", groups=4,
                         payload_dim=4, clock="poisson",
                         activation_rate=0.8),
}


@pytest.mark.parametrize("run", list(_RUNS))
def test_run_matches_jax_within_tolerance(run):
    kw = dict(algorithm="push-sum", fanout="all", predicate="global",
              tol=1e-3, seed=7, max_rounds=3000)
    kw.update(_RUNS[run])
    rj = jx.run_simulation(jx.build_topology("imp3D", 216, seed=1),
                           jx.RunConfig(**kw))
    rt = tx.run_simulation(tx.build_topology("imp3D", 216, seed=1),
                           tx.RunConfig(device="cpu", **kw))
    assert rj.converged and rt.converged
    assert abs(rt.rounds - rj.rounds) <= 1
    np.testing.assert_allclose(float(rt.final_state.loss),
                               float(np.asarray(rj.final_state.loss)),
                               rtol=1e-4)
    if rt.rounds == rj.rounds:
        np.testing.assert_allclose(rt.final_state.ratio.numpy(),
                                   np.asarray(rj.final_state.ratio),
                                   atol=1e-5)
    losses = [m["train_loss"] for m in rt.metrics if "train_loss" in m]
    assert losses and losses[-1] == float(rt.final_state.loss)


def test_sgp_deterministic_and_descends():
    kw = dict(algorithm="push-sum", fanout="all", workload="sgp",
              payload_dim=4, predicate="global", tol=1e-3, seed=7,
              max_rounds=3000, device="cpu")
    topo = tx.build_topology("imp3D", 64, seed=1)
    r1 = tx.run_simulation(topo, tx.RunConfig(**kw))
    r2 = tx.run_simulation(topo, tx.RunConfig(**kw))
    assert r1.converged and r1.rounds == r2.rounds
    assert _same(r1.final_state.loss, r2.final_state.loss)
    assert float(r1.final_state.loss) < 0.5
    ratio = r1.final_state.ratio.numpy()
    assert np.max(np.abs(ratio - ratio.mean(axis=0))) < 5e-3


def test_continue_from_jax_state():
    """A JAX SGP state carried across with the converters runs on in the
    port (within the learner's tolerance of the JAX run)."""
    kw = dict(algorithm="push-sum", fanout="all", workload="sgp",
              payload_dim=4, predicate="global", tol=1e-3, seed=7)
    tj = jx.build_topology("imp3D", 216, seed=1)
    mid = jx.run_simulation(tj, jx.RunConfig(max_rounds=16,
                                             chunk_rounds=16, **kw))
    end_j = jx.run_simulation(tj, jx.RunConfig(max_rounds=32,
                                               chunk_rounds=16, **kw))
    end_t = tx.run_simulation(
        tx.build_topology("imp3D", 216, seed=1),
        tx.RunConfig(device="cpu", max_rounds=32, **kw),
        initial_state=_carry(mid.final_state))
    assert end_t.rounds == end_j.rounds == 32
    np.testing.assert_allclose(end_t.final_state.ratio.numpy(),
                               np.asarray(end_j.final_state.ratio),
                               atol=1e-5)


def test_converters_check_shapes():
    js = jl.sgp_init(10, 3)
    f = [np.asarray(getattr(js, x)) for x in _SGP_FIELDS]
    with pytest.raises(ValueError, match="loss"):
        sgp_state_from_numpy(*f[:-1], np.float64(1.0), device="cpu")
    with pytest.raises(ValueError, match=r"\[n, d\]"):
        sgp_state_from_numpy(np.zeros(10, np.float32), f[1],
                             np.zeros(10, np.float32), *f[3:],
                             device="cpu")
    a, b, _ = jl.make_least_squares(10, 3, 2, seed=0)
    with pytest.raises(ValueError, match="SGP data b"):
        sgp_bundle_from_numpy(None, a, b[:, :1], device="cpu")


@pytest.mark.parametrize("kw", [
    dict(algorithm="gossip", workload="sgp"),
    dict(algorithm="push-sum", workload="sgp", predicate="delta"),
    dict(algorithm="push-sum", workload="sgp", predicate="global",
         accel="epd"),
    dict(algorithm="push-sum", workload="sgp", predicate="global",
         delivery="invert"),
    dict(algorithm="push-sum", workload="sgp", predicate="global", lr=0.0),
    dict(algorithm="push-sum", workload="sgp", predicate="global",
         local_steps=0),
    dict(algorithm="push-sum", workload="sgp", predicate="global",
         sgp_samples=0),
    dict(algorithm="push-sum", workload="sgp", predicate="global",
         loss_tol=0.0),
    dict(algorithm="push-sum", workload="nonsense"),
    dict(algorithm="push-sum", groups=2),
    dict(algorithm="push-sum", workload="gala", groups=1,
         predicate="global"),
    dict(algorithm="push-sum", workload="gala", groups=2),
    dict(algorithm="push-sum", workload="gala", groups=2,
         predicate="global", fanout="all", delivery="pallas"),
    dict(algorithm="push-sum", fanout="all", delivery="megakernel",
         workload="sgp", predicate="global"),
    dict(algorithm="push-sum", semantics="reference", workload="gala",
         groups=2),
])
def test_config_rejections_match_jax(kw):
    with pytest.raises(ValueError) as ej:
        jx.RunConfig(**kw)
    with pytest.raises(ValueError) as et:
        tx.RunConfig(device="cpu", **kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("flags", [
    ["--payload-dim", "0"], ["--payload-dim", "two"], ["--lr", "0"],
    ["--lr", "-0.1"], ["--local-steps", "0"], ["--sgp-samples", "0"],
    ["--loss-tol", "0"], ["--workload", "training"], ["--groups", "0"],
])
def test_cli_bad_learning_flags_exit_2(flags, capsys):
    assert torch_main(["64", "full", "push-sum", "--device", "cpu",
                       *flags]) == 2
    assert flags[0] in capsys.readouterr().err


def test_cli_gala_divisibility_exit_2(capsys):
    assert torch_main(["64", "imp3D", "push-sum", "--fanout", "all",
                       "--workload", "gala", "--groups", "3",
                       "--predicate", "global", "--device", "cpu"]) == 2
    assert "divisible by --groups" in capsys.readouterr().err
