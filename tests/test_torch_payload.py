"""PyTorch port, vector payloads: the ``[n, d]`` initial state
(``pushsum_payload_values``), ``matvec_payload`` over the fused gather and
routed deliveries (columns paired (0, 1), (2, 3), ..., ``w`` last, an odd
leftover paired with zeros), ``mask_sender_rows``, and the fanout-all
round on both deliveries with a vector payload, each bitwise the JAX
package's on the CPU (tolerance 0: the same bits). ``payload_dim == 1``
keeps the scalar state byte for byte."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gossipprotocol_tpu as jx
from gossipprotocol_tpu.ops import delivery as jdel
from gossipprotocol_tpu.ops.pallasdelivery import build_pallas_delivery
from gossipprotocol_tpu.protocols import state as jst

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch.ops import delivery as tdel
from gossipprotocol_tpu_torch.ops.pallasdelivery import (
    build_pallas_delivery as torch_build_pallas,
)
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
           "powerlaw": ("powerlaw", 400, {"seed": 3, "m": 3})}
_built: dict = {}


def _deliveries(graph):
    """(port pallas, port routed, JAX pallas) of one graph."""
    if graph not in _built:
        name, n, kw = _GRAPHS[graph]
        tj, tt = jx.build_topology(name, n, **kw), tx.build_topology(
            name, n, **kw)
        _built[graph] = (
            torch_build_pallas(tt, device="cpu"),
            tdel.build_routed_delivery(tt, device="cpu"),
            build_pallas_delivery(tj))
    return _built[graph]


@pytest.mark.parametrize("value_mode", ["scaled", "index"])
@pytest.mark.parametrize("d", [1, 2, 3, 16])
def test_init_matches_jax(d, value_mode):
    a = tst.pushsum_init(300, value_mode=value_mode, device="cpu",
                         payload_dim=d)
    b = jst.pushsum_init(300, value_mode=value_mode, payload_dim=d)
    for f in ("s", "w", "ratio", "streak", "converged", "alive"):
        assert _same(getattr(a, f), getattr(b, f)), f


def test_scalar_init_unchanged():
    """payload_dim 1 is the scalar state: [n] fields, the bits of
    i / N."""
    st = tst.pushsum_init(1000, device="cpu")
    i = torch.arange(1000, dtype=torch.float32)
    assert st.s.shape == (1000,) and st.s.dtype == torch.float32
    assert torch.equal(st.s, i / torch.full_like(i, 1000))


def test_payload_values_match_numpy_revive():
    ids = np.array([0, 7, 299, 150])
    a = tst.pushsum_payload_values(torch.from_numpy(ids), 300, 5, "scaled",
                                   torch.float32)
    b = jst.pushsum_payload_values(ids, 300, 5, "scaled", np.float32, np)
    assert _same(a, b)


_jitted: dict = {}


def _jax_payload(dl, graph, d):
    """The JAX package's ``matvec_payload`` over its delivery ``dl``
    (interpret mode), jitted once per (graph, d)."""
    key = (graph, d)
    if key not in _jitted:
        _jitted[key] = jax.jit(lambda xs, xw: jdel.matvec_payload(
            lambda a, b: dl.matvec(a, b, interpret=True), xs, xw))
    return _jitted[key]


@pytest.mark.parametrize("d", [1, 2, 3, 16])
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_matvec_payload_bitwise(graph, d):
    """Pallas and routed: ``ceil((d + 1) / 2)`` calls, each output bitwise
    the JAX package's on the same inputs (over its pallas delivery, which
    its own tests hold bitwise to its routed one)."""
    tp, tr, jp = _deliveries(graph)
    n = tp.n
    rng = np.random.default_rng(d)
    xs = rng.standard_normal((n, d) if d > 1 else n).astype(np.float32)
    xw = rng.random(n).astype(np.float32)
    calls = []

    def counted(mv):
        def f(a, b):
            calls.append(1)
            return mv(a, b)
        return f

    want = _jax_payload(jp, graph, d)(jnp.asarray(xs), jnp.asarray(xw))
    for dl in (tp, tr):
        calls.clear()
        got = tdel.matvec_payload(counted(dl.matvec), torch.from_numpy(xs),
                                  torch.from_numpy(xw))
        assert len(calls) == (-(-(d + 1) // 2) if d > 1 else 1)
        assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_mask_sender_rows_bitwise():
    rng = np.random.default_rng(0)
    s = rng.standard_normal((500, 3)).astype(np.float32)
    w = rng.random(500).astype(np.float32)
    key_t = fold_in(key_data(11, "cpu"), 4)
    key_j = jax.random.fold_in(jax.random.key(11), 4)
    gids = np.arange(500)
    for clock in ((1.0, 1), (0.25, 5)):
        a = tdel.mask_sender_rows(torch.from_numpy(s), torch.from_numpy(w),
                                  key_t, clock, torch.from_numpy(gids))
        b = jdel.mask_sender_rows(jnp.asarray(s), jnp.asarray(w), key_j,
                                  clock, jnp.asarray(gids, jnp.int32))
        assert _same(a[0], b[0]) and _same(a[1], b[1])


