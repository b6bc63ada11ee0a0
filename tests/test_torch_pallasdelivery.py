"""PyTorch port, fused gather delivery (ops/pallasdelivery.py): the plan
tables are the JAX package's byte for byte in both gather modes, the
converters carry a JAX-built delivery across unchanged, and ``matvec`` is
bitwise equal to the JAX package's ``PallasDelivery.matvec`` run in
interpret mode — on the graphs of tests/test_pallasdelivery.py (line,
imp3D, and a power-law graph with a hub-split class)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gossipprotocol_tpu.ops import pallasdelivery as jpd
from gossipprotocol_tpu.topology import build_topology as jax_build
from gossipprotocol_tpu_torch.convert import (
    delivery_from_numpy, gather_plan_from_numpy,
)
from gossipprotocol_tpu_torch.ops import pallasdelivery as tpd
from gossipprotocol_tpu_torch.ops.delivery import RoutedConfigError
from gossipprotocol_tpu_torch.topology import build_topology as torch_build


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


_GRAPHS = {
    "line": ("line", 130, {}),
    "imp3D": ("imp3D", 216, {"seed": 4}),
    "powerlaw": ("powerlaw", 400, {"seed": 3, "m": 3}),
}
# None = the default threshold (resident at these sizes); 2 forces bucket
_MODES = {"resident": None, "bucket": 2}


def _same_bytes(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _plans_equal(tp, jp):
    return (tp.mode == jp.mode and tp.src_rows == jp.src_rows
            and tp.out_len == jp.out_len
            and all(_same_bytes(getattr(tp, f), getattr(jp, f))
                    for f in ("idx", "rows", "lidx")))


def _deliveries(graph, mode):
    name, n, kw = _GRAPHS[graph]
    rr = _MODES[mode]
    jd = jpd.build_pallas_delivery(jax_build(name, n, **kw), device=False,
                                   resident_rows=rr)
    td = tpd.build_pallas_delivery(torch_build(name, n, **kw),
                                   device="cpu", resident_rows=rr)
    return jd, td


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_plan_tables_equal(seed, mode):
    rng = np.random.default_rng(seed)
    src_len = int(rng.integers(300, 5000))
    src = rng.integers(0, src_len + 1, int(rng.integers(1, 4000)))
    jp = jpd.build_gather_plan(src, src_len, resident_rows=_MODES[mode])
    tp = tpd.build_gather_plan(src, src_len, resident_rows=_MODES[mode],
                               device="cpu")
    assert tp.mode == mode
    assert _plans_equal(tp, jp)
    # and the gather itself: out[j] = flat_padded[src[j]]
    flat = rng.standard_normal(src_len).astype(np.float32)
    got = tp.gather(torch.from_numpy(flat)).numpy()
    want = np.asarray(jp.gather(jnp.asarray(flat), interpret=True))
    assert _same_bytes(got, want)
    assert _same_bytes(got, np.append(flat, np.float32(0))[src])


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_delivery_fields_equal(graph, mode):
    jd, td = _deliveries(graph, mode)
    assert (td.n, td.nu, td.m_pairs, td.classes) == (
        jd.n, jd.nu, jd.m_pairs, jd.classes)
    assert _plans_equal(td.gather_pre, jd.gather_pre)
    assert _plans_equal(td.gather_out, jd.gather_out)
    assert _same_bytes(td.degree, jd.degree)
    assert tpd.pallas_streamed_bytes_per_round(td) == \
        jpd.pallas_streamed_bytes_per_round(jd)


def test_powerlaw_graph_has_a_hub_split_class():
    _, td = _deliveries("powerlaw", "resident")
    assert any(2 * c > 128 for c, *_ in td.classes)


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_matvec_bitwise_vs_jax(graph, mode):
    jd, td = _deliveries(graph, mode)
    rng = np.random.default_rng(len(graph))
    xs = rng.standard_normal(td.n).astype(np.float32)
    xw = rng.random(td.n).astype(np.float32)
    jdev = jpd.to_device(jd)
    want_s, want_w = jdev.matvec(jnp.asarray(xs), jnp.asarray(xw),
                                 interpret=True)
    got_s, got_w = td.matvec(torch.from_numpy(xs), torch.from_numpy(xw))
    assert _same_bytes(got_s, want_s) and _same_bytes(got_w, want_w)


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_delivery_carried_across_from_jax(graph):
    jd, td = _deliveries(graph, "bucket")
    carried = delivery_from_numpy(
        jd.n, jd.nu, jd.m_pairs, jd.classes, tuple(jd.gather_pre),
        tuple(jd.gather_out), jd.degree, device="cpu")
    assert carried.classes == td.classes
    assert _plans_equal(carried.gather_pre, td.gather_pre)
    assert _plans_equal(carried.gather_out, td.gather_out)
    x = torch.linspace(0, 1, td.n)
    for a, b in zip(carried.matvec(x, x), td.matvec(x, x)):
        assert _same_bytes(a, b)


def test_matvec_sums_neighbours():
    """Against a dense reference on a graph with no float reassociation
    (small integers): in[i] = sum of x over i's neighbours."""
    topo = torch_build("powerlaw", 400, seed=3, m=3)
    td = tpd.build_pallas_delivery(topo, device="cpu")
    x = torch.arange(td.n, dtype=torch.float32)
    in_s, in_w = td.matvec(x, torch.ones(td.n))
    off = topo.offsets.astype(np.int64)
    want = np.array([topo.indices[off[i]:off[i + 1]].astype(np.float64).sum()
                     for i in range(td.n)])
    assert np.array_equal(in_s.numpy().astype(np.float64), want)
    assert np.array_equal(in_w.numpy(), topo.degree.astype(np.float32))


def test_converter_rejects_out_of_bounds_tables():
    plan = tpd.build_gather_plan_np(np.arange(100), 100, resident_rows=0)
    mode, src_rows, out_len, idx, rows, lidx = plan
    bad = rows.copy()
    bad[0, 0] = src_rows
    with pytest.raises(ValueError, match="out of the padded source"):
        gather_plan_from_numpy(mode, src_rows, out_len, idx, bad, lidx,
                               device="cpu")
    with pytest.raises(ValueError, match="unknown gather mode"):
        gather_plan_from_numpy("dma", src_rows, out_len, idx, rows, lidx,
                               device="cpu")


def test_complete_graph_is_refused():
    with pytest.raises(RoutedConfigError):
        tpd.build_pallas_delivery(torch_build("full", 20), device="cpu")


def test_cpu_gathers_launch_nothing_and_other_devices_raise():
    before = dict(tpd.LAUNCHES)
    _, td = _deliveries("line", "bucket")
    td.matvec(torch.ones(td.n), torch.ones(td.n))
    assert tpd.LAUNCHES == before
    x = torch.empty(8, 128, device="meta")
    idx = torch.empty(1, 8, 128, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tpd.gather_resident(x, idx)


# ---- bucket-plan invariants the card's gather_bucket relies on ----------
# (csrc/gather.cu stages rows[t, :max(lidx >> 7) + 1] of each tile in at
# most 1024 ints of shared memory and reads x[rows_s[li >> 7] * 128 +
# (li & 127)]; padding outputs must read the +0.0 slot)

def _bucket_cases():
    rng = np.random.default_rng(7)
    cases = {}
    for k in range(3):
        src_len = int(rng.integers(2_000, 60_000))
        cases[f"random{k}"] = (
            rng.integers(0, src_len + 1, int(rng.integers(1, 5_000))),
            src_len)
    # one tile whose 1024 outputs read 1024 distinct rows, in a shuffled
    # order, followed by a ragged tile
    cases["distinct1024"] = (rng.permutation(1024) * 128 + 5, 1024 * 128)
    # a single tile whose outputs all read one row (and padding)
    cases["one_row"] = (np.full(700, 3 * 128 + 9), 4 * 128)
    return cases


_BUCKET_CASES = _bucket_cases()


@pytest.mark.parametrize("case", list(_BUCKET_CASES))
def test_bucket_plan_invariants(case):
    src, src_len = _BUCKET_CASES[case]
    plan = tpd.build_gather_plan_np(src, src_len, resident_rows=0)
    assert plan.mode == "bucket"
    tiles, r_cap = plan.rows.shape
    assert r_cap <= tpd.TILE and r_cap % 8 == 0
    li = plan.lidx.reshape(tiles, tpd.TILE).astype(np.int64)
    pos = li // tpd.LANES
    for t in range(tiles):
        used = np.unique(pos[t])
        distinct = int(pos[t].max()) + 1
        # every position up to the max is read, so max + 1 is the tile's
        # distinct-row count, and it fits the table
        assert np.array_equal(used, np.arange(distinct))
        assert distinct <= r_cap
        rows_t = plan.rows[t, :distinct].astype(np.int64)
        assert np.all(np.diff(rows_t) > 0)            # ascending, distinct
        assert np.all(plan.rows[t, distinct:] == 0)   # zero table padding
    # every output reads its source slot; padding outputs the zero slot
    flat = np.full(tiles * tpd.TILE, src_len, np.int64)
    flat[: len(src)] = src
    got = (np.take_along_axis(plan.rows.astype(np.int64), pos, axis=1)
           * tpd.LANES + li % tpd.LANES).reshape(-1)
    assert np.array_equal(got, flat)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        src_len).astype(np.float32) + 1)
    gp = gather_plan_from_numpy(*plan, device="cpu")
    out = gp.gather_padded(gp.padded_source(x)).numpy()
    assert np.array_equal(out[: len(src)], x.numpy()[src])
    pad = out[len(src):]
    assert np.all(pad == 0) and not np.signbit(pad).any()
    if case == "distinct1024":
        assert int(pos[0].max()) + 1 == 1024 == r_cap
    if case == "one_row":
        assert tiles == 1 and int(pos[0].max()) + 1 == 2  # the row + zero slot
    jp = jpd.build_gather_plan(src, src_len, resident_rows=0)
    assert _plans_equal(gather_plan_from_numpy(*plan, device="cpu"), jp)


def test_gather_bucket_rejects_a_wider_row_table():
    x = torch.zeros(8, tpd.LANES)
    rows = torch.zeros(1, tpd.TILE + 8, dtype=torch.int32)
    lidx = torch.zeros(1, tpd.TILE_ROWS, tpd.LANES, dtype=torch.int32)
    with pytest.raises(ValueError, match="row table width"):
        tpd.gather_bucket(x, rows, lidx)
