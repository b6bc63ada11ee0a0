"""PyTorch port, the host side of the K-round kernel (``ops/megakernel.py``)
that runs on any machine: the global mean summed in the kernel's order
(``kernel_order_mean``, the plain version the kernel is held to on the
card) against a float32 numpy replay of that order; the compact pair
tables the kernel gathers through, against the delivery's own gather
plans; the class table's work units; and the phase-split read-out. The
kernel itself runs only on the card (``tests/test_torch_kernels_cuda.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gossipprotocol_tpu_torch.ops import megakernel as mkm
from gossipprotocol_tpu_torch.ops.pallasdelivery import (
    LANES, build_pallas_delivery,
)
from gossipprotocol_tpu_torch.topology import build_topology


@pytest.fixture(scope="module", autouse=True)
def _one_openmp_thread():
    """torch's CPU kernels on one OpenMP thread while this module runs
    (GNU OpenMP hangs in a child forked after a parallel region on several
    threads, and later tests in the same worker fork)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _replay_kernel_mean(s, w, grid, threads):
    """The kernel's order in float32 numpy: each thread adds its nodes
    i = thread + t * grid * threads in ascending t from +0; a shuffle-down
    tree in each warp (offsets 16..1, a lane past the warp keeping its own
    value); the warps of a block left to right; the blocks left to right
    from block 0's sum; then sum(s) / max(sum(w), 1e-30)."""
    stride = grid * threads
    sums = []
    for x in (s, w):
        acc = np.zeros(stride, np.float32)
        for t0 in range(0, len(x), stride):
            chunk = x[t0: t0 + stride]
            acc[: len(chunk)] = acc[: len(chunk)] + chunk
        v = acc.reshape(grid, threads // 32, 32)
        for off in (16, 8, 4, 2, 1):
            down = v.copy()
            down[..., : 32 - off] = v[..., off:]
            v = v + down
        warps = v[..., 0]
        block = warps[:, 0].copy()
        for j in range(1, threads // 32):
            block = block + warps[:, j]
        total = block[0]
        for b in block[1:]:
            total = np.float32(total + b)
        sums.append(np.float32(total))
    return np.float32(sums[0] / max(sums[1], np.float32(1e-30)))


@pytest.mark.parametrize("grid", [1, 3, 132])
@pytest.mark.parametrize("n", [1_000, 300_001])
def test_kernel_order_mean_replays_the_kernel_order(grid, n):
    rng = np.random.default_rng(grid * 7 + n)
    s = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))).astype(
        np.float32)
    w = rng.random(n).astype(np.float32)
    got = mkm.kernel_order_mean(torch.from_numpy(s), torch.from_numpy(w),
                                grid)
    want = _replay_kernel_mean(s, w, grid, mkm.THREADS)
    assert got.dtype == torch.float32
    assert np.float32(got.item()).tobytes() == want.tobytes()


_GRAPHS = {
    "line": ("line", 130, {}),
    "imp3D": ("imp3D", 216, {"seed": 4}),
    "powerlaw": ("powerlaw", 400, {"seed": 3, "m": 3}),   # hub split
    "erdos_renyi": ("erdos_renyi", 500, {"seed": 1}),     # c = 1, 2 classes
}


def _delivery(graph):
    name, n, kw = _GRAPHS[graph]
    return build_pallas_delivery(build_topology(name, n, **kw), device="cpu")


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_pair_tables_gather_what_the_plans_gather(graph):
    """Through the compact tables, (s, w)-interleaved sources give the
    very floats the plans gather from [xs | xw | 0] and from the packed
    fold outputs, bitwise (tile padding included)."""
    pd = _delivery(graph)
    n, nu = pd.n, pd.nu
    pre_node, out_rank = mkm._pair_tables(pd)
    rng = np.random.default_rng(len(graph))
    xs = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    xw = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    x = torch.zeros(pd.gather_pre.src_rows * LANES)
    x[:n], x[n: 2 * n] = xs, xw
    want_pre = pd.gather_pre.gather_padded(x.view(-1, LANES))
    xp2 = torch.zeros(n + 1, 2)
    xp2[:n, 0], xp2[:n, 1] = xs, xw
    assert torch.equal(xp2[pre_node.long()].reshape(-1).view(torch.int32),
                       want_pre.view(torch.int32))

    y = torch.zeros(pd.gather_out.src_rows * LANES)
    y[: 2 * nu] = torch.from_numpy(
        rng.standard_normal(2 * nu).astype(np.float32))
    want_out = pd.gather_out.gather_padded(y.view(-1, LANES))[: 2 * n]
    yp2 = y[: 2 * (nu + 1)].view(nu + 1, 2)
    got = yp2[out_rank.long()]
    assert torch.equal(got[:, 0].view(torch.int32),
                       want_out[:n].view(torch.int32))
    assert torch.equal(got[:, 1].view(torch.int32),
                       want_out[n:].view(torch.int32))


def test_pair_tables_refuse_unpaired_plans():
    pd = _delivery("imp3D")
    idx = pd.gather_pre.idx.clone()
    idx.view(-1)[1] += 1                    # a w lane off its s lane
    bad = pd._replace(gather_pre=pd.gather_pre._replace(idx=idx))
    with pytest.raises(ValueError, match="pairs"):
        mkm._pair_tables(bad)


@pytest.mark.parametrize("graph", list(_GRAPHS))
def test_class_table_units_cover_every_class(graph):
    """Each small class's 128-pair units cover its runs and stay in its
    region; each split class has one unit per two of its q * n_c rows;
    the prefixes the kernel indexes by are the running sums."""
    pd = _delivery(graph)
    rows, n_part, n_arr, split_units, small_units = mkm._class_table(pd)
    assert len(rows[0]) == mkm._CLASS_COLS
    out_at = part_at = arr_at = 0
    at = {True: 0, False: 0}
    for row, (c, n_c, start, reg_rows, cap) in zip(rows, pd.classes):
        rc, rn, rstart, rcap, q, r_out, r_part, r_arr, unit_at, units = row
        assert (rc, rn, rstart, rcap) == (c, n_c, start, cap)
        split = 2 * c > LANES
        assert q == (2 * c // LANES if split else 0)
        assert (r_out, unit_at) == (out_at, at[split])
        if split:
            assert units * 2 == q * n_c
            assert (r_part, r_arr) == (part_at, arr_at)
            part_at += q * n_c
            arr_at += n_c
        else:
            assert units * 128 >= n_c * c > (units - 1) * 128
            assert units * 128 <= reg_rows * 64
        at[split] += units
        out_at += 2 * n_c
    assert (n_part, n_arr) == (part_at, arr_at)
    assert (split_units, small_units) == (at[True], at[False])


def test_format_phase_split():
    split = dict(grid=132, executed=16, ns_per_cycle=0.505, launch_us=650.0,
                 prologue_us=4.25, prologue_barrier_us=1.5, round_us=41.0,
                 phases={name: dict(mean_us=1.0, max_us=2.0,
                                    min_mean_us=0.5)
                         for name, *_ in mkm._PHASES})
    line = mkm.format_phase_split(split)
    for name, *_ in mkm._PHASES:
        assert f"{name} 1.00 [0.50; 2.00]" in line
    assert "round 41.00" in line and "launch 650.0" in line
