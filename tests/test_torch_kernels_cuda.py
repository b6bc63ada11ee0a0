"""PyTorch port, CUDA kernels against their plain PyTorch versions on the
card (bitwise: the folds replay a fixed tree, the gathers only move
data). Marked ``cuda``; without a CUDA device every test skips. On a
machine with one:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Whether a card is present is decided inside the fixture, never at import
time, so every test worker collects the same tests."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gossipprotocol_tpu_torch.ops import build
from gossipprotocol_tpu_torch.ops import classops as co
from gossipprotocol_tpu_torch.ops import pallasdelivery as pdm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false); the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _mixed(rng, n, subnormal=False):
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-40, 40, n))).astype(
        np.float32)
    if subnormal:
        m = rng.random(n) < 0.2
        x[m] = (rng.standard_normal(m.sum()) * 1e-39).astype(np.float32)
    x[rng.random(n) < 0.05] = -0.0
    return x


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("subnormal", [False, True])
@pytest.mark.parametrize("c", [1, 2, 4, 8, 16, 32, 64])
def test_reduce_small_kernel(cuda, c, subnormal):
    x = torch.from_numpy(_mixed(np.random.default_rng(c), 3 * co.BLK * 128,
                                subnormal)).to(cuda)
    before = co.LAUNCHES["class_reduce_small"]
    got = co.class_reduce_small(x, c)
    torch.cuda.synchronize()
    assert co.LAUNCHES["class_reduce_small"] == before + 1
    assert _bits_equal(got, co.class_reduce_small_plain(x, c))


# q > 64 spreads a slot over several blocks (the last one folds it), q < 64
# packs whole slots in one; (2048, 8) is power_law 1M's hub class
@pytest.mark.parametrize("subnormal", [False, True])
@pytest.mark.parametrize("q,cap", [(2, 8), (8, 256), (64, 8), (300, 16),
                                   (2048, 8), (4096, 8), (8, 1024), (33, 16),
                                   (257, 16)])
def test_reduce_split_kernel(cuda, q, cap, subnormal):
    x = torch.from_numpy(_mixed(np.random.default_rng(q + cap),
                                q * cap * 128, subnormal)).to(cuda)
    got = co.class_reduce_split(x, 64 * q)
    torch.cuda.synchronize()
    assert _bits_equal(got, co.class_reduce_split_plain(x, 64 * q))


@pytest.mark.parametrize("q,cap", [(2, 8), (2048, 8)])
def test_reduce_split_kernel_negative_zero(cuda, q, cap):
    """An all -0.0 region sums to -0.0: the left fold starts at p_0."""
    x = torch.full((q * cap * 128,), -0.0, device=cuda)
    got = co.class_reduce_split(x, 64 * q)
    torch.cuda.synchronize()
    assert _bits_equal(got, co.class_reduce_split_plain(x, 64 * q))
    assert bool(torch.signbit(got).all())


def test_reduce_split_kernel_calls_in_a_row(cuda):
    """The arrival counters are reset by each launch: two calls give the
    same bits, one launch each, and leave every counter at zero."""
    q, cap = 2048, 8
    x = torch.from_numpy(_mixed(np.random.default_rng(5),
                                q * cap * 128)).to(cuda)
    before = co.LAUNCHES["class_reduce_split"]
    a = co.class_reduce_split(x, 64 * q)
    assert co.LAUNCHES["class_reduce_split"] == before + 1
    b = co.class_reduce_split(x, 64 * q)
    assert co.LAUNCHES["class_reduce_split"] == before + 2
    torch.cuda.synchronize()
    assert _bits_equal(a, b)
    assert _bits_equal(a, co.class_reduce_split_plain(x, 64 * q))
    _, arrived = co._fold_scratch(x.device, build.stream_handle(x.device),
                                  cap, q)
    assert int(arrived.abs().sum()) == 0


def test_reduce_split_kernel_two_streams(cuda):
    """Calls on two streams at once use a scratch each: both give the
    plain version's bits."""
    q, cap = 2048, 8
    rng = np.random.default_rng(6)
    xs = [torch.from_numpy(_mixed(rng, q * cap * 128)).to(cuda)
          for _ in range(2)]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    got = []
    for _ in range(8):
        got.append(co.class_reduce_split(xs[0], 64 * q))
        with torch.cuda.stream(side):
            got.append(co.class_reduce_split(xs[1], 64 * q))
    torch.cuda.synchronize()
    want = [co.class_reduce_split_plain(x, 64 * q) for x in xs]
    for i, g in enumerate(got):
        assert _bits_equal(g, want[i % 2])


def _bucket_src(case, rng):
    if case == "distinct1024":      # 64 tiles, each of 1024 distinct rows
        rows = rng.permutation(64 * 1024)
        return rows * 128 + rng.integers(0, 128, rows.size), 64 * 1024 * 128
    if case == "one_tile":          # one tile, a few rows, and padding
        return rng.integers(0, 3 * 128, 700), 3 * 128
    # 1M density: gather_pre of a 1M-node graph reads 2n + tail values
    # for about 8M outputs, ~1,000 distinct rows per tile
    return rng.integers(0, 2_000_001, 8_000_000), 2_000_000


@pytest.mark.parametrize("case", ["distinct1024", "one_tile", "density_1M"])
def test_gather_bucket_kernel_plans(cuda, case):
    rng = np.random.default_rng(11)
    src, src_len = _bucket_src(case, rng)
    plan = pdm.build_gather_plan(src, src_len, resident_rows=0, device=cuda)
    assert plan.mode == "bucket"
    flat = torch.from_numpy(rng.standard_normal(src_len).astype(
        np.float32)).to(cuda)
    x2d = plan.padded_source(flat)
    before = pdm.LAUNCHES["gather_bucket"]
    got = pdm.gather_bucket(x2d, plan.rows, plan.lidx)
    assert pdm.LAUNCHES["gather_bucket"] == before + 1
    want = pdm.gather_bucket_plain(x2d, plan.rows, plan.lidx)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)
    got = got.reshape(-1).cpu().numpy()
    ref = np.append(flat.cpu().numpy(), np.float32(0))[src]
    assert np.array_equal(got[: len(src)], ref)
    assert np.all(got[len(src):] == 0)


@pytest.mark.parametrize("resident_rows", [None, 0])
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_kernels(cuda, seed, resident_rows):
    rng = np.random.default_rng(seed)
    src_len = int(rng.integers(10_000, 200_000))
    src = rng.integers(0, src_len + 1, int(rng.integers(1, 300_000)))
    plan = pdm.build_gather_plan(src, src_len, resident_rows=resident_rows,
                                 device=cuda)
    flat = torch.from_numpy(rng.standard_normal(src_len).astype(
        np.float32)).to(cuda)
    x2d = plan.padded_source(flat)
    got = plan.gather_padded(x2d)
    if plan.mode == "resident":
        want = pdm.gather_resident_plain(x2d, plan.idx).reshape(-1)
    else:
        want = pdm.gather_bucket_plain(x2d, plan.rows, plan.lidx).reshape(-1)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)
    ref = np.append(flat.cpu().numpy(), np.float32(0))[src]
    assert np.array_equal(got[: len(src)].cpu().numpy(), ref)


def test_matvec_card_equals_cpu(cuda):
    from gossipprotocol_tpu_torch.topology import build_topology

    topo = build_topology("power_law", 20_000, seed=1, m=4)
    for rr in (None, 0):
        on_card = pdm.build_pallas_delivery(topo, device=cuda,
                                            resident_rows=rr)
        on_cpu = pdm.build_pallas_delivery(topo, device="cpu",
                                           resident_rows=rr)
        x = torch.rand(topo.num_nodes, generator=torch.Generator().manual_seed(0))
        a = on_card.matvec(x.to(cuda), x.to(cuda))
        b = on_cpu.matvec(x, x)
        for u, v in zip(a, b):
            assert _bits_equal(u.cpu(), v)


def test_dead_set_run_card_equals_cpu(cuda):
    """The general live-degree round (an arbitrary dead set) on the card
    against the CPU, 16 rounds, bitwise."""
    from gossipprotocol_tpu_torch.engine import RunConfig, run_simulation
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init
    from gossipprotocol_tpu_torch.topology import build_topology

    topo = build_topology("power_law", 20_000, seed=2, m=3)
    dead = torch.from_numpy(np.random.default_rng(4).random(20_000) < 0.1)
    start = pushsum_init(20_000, device="cpu")._replace(alive=~dead)
    res = [run_simulation(topo, RunConfig(algorithm="push-sum", fanout="all",
                                          delivery="pallas", device=d,
                                          max_rounds=16, chunk_rounds=8),
                          initial_state=start)
           for d in ("cuda", "cpu")]
    assert res[0].rounds == res[1].rounds == 16
    for a, b in zip(res[0].final_state, res[1].final_state):
        if a.dtype == torch.float32:
            assert _bits_equal(a, b)
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("graph", [("imp3D", 20_000, {"seed": 1}),
                                   ("power_law", 20_000, {"seed": 1, "m": 4})])
def test_dead_set_matvecs_on_card_equal_plain(cuda, graph):
    """The live-degree branch of the round under a random dead set: the
    masked shares and ``matvec(alive, alive)`` through the pallas and the
    routed kernels on the card, bitwise their plain versions (the same
    deliveries on the CPU) and each other; then one whole round of the
    dead-set path and a run with a kill strike at round 3 rewired mid-run
    (a plan rebuilt under the new CSR's key), card against CPU."""
    from gossipprotocol_tpu_torch.convert import routed_delivery_from_numpy
    from gossipprotocol_tpu_torch.engine import RunConfig, run_simulation
    from gossipprotocol_tpu_torch.ops.delivery import build_routed_delivery_np
    from gossipprotocol_tpu_torch.protocols.diffusion import (
        pushsum_diffusion_round_routed,
    )
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init
    from gossipprotocol_tpu_torch.topology import build_topology
    from gossipprotocol_tpu_torch.utils import faults

    name, n, kw = graph
    topo = build_topology(name, n, **kw)
    n = topo.num_nodes
    host = build_routed_delivery_np(topo)
    dels = {
        "pallas": (pdm.build_pallas_delivery(topo, device=cuda),
                   pdm.build_pallas_delivery(topo, device="cpu")),
        "routed": (routed_delivery_from_numpy(host, cuda),
                   routed_delivery_from_numpy(host, "cpu")),
    }
    rng = np.random.default_rng(5)
    alive = torch.from_numpy(rng.random(n) > 0.1)
    state = pushsum_init(n, device="cpu")._replace(alive=alive)
    deg = torch.from_numpy(topo.degree.astype(np.float32))
    inv = torch.ones_like(deg) / (deg + 1)
    zero = torch.zeros(n)
    share_s = torch.where(alive, state.s * inv, zero)
    share_w = torch.where(alive, state.w * inv, zero)
    alive_f = alive.to(torch.float32)
    outs = {}
    for dname, (card, cpu) in dels.items():
        for xs, xw in ((share_s, share_w), (alive_f, alive_f)):
            a = card.matvec(xs.to(cuda), xw.to(cuda))
            b = cpu.matvec(xs, xw)
            for u, v in zip(a, b):
                assert _bits_equal(u.cpu(), v)
            outs.setdefault(dname, []).append(a)
        rounds = [pushsum_diffusion_round_routed(
            type(state)(*(t.to(dev) for t in state)), d, predicate="global",
            all_alive=False, targets_alive=False)
            for dev, d in ((cuda, card), ("cpu", cpu))]
        for u, v in zip(*rounds):
            u = u.cpu()
            assert (_bits_equal(u, v) if u.dtype == torch.float32
                    else torch.equal(u, v))
    for a, b in zip(outs["pallas"], outs["routed"]):
        for u, v in zip(a, b):
            assert _bits_equal(u, v)
    sched = faults.build_schedule(n, fail_fraction=0.1, fail_round=3, seed=1)
    for delivery in ("pallas", "routed"):
        res = [run_simulation(topo, RunConfig(
            algorithm="push-sum", fanout="all", delivery=delivery,
            device=dev, max_rounds=12, chunk_rounds=4, repair="rewire",
            fault_schedule=sched, plan_cache="none"))
            for dev in (str(cuda), "cpu")]
        assert res[0].rounds == res[1].rounds == 12
        assert any(m.get("event") == "repair" and m["changed"]
                   for m in res[0].metrics)
        for a, b in zip(res[0].final_state, res[1].final_state):
            assert (_bits_equal(a, b) if a.dtype == torch.float32
                    else torch.equal(a, b))


@pytest.mark.parametrize("delivery", ["pallas", "routed"])
def test_dead_set_recount_on_card_equals_plain(cuda, delivery):
    """The telemetry recount under a dead set (``routed_message_counts``:
    ``matvec(alive, alive)`` through the delivery's kernels a second time
    in the round) on the card, equal to its plain version on the CPU; and
    a telemetry run with a kill strike, card against CPU: the same
    counters every chunk, the same state bitwise as without telemetry."""
    from gossipprotocol_tpu_torch.engine import RunConfig, run_simulation
    from gossipprotocol_tpu_torch.engine.driver import device_arrays
    from gossipprotocol_tpu_torch.obs import Telemetry
    from gossipprotocol_tpu_torch.protocols.diffusion import (
        routed_message_counts,
    )
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init
    from gossipprotocol_tpu_torch.topology import build_topology
    from gossipprotocol_tpu_torch.utils import faults
    import tempfile

    topo = build_topology("imp3D", 20_000, seed=1)
    n = topo.num_nodes
    alive = torch.from_numpy(np.random.default_rng(6).random(n) > 0.1)
    state = pushsum_init(n, device="cpu")._replace(alive=alive)
    got = {}
    for dev in (str(cuda), "cpu"):
        cfg = RunConfig(algorithm="push-sum", fanout="all",
                        delivery=delivery, device=dev, plan_cache="none")
        d = device_arrays(topo, cfg)
        st = type(state)(*(t.to(dev) for t in state))
        before = dict(co.LAUNCHES)
        got[dev] = routed_message_counts(
            st, d, n=n, all_alive=False, targets_alive=False).cpu()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert co.LAUNCHES["class_reduce_small"] > before[
                "class_reduce_small"]
    assert torch.equal(got[str(cuda)], got["cpu"])
    assert int(got["cpu"][1]) < int(got["cpu"][0])
    sched = faults.build_schedule(n, fail_fraction=0.1, fail_round=3, seed=1)
    res = {}
    for dev in (str(cuda), "cpu"):
        tel = Telemetry(tempfile.mkdtemp())
        res[dev] = run_simulation(topo, RunConfig(
            algorithm="push-sum", fanout="all", delivery=delivery,
            device=dev, max_rounds=12, chunk_rounds=4, telemetry=tel,
            fault_schedule=sched, plan_cache="none"))
        tel.close()
    off = run_simulation(topo, RunConfig(
        algorithm="push-sum", fanout="all", delivery=delivery,
        device=str(cuda), max_rounds=12, chunk_rounds=4,
        fault_schedule=sched, plan_cache="none"))
    rows = [[(m["round"], m["sent"], m["delivered"]) for m in r.metrics
             if "sent" in m] for r in res.values()]
    assert rows[0] == rows[1] and len(rows[0]) == 4
    for a, b in zip(res[str(cuda)].final_state, off.final_state):
        assert (_bits_equal(a, b) if a.dtype == torch.float32
                else torch.equal(a, b))


_MK_GRAPHS = {"imp3D": ("imp3D", 216, {"seed": 4}),
              "powerlaw": ("powerlaw", 400, {"seed": 3, "m": 3})}


@pytest.mark.parametrize("predicate", ["delta", "global"])
@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("graph", list(_MK_GRAPHS))
def test_megakernel_kernel(cuda, graph, k, predicate):
    """The K-round kernel against its plain version (the global mean
    summed in the kernel's order), 48 rounds from the initial state with
    a real streak, so runs converge and freeze mid-launch: every field
    and the round count bitwise equal."""
    from gossipprotocol_tpu_torch.ops import megakernel as mkm
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init
    from gossipprotocol_tpu_torch.topology import build_topology

    name, n, kw = _MK_GRAPHS[graph]
    topo = build_topology(name, n, **kw)
    mk = mkm.build_megakernel_delivery(
        pdm.build_pallas_delivery(topo, device=cuda))
    opts = dict(n=topo.num_nodes, rounds_per_kernel=k, eps=1e-5,
                streak_target=2, predicate=predicate, tol=1e-3)
    ms_k = mkm.pad_state(pushsum_init(topo.num_nodes, device=cuda))
    ms_p = mkm.pad_state(pushsum_init(topo.num_nodes, device=cuda))
    before = mkm.LAUNCHES["megakernel"]
    for _ in range(48 // k):
        ms_k = mkm.megakernel_rounds(ms_k, mk, **opts)
        ms_p = mkm.megakernel_rounds_plain(ms_p, mk, **opts,
                                           mean_grid=mkm.launch_grid(mk))
    torch.cuda.synchronize()
    assert mkm.LAUNCHES["megakernel"] == before + 48 // k
    for a, b in zip(ms_k, ms_p):
        if a.dtype == torch.float32:
            assert _bits_equal(a, b)
        else:
            assert torch.equal(a, b)
    assert 0 < int(ms_k.round) < 48  # converged inside the budget


def _mk_setup(cuda, name, n, kw):
    from gossipprotocol_tpu_torch.ops import megakernel as mkm
    from gossipprotocol_tpu_torch.topology import build_topology

    topo = build_topology(name, n, **kw)
    return topo.num_nodes, mkm.build_megakernel_delivery(
        pdm.build_pallas_delivery(topo, device=cuda))


def _mk_equal(ms_k, ms_p):
    for a, b in zip(ms_k, ms_p):
        if a.dtype == torch.float32:
            assert _bits_equal(a, b)
        else:
            assert torch.equal(a, b)


# graphs wide enough to spread the fold over every block of the grid, so
# its handed-out half runs (imp3D 30^3; power_law with split classes)
_MK_WIDE = {"imp3D": ("imp3D", 27_000, {"seed": 1}),
            "powerlaw": ("power_law", 20_000, {"seed": 2, "m": 4})}


@pytest.mark.parametrize("predicate", ["delta", "global"])
@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("graph", list(_MK_WIDE))
def test_megakernel_kernel_wide(cuda, graph, k, predicate):
    """32 rounds on a graph whose fold spans every block, against the
    plain version: every field bitwise."""
    from gossipprotocol_tpu_torch.ops import megakernel as mkm
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init

    n, mk = _mk_setup(cuda, *_MK_WIDE[graph])
    opts = dict(n=n, rounds_per_kernel=k, eps=1e-6, streak_target=3,
                predicate=predicate, tol=1e-3)
    ms_k = mkm.pad_state(pushsum_init(n, device=cuda))
    ms_p = mkm.pad_state(pushsum_init(n, device=cuda))
    for _ in range(32 // k):
        ms_k = mkm.megakernel_rounds(ms_k, mk, **opts)
        ms_p = mkm.megakernel_rounds_plain(ms_p, mk, **opts,
                                           mean_grid=mkm.launch_grid(mk))
    torch.cuda.synchronize()
    _mk_equal(ms_k, ms_p)


@pytest.mark.parametrize("predicate", ["delta", "global"])
@pytest.mark.parametrize("k", [1, 16])
@pytest.mark.parametrize("graph", list(_MK_GRAPHS))
def test_megakernel_kernel_quorum(cuda, graph, k, predicate):
    """The quorum supervisor: the run stops once that many rows are
    converged, bitwise where the plain version stops."""
    from gossipprotocol_tpu_torch.ops import megakernel as mkm
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init

    n, mk = _mk_setup(cuda, *_MK_GRAPHS[graph])
    opts = dict(n=n, rounds_per_kernel=k, eps=1e-5, streak_target=2,
                predicate=predicate, tol=1e-3, quorum=n // 2)
    ms_k = mkm.pad_state(pushsum_init(n, device=cuda))
    ms_p = mkm.pad_state(pushsum_init(n, device=cuda))
    for _ in range(48 // k):
        ms_k = mkm.megakernel_rounds(ms_k, mk, **opts)
        ms_p = mkm.megakernel_rounds_plain(ms_p, mk, **opts,
                                           mean_grid=mkm.launch_grid(mk))
    torch.cuda.synchronize()
    _mk_equal(ms_k, ms_p)
    assert 0 < int(ms_k.round) < 48


@pytest.mark.parametrize("predicate", ["delta", "global"])
@pytest.mark.parametrize("graph", list(_MK_GRAPHS))
def test_megakernel_kernel_frozen_exit(cuda, graph, predicate):
    """From an already-converged state the launch runs no round: the
    state and the round count come back bitwise unchanged."""
    from gossipprotocol_tpu_torch.ops import megakernel as mkm
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init

    n, mk = _mk_setup(cuda, *_MK_GRAPHS[graph])
    opts = dict(n=n, rounds_per_kernel=16, eps=1e-5, streak_target=2,
                predicate=predicate, tol=1e-3)
    ms = mkm.pad_state(pushsum_init(n, device=cuda))
    for _ in range(2):  # a state some rounds in
        ms = mkm.megakernel_rounds_plain(ms, mk, **opts,
                                         mean_grid=mkm.launch_grid(mk))
    ms = ms._replace(conv=torch.ones_like(ms.conv))
    before = [t.clone() for t in ms]
    ms = mkm.megakernel_rounds(ms, mk, **opts)
    torch.cuda.synchronize()
    _mk_equal(ms, before)


@pytest.mark.parametrize("graph", list(_MK_GRAPHS))
def test_megakernel_kernel_launches_in_a_row(cuda, graph):
    """Launches of different K back to back on one delivery (its scratch
    counters carried across launches): 16, 1, 7, 16 rounds, bitwise equal
    to the plain version after each."""
    from gossipprotocol_tpu_torch.ops import megakernel as mkm
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init

    n, mk = _mk_setup(cuda, *_MK_GRAPHS[graph])
    ms_k = mkm.pad_state(pushsum_init(n, device=cuda))
    ms_p = mkm.pad_state(pushsum_init(n, device=cuda))
    for k in (16, 1, 7, 16):
        opts = dict(n=n, rounds_per_kernel=k, eps=1e-7, streak_target=2**30,
                    predicate="delta", tol=1e-3)
        ms_k = mkm.megakernel_rounds(ms_k, mk, **opts)
        ms_p = mkm.megakernel_rounds_plain(ms_p, mk, **opts)
        torch.cuda.synchronize()
        _mk_equal(ms_k, ms_p)
    assert int(ms_k.round) == 40


@pytest.mark.parametrize("graph", list(_MK_WIDE))
def test_megakernel_kernel_repeatable(cuda, graph):
    """Five runs on one input, bitwise equal to each other: the fold's
    handed-out half, the L1-cached gathers and the barrier leave no trace
    of the schedule in the result."""
    from gossipprotocol_tpu_torch.ops import megakernel as mkm
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init

    n, mk = _mk_setup(cuda, *_MK_WIDE[graph])
    opts = dict(n=n, rounds_per_kernel=16, eps=1e-6, streak_target=3,
                predicate="global", tol=1e-3)
    runs = []
    for _ in range(5):
        ms = mkm.pad_state(pushsum_init(n, device=cuda))
        for _ in range(3):
            ms = mkm.megakernel_rounds(ms, mk, **opts)
        torch.cuda.synchronize()
        runs.append(ms)
    for other in runs[1:]:
        _mk_equal(other, runs[0])


# the largest power_law the default resident bound admits (2n + 1 share
# values in 8,192 rows), and imp3D 1M under a raised bound, whose node
# state (7 words a node, 8 nodes a thread at 132 SMs) overflows the shared
# memory, so the kernel keeps it in device memory
_MK_LARGE = {"power_law_bound": ("power_law", 524_287, {"seed": 5, "m": 4},
                                 None),
             "imp3D_1M_raised": ("imp3D", 1_000_000, {"seed": 1}, 16384)}


@pytest.mark.parametrize("graph", list(_MK_LARGE))
def test_megakernel_kernel_large(cuda, graph, monkeypatch):
    """Two K = 16 launches at the largest sizes, under both predicates:
    every field bitwise the plain version's."""
    from gossipprotocol_tpu_torch.ops import megakernel as mkm
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init

    name, n0, kw, rows = _MK_LARGE[graph]
    if rows is not None:
        monkeypatch.setenv("GOSSIP_TPU_PALLAS_RESIDENT_ROWS", str(rows))
    n, mk = _mk_setup(cuda, name, n0, kw)
    grid = mkm.launch_grid(mk)
    if rows is not None:   # past the shared memory (s_stage alone: 33 KB)
        slots = -(-n // (grid * mkm.THREADS))
        assert slots * mkm.THREADS * 28 + 33 * 1024 > 227 * 1024
    for predicate in ("delta", "global"):
        opts = dict(n=n, rounds_per_kernel=16, eps=1e-7, streak_target=3,
                    predicate=predicate, tol=1e-4)
        ms_k = mkm.pad_state(pushsum_init(n, device=cuda))
        ms_p = mkm.pad_state(pushsum_init(n, device=cuda))
        for _ in range(2):
            ms_k = mkm.megakernel_rounds(ms_k, mk, **opts)
            ms_p = mkm.megakernel_rounds_plain(ms_p, mk, **opts,
                                               mean_grid=grid)
        torch.cuda.synchronize()
        _mk_equal(ms_k, ms_p)


def test_megakernel_phase_split(cuda):
    """The probe instantiation runs the same rounds (state bitwise equal
    to the plain kernel's) and reports every phase."""
    from gossipprotocol_tpu_torch.ops import megakernel as mkm
    from gossipprotocol_tpu_torch.protocols.state import pushsum_init

    n, mk = _mk_setup(cuda, *_MK_WIDE["powerlaw"])
    opts = dict(n=n, rounds_per_kernel=16, eps=1e-7, streak_target=2**30,
                predicate="global", tol=1e-3)
    a = mkm.pad_state(pushsum_init(n, device=cuda))
    b = mkm.pad_state(pushsum_init(n, device=cuda))
    before = mkm.LAUNCHES["megakernel"]
    split = mkm.megakernel_phase_split(a, mk, **opts)
    assert mkm.LAUNCHES["megakernel"] == before  # measurement only
    mkm.megakernel_rounds(b, mk, **opts)
    torch.cuda.synchronize()
    _mk_equal(a, b)
    assert split["executed"] == 16
    assert set(split["phases"]) == {name for name, *_ in mkm._PHASES}
    assert all(v["mean_us"] >= 0 for v in split["phases"].values())
    assert split["round_us"] > 0 and split["launch_us"] > 0


# resident sources of 1 row, 8,192 rows (the resident bound) and a 1M-node
# share source (2,000,001 values, 15,632 rows), each with one plan tile
_RESIDENT_ROWS = {"one_row": 1, "bound": 8192, "1M_nodes": 15_632}


@pytest.mark.parametrize("rows", list(_RESIDENT_ROWS))
def test_gather_resident_sources(cuda, rows):
    """The resident gather on random tables (one tile, indices over the
    whole source, its last slot included): one launch, bitwise equal to
    its plain version."""
    src_rows = _RESIDENT_ROWS[rows]
    rng = np.random.default_rng(src_rows)
    x2d = torch.from_numpy(_mixed(rng, src_rows * 128)).to(cuda).view(
        src_rows, 128)
    idx_np = rng.integers(0, src_rows * 128, pdm.TILE).astype(np.int32)
    idx_np[-1] = src_rows * 128 - 1
    idx = torch.from_numpy(idx_np).to(cuda).view(1, 8, 128)
    before = pdm.LAUNCHES["gather_resident"]
    out = pdm.gather_resident(x2d, idx)
    torch.cuda.synchronize()
    assert pdm.LAUNCHES["gather_resident"] == before + 1
    assert _bits_equal(out, pdm.gather_resident_plain(x2d, idx))


# ---- the routed slice: expand kernels, Clos stage and final passes -----

@pytest.mark.parametrize("c", [1, 2, 4, 8, 16, 32, 64])
def test_expand_small_kernel(cuda, c):
    x = torch.from_numpy(_mixed(np.random.default_rng(c),
                                2 * co.BLK * 128 // c)).to(cuda)
    before = co.LAUNCHES["class_expand_small"]
    got = co.class_expand_small(x, c)
    torch.cuda.synchronize()
    assert co.LAUNCHES["class_expand_small"] == before + 1
    assert _bits_equal(got, co.class_expand_small_plain(x, c))


@pytest.mark.parametrize("q,cap", [(2, 8), (8, 256), (2048, 8)])
def test_expand_split_kernel(cuda, q, cap):
    x = torch.from_numpy(_mixed(np.random.default_rng(q + cap),
                                2 * cap)).to(cuda)
    got = co.class_expand_split(x, 64 * q)
    torch.cuda.synchronize()
    assert _bits_equal(got, co.class_expand_split_plain(x, 64 * q))


def _placed_plan(src_of, m_in, unit, device):
    from gossipprotocol_tpu_torch.convert import plan_from_numpy
    from gossipprotocol_tpu_torch.ops.exec import device_plan
    from gossipprotocol_tpu_torch.ops.plan import build_route_plan

    return plan_from_numpy(device_plan(build_route_plan(
        src_of, m_in=m_in, unit=unit)), device)


# nt 130 unit-2 tiles: two radix stages, tau_slab > tau_in
@pytest.mark.parametrize("unit,nt,dont_care", [
    (1, 3, False), (2, 5, False), (2, 4, True), (1, 2, True),
    (2, 130, False)])
def test_route_kernels(cuda, unit, nt, dont_care):
    """Each stage's written rows and the final pass against their plain
    versions, bitwise, and the whole plan against ``x[perm]``."""
    from gossipprotocol_tpu_torch.ops import exec as ex

    rng = np.random.default_rng(nt + unit)
    u = 16384 // unit
    m = nt * u
    perm = rng.permutation(m).astype(np.int64)
    if dont_care:
        perm[rng.random(m) < 0.4] = -1
    dp = _placed_plan(perm, m, unit, cuda)
    x = torch.from_numpy(_mixed(rng, nt * 16384)).to(cuda)
    cur = x.view(-1, 128, 128)
    before = dict(ex.LAUNCHES)
    for st in dp.stages:
        got = ex.stage_call(st, cur, unit)
        want = ex.stage_call_plain(st, cur, unit)
        torch.cuda.synchronize()
        assert _bits_equal(ex.stage_rows_written(st, got),
                           ex.stage_rows_written(st, want))
        cur = want
    got = ex.final_call(dp.final, dp.nt_out, cur, unit)
    torch.cuda.synchronize()
    want = ex.final_call_plain(dp.final, dp.nt_out, cur, unit)
    assert _bits_equal(got, want)
    assert ex.LAUNCHES["stage_call"] == before["stage_call"] + len(dp.stages)
    assert ex.LAUNCHES["final_call"] == before["final_call"] + 1
    _check_final_again(dp.final, dp.nt_out, cur, unit, want)
    y = ex.apply_plan(dp, x).view(-1, unit).cpu()
    real = np.flatnonzero(perm >= 0)
    src = x.view(-1, unit).cpu()[torch.from_numpy(perm[real])]
    assert _bits_equal(y[torch.from_numpy(real)], src)
    assert bool((y[torch.from_numpy(np.flatnonzero(perm < 0))] == 0).all())


def _check_final_again(fin, nt_out, cur, unit, want):
    """The final pass twice more in a row (the persistent grid's
    barriers start afresh), bitwise against ``want``."""
    from gossipprotocol_tpu_torch.ops import exec as ex

    for _ in range(2):
        out = ex.final_call(fin, nt_out, cur, unit)
        torch.cuda.synchronize()
        assert _bits_equal(out, want)


def _random_final(rng, nt_out, k, unit, device):
    """A final pass with random planes (every decoded index a lane:
    unit 2's S0 and S2 below 127, since the odd lane adds one) and
    random masks (an eighth of the slots at k = 3 with no bit set)."""
    from gossipprotocol_tpu_torch.ops import exec as ex

    iw = 64 if unit == 2 else 128
    planes = rng.integers(0, 128, (nt_out, k, 3, iw, 128))
    if unit == 2:
        planes[:, :, 0::2] = rng.integers(0, 127, (nt_out, k, 2, iw, 128))
    mask = rng.integers(0, 256, (nt_out, k, 16, 128), dtype=np.uint8)
    return ex.DeviceFinal(k, torch.from_numpy(planes.astype(np.int8)).to(
        device), torch.from_numpy(mask).to(device))


# k >= 3 merges; nt_out 600 is more tiles than one wave of the persistent
# grid (one block per SM, 132 on the H100)
@pytest.mark.parametrize("unit,k,nt_out", [(2, 3, 600), (1, 3, 600),
                                           (2, 5, 140), (1, 1, 7),
                                           (2, 2, 1)])
def test_route_final_kernel_wide(cuda, unit, k, nt_out):
    from gossipprotocol_tpu_torch.ops import exec as ex

    rng = np.random.default_rng(unit * 100 + k)
    fin = _random_final(rng, nt_out, k, unit, cuda)
    cur = torch.from_numpy(_mixed(rng, nt_out * k * 16384)).to(cuda).view(
        -1, 128, 128)
    want = ex.final_call_plain(fin, nt_out, cur, unit)
    before = ex.LAUNCHES["final_call"]
    got = ex.final_call(fin, nt_out, cur, unit)
    torch.cuda.synchronize()
    assert ex.LAUNCHES["final_call"] == before + 1
    assert _bits_equal(got, want)
    _check_final_again(fin, nt_out, cur, unit, want)


@pytest.mark.parametrize("graph", [("imp3D", 20_000, {"seed": 1}),
                                   ("power_law", 20_000, {"seed": 1, "m": 4})])
def test_routed_matvec_equals_pallas_on_card(cuda, graph):
    """The routed matvec on the card against the fused gather delivery
    on the card and against itself on the CPU, bitwise."""
    from gossipprotocol_tpu_torch.convert import routed_delivery_from_numpy
    from gossipprotocol_tpu_torch.ops.delivery import build_routed_delivery_np
    from gossipprotocol_tpu_torch.topology import build_topology

    name, n, kw = graph
    topo = build_topology(name, n, **kw)
    n = topo.num_nodes  # imp3D rounds up to a cube
    host = build_routed_delivery_np(topo)
    rd = routed_delivery_from_numpy(host, cuda)
    rd_cpu = routed_delivery_from_numpy(host, "cpu")
    pd = pdm.build_pallas_delivery(topo, device=cuda)
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    xw = torch.from_numpy(rng.random(n).astype(np.float32))
    a = rd.matvec(xs.to(cuda), xw.to(cuda))
    b = pd.matvec(xs.to(cuda), xw.to(cuda))
    c = rd_cpu.matvec(xs, xw)
    torch.cuda.synchronize()
    for u, v, w in zip(a, b, c):
        assert _bits_equal(u, v)
        assert _bits_equal(u.cpu(), w)


def _exchange_slabs(shards, block, dtype, offset, device):
    """S slabs [S, block] as views at a byte ``offset`` into one buffer,
    so rows start unaligned for the bf16 and int8 wires."""
    rng = np.random.default_rng(shards * 1000 + block + offset)
    esize = torch.empty(0, dtype=dtype).element_size()
    raw = torch.from_numpy(rng.integers(
        -128, 128, shards * (shards * block * esize + 64),
        dtype=np.int64).astype(np.int8)).to(device)
    out = []
    for s in range(shards):
        lo = s * (shards * block * esize + 64) + offset
        out.append(raw[lo: lo + shards * block * esize].view(dtype).view(
            shards, block))
    return out


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
def test_exchange_kernel(cuda, shards, dtype, overlap):
    """``pallas_exchange`` against its plain version and the one-permutation
    spelling, bitwise (bytes compared, NaN payloads included): every
    dtype, row lengths that are not multiples of 16 bytes, rows starting
    off a 16-byte boundary, and both schedules, each one launch."""
    esize = torch.empty(0, dtype=dtype).element_size()
    for block, offset in ((37, 0), (1, 0), (4096 + 3, 0), (64, esize)):
        slabs = _exchange_slabs(shards, block, dtype, offset, cuda)
        before = pdm.LAUNCHES["pallas_exchange"]
        got = pdm.pallas_exchange(slabs, overlap=overlap)
        torch.cuda.synchronize()
        assert pdm.LAUNCHES["pallas_exchange"] == before + 1
        plain = pdm.pallas_exchange_plain(slabs, overlap=overlap)
        perm = pdm.exchange_plain(slabs)
        for g, p, q in zip(got, plain, perm):
            assert g.dtype == dtype and g.shape == (shards, block)
            assert torch.equal(g.view(torch.int8), p.view(torch.int8))
            assert torch.equal(g.view(torch.int8), q.view(torch.int8))


def test_sharded_matvec_card_equals_single_card(cuda):
    """The 4-shard push matvec on the card, every transport and wire,
    against the single-card routed matvec (f32) and its own CPU run
    (every wire), bitwise."""
    from gossipprotocol_tpu_torch.convert import shard_push_from_numpy
    from gossipprotocol_tpu_torch.ops.delivery import build_routed_delivery
    from gossipprotocol_tpu_torch.ops.sharddelivery import (
        build_shard_push_deliveries,
    )
    from gossipprotocol_tpu_torch.parallel import padded_size
    from gossipprotocol_tpu_torch.topology import build_topology

    topo = build_topology("power_law", 20_000, seed=1, m=4)
    host = build_shard_push_deliveries(topo, padded_size(20_000, 4), 4,
                                       build_workers=1)
    on_card = shard_push_from_numpy(host, cuda)
    on_cpu = shard_push_from_numpy(host, "cpu")
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.random(20_000).astype(np.float32))
    xw = torch.from_numpy(rng.random(20_000).astype(np.float32))
    single = build_routed_delivery(topo, device=cuda).matvec(
        xs.to(cuda), xw.to(cuda))
    for wire in ("f32", "bf16", "int8"):
        want = on_cpu.matvec(xs, xw, wire=wire)
        for exchange in ("all_to_all", "pallas", "overlap"):
            got = on_card.matvec(xs.to(cuda), xw.to(cuda),
                                 exchange=exchange, wire=wire)
            torch.cuda.synchronize()
            for g, w, r in zip(got, want, single):
                assert _bits_equal(g.cpu(), w)
                if wire == "f32":
                    assert _bits_equal(g, r)


# q <= 32: one window; 40, 100, 1,000: windows shifted by their leading
# padding; q < 64 packs several nodes into a block of rows, q > 64 spreads
# a node over several (the last one folds it); q = 8, n_c = 1,024 is
# power_law 1M's c = 512 hub class, q = 2,048 its c = 131,072 one
@pytest.mark.parametrize("subnormal", [False, True])
@pytest.mark.parametrize("q,n_c", [(2, 300), (16, 40), (48, 5), (300, 4),
                                   (1024, 3), (2048, 2), (40, 7), (100, 5),
                                   (1000, 3), (2048, 1), (1, 200), (8, 1024),
                                   (2048, 8), (4096, 2)])
def test_reduce_big_kernel(cuda, q, n_c, subnormal):
    x = torch.from_numpy(_mixed(np.random.default_rng(q * 7 + n_c),
                                n_c * q * 128, subnormal)).to(cuda)
    before = co.LAUNCHES["class_reduce_big"]
    got = co.class_reduce_big(x, 64 * q)
    torch.cuda.synchronize()
    assert co.LAUNCHES["class_reduce_big"] == before + 1
    assert _bits_equal(got, co.class_reduce_big_plain(x, 64 * q))


def test_reduce_big_kernel_calls_in_a_row(cuda):
    """The arrival counters are reset by each launch: two calls give the
    same bits, one launch each, and leave every counter at zero."""
    q, n_c = 1000, 6
    x = torch.from_numpy(_mixed(np.random.default_rng(8),
                                n_c * q * 128)).to(cuda)
    before = co.LAUNCHES["class_reduce_big"]
    a = co.class_reduce_big(x, 64 * q)
    b = co.class_reduce_big(x, 64 * q)
    assert co.LAUNCHES["class_reduce_big"] == before + 2
    torch.cuda.synchronize()
    assert _bits_equal(a, b)
    assert _bits_equal(a, co.class_reduce_big_plain(x, 64 * q))
    _, arrived = co._fold_scratch(x.device, build.stream_handle(x.device),
                                  n_c, q)
    assert int(arrived.abs().sum()) == 0


def test_reduce_big_kernel_two_streams(cuda):
    """Calls on two streams at once use a scratch each: both give the
    plain version's bits."""
    q, n_c = 2048, 8
    rng = np.random.default_rng(9)
    xs = [torch.from_numpy(_mixed(rng, n_c * q * 128)).to(cuda)
          for _ in range(2)]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    got = []
    for _ in range(8):
        got.append(co.class_reduce_big(xs[0], 64 * q))
        with torch.cuda.stream(side):
            got.append(co.class_reduce_big(xs[1], 64 * q))
    torch.cuda.synchronize()
    want = [co.class_reduce_big_plain(x, 64 * q) for x in xs]
    for i, g in enumerate(got):
        assert _bits_equal(g, want[i % 2])


def test_reduce_big_kernel_in_a_graph_then_eager(cuda):
    """A fresh stream's scratch is made by an eager call, never inside a
    capture: capturing first raises. Warmed up there, the captured fold,
    an eager call on that stream before the first replay, and the
    replays all give the plain version's bits."""
    q, n_c = 1000, 3
    x = torch.from_numpy(_mixed(np.random.default_rng(10),
                                n_c * q * 128)).to(cuda)
    want = co.class_reduce_big_plain(x, 64 * q)
    fresh = torch.cuda.Stream(cuda)
    fresh.wait_stream(torch.cuda.current_stream(cuda))
    key = (x.device, fresh.cuda_stream, n_c, q)
    co._FOLD_SCRATCH.pop(key, None)
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=fresh):
            co.class_reduce_big(x, 64 * q)
    assert key not in co._FOLD_SCRATCH
    with torch.cuda.stream(fresh):
        warm = co.class_reduce_big(x, 64 * q)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=fresh):
        captured = co.class_reduce_big(x, 64 * q)
    with torch.cuda.stream(fresh):
        eager = co.class_reduce_big(x, 64 * q)
    fresh.synchronize()
    assert _bits_equal(warm, want) and _bits_equal(eager, want)
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert _bits_equal(captured, want)


def test_reduce_big_kernel_negative_zero(cuda):
    """Windows are left folds from +0, so an all -0.0 node sums to +0.0,
    as in the plain version."""
    q, n_c = 1000, 2
    x = torch.full((n_c * q * 128,), -0.0, device=cuda)
    got = co.class_reduce_big(x, 64 * q)
    torch.cuda.synchronize()
    assert _bits_equal(got, co.class_reduce_big_plain(x, 64 * q))


# q 1 (every store of a thread lands on another node), 3 (not a power of
# two), 8 (power_law 1M's c = 512 hub class at its cap of 1,024 nodes and
# at its 776 real ones), 1,024 and 2,048 (c = 131,072 at cap 8), a single
# node, and q 4,096 over 10 nodes: more float4 than one step of a full
# wave covers, so the grid walks on
@pytest.mark.parametrize("q,n_c", [(2, 300), (16, 40), (2048, 2), (1, 200),
                                   (1, 1), (3, 50), (8, 1024), (8, 776),
                                   (8, 1), (1024, 3), (2048, 8), (2048, 1),
                                   (4096, 10)])
def test_expand_big_kernel(cuda, q, n_c):
    p = torch.from_numpy(_mixed(np.random.default_rng(q + n_c),
                                2 * n_c)).to(cuda)
    before = co.LAUNCHES["class_expand_big"]
    got = co.class_expand_big(p, 64 * q)
    torch.cuda.synchronize()
    assert co.LAUNCHES["class_expand_big"] == before + 1
    assert _bits_equal(got, co.class_expand_big_plain(p, 64 * q))


@pytest.mark.parametrize("graph", [("imp3D", 20_000, {"seed": 1}),
                                   ("power_law", 20_000, {"seed": 2, "m": 3}),
                                   ("full", 5_000, {})])
def test_gossip_card_equals_cpu(cuda, graph):
    """16 gossip rounds on the card and on the CPU, bitwise (integer
    state, counter-based draws): dense (with the inverted branch once
    every node spreads), CSR and implicit-full."""
    from gossipprotocol_tpu_torch.engine import RunConfig, run_simulation
    from gossipprotocol_tpu_torch.topology import build_topology

    name, n, kw = graph
    topo = build_topology(name, n, **kw)
    res = [run_simulation(topo, RunConfig(algorithm="gossip", device=d,
                                          max_rounds=16, chunk_rounds=4))
           for d in ("cuda", "cpu")]
    assert res[0].rounds == res[1].rounds
    for a, b in zip(res[0].final_state, res[1].final_state):
        assert torch.equal(a, b)


def test_pushsum_scatter_card_close_to_cpu(cuda):
    """Fanout-one push-sum on the card against the CPU: the same draws,
    the float sums in atomic order, so equal to a few ulps."""
    from gossipprotocol_tpu_torch.engine import RunConfig, run_simulation
    from gossipprotocol_tpu_torch.topology import build_topology

    topo = build_topology("erdos_renyi", 20_000, seed=5)
    res = [run_simulation(topo, RunConfig(algorithm="push-sum", device=d,
                                          max_rounds=16, chunk_rounds=8))
           for d in ("cuda", "cpu")]
    a, b = res[0].final_state, res[1].final_state
    assert torch.equal(a.alive, b.alive)
    assert torch.allclose(a.s, b.s, rtol=1e-5, atol=1e-9)
    assert torch.allclose(a.w, b.w, rtol=1e-5, atol=1e-9)


def test_gossip_inverted_card_equals_cpu(cuda):
    """From a saturated state (every node has heard) the CPU run takes
    the gather-inverted branch from its first chunk and the card's the
    scatter: 16 rounds, bitwise equal. On the card the inverted
    histogram equals the scatter's on that state."""
    from gossipprotocol_tpu_torch.engine import RunConfig, run_simulation
    from gossipprotocol_tpu_torch.protocols.gossip import (
        hits_by_inversion, inverted_dense,
    )
    from gossipprotocol_tpu_torch.protocols.sampling import (
        fold_in, key_data, sample_neighbors,
    )
    from gossipprotocol_tpu_torch.protocols.state import gossip_init
    from gossipprotocol_tpu_torch.topology import build_topology

    topo = build_topology("imp3D", 20_000, seed=1)
    start = gossip_init(topo.num_nodes, 0, device="cpu")
    start = start._replace(counts=torch.ones_like(start.counts))
    res = [run_simulation(topo, RunConfig(algorithm="gossip", device=d,
                                          max_rounds=16, chunk_rounds=4),
                          initial_state=start)
           for d in ("cuda", "cpu")]
    assert res[0].rounds == res[1].rounds
    for a, b in zip(res[0].final_state, res[1].final_state):
        assert torch.equal(a, b)
    nbrs = inverted_dense(topo, device="cuda")
    n = topo.num_nodes
    for r in range(4):
        key = fold_in(key_data(3, "cuda"), r)
        targets, valid = sample_neighbors(nbrs, n, key)
        scatter = torch.zeros(n, dtype=torch.int32, device="cuda")
        scatter.index_add_(0, targets, valid.to(torch.int32))
        assert torch.equal(hits_by_inversion(nbrs, key), scatter)


# ---- the measurement probes' kernels (ops/probes.py, csrc/probes.cu) ----

def _randn(cuda, *shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(cuda)


@pytest.mark.parametrize("bucket_major", [True, False])
@pytest.mark.parametrize("tiles,buckets,cr", [(1, 102, 1), (37, 102, 1),
                                              (512, 102, 1), (9, 16, 8),
                                              (3, 1, 128)])
def test_probe_slab_kernel(cuda, tiles, buckets, cr, bucket_major):
    from gossipprotocol_tpu_torch.ops import probes as pr

    x = _randn(cuda, tiles, 128, 128, seed=tiles)
    before = pr.LAUNCHES["probe_slab"]
    got = pr.probe_slab(x, buckets, cr, bucket_major)
    torch.cuda.synchronize()
    assert pr.LAUNCHES["probe_slab"] == before + 1
    assert _bits_equal(got, pr.probe_slab_plain(x, buckets, cr,
                                                bucket_major))


# every row 15 size (2-16 MB, L2-resident: one wave grid-stride), row 19
# (64 MiB, streamed: one block per 256 float4) and one row past it, and the
# edges: 1 row, a tile that does not divide the rows
@pytest.mark.parametrize("rows,tile_rows", [
    (4096, None), (8192, None), (16384, None), (24576, None), (32768, None),
    (131072, 1024), (131073, 1024), (3000, 1024), (7, 2), (7, 3), (1, None),
    (1, 1)])
def test_probe_scale2_kernel(cuda, rows, tile_rows):
    from gossipprotocol_tpu_torch.ops import probes as pr

    x = _randn(cuda, rows, 128, seed=rows)
    x[0, :4] = torch.tensor([-0.0, float("inf"), 3e38, 1e-40])
    before = pr.LAUNCHES["probe_scale2"]
    got = pr.probe_scale2(x, tile_rows)
    torch.cuda.synchronize()
    assert pr.LAUNCHES["probe_scale2"] == before + 1
    assert _bits_equal(got, pr.probe_scale2_plain(x))


# row 16's sizes (8-4,096 rows) and the edges: 1 row, row counts that do
# not divide into the 16 chunks, more rows than the default probe's
@pytest.mark.parametrize("rows", [1, 7, 8, 100, 256, 1000, 1024, 4096,
                                  5000, 20000])
def test_probe_gather_rows_kernel(cuda, rows):
    from gossipprotocol_tpu_torch.ops import probes as pr

    x = _randn(cuda, rows, 128, seed=rows)
    idx = torch.from_numpy(np.random.default_rng(rows + 1).integers(
        0, rows, (rows, 128)).astype(np.int32)).to(cuda)
    before = pr.LAUNCHES["probe_gather_rows"]
    got = pr.probe_gather_rows(x, idx)
    torch.cuda.synchronize()
    assert pr.LAUNCHES["probe_gather_rows"] == before + 1
    assert _bits_equal(got, pr.probe_gather_rows_plain(x, idx))


# row 17's [128, 128 / 512 / 4,096] and row 18's [15, 4096, 128], and every
# branch of gather_lanes_geometry: rows of at most 128 lanes read in place
# (4 and 128 lanes) and longer ones staged (132 lanes and up), lanes that
# are not powers of two (4, 132, 4,100), 1 and 7 rows, row counts that
# leave the last block's group of rows short (1 and 1,001 rows of 128
# lanes in groups of 4; 7 rows of 132 in groups of 3), and rows longer
# than a block's shared memory holds (60,000 lanes, 240,000 bytes: read
# in place, one a block)
@pytest.mark.parametrize("shape", [(128, 128), (128, 512), (128, 4096),
                                   (15, 4096, 128), (2, 3, 4), (1, 4),
                                   (7, 4), (7, 132), (1, 4100), (7, 4100),
                                   (1, 128), (1001, 128), (2, 60000)])
def test_probe_gather_lanes_kernel(cuda, shape):
    from gossipprotocol_tpu_torch.ops import probes as pr

    x = _randn(cuda, *shape, seed=sum(shape))
    rng = np.random.default_rng(1)
    idx = torch.from_numpy(rng.integers(0, shape[-1], shape).astype(
        np.int32)).to(cuda)
    idx.view(-1, shape[-1])[0, :2] = torch.tensor([0, shape[-1] - 1])
    cols = shape[-1]
    _, _, staged = pr.gather_lanes_geometry(
        x.numel() // cols, cols, pr._card(x.device.index)[0],
        pr._smem_optin(x.device.index))
    assert staged == (128 < cols != 60000)
    before = pr.LAUNCHES["probe_gather_lanes"]
    got = pr.probe_gather_lanes(x, idx)
    torch.cuda.synchronize()
    assert pr.LAUNCHES["probe_gather_lanes"] == before + 1
    assert _bits_equal(got, pr.probe_gather_lanes_plain(x, idx))


def test_lane_gather_and_expand_big_in_a_graph(cuda):
    """Both kernels captured in a CUDA graph (after an eager warm-up on
    the capture stream, as the probes time them): the replays give the
    plain versions' bits, one launch each at capture."""
    from gossipprotocol_tpu_torch.ops import probes as pr

    x = _randn(cuda, 128, 4096, seed=3)
    idx = torch.from_numpy(np.random.default_rng(4).integers(
        0, 4096, (128, 4096)).astype(np.int32)).to(cuda)
    p = torch.from_numpy(_mixed(np.random.default_rng(5), 2 * 1024)).to(cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        pr.probe_gather_lanes(x, idx)
        co.class_expand_big(p, 512)
    side.synchronize()
    before = (pr.LAUNCHES["probe_gather_lanes"],
              co.LAUNCHES["class_expand_big"])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        lanes = pr.probe_gather_lanes(x, idx)
        hubs = co.class_expand_big(p, 512)
    assert (pr.LAUNCHES["probe_gather_lanes"],
            co.LAUNCHES["class_expand_big"]) == (before[0] + 1,
                                                 before[1] + 1)
    for _ in range(2):
        lanes.zero_()
        hubs.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert _bits_equal(lanes, pr.probe_gather_lanes_plain(x, idx))
        assert _bits_equal(hubs, co.class_expand_big_plain(p, 512))


# 200 and 488 tiles: more blocks than the card holds at once (two an SM,
# 264 on an H100 SXM), and not a multiple of it
@pytest.mark.parametrize("tiles", [1, 7, 200, 488])
def test_probe_tile_perm_kernel(cuda, tiles):
    """Arbitrary int8 planes (any index planes compose), a different set
    per tile, with index 127 held in every plane."""
    from gossipprotocol_tpu_torch.ops import probes as pr

    rng = np.random.default_rng(tiles)
    x = _randn(cuda, tiles, 128, 128, seed=tiles)
    planes = []
    for _ in range(3):
        p = rng.integers(0, 128, (tiles, 128, 128)).astype(np.int8)
        p[:, 0, :] = 127
        p[:, :, 0] = 127
        planes.append(torch.from_numpy(p).to(cuda))
    got = pr.probe_tile_perm(x, *planes)
    torch.cuda.synchronize()
    assert _bits_equal(got, pr.probe_tile_perm_plain(x, *planes))


def test_probe_tile_perm_kernel_routed(cuda):
    """The probe's input: one routed permutation broadcast over 488 tiles
    (the JAX probe's default), exact against the flattened permutation,
    bitwise against the plain version, one launch; two calls in a row."""
    from gossipprotocol_tpu_torch.ops import probes as pr
    from gossipprotocol_tpu_torch.probes.tile_perm_probe import (
        route_tile_perm_cached, tile_planes,
    )

    perm = np.random.default_rng(0).permutation(128 * 128)
    planes, _ = route_tile_perm_cached(perm)
    x = _randn(cuda, 488, 128, 128, seed=5)
    i1, i2, i3 = tile_planes(planes, 488, cuda)
    want = x.view(488, -1)[:, torch.from_numpy(perm).to(cuda)].view(
        488, 128, 128)
    for _ in range(2):
        before = pr.LAUNCHES["probe_tile_perm"]
        got = pr.probe_tile_perm(x, i1, i2, i3)
        torch.cuda.synchronize()
        assert pr.LAUNCHES["probe_tile_perm"] == before + 1
        assert torch.equal(got, want)
        assert _bits_equal(got, pr.probe_tile_perm_plain(x, i1, i2, i3))


# ---- the reference semantics: card against CPU ---------------------------

@pytest.mark.parametrize("graph", [("full", 300), ("line", 60),
                                   ("imp3D", 200), ("power_law", 300)])
def test_reference_walk_card_equals_cpu(cuda, graph):
    """The single-token walk: hop count and state bitwise (each hop is
    one scalar add, halve and divide; no atomics)."""
    from gossipprotocol_tpu_torch.engine import RunConfig, run_simulation
    from gossipprotocol_tpu_torch.topology import build_topology

    topo = build_topology(*graph, seed=1)
    res = [run_simulation(topo, RunConfig(
        algorithm="push-sum", semantics="reference", seed=2, device=d))
        for d in ("cuda", "cpu")]
    assert res[0].converged and res[0].rounds == res[1].rounds
    for a, b in zip(res[0].final_state, res[1].final_state):
        assert a.dtype == b.dtype
        assert (_bits_equal(a, b) if a.dtype == torch.float32
                else torch.equal(a, b))


@pytest.mark.parametrize("argv", [["300", "full"], ["100", "line"],
                                  ["300", "3D"], ["300", "imp3D"]])
@pytest.mark.parametrize("algo", ["gossip", "push-sum"])
def test_reference_cli_card_equals_cpu(cuda, argv, algo, capsys):
    from gossipprotocol_tpu_torch.cli import main

    out = []
    for d in ("cuda", "cpu"):
        assert main(argv + [algo, "--semantics", "reference",
                            "--device", d]) == 0
        text = capsys.readouterr().out
        out.append([ln for ln in text.splitlines()
                    if not ln.startswith(("Convergence Time", "rounds"))]
                   + [ln.split("compile")[0] for ln in text.splitlines()
                      if ln.startswith("rounds")])
    assert out[0] == out[1]


# ---- the reference walk's chunk kernel (csrc/walk.cu) ----------------------

def _walk_graph(name):
    from gossipprotocol_tpu_torch.topology import build_topology
    from gossipprotocol_tpu_torch.topology import builders as tb

    return {
        "imp3D": lambda: build_topology("imp3D", 343, seed=1),
        "power_law": lambda: build_topology("power_law", 2000, seed=2),
        "full": lambda: build_topology("full", 300),
        "full301": lambda: build_topology("full", 301),
        "line": lambda: build_topology("line", 40),
        "quirk": lambda: tb.add_isolated_rows(
            tb.build_imp3d_reference_quirks(1000, seed=0)),
        "line+isolated": lambda: tb.add_isolated_rows(
            build_topology("line", 20)),
    }[name]()


# (graph, layout, hops, seed, start, quorum or None)
_WALK_CASES = {
    "dense converges": ("imp3D", "dense", 8000, 3, 0, None),
    "csr converges": ("imp3D", "csr", 8000, 3, 0, None),
    "csr power_law": ("power_law", "csr", 6000, 5, 0, None),
    "full converges": ("full", "full", 5000, 4, 0, None),
    "dense quorum": ("line", "dense", 9000, 5, 0, 39),
    "full quorum": ("full301", "full", 5000, 1, 0, 300),
    "quirk graph": ("quirk", "dense", 9000, 2, 0, None),
    "trapped dense": ("line+isolated", "dense", 3000, 2, 20, None),
    "trapped csr": ("line+isolated", "csr", 300, 2, 20, None),
}


@pytest.mark.parametrize("case", list(_WALK_CASES))
def test_walk_kernel(cuda, case):
    """One launch of the walk kernel against the plain chunk on the card,
    bitwise in every field (the node arrays, round, cur, the message) and
    in the settled count: chunks that converge, stop at a quorum and start
    trapped, on the dense, CSR and complete-graph layouts."""
    from gossipprotocol_tpu_torch.ops import walk as ow
    from gossipprotocol_tpu_torch.protocols import sampling as ts
    from gossipprotocol_tpu_torch.protocols import walk as tw

    graph, layout, hops, seed, start, quorum = _WALK_CASES[case]
    topo = _walk_graph(graph)
    n = topo.num_nodes
    q = n if quorum is None else quorum
    nbrs = (None if layout == "full" else
            ts.device_topology(topo, dense=(layout == "dense"), device=cuda))
    key = ts.key_data(seed, cuda)
    st = tw.pushsum_walk_init(n, start, device=cuda)
    want = tw.walk_chunk_plain(tw.WalkDraws(nbrs, n, cuda), st, key, hops, q,
                               3)
    got = type(st)(*(t.clone() for t in st))
    before = ow.LAUNCHES["walk_chunk"]
    settled = ow.walk_chunk(ow.walk_layout(nbrs, n), got, key, hops, q, 3)
    torch.cuda.synchronize()
    assert ow.LAUNCHES["walk_chunk"] == before + 1
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert (_bits_equal(a.reshape(-1), b.reshape(-1))
                if a.dtype == torch.float32 else torch.equal(a, b)), f
    assert int(settled) == int(torch.sum(want.converged | ~want.alive))
    if graph == "line+isolated":
        assert int(got.round) == hops and int(got.cur) == start


def test_walk_kernel_chunks_in_a_row(cuda):
    """Chunks of 100 hops, launch after launch on the state the kernel
    updates in place, end where the CPU's plain chunks end; the engine's
    runner launches the kernel once a chunk."""
    from gossipprotocol_tpu_torch.engine import RunConfig, run_simulation
    from gossipprotocol_tpu_torch.ops import walk as ow

    topo = _walk_graph("imp3D")
    cfg = dict(algorithm="push-sum", semantics="reference", seed=4)
    before = ow.LAUNCHES["walk_chunk"]
    card = run_simulation(topo, RunConfig(**cfg, device="cuda",
                                          chunk_rounds=100))
    launches = ow.LAUNCHES["walk_chunk"] - before
    cpu = run_simulation(topo, RunConfig(**cfg, device="cpu"))
    assert card.converged and card.rounds == cpu.rounds
    for a, b in zip(card.final_state, cpu.final_state):
        assert (_bits_equal(a.reshape(-1), b.reshape(-1))
                if a.dtype == torch.float32 else torch.equal(a, b))
    # the warm-up chunk and one launch per chunk of the run
    assert launches == 1 + -(-card.rounds // 100)


@pytest.mark.parametrize("dim", [None, 8])
def test_gala_group_sum_on_card_same_bits_every_run(cuda, dim):
    """GALA's group sum on the card (``learn/gala.py``
    ``contiguous_group_sum``, a reduction over each group's rows, not
    ``index_add_``'s atomics): the same bits on every call, and within
    relative 1e-6 of the float64 sum on the CPU."""
    from gossipprotocol_tpu_torch.learn.gala import contiguous_group_sum

    rows, groups = 4 * 8192, 4
    shape = (rows,) if dim is None else (rows, dim)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 1.5, shape).astype(np.float32))
    ids = torch.arange(rows) // (rows // groups)
    exact = torch.zeros((groups,) + shape[1:], dtype=torch.float64) \
        .index_add_(0, ids, x.double())
    runs = [contiguous_group_sum(x.to(cuda), groups, rows // groups)
            for _ in range(3)]
    assert all(_bits_equal(r, runs[0]) for r in runs)
    err = (runs[0].cpu().double() - exact).abs() / exact.abs()
    assert float(err.max()) <= 1e-6


@pytest.mark.parametrize("graph", [("imp3D", 4096), ("power_law", 4096)])
def test_gossip_seed_sweep_lanes_equal_standalone_card_runs(cuda, graph):
    """A gossip seed sweep on the card: every lane's rounds and final
    state bitwise its standalone card run (the hits are integer adds)."""
    import dataclasses

    from gossipprotocol_tpu_torch.engine.driver import (
        RunConfig, run_simulation,
    )
    from gossipprotocol_tpu_torch.sweep import SweepSpec
    from gossipprotocol_tpu_torch.topology import build_topology

    topo = build_topology(graph[0], graph[1], seed=0)
    cfg = RunConfig(algorithm="gossip", device="cuda", max_rounds=3000)
    spec = SweepSpec.from_seeds(4, base_seed=3)
    res = run_simulation(topo, dataclasses.replace(cfg, sweep=spec))
    assert res.lanes == 4
    for i in range(4):
        solo = run_simulation(topo, spec.lane_config(cfg, i))
        assert res.lane_records[i]["rounds"] == solo.rounds
        lane = res.lane_state(i)
        for f in lane._fields:
            assert torch.equal(getattr(lane, f),
                               getattr(solo.final_state, f)), (i, f)


def test_capacity_prediction_not_below_card_peak(cuda):
    """A small run's predicted total is at or above the card's measured
    peak (the allocator's high-water mark over the build and the run,
    less what was held before)."""
    from gossipprotocol_tpu_torch.engine.driver import (
        RunConfig, run_simulation,
    )
    from gossipprotocol_tpu_torch.obs.capacity import estimate_for_topology
    from gossipprotocol_tpu_torch.topology import build_topology

    topo = build_topology("imp3D", 32768, seed=0)
    for cfg in (RunConfig(algorithm="push-sum", device="cuda",
                          max_rounds=48),
                RunConfig(algorithm="push-sum", fanout="all",
                          delivery="pallas", device="cuda", max_rounds=48,
                          plan_cache="none")):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run_simulation(topo, cfg)
        peak = torch.cuda.max_memory_allocated() - base
        predicted = estimate_for_topology(
            topo, cfg, 1)["per_device"]["total_bytes"]
        assert predicted >= peak, (cfg.delivery, predicted, peak)


def test_capacity_megakernel_fields_ask_the_launcher(cuda):
    """The planner's shared-memory field on the card is the launcher's own
    choice: the state stays in shared memory at imp3D 4096, and a grid
    of one block cannot hold a million nodes' state there."""
    from gossipprotocol_tpu_torch.engine.driver import RunConfig
    from gossipprotocol_tpu_torch.obs.capacity import estimate_for_topology
    from gossipprotocol_tpu_torch.ops import megakernel as mkm
    from gossipprotocol_tpu_torch.topology import build_topology

    topo = build_topology("imp3D", 4096, seed=0)
    doc = estimate_for_topology(
        topo, RunConfig(algorithm="push-sum", fanout="all",
                        delivery="megakernel", device="cuda"), 1)
    assert doc["per_device"]["megakernel_state_in_shared_memory"] is True
    assert mkm.state_in_shared_memory(4096, 4096, cuda)
    import ctypes

    lib = mkm.build.library("megakernel")
    out = ctypes.c_int(7)
    with torch.cuda.device(cuda):
        rc = lib.gossip_megakernel_state_in_smem(10**6, 1,
                                                 ctypes.addressof(out))
    assert rc == 0 and out.value == 0
