"""PyTorch port, checkpoints of the workload states and the workload
CLI: an SGP and an accelerated checkpoint hold the JAX package's array
names, dtypes and trajectory metadata for the same run (``loss``,
``s_prev``, ``w_prev``, ``omega`` included); a run resumed from one in
the middle ends bitwise where the uninterrupted run ends; a resume under
another ``--payload-dim``, ``--lr``, ``--clock`` or ``--groups`` exits 2;
every rejected workload combination exits 2 with the JAX CLI's message,
and with ``--devices`` the workload flags exit 2 naming themselves."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gossipprotocol_tpu as jx
from gossipprotocol_tpu import cli as jcli
from gossipprotocol_tpu.utils import checkpoint as jck

import gossipprotocol_tpu_torch as tx
from gossipprotocol_tpu_torch import cli as tcli
from gossipprotocol_tpu_torch.engine import resume_simulation
from gossipprotocol_tpu_torch.utils import checkpoint as tck


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


def _bitwise(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape
               and x.numpy().tobytes() == y.numpy().tobytes()
               for x, y in zip(a, b))


_SGP = dict(algorithm="push-sum", fanout="all", workload="sgp",
            payload_dim=4, predicate="global", tol=1e-3, seed=3, lr=0.08,
            clock="poisson", activation_rate=2.0)
_ACCEL = dict(algorithm="push-sum", fanout="all", accel="chebyshev",
              accel_lambda=0.99, eps=1e-7, payload_dim=2)
_CASES = {"sgp": ("imp3D", 64, _SGP, "SGPState"),
          "accel": ("line", 48, _ACCEL, "AccelState")}


@pytest.mark.parametrize("case", list(_CASES))
def test_checkpoint_files_match_jax(tmp_path, case):
    """The first 12 rounds saved by both engines every 4-round chunk:
    the same file names, array names, dtypes and shapes, the same
    metadata; the accelerated states' bytes equal (the SGP learner is
    held to its tolerance: 1e-5)."""
    name, n, kw, state_type = _CASES[case]
    base = dict(kw, max_rounds=12, chunk_rounds=4, checkpoint_every=1)
    rt = tx.run_simulation(tx.build_topology(name, n), tx.RunConfig(
        device="cpu", checkpoint_dir=str(tmp_path / "t"), **base))
    rj = jx.run_simulation(jx.build_topology(name, n), jx.RunConfig(
        checkpoint_dir=str(tmp_path / "j"), **base))
    names = [os.path.basename(p) for p in rt.checkpoints]
    assert names == [os.path.basename(p) for p in rj.checkpoints]
    assert len(names) == 3
    for pt, pj in zip(rt.checkpoints, rj.checkpoints):
        with np.load(pt) as zt, np.load(pj) as zj:
            assert sorted(zt.files) == sorted(zj.files)
            for f in zt.files:
                if f == "__meta__":
                    continue
                a, b = zt[f], zj[f]
                assert (a.dtype, a.shape) == (b.dtype, b.shape), f
                if case == "accel" or f not in ("s", "ratio", "loss"):
                    assert a.tobytes() == b.tobytes(), f
                else:
                    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
            mt = json.loads(str(zt["__meta__"]))
            mj = json.loads(str(zj["__meta__"]))
        assert mt.pop(tck.PACKAGE_KEY) == tck.PACKAGE_TAG
        mt.pop("saved_at"), mj.pop("saved_at")
        assert mt == mj and mt["state_type"] == state_type


def test_trajectory_meta_matches_jax():
    for kw in (_SGP, _ACCEL, dict(algorithm="push-sum", fanout="all",
                                  workload="gala", groups=4,
                                  predicate="global")):
        assert tck.trajectory_meta(tx.RunConfig(**kw)) == \
            jck.trajectory_meta(jx.RunConfig(**kw))
    assert tck.trajectory_meta(tx.RunConfig(
        algorithm="push-sum", dtype="float64")) == jck.trajectory_meta(
        jx.RunConfig(algorithm="push-sum", dtype=jnp.float64))


@pytest.mark.parametrize("case", list(_CASES))
def test_resume_bitwise(tmp_path, case):
    name, n, kw, _ = _CASES[case]
    topo = tx.build_topology(name, n)
    cfg = tx.RunConfig(device="cpu", chunk_rounds=4, checkpoint_every=1,
                       checkpoint_dir=str(tmp_path), max_rounds=2000, **kw)
    full = tx.run_simulation(topo, cfg)
    assert full.converged and len(full.checkpoints) >= 3
    mid = full.checkpoints[len(full.checkpoints) // 2]
    st, _meta = tck.load(mid)
    resumed = resume_simulation(topo, cfg, st)
    assert resumed.rounds == full.rounds
    assert _bitwise(resumed.final_state, full.final_state)


_CKPT_ARGV = ["64", "imp3D", "push-sum", "--fanout", "all", "--workload",
              "sgp", "--payload-dim", "4", "--predicate", "global", "--tol",
              "1e-3", "--chunk-rounds", "4", "--max-rounds", "8",
              "--device", "cpu"]


@pytest.mark.parametrize("change,field", [
    (["--payload-dim", "5"], "payload_dim"),
    (["--lr", "0.01"], "lr"),
    (["--clock", "poisson"], "clock"),
    (["--workload", "gala", "--groups", "4"], "workload"),
])
def test_resume_mismatch_exit_2(tmp_path, change, field, capsys):
    ck = str(tmp_path / "ck")
    rc = tcli.main(_CKPT_ARGV + ["--checkpoint-dir", ck,
                                 "--checkpoint-every", "1"])
    assert rc in (0, 1)
    argv = list(_CKPT_ARGV)
    for i in range(0, len(change), 2):
        if change[i] in argv:
            argv[argv.index(change[i]) + 1] = change[i + 1]
        else:
            argv += change[i:i + 2]
    capsys.readouterr()
    assert tcli.main(argv + ["--resume", ck]) == 2
    err = capsys.readouterr().err
    assert err.startswith("checkpoint mismatch") and field in err


def _last_line(err: str) -> str:
    """The last stderr line, argparse's program name taken off."""
    lines = err.strip().splitlines()
    last = lines[-1] if lines else ""
    return last.split(": error: ", 1)[-1]


def _jax_rejects(argv, capsys):
    """The JAX CLI's exit code and last stderr line for ``argv``."""
    try:
        rc = jcli.main(argv)
    except SystemExit as e:  # argparse's usage errors
        rc = e.code
    finally:
        import jax

        jax.config.update("jax_enable_x64", False)
    return rc, _last_line(capsys.readouterr().err)


_REJECTED = [
    ["64", "imp3D", "push-sum", "--payload-dim", "3", "--delivery",
     "invert"],
    ["64", "imp3D", "gossip", "--payload-dim", "3"],
    ["64", "imp3D", "push-sum", "--workload", "sgp"],
    ["64", "imp3D", "push-sum", "--workload", "gala", "--groups", "2",
     "--predicate", "global", "--fanout", "all", "--delivery", "routed"],
    ["64", "imp3D", "push-sum", "--groups", "2"],
    ["64", "imp3D", "push-sum", "--fanout", "all", "--accel", "epd",
     "--clock", "poisson"],
    ["64", "imp3D", "push-sum", "--accel", "epd"],
    ["64", "imp3D", "push-sum", "--fanout", "all", "--delivery", "pallas",
     "--accel", "chebyshev"],
    ["64", "imp3D", "push-sum", "--fanout", "all", "--delivery", "routed",
     "--x64"],
    ["64", "imp3D", "push-sum", "--fanout", "all", "--delivery",
     "megakernel", "--workload", "sgp", "--predicate", "global"],
    ["64", "imp3D", "push-sum", "--fanout", "all", "--delivery", "pallas",
     "--edge-chunks", "2"],
    ["64", "imp3D", "push-sum", "--edge-chunks", "2"],
    ["64", "imp3D", "push-sum", "--accel-lambda", "1.5"],
    ["64", "imp3D", "push-sum", "--fanout", "all", "--accel", "epd",
     "--fail-fraction", "0.1", "--fail-round", "2"],
    ["64", "imp3D", "push-sum", "--fanout", "all", "--workload", "gala",
     "--groups", "3", "--predicate", "global"],
    ["100", "power_law", "push-sum", "--delivery", "invert"],
    ["64", "imp3D", "push-sum", "--delivery", "invert", "--fail-fraction",
     "0.1", "--fail-round", "2"],
    ["64", "imp3D", "push-sum", "--delivery", "invert", "--clock",
     "poisson"],
    ["64", "imp3D", "gossip", "--clock", "poisson", "--semantics",
     "reference"],
]


@pytest.mark.parametrize("argv", _REJECTED,
                         ids=[str(i) for i in range(len(_REJECTED))])
def test_rejections_exit_2_with_jax_message(argv, capsys):
    rc_j, err_j = _jax_rejects(argv + ["--quiet"], capsys)
    assert rc_j == 2
    assert tcli.main(argv + ["--device", "cpu"]) == 2
    assert _last_line(capsys.readouterr().err) == err_j


@pytest.mark.parametrize("flags,name", [
    (["--payload-dim", "2"], "--payload-dim"),
    (["--workload", "sgp", "--predicate", "global"], "--workload"),
    (["--clock", "poisson"], "--clock"),
    (["--accel", "epd", "--delivery", "scatter"], "--accel"),
    (["--x64", "--delivery", "scatter"], "--x64"),
    (["--delivery", "scatter"], "--delivery scatter with --fanout all"),
])
def test_devices_refuse_workload_flags(flags, name, capsys):
    argv = ["64", "imp3D", "push-sum", "--fanout", "all", "--delivery",
            "pallas", "--devices", "2", "--device", "cpu"]
    rc = tcli.main(argv + flags)
    err = capsys.readouterr().err
    assert rc == 2
    assert err.startswith(f"option not yet ported with --devices: {name}")


def test_sharded_engine_refuses_workloads():
    from gossipprotocol_tpu_torch.engine.driver import NotPortedError
    from gossipprotocol_tpu_torch.parallel import run_simulation_sharded

    cfg = tx.RunConfig(device="cpu", algorithm="push-sum", fanout="all",
                       delivery="pallas", payload_dim=3, clock="poisson")
    with pytest.raises(NotPortedError, match="--payload-dim, --clock"):
        run_simulation_sharded(tx.build_topology("imp3D", 64), cfg,
                               num_devices=2)
