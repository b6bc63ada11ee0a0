"""PyTorch port, the reference's curve tools (``experiments.curves``,
``experiments.oracle_curves``) against the JAX package's on the CPU: the
same columns and round counts over the same grid, and the oracle's CSV
byte for byte."""

from __future__ import annotations

import csv

import pytest
import torch

from gossipprotocol_tpu.experiments import curves as jcurves
from gossipprotocol_tpu.experiments import oracle_curves as joracle

from gossipprotocol_tpu_torch.experiments import curves as tcurves
from gossipprotocol_tpu_torch.experiments import oracle_curves as toracle


@pytest.fixture(scope="module", autouse=True)
def _one_openmp_thread():
    """This module's OpenMP code (torch's CPU kernels) runs on one
    thread, restored afterwards: once a process has run a parallel region
    on several threads, GNU OpenMP waits forever in a child forked from
    it, and the JAX package's shard builds fork their workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


# the columns that do not depend on the clock
_EXACT = ("algorithm", "topology", "nodes_requested", "nodes_actual",
          "rounds", "converged", "global_rounds", "global_converged")


# Reference gossip on the full graph (keep-alive off, every node to
# converge) livelocks to the tool's 500,000-round cap in both packages: the
# last spreader never hears again. At a millisecond a round on the CPU
# that is minutes, so the reference gossip case leaves full out.
@pytest.mark.parametrize("extra", [
    [],
    ["--semantics", "reference", "--algorithms", "push-sum"],
    ["--semantics", "reference", "--algorithms", "gossip", "--topologies",
     "line,3D,imp3D"],
    ["--topologies", "imp3D", "--algorithms", "push-sum", "--nodes", "27",
     "--global-check", "--global-max-rounds", "5000"],
], ids=["intended", "reference-walk", "reference-gossip", "global-check"])
def test_curves_rounds_and_columns_equal_jax(extra, tmp_path):
    """The Report grid at 8 and 27 nodes (both algorithms, the four
    topologies): JAX's columns in JAX's order, and JAX's rounds."""
    argv = ["--nodes", "8,27", "--repeats", "1"] + extra
    jout, tout = tmp_path / "j.csv", tmp_path / "t.csv"
    assert jcurves.main(argv + ["--out", str(jout)]) == 0
    assert tcurves.main(argv + ["--device", "cpu", "--out", str(tout),
                                "--json-out", str(tmp_path / "t.json")]) == 0
    j, t = _rows(jout), _rows(tout)
    assert list(t[0]) == list(j[0])
    assert [[r[c] for c in _EXACT] for r in t] == \
        [[r[c] for c in _EXACT] for r in j]
    assert (tmp_path / "t.json").stat().st_size > 0


def test_oracle_curves_csv_byte_equal_jax(tmp_path, native_oracle):
    """The oracle tool at 100 and 250 nodes, three seeds, and at the
    calibration anchor (1,000 nodes, where the predicted and published
    columns fill): the CSV is JAX's byte for byte."""
    for argv in (["--nodes", "100,250", "--seeds", "3"],
                 ["--nodes", "1000", "--seeds", "2", "--topologies",
                  "full,imp3D,3D"]):
        jout, tout = tmp_path / "j.csv", tmp_path / "t.csv"
        assert joracle.main(argv + ["--out", str(jout)]) == 0
        assert toracle.main(argv + ["--out", str(tout)]) == 0
        assert tout.read_bytes() == jout.read_bytes()


def test_oracle_curves_keeps_the_published_anchors():
    assert toracle.PUBLISHED_MS_AT_1000 == joracle.PUBLISHED_MS_AT_1000
    assert toracle.PUBLISHED_LINE_GOSSIP_MS == \
        joracle.PUBLISHED_LINE_GOSSIP_MS
    assert toracle.CALIBRATION_ANCHOR == joracle.CALIBRATION_ANCHOR


def test_line_growth_fit_equals_jax(native_oracle):
    assert toracle.line_growth_fit(seeds=2) == \
        joracle.line_growth_fit(seeds=2)
