"""PyTorch port, the host side of the CUDA launchers that runs on any
machine: the ctypes signatures of the exported launchers, the argument
checks the wrappers make before a launch, and the spread folds' scratch
cache. The kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``)."""

from __future__ import annotations

import ctypes
import re

import numpy as np
import pytest
import torch

from gossipprotocol_tpu_torch.ops import build
from gossipprotocol_tpu_torch.ops import classops as co
from gossipprotocol_tpu_torch.ops import exec as ex

_EXPORT = re.compile(r"GOSSIP_EXPORT\s+(?:const\s+)?\w+\*?\s+(gossip_\w+)"
                     r"\s*\(([^)]*)\)")
_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


def _prototypes(lib):
    """{name: parameter list} of every launcher ``csrc/<lib>.cu`` exports
    (the error-string helper aside)."""
    text = (build.CSRC / f"{lib}.cu").read_text()
    return {name: [p.strip() for p in params.split(",")]
            for name, params in _EXPORT.findall(text)
            if name != "gossip_cuda_error_string"}


def _ctype(param):
    """The ctypes type a C parameter is passed as: a pointer (the stream
    too) as void*, an array of pointers as void**, a scalar as itself."""
    stars = param.count("*")
    if stars >= 2:
        return build._PTRS
    if stars == 1:
        return ctypes.c_void_p
    ctype = " ".join(param.split()[:-1])  # drop the parameter's name
    return _SCALARS[ctype.replace("const ", "")]


_ALL = [(lib, fn) for lib in build.SOURCES for fn in build._SIGNATURES[lib]]


@pytest.mark.parametrize("lib", build.SOURCES)
def test_every_exported_launcher_has_a_signature(lib):
    assert set(_prototypes(lib)) == set(build._SIGNATURES[lib])


@pytest.mark.parametrize("lib,fn", _ALL)
def test_launcher_signature_matches_the_c_prototype(lib, fn):
    """Arity and the pointer / long long / int / float kind of every
    argument, read from the source the library is built from."""
    params = _prototypes(lib)[fn]
    assert tuple(_ctype(p) for p in params) == build._SIGNATURES[lib][fn], \
        params


def _meta_final(nt_out, k, unit):
    iw = 64 if unit == 2 else 128
    fin = ex.DeviceFinal(
        k, torch.empty((nt_out, k, 3, iw, 128), dtype=torch.int8,
                       device="meta"),
        torch.empty((nt_out, k, 16, 128), dtype=torch.uint8, device="meta"))
    cur = torch.empty((nt_out * k, 128, 128), device="meta")
    return fin, cur


@pytest.mark.parametrize("k,unit", [(0, 2), (0, 1), (2, 3), (1, 0)])
def test_final_call_rejects_geometry_before_launch(k, unit):
    """k < 1 or a unit other than 1 and 2 is refused before any device
    check (the launcher would refuse it too)."""
    fin, cur = _meta_final(4, k, unit)
    before = dict(ex.LAUNCHES)
    with pytest.raises(ValueError, match="unit 1 or 2"):
        ex.final_call(fin, 4, cur, unit)
    assert ex.LAUNCHES == before


def test_final_call_off_the_card_raises():
    fin, cur = _meta_final(4, 2, 2)
    with pytest.raises(ValueError, match="no kernel"):
        ex.final_call(fin, 4, cur, 2)


@pytest.mark.parametrize("c", [64 * 1500, 64 * 3000])
def test_reduce_big_rejects_partial_row_blocks(c):
    """q > 1,024 rows per node must be whole 1,024-row blocks, on every
    device (the launcher refuses it as well)."""
    q = 2 * c // 128
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="1024-row blocks"):
            co.class_reduce_big(torch.zeros(q * 128, device=dev), c)


def test_fold_scratch_keyed_per_device_stream_and_shape():
    """One scratch per (device, stream, nodes, q), made once with zeroed
    counters; the split and node-major folds share it."""
    keys = [("cpu", 11, 8, 2048), ("cpu", 12, 8, 2048),
            ("cpu", 11, 4, 2048), ("cpu", 11, 8, 1024)]
    try:
        first = [co._fold_scratch(*k) for k in keys]
        for (dev, stream, nodes, q), (part, arrived) in zip(keys, first):
            assert part.shape == (2 * nodes * q,)
            assert part.dtype == torch.float32
            assert arrived.shape == (nodes,) and arrived.dtype == torch.int32
            assert not bool(arrived.any())
        again = co._fold_scratch(torch.device("cpu"), 11, 8, 2048)
        assert again[0] is first[0][0] and again[1] is first[0][1]
        ids = {id(p) for p, _ in first}
        assert len(ids) == len(keys)
    finally:
        for dev, stream, nodes, q in keys:
            co._FOLD_SCRATCH.pop((torch.device(dev), stream, nodes, q), None)


def test_reduce_big_cpu_path_takes_no_scratch():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        2 * 40 * 128).astype(np.float32))
    before = dict(co._FOLD_SCRATCH)
    co.class_reduce_big(x, 64 * 40)
    assert co._FOLD_SCRATCH == before


def test_fold_scratch_is_not_made_inside_a_capture(monkeypatch):
    """Inside a CUDA-graph capture a missing scratch raises (its zeroed
    counters would exist only at replay); one made before is handed out."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    made = (torch.zeros(2 * 3 * 40), torch.zeros(3, dtype=torch.int32))
    monkeypatch.setitem(co._FOLD_SCRATCH,
                        (torch.device("cuda", 0), 21, 3, 40), made)
    before = dict(co._FOLD_SCRATCH)
    with pytest.raises(RuntimeError, match="capture"):
        co._fold_scratch(torch.device("cuda", 0), 22, 3, 40)
    assert co._FOLD_SCRATCH == before
    assert co._fold_scratch(torch.device("cuda", 0), 21, 3, 40) is made
    # the CPU path never asks (no capture exists there)
    part, _ = co._fold_scratch(torch.device("cpu"), 22, 3, 40)
    co._FOLD_SCRATCH.pop((torch.device("cpu"), 22, 3, 40))
    assert part.shape == (2 * 3 * 40,)
