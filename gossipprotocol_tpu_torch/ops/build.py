"""Build and load the port's CUDA kernels (``gossipprotocol_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use, from the package's sources only, into
``gossipprotocol_tpu_torch/_build/<hash>/`` (listed in ``.gitignore``),
keyed on a hash of every source and the compiler flags — a changed
source builds anew, an unchanged one loads the existing library. All
sources compile in parallel, one ``nvcc`` process each. ``resolve_device``
is the one check of the device every entry point is asked for.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"

# one shared library per source; the launchers each library exports
SOURCES = ("classops", "exchange", "gather", "megakernel", "probes",
           "route", "walk")

# sm_90a (Hopper). No --use_fast_math: the folds and the walk must keep
# denormals and IEEE rounding (and division); --fmad=false forbids
# contraction, so the one fused multiply-add (the megakernel's s -
# share*deg) is the explicit __fmaf_rn.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_VOIDP = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
_F32 = ctypes.c_float
_PTRS = ctypes.POINTER(ctypes.c_void_p)

# argtypes of every exported launcher (pointers and the stream as void*,
# so ctypes never truncates them to 32 bits)
_SIGNATURES = {
    "classops": {
        "gossip_class_reduce_small": (_VOIDP, _VOIDP, _LL, _INT, _VOIDP),
        # x, out, part scratch, arrival counters, cap, q, stream
        "gossip_class_reduce_split": (_VOIDP, _VOIDP, _VOIDP, _VOIDP, _LL,
                                      _INT, _VOIDP),
        "gossip_class_expand_small": (_VOIDP, _VOIDP, _LL, _INT, _VOIDP),
        "gossip_class_expand_split": (_VOIDP, _VOIDP, _LL, _INT, _VOIDP),
        # x, out, part scratch, arrival counters, n_c, q, stream
        "gossip_class_reduce_big": (_VOIDP, _VOIDP, _VOIDP, _VOIDP, _LL,
                                    _INT, _VOIDP),
        # pairs, out, n_c, q, blocks, stream
        "gossip_class_expand_big": (_VOIDP, _VOIDP, _LL, _INT, _LL,
                                    _VOIDP),
    },
    "exchange": {
        # src pointers, dst pointers, shards, row bytes, schedule (0:
        # (s, d) order, 1: the ring's step order; one launch), stream
        "gossip_exchange": (_PTRS, _PTRS, _INT, _LL, _INT, _VOIDP),
    },
    "gather": {
        "gossip_gather_resident": (_VOIDP, _VOIDP, _VOIDP, _LL, _VOIDP),
        # x, rows, lidx, out, tiles, r_cap, evict-first hints on the
        # stream (0 or 1), stream
        "gossip_gather_bucket": (_VOIDP, _VOIDP, _VOIDP, _VOIDP, _LL, _INT,
                                 _INT, _VOIDP),
    },
    "megakernel": {
        "gossip_megakernel_max_grid": (_VOIDP,),
        # n, grid, out
        "gossip_megakernel_state_in_smem": (_LL, _INT, _VOIDP),
        # state (5), round, deg, pre_node, out_rank, xp2, yp2, part,
        # arrived, red, cnt, bar, work, probe stamps (null: the plain
        # kernel), classes, ncls, split_units, small_units, n, nu, k, eps,
        # tol, streak_target, global_pred, quorum, grid, stream
        "gossip_megakernel": (
            *(_VOIDP,) * 19, _INT, _LL, _LL, _LL, _LL, _INT, _F32, _F32,
            _INT, _INT, _LL, _INT, _VOIDP),
    },
    "probes": {
        # x, out, tiles, buckets, cr, bucket_major, stream
        "gossip_probe_slab": (_VOIDP, _VOIDP, _INT, _INT, _INT, _INT,
                              _VOIDP),
        # x, y, n, blocks, evict-first loads (0 or 1), stream
        "gossip_probe_scale2": (_VOIDP, _VOIDP, _LL, _LL, _INT, _VOIDP),
        # x, idx, out, rows, chunk_rows, stream
        "gossip_probe_gather_rows": (_VOIDP, _VOIDP, _VOIDP, _INT, _INT,
                                     _VOIDP),
        # x, idx, out, rows, cols, rows_per_block, threads, staged (0 or
        # 1), device, stream
        "gossip_probe_gather_lanes": (_VOIDP, _VOIDP, _VOIDP, _LL, _INT,
                                      _INT, _INT, _INT, _INT, _VOIDP),
        # x, idx1, idx2, idx3, out, tiles, stream
        "gossip_probe_tile_perm": (*(_VOIDP,) * 5, _LL, _VOIDP),
    },
    "route": {
        # x, idx, out, tiles, o, b, cr, tau_in, tau_slab, unit, stream
        "gossip_route_stage": (_VOIDP, _VOIDP, _VOIDP, _LL, _INT, _INT,
                               _INT, _INT, _INT, _INT, _VOIDP),
        # x, idx, mask, out, nt_out, k, unit, device, stream
        "gossip_route_final": (_VOIDP, _VOIDP, _VOIDP, _VOIDP, _LL, _INT,
                               _INT, _INT, _VOIDP),
    },
    "walk": {
        # s, w, ratio, streak, converged, degree, starts, flat, round,
        # cur, msg_s, msg_w, settled, key, n, flat_len, row_width,
        # layout, hops, quorum, streak_target, partitionable, stream
        "gossip_walk_chunk": (*(_VOIDP,) * 14, _LL, _LL, _INT, _INT, _LL,
                              _INT, _INT, _INT, _VOIDP),
        # next, steps, out, stream
        "gossip_pointer_chase": (_VOIDP, _LL, _VOIDP, _VOIDP),
    },
}


class KernelBuildError(RuntimeError):
    """nvcc refused a kernel source (the message carries its output)."""


class _Loaded:
    """The process's loaded kernel libraries and their ptxas reports."""

    def __init__(self):
        self.libs: Dict[str, ctypes.CDLL] = {}
        self.logs: Dict[str, str] = {}
        self.build_dir: Optional[Path] = None


_LOADED = _Loaded()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "no nvcc found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels compile at first use on a machine with the CUDA toolkit")


def source_hash() -> str:
    """Content key of the build: every csrc file plus the flags."""
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build_all() -> Dict[str, str]:
    """Compile every source that has no library under the current hash
    (all ``nvcc`` processes started together), load them all, and return
    ``{name: ptxas report}`` for the sources compiled by this call.
    Idempotent: a second call loads nothing new and returns ``{}``."""
    if _LOADED.libs:
        return {}
    out_dir = BUILD_ROOT / source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name in SOURCES:
        lib = out_dir / f"lib{name}.so"
        if lib.exists():
            continue
        # compile to a private name, then rename: concurrent builders
        # (several test workers on one card) never load a half-written file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        pending[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, lib)
    logs = {}
    failures = []
    for name, (proc, tmp, lib) in pending.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"--- {name}.cu (nvcc rc {proc.returncode})\n"
                            f"{text}")
            continue
        os.replace(tmp, lib)
        logs[name] = text
    if failures:
        raise KernelBuildError("\n".join(failures))
    for name in SOURCES:
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.gossip_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gossip_cuda_error_string.restype = ctypes.c_char_p
        _LOADED.libs[name] = lib
    _LOADED.logs.update(logs)
    _LOADED.build_dir = out_dir
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building everything on first use."""
    if name not in _LOADED.libs:
        build_all()
    return _LOADED.libs[name]


def check(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.gossip_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"error {rc} ({msg})")


def resolve_device(device):
    """``device`` as a torch device; raises when CUDA is asked for and no
    card is present (the port never carries on on the CPU instead). Every
    entry point that places tensors passes its ``device`` through here."""
    import torch

    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False — run on a machine with an NVIDIA GPU, or pass "
            "device='cpu' (--device cpu) for the plain PyTorch path")
    return dev


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
