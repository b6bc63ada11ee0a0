"""ctypes loaders of the port's three host libraries (a copy of
``gossipprotocol_tpu/native.py``).

Each library is a byte-for-byte copy of a JAX package source (tests hold
the copies equal), so both packages produce the same bytes:

* ``csrc/host/routecolor.cpp`` — the routing plan compiler's Euler-split
  coloring and stage planner (``ops/clos.py``, ``ops/plan.py``);
* ``csrc/host/graphgen.cpp`` — the canonical CSR build and the
  Barabási–Albert edge list (``topology/base.py``, ``builders.py``),
  draw for draw the numpy builders' splitmix64 stream;
* ``csrc/host/asyncsim.cpp`` — the reference's actor semantics as an
  event-driven oracle (gossip events, the push-sum walk's hops), run on
  the host by ``experiments/oracle_curves.py`` and the tests.

The shared libraries are not in git: each compiles at first use with
``g++`` (the flags of ``native/Makefile``) into
``gossipprotocol_tpu_torch/_build/host-<hash>/``, keyed on its source and
its flags. routecolor builds with OpenMP; a compiler without it (no
``libgomp``) builds the same source single-threaded — the source guards
every pragma with ``_OPENMP``, and the thread count never changes a
result, only the build time — and :func:`threads_note` says which build
loaded. A compile that fails raises :class:`NativeBuildError` with the
compiler's output.

``GOSSIP_TPU_NATIVE=0`` asks for the numpy mirrors instead (every entry
point returns None and the callers take their numpy spelling; the oracle
has no mirror and reports itself unavailable). Nothing else selects
them: at 1M nodes the python Hierholzer coloring turns a build of
seconds into hours.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = Path(__file__).resolve().parent
SOURCE = _PKG_DIR / "csrc" / "host" / "routecolor.cpp"
GRAPHGEN_SOURCE = _PKG_DIR / "csrc" / "host" / "graphgen.cpp"
ASYNC_SOURCE = _PKG_DIR / "csrc" / "host" / "asyncsim.cpp"
BUILD_ROOT = _PKG_DIR / "_build"   # ops/build.py's directory (gitignored)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-fopenmp", "-shared")
SERIAL_FLAGS = tuple(f for f in CXX_FLAGS if f != "-fopenmp")

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I8P = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")

# the oracle materializes the implicit complete graph; past this many
# nodes its n * (n - 1) entries are refused (the JAX package's limit)
ORACLE_FULL_MAX_NODES = 20_000


class NativeBuildError(RuntimeError):
    """g++ refused a host library (the message carries its output)."""


class _Lib:
    """A loaded host library of the process (None until first use)."""

    lib: Optional[ctypes.CDLL] = None
    path: Optional[Path] = None
    flags: Tuple[str, ...] = ()


_LIB = _Lib()        # routecolor
_GRAPHGEN = _Lib()
_ASYNC = _Lib()

# threads a single-threaded build spreads route_tiles_full over (None:
# one per core); set_native_threads lowers it in build-pool workers so
# W workers x their threads stay within the host's cores
_THREADS: Optional[int] = None


def enabled() -> bool:
    """False under ``GOSSIP_TPU_NATIVE=0`` (the numpy mirrors run)."""
    return os.environ.get("GOSSIP_TPU_NATIVE", "1") != "0"


def backend() -> str:
    """Which backend the next plan or topology build runs: ``native`` or
    ``numpy``."""
    return "native" if enabled() else "numpy"


def threads_note() -> str:
    """How the loaded routing library runs: OpenMP or single-threaded."""
    if _LIB.lib is None:
        return "not loaded"
    return ("OpenMP" if "-fopenmp" in _LIB.flags
            else "single-threaded (the compiler has no OpenMP)")


def library_path(flags=CXX_FLAGS, source: Path = SOURCE) -> Path:
    """Where the library for ``source`` (routecolor by default) under
    ``flags`` lives."""
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(flags).encode())
    h.update(source.read_bytes())
    return BUILD_ROOT / f"host-{h.hexdigest()}" / f"lib{source.stem}.so"


def _compile(lib_path: Path, flags, source: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders (test
    # workers) never load a half-written file
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *flags, "-o", tmp, str(source)],
                              capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise NativeBuildError(f"cannot run the C++ compiler {cxx!r}: "
                               f"{e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeBuildError(
            f"{cxx} {' '.join(flags)} failed (rc {proc.returncode}) on "
            f"{source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)


def _configure(lib: ctypes.CDLL) -> None:
    lib.route_color_tiles.restype = ctypes.c_int64
    lib.route_color_tiles.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, _I32P, _I32P, _I32P,
    ]
    lib.route_tiles_full.restype = ctypes.c_int64
    lib.route_tiles_full.argtypes = [
        ctypes.c_int64, ctypes.c_int32, _I64P, _I8P,
    ]
    lib.set_native_threads.restype = None
    lib.set_native_threads.argtypes = [ctypes.c_int32]
    lib.plan_stage_count.restype = ctypes.c_int64
    lib.plan_stage_count.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        _I64P, _I32P, _I32P, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.plan_stage_place.restype = ctypes.c_int64
    # new_pos/perm as raw pointers: perm is optional (NULL skips the
    # permutation fill on geometry-only passes)
    lib.plan_stage_place.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _I64P, _I32P, _I32P, ctypes.c_void_p, ctypes.c_void_p,
    ]


def _configure_graphgen(lib: ctypes.CDLL) -> None:
    lib.csr_build.restype = ctypes.c_int64
    lib.csr_build.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _I64P, _I64P, _I64P, _I32P,
    ]
    lib.ba_edges.restype = ctypes.c_int64
    lib.ba_edges.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64, _I64P, _I64P,
    ]


def _configure_async(lib: ctypes.CDLL) -> None:
    lib.async_gossip.restype = ctypes.c_int64
    lib.async_gossip.argtypes = [
        ctypes.c_int64, _I64P, _I32P, ctypes.c_uint64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.async_gossip_cost.restype = ctypes.c_int64
    lib.async_gossip_cost.argtypes = [
        ctypes.c_int64, _I64P, _I32P, ctypes.c_uint64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.async_pushsum_walk.restype = ctypes.c_int64
    lib.async_pushsum_walk.argtypes = [
        ctypes.c_int64, _I64P, _I32P, ctypes.c_uint64, ctypes.c_int64,
        ctypes.c_int64,
    ]


def _load_lib(held: _Lib, source: Path, flag_sets,
              configure) -> Optional[ctypes.CDLL]:
    """``source``'s library, compiled on first use under the first of
    ``flag_sets`` that builds; None under ``GOSSIP_TPU_NATIVE=0``. Raises
    :class:`NativeBuildError` when every compile fails."""
    if not enabled():
        return None
    if held.lib is None:
        errors = []
        for flags in flag_sets:
            path = library_path(flags, source)
            if not path.exists():
                try:
                    _compile(path, flags, source)
                except NativeBuildError as e:
                    errors.append(str(e))
                    continue
            lib = ctypes.CDLL(str(path))
            configure(lib)
            held.lib, held.path, held.flags = lib, path, flags
            break
        else:
            raise NativeBuildError("\n".join(errors))
    return held.lib


def _load() -> Optional[ctypes.CDLL]:
    """The routing library (with OpenMP, else single-threaded)."""
    return _load_lib(_LIB, SOURCE, (CXX_FLAGS, SERIAL_FLAGS), _configure)


def _load_graphgen() -> Optional[ctypes.CDLL]:
    return _load_lib(_GRAPHGEN, GRAPHGEN_SOURCE, (SERIAL_FLAGS,),
                     _configure_graphgen)


def _load_async() -> Optional[ctypes.CDLL]:
    return _load_lib(_ASYNC, ASYNC_SOURCE, (SERIAL_FLAGS,), _configure_async)


def available() -> bool:
    """Do the graph builders run natively? False under
    ``GOSSIP_TPU_NATIVE=0``; otherwise builds the library (raising if g++
    refuses it) and returns True."""
    return _load_graphgen() is not None


def async_available() -> bool:
    """Does the oracle run? As :func:`available`, for ``asyncsim.cpp``."""
    return _load_async() is not None


def route_color_tiles(src_rows: np.ndarray, dst_rows: np.ndarray, n: int,
                      deg: int) -> Optional[np.ndarray]:
    """Batch Euler-split edge coloring (``routecolor.cpp``).

    ``src_rows``/``dst_rows``: int32 ``[T, n*deg]`` row ids in ``[0, n)``
    forming, per tile, a ``deg``-regular bipartite multigraph. Returns a
    proper coloring ``[T, n*deg]`` with colors in ``[0, deg)``, or None
    under ``GOSSIP_TPU_NATIVE=0``.
    """
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src_rows, dtype=np.int32)
    dst = np.ascontiguousarray(dst_rows, dtype=np.int32)
    if src.shape != dst.shape or src.shape[-1] != n * deg:
        raise ValueError(f"route_color_tiles: src {src.shape} and dst "
                         f"{dst.shape} must be [T, {n * deg}]")
    tiles = int(np.prod(src.shape[:-1], dtype=np.int64)) if src.ndim > 1 else 1
    color = np.empty_like(src)
    rc = lib.route_color_tiles(tiles, n, deg, src.reshape(-1),
                               dst.reshape(-1), color.reshape(-1))
    if rc != 0:
        raise ValueError(f"route_color_tiles: malformed input (rc={rc})")
    return color


def route_tiles_full(perms: np.ndarray, unit: int) -> Optional[np.ndarray]:
    """Fused tile router (``routecolor.cpp``): per-tile unit permutations
    ``[T, U]`` (``-1`` slots completed to bijections with the fill rule of
    ``ops.plan._complete_bijections``) to stacked gather triples int8
    ``[T, 3, 128, 128]`` in ``ops.clos.route_tile_perms``'s convention;
    None under ``GOSSIP_TPU_NATIVE=0``."""
    lib = _load()
    if lib is None:
        return None
    perms = np.ascontiguousarray(perms, dtype=np.int64)
    # the C side derives U from unit alone and strides the buffer by it:
    # a mismatched width would read out of bounds, not raise
    if perms.ndim != 2 or perms.shape[1] != 16384 // unit:
        raise ValueError(
            f"route_tiles_full: perms must be [T, {16384 // unit}] for "
            f"unit={unit}, got {perms.shape}")
    t = perms.shape[0]
    idx = np.empty((t, 3, 128, 128), np.int8)
    # a single-threaded build spreads the tiles over threads here instead
    # (ctypes releases the GIL; tiles are independent, writes disjoint)
    workers = 1 if "-fopenmp" in _LIB.flags else min(
        _THREADS or os.cpu_count() or 1, t // 16)
    bounds = np.linspace(0, t, max(workers, 1) + 1).astype(np.int64)

    def run(lo_hi):
        lo, hi = (int(v) for v in lo_hi)
        return lib.route_tiles_full(hi - lo, unit, perms[lo:hi].reshape(-1),
                                    idx[lo:hi].reshape(-1))

    spans = list(zip(bounds[:-1], bounds[1:]))
    if len(spans) == 1:
        rcs = [run(spans[0])]
    else:
        with ThreadPoolExecutor(len(spans)) as pool:
            rcs = list(pool.map(run, spans))
    if any(rcs):
        raise ValueError(f"route_tiles_full: non-injective perm (rc={rcs})")
    return idx


def set_native_threads(n: int) -> None:
    """Clamp the library's thread count — OpenMP's, or the Python threads
    a single-threaded build spreads the tile router over (results never
    depend on it); the OpenMP half is a no-op under
    ``GOSSIP_TPU_NATIVE=0``."""
    global _THREADS
    _THREADS = max(1, int(n))
    lib = _load()
    if lib is not None:
        lib.set_native_threads(int(n))


def plan_stage_pack(pos: np.ndarray, bucket: np.ndarray, u: int, b: int,
                    t_grid: int) -> Optional[Tuple[np.ndarray, int]]:
    """Counting-sort run packing for one compiler stage
    (``routecolor.cpp::plan_stage_count``): ``(rank, max_run)``, each
    flow's rank within its (tile, bucket) run in ascending-``pos`` order
    and the longest run in units; None under ``GOSSIP_TPU_NATIVE=0``."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    bucket32 = np.ascontiguousarray(bucket, dtype=np.int32)
    if bucket32.shape != pos.shape:
        raise ValueError("plan_stage_pack: pos and bucket differ in shape")
    rank = np.empty(pos.size, np.int32)
    max_run = ctypes.c_int64(0)
    rc = lib.plan_stage_count(pos.size, t_grid, u, b, pos, bucket32, rank,
                              ctypes.byref(max_run))
    if rc != 0:
        raise ValueError(
            f"plan_stage_count: malformed flows (rc={rc}: "
            f"{'duplicate pos' if rc == 2 else 'out of range'})")
    return rank, int(max_run.value)


def plan_stage_place(pos: np.ndarray, bucket: np.ndarray, rank: np.ndarray,
                     u: int, unit: int, b: int, cr: int, o: int,
                     tau_in: int, tau_slab: int,
                     perm: Optional[np.ndarray] = None
                     ) -> Optional[np.ndarray]:
    """Fused flow placement for one compiler stage
    (``routecolor.cpp::plan_stage_place``): ``new_pos`` int64 ``[F]``,
    and when ``perm`` (int64 ``[t_grid * o, u]`` pre-filled with -1) is
    given, each flow's source unit scattered into it in place. None under
    ``GOSSIP_TPU_NATIVE=0``."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    bucket32 = np.ascontiguousarray(bucket, dtype=np.int32)
    rank32 = np.ascontiguousarray(rank, dtype=np.int32)
    if not (bucket32.shape == rank32.shape == pos.shape):
        raise ValueError("plan_stage_place: pos, bucket, rank differ in "
                         "shape")
    if perm is not None and (perm.dtype != np.int64
                             or not perm.flags.c_contiguous):
        raise ValueError("plan_stage_place: perm must be C-contiguous "
                         "int64")
    new_pos = np.empty(pos.size, np.int64)
    rc = lib.plan_stage_place(
        pos.size, u, unit, b, cr, o, tau_in, tau_slab, pos, bucket32,
        rank32, new_pos.ctypes.data,
        perm.ctypes.data if perm is not None else None)
    if rc != 0:
        raise ValueError(f"plan_stage_place: malformed geometry (rc={rc})")
    return new_pos


# ---- graphgen.cpp: topology assembly -------------------------------------

def csr_build(num_nodes: int, src: np.ndarray, dst: np.ndarray
              ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Canonical symmetric CSR ``(offsets int64 [n + 1], indices int32)``
    of an undirected edge list, self-loops dropped and each row sorted and
    deduplicated (byte-equal to ``topology/base.py``'s numpy path); None
    under ``GOSSIP_TPU_NATIVE=0``. An edge outside ``[0, n)`` raises."""
    lib = _load_graphgen()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("csr_build: src and dst must be equal 1-d arrays")
    e = len(src)
    offsets = np.empty(num_nodes + 1, dtype=np.int64)
    indices = np.empty(max(2 * e, 1), dtype=np.int32)
    nnz = lib.csr_build(num_nodes, e, src, dst, offsets, indices)
    if nnz < 0:
        raise ValueError("csr_build: edge index out of range")
    return offsets, indices[:nnz].copy()


def ba_edges(num_nodes: int, m: int, seed: int) -> Optional[np.ndarray]:
    """Barabási–Albert edge list int64 ``[E, 2]``, draw for draw the numpy
    builder's (``topology/builders.py`` :func:`build_power_law`); None
    under ``GOSSIP_TPU_NATIVE=0``."""
    lib = _load_graphgen()
    if lib is None:
        return None
    cap = (m + 1) * m // 2 + max(num_nodes - m - 1, 0) * m
    src = np.empty(cap, dtype=np.int64)
    dst = np.empty(cap, dtype=np.int64)
    ne = lib.ba_edges(num_nodes, m, np.uint64(seed & (2**64 - 1)).item(),
                      src, dst)
    if ne < 0:
        raise ValueError("ba_edges: invalid n/m")
    return np.stack([src[:ne], dst[:ne]], axis=1)


# ---- asyncsim.cpp: the reference's actor semantics, as an oracle -----------

def _topo_csr64(topo) -> Tuple[np.ndarray, np.ndarray]:
    """The oracle's CSR: int64 offsets and int32 indices; the implicit
    complete graph materialized (up to :data:`ORACLE_FULL_MAX_NODES`)."""
    if topo.implicit_full:
        n = topo.num_nodes
        if n > ORACLE_FULL_MAX_NODES:
            raise ValueError("oracle on implicit full topology: n too large")
        ids = np.arange(n, dtype=np.int32)
        indices = np.ascontiguousarray(
            np.stack([np.delete(ids, i) for i in range(n)]).reshape(-1))
        offsets = np.arange(0, n * (n - 1) + 1, n - 1, dtype=np.int64)
        return offsets, indices
    return (np.ascontiguousarray(topo.offsets, dtype=np.int64),
            np.ascontiguousarray(topo.indices, dtype=np.int32))


def _seed64(seed: int) -> int:
    return np.uint64(seed & (2**64 - 1)).item()


def async_gossip_events(topo, seed: int, threshold: int = 11,
                        start_node: int = 0,
                        max_events: int = 100_000_000) -> Optional[int]:
    """Message events to global convergence under the reference's actor
    semantics (``asyncsim.cpp``); None under ``GOSSIP_TPU_NATIVE=0``.
    Raises if convergence is not reached within ``max_events``."""
    lib = _load_async()
    if lib is None:
        return None
    offsets, indices = _topo_csr64(topo)
    ev = lib.async_gossip(topo.num_nodes, offsets, indices, _seed64(seed),
                          threshold, start_node, max_events)
    if ev < 0:
        raise RuntimeError("async_gossip: no convergence within max_events")
    return int(ev)


def async_gossip_dispatch_cost(topo, seed: int, threshold: int = 11,
                               start_node: int = 0,
                               max_events: int = 100_000_000,
                               threads: int = 8
                               ) -> Optional[Tuple[int, int]]:
    """``(events, dispatcher_cost)`` under the reference's actor
    semantics: one oracle sweep (a round-robin pass over the runnable
    actors) costs ``max(sweep_events, threads)`` thread-time units. The
    same RNG stream as :func:`async_gossip_events`, so the events match
    it exactly. None under ``GOSSIP_TPU_NATIVE=0``."""
    lib = _load_async()
    if lib is None:
        return None
    offsets, indices = _topo_csr64(topo)
    cost = ctypes.c_int64(0)
    ev = lib.async_gossip_cost(topo.num_nodes, offsets, indices,
                               _seed64(seed), threshold, start_node,
                               max_events, threads, ctypes.byref(cost))
    if ev < 0:
        raise RuntimeError("async_gossip_cost: no convergence in max_events")
    return int(ev), int(cost.value)


def async_pushsum_hops(topo, seed: int, start_node: int = 0,
                       max_hops: int = 1_000_000_000) -> Optional[int]:
    """Hops of the reference's single-token push-sum walk until every node
    converges on its second receipt (the walk's 2-cover time); None under
    ``GOSSIP_TPU_NATIVE=0``. Raises when the walk is trapped or reaches
    ``max_hops``."""
    lib = _load_async()
    if lib is None:
        return None
    offsets, indices = _topo_csr64(topo)
    hops = lib.async_pushsum_walk(topo.num_nodes, offsets, indices,
                                  _seed64(seed), start_node, max_hops)
    if hops < 0:
        raise RuntimeError("async_pushsum_walk: trapped or max_hops reached")
    return int(hops)
