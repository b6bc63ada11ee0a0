"""Disk cache of the delivery plans (the routed, pallas and sharded-push
halves of ``gossipprotocol_tpu/ops/plancache.py``; the sharded pull
family is not yet ported).

The plan build is O(E) host work, while its tables are a pure function
of the adjacency. They are cached keyed by a blake2b digest of the CSR,
one uncompressed ``.npz`` per topology, published through ``os.replace``
so a crashed build never leaves a truncated entry behind.

The on-disk format is the JAX package's, byte for byte in layout and key:
``routed_v2_<key>.npz`` (routed), ``routedpl_v2_<key>.npz`` (pallas) and
``routedpush_v2_<key>_p<n_padded>x<shards>.npz`` (the sharded push
design, keyed by the partition too) under the same directory (``$GOSSIP_TPU_PLAN_CACHE``, else
``~/.cache/gossipprotocol_tpu/routed-plans``), so an entry written by
either package is read by the other (``tests/test_torch_plancache.py``).
The routed realmask, the one highly compressible array, is stored
bit-packed.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time
import warnings
import zipfile
from typing import Optional

import numpy as np

from gossipprotocol_tpu_torch.ops.delivery import (
    RoutedDelivery, build_routed_delivery_np,
)
from gossipprotocol_tpu_torch.ops.exec import (
    DeviceFinal, DevicePlan, DeviceStage,
)
from gossipprotocol_tpu_torch.ops.pallasdelivery import (
    HostGatherPlan, HostPallasDelivery, PallasDelivery,
    build_pallas_delivery_np,
)

# Bumped whenever the table layout changes (the JAX package's constant:
# a stale-format entry must rebuild, not deserialize garbage).
FORMAT_VERSION = 2

# Provenance stamp only, not an invalidation key: builders must produce
# bitwise-identical plans (the JAX package's constant).
BUILDER_VERSION = 2

_PLAN_GROUPS = ("plan_in", "plan_m", "plan_out")


def _provenance(build_s: float, build_workers: int) -> dict:
    """Entry metadata recorded at save time and logged on save/load."""
    return {
        "builder": BUILDER_VERSION,
        "build_s": round(float(build_s), 3),
        "build_workers": int(build_workers),
        "host_cpus": os.cpu_count(),
    }


@contextlib.contextmanager
def _single_flight(path: str):
    """Advisory build lock for one cache entry: concurrent builders of
    the same topology serialize on ``<entry>.npz.lock`` so the plan build
    runs once and the others load its result.

    Yields the seconds spent waiting (0.0 when acquired at once, None
    when locking is unavailable — no fcntl, or an unwritable cache dir —
    and both sides then build; entries are bitwise equal). The ``.lock``
    suffix keeps these files out of :func:`_evict_over_budget`.
    """
    try:
        import fcntl
    except ImportError:  # non-POSIX host
        yield None
        return
    lock_path = path + ".lock"
    try:
        os.makedirs(os.path.dirname(lock_path) or ".", exist_ok=True)
        fh = open(lock_path, "a")
    except OSError:
        yield None
        return
    try:
        wait_s = 0.0
        try:
            fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            t0 = time.perf_counter()
            fcntl.flock(fh, fcntl.LOCK_EX)
            wait_s = time.perf_counter() - t0
        try:
            yield wait_s
        finally:
            try:
                fcntl.flock(fh, fcntl.LOCK_UN)
            except OSError:
                pass
    finally:
        fh.close()


def entry_provenance(path: str) -> Optional[dict]:
    """The provenance dict of a cache entry, or None (absent entry, no
    provenance, or unreadable metadata)."""
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            return meta.get("provenance")
    except (OSError, ValueError, KeyError, json.JSONDecodeError,
            zipfile.BadZipFile):
        return None


def _provenance_note(path: str) -> str:
    prov = entry_provenance(path)
    if not prov:
        return ""
    return (f"; built in {prov.get('build_s', '?')}s with "
            f"{prov.get('build_workers', '?')} workers "
            f"(builder v{prov.get('builder', '?')})")


def default_cache_dir() -> str:
    """``$GOSSIP_TPU_PLAN_CACHE`` or ``~/.cache/gossipprotocol_tpu/
    routed-plans`` (the JAX package's directory: the two share entries)."""
    env = os.environ.get("GOSSIP_TPU_PLAN_CACHE")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "gossipprotocol_tpu",
        "routed-plans")


def cache_key(topo) -> str:
    """Content address of the adjacency: blake2b-128 over the node count
    and the CSR arrays, the JAX package's ``Topology.adjacency_digest``.
    A cache key fails open (a collision would load another graph's
    tables), hence a collision-resistant digest."""
    if topo.implicit_full:
        raise ValueError("the implicit complete graph has no CSR to digest")
    h = hashlib.blake2b(digest_size=16)
    h.update(str(topo.num_nodes).encode())
    h.update(np.ascontiguousarray(topo.offsets))
    h.update(np.ascontiguousarray(topo.indices))
    return f"{topo.num_nodes}-{h.hexdigest()}"


# ---- routed delivery ----------------------------------------------------

def entry_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"routed_v{FORMAT_VERSION}_{key}.npz")


def _pack_plan(prefix: str, dp, arrays: dict) -> dict:
    meta = {
        "unit": int(dp.unit), "nt_in": int(dp.nt_in),
        "nt_out": int(dp.nt_out),
        "stages": [[int(v) for v in tuple(st)[:6]] for st in dp.stages],
        "final_k": int(dp.final.k),
    }
    for i, st in enumerate(dp.stages):
        arrays[f"{prefix}.s{i}"] = np.asarray(st.idx)
    arrays[f"{prefix}.fidx"] = np.asarray(dp.final.idx)
    arrays[f"{prefix}.fmask"] = np.asarray(dp.final.mask)
    return meta


def _unpack_plan(prefix: str, meta: dict, z) -> DevicePlan:
    stages = tuple(
        DeviceStage(*geom, idx=z[f"{prefix}.s{i}"])
        for i, geom in enumerate(meta["stages"]))
    fin = DeviceFinal(meta["final_k"], z[f"{prefix}.fidx"],
                      z[f"{prefix}.fmask"])
    return DevicePlan(meta["unit"], meta["nt_in"], meta["nt_out"],
                      stages, fin)


def save(rd, path: str, provenance: Optional[dict] = None) -> None:
    """Serialize a host-side routed delivery (numpy leaves: the port's
    :func:`~gossipprotocol_tpu_torch.ops.delivery.build_routed_delivery_np`
    or the JAX package's ``device=False`` build)."""
    arrays: dict = {}
    meta = {
        "format": FORMAT_VERSION,
        "n": int(rd.n), "nu": int(rd.nu), "m_pairs": int(rd.m_pairs),
        "classes": [[int(v) for v in c] for c in rd.classes],
        "realmask_len": int(np.asarray(rd.realmask).shape[0]),
    }
    if provenance:
        meta["provenance"] = provenance
    for group in _PLAN_GROUPS:
        meta[group] = [_pack_plan(f"{group}{i}", dp, arrays)
                       for i, dp in enumerate(getattr(rd, group))]
    arrays["realmask_bits"] = np.packbits(
        np.asarray(rd.realmask).astype(bool))
    arrays["degree"] = np.asarray(rd.degree, np.int32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + f".tmp{os.getpid()}.npz"
    try:
        np.savez(tmp, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str) -> Optional[RoutedDelivery]:
    """The host-side routed delivery of a cache entry, or None (absent,
    unreadable, or of another format)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if meta.get("format") != FORMAT_VERSION:
                return None
            realmask = np.unpackbits(
                z["realmask_bits"],
                count=meta["realmask_len"]).astype(np.float32)
            try:
                os.utime(path)  # LRU signal for _evict_over_budget
            except OSError:
                pass
            return RoutedDelivery(
                n=meta["n"], nu=meta["nu"], m_pairs=meta["m_pairs"],
                classes=tuple(tuple(c) for c in meta["classes"]),
                plan_in=tuple(_unpack_plan(f"plan_in{i}", m, z)
                              for i, m in enumerate(meta["plan_in"])),
                plan_m=tuple(_unpack_plan(f"plan_m{i}", m, z)
                             for i, m in enumerate(meta["plan_m"])),
                plan_out=tuple(_unpack_plan(f"plan_out{i}", m, z)
                               for i, m in enumerate(meta["plan_out"])),
                realmask=realmask,
                degree=z["degree"],
            )
    except (OSError, ValueError, KeyError, json.JSONDecodeError,
            zipfile.BadZipFile):
        # a corrupt entry (torn write, truncation) rebuilds, never crashes
        return None


def _place_routed(host, device) -> RoutedDelivery:
    from gossipprotocol_tpu_torch.convert import routed_delivery_from_numpy

    return routed_delivery_from_numpy(host, device=device)


def routed_delivery_cached(topo, cache_dir: Optional[str] = None,
                           progress=None, device="cuda"):
    """Cache-aware :func:`~gossipprotocol_tpu_torch.ops.delivery.
    build_routed_delivery`: ``(delivery on device, provenance)`` with
    provenance ``"hit"``, ``"miss"`` (built and saved) or ``"off"``
    (``cache_dir == "none"``, or the implicit complete graph, whose build
    raises the user-facing error)."""
    return _cached(topo, cache_dir, progress, device, "routed", entry_path,
                   load, save,
                   lambda t: build_routed_delivery_np(t, progress=progress),
                   _place_routed)


def _cached(topo, cache_dir, progress, device, what, path_of, load_fn,
            save_fn, build_np, place):
    """The cache front end both delivery families share: load the entry
    of ``topo`` or build it (once per entry across processes, under
    :func:`_single_flight`), save it, and place it on ``device``."""
    from gossipprotocol_tpu_torch.ops.build import resolve_device

    dev = resolve_device(device)  # fail before the host build
    cache_dir = cache_dir or default_cache_dir()
    if cache_dir == "none" or topo.implicit_full:
        return place(build_np(topo), dev), "off"
    path = path_of(cache_dir, cache_key(topo))
    host = load_fn(path)
    if host is not None:
        if progress:
            progress(f"{what} delivery: plan cache hit ({path})"
                     f"{_provenance_note(path)}")
        return place(host, dev), "hit"
    with _single_flight(path) as wait_s:
        if wait_s:
            host = load_fn(path)
            if host is not None:
                if progress:
                    progress(f"{what} delivery: plan cache hit after "
                             f"single-flight wait ({wait_s:.2f}s; {path})"
                             f"{_provenance_note(path)}")
                return place(host, dev), "hit"
        t0 = time.perf_counter()
        host = build_np(topo)
        prov = _provenance(time.perf_counter() - t0, build_workers=1)
        if wait_s:
            prov["single_flight_wait_s"] = round(wait_s, 3)
        try:
            save_fn(host, path, provenance=prov)
            _evict_over_budget(cache_dir, keep=path)
            if progress:
                progress(f"{what} delivery: plan cached ({path}); "
                         f"built in {prov['build_s']}s")
        except OSError as e:
            # a full disk or read-only cache dir must not cost the user
            # the build just paid for: continue uncached, loudly
            warnings.warn(f"{what} plan cache write failed ({e}); "
                          "continuing uncached")
    return place(host, dev), "miss"


# ---- pallas (fused gather) delivery -------------------------------------

def pallas_entry_path(cache_dir: str, key: str) -> str:
    # the "routed" prefix keeps the entry under _evict_over_budget's
    # family filter (the JAX package's naming)
    return os.path.join(cache_dir, f"routedpl_v{FORMAT_VERSION}_{key}.npz")


def _pack_gather(prefix: str, g, meta: dict, arrays: dict) -> None:
    meta[prefix] = {"mode": g.mode, "src_rows": int(g.src_rows),
                    "out_len": int(g.out_len)}
    arrays[f"{prefix}.idx"] = np.asarray(g.idx)
    arrays[f"{prefix}.rows"] = np.asarray(g.rows)
    arrays[f"{prefix}.lidx"] = np.asarray(g.lidx)


def _unpack_gather(prefix: str, meta: dict, z) -> HostGatherPlan:
    m = meta[prefix]
    return HostGatherPlan(m["mode"], m["src_rows"], m["out_len"],
                          z[f"{prefix}.idx"], z[f"{prefix}.rows"],
                          z[f"{prefix}.lidx"])


def save_pallas(pd, path: str, provenance: Optional[dict] = None) -> None:
    """Serialize a host-side delivery (a :class:`HostPallasDelivery`, or
    anything with its fields as numpy, such as the JAX package's)."""
    arrays: dict = {"degree": np.asarray(pd.degree, np.int32)}
    meta: dict = {
        "format": FORMAT_VERSION,
        "n": int(pd.n), "nu": int(pd.nu), "m_pairs": int(pd.m_pairs),
        "classes": [[int(v) for v in c] for c in pd.classes],
    }
    if provenance:
        meta["provenance"] = provenance
    _pack_gather("gather_pre", pd.gather_pre, meta, arrays)
    _pack_gather("gather_out", pd.gather_out, meta, arrays)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + f".tmp{os.getpid()}.npz"
    try:
        np.savez(tmp, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pallas(path: str) -> Optional[HostPallasDelivery]:
    """The host-side delivery of a cache entry, or None (absent,
    unreadable, or of another format)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if meta.get("format") != FORMAT_VERSION:
                return None
            try:
                os.utime(path)  # LRU signal for _evict_over_budget
            except OSError:
                pass
            return HostPallasDelivery(
                n=meta["n"], nu=meta["nu"], m_pairs=meta["m_pairs"],
                classes=tuple(tuple(c) for c in meta["classes"]),
                gather_pre=_unpack_gather("gather_pre", meta, z),
                gather_out=_unpack_gather("gather_out", meta, z),
                degree=z["degree"],
            )
    except (OSError, ValueError, KeyError, json.JSONDecodeError,
            zipfile.BadZipFile):
        return None


def _place_pallas(host: HostPallasDelivery, device) -> PallasDelivery:
    from gossipprotocol_tpu_torch.convert import delivery_from_numpy

    return delivery_from_numpy(*host, device=device)


def pallas_delivery_cached(topo, cache_dir: Optional[str] = None,
                           progress=None, device="cuda"):
    """Cache-aware :func:`~gossipprotocol_tpu_torch.ops.pallasdelivery.
    build_pallas_delivery`: ``(delivery on device, provenance)`` with
    provenance ``"hit"``, ``"miss"`` (built and saved) or ``"off"``
    (``cache_dir == "none"``, or the implicit complete graph)."""
    return _cached(topo, cache_dir, progress, device, "pallas",
                   pallas_entry_path, load_pallas, save_pallas,
                   build_pallas_delivery_np, _place_pallas)


# ---- sharded push deliveries ---------------------------------------------

_PUSH_PLAN_GROUPS = ("plan_in", "plan_send", "plan_recv", "plan_out")


def push_entry_path(cache_dir: str, key: str, n_padded: int,
                    num_shards: int) -> str:
    # the "routedpush_" prefix keeps the entry under _evict_over_budget's
    # family filter (the JAX package's naming)
    return os.path.join(
        cache_dir,
        f"routedpush_v{FORMAT_VERSION}_{key}_p{n_padded}x{num_shards}.npz")


def save_push_shards(stacked, path: str,
                     provenance: Optional[dict] = None) -> None:
    """Serialize a stacked host-form push delivery (numpy leaves with a
    leading shard axis: the port's or the JAX package's
    ``build_shard_push_deliveries``)."""
    arrays: dict = {}
    meta = {
        "format": FORMAT_VERSION,
        "n": int(stacked.n), "local_n": int(stacked.local_n),
        "num_shards": int(stacked.num_shards),
        "nu": int(stacked.nu), "m_pairs": int(stacked.m_pairs),
        "block_pairs": int(stacked.block_pairs),
        "classes": [[int(v) for v in c] for c in stacked.classes],
        "realmask_shape": list(np.asarray(stacked.realmask).shape),
    }
    if provenance:
        meta["provenance"] = provenance
    for group in _PUSH_PLAN_GROUPS:
        meta[group] = [_pack_plan(f"{group}{i}", dp, arrays)
                       for i, dp in enumerate(getattr(stacked, group))]
    arrays["realmask_bits"] = np.packbits(
        np.asarray(stacked.realmask).astype(bool))
    arrays["degree"] = np.asarray(stacked.degree, np.int32)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + f".tmp{os.getpid()}.npz"
    try:
        np.savez(tmp, __meta__=json.dumps(meta), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_push_shards(path: str):
    """The stacked host-form push delivery of a cache entry, or None
    (absent, unreadable, or of another format)."""
    from gossipprotocol_tpu_torch.ops.sharddelivery import ShardPushDelivery

    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if meta.get("format") != FORMAT_VERSION:
                return None
            shape = tuple(meta["realmask_shape"])
            realmask = np.unpackbits(
                z["realmask_bits"], count=int(np.prod(shape))
            ).astype(np.float32).reshape(shape)
            try:
                os.utime(path)  # LRU signal for _evict_over_budget
            except OSError:
                pass
            return ShardPushDelivery(
                n=meta["n"], local_n=meta["local_n"],
                num_shards=meta["num_shards"],
                nu=meta["nu"], m_pairs=meta["m_pairs"],
                block_pairs=meta["block_pairs"],
                classes=tuple(tuple(c) for c in meta["classes"]),
                **{g: tuple(_unpack_plan(f"{g}{i}", m, z)
                            for i, m in enumerate(meta[g]))
                   for g in _PUSH_PLAN_GROUPS},
                realmask=realmask,
                degree=z["degree"],
            )
    except (OSError, ValueError, KeyError, json.JSONDecodeError,
            zipfile.BadZipFile):
        return None


def shard_push_deliveries_cached(topo, n_padded: int, num_shards: int,
                                 cache_dir: Optional[str] = None,
                                 progress=None,
                                 build_workers: Optional[int] = None):
    """Cache-aware :func:`~gossipprotocol_tpu_torch.ops.sharddelivery.
    build_shard_push_deliveries`: ``(stacked host-form delivery,
    provenance)``, provenance ``"hit"``, ``"miss"`` (built and saved) or
    ``"off"`` (``cache_dir == "none"``). Entries are keyed by the
    adjacency digest and the partition; ``build_workers`` is build-side
    only, never part of the key. The caller places the tables
    (``convert.shard_push_from_numpy``)."""
    from gossipprotocol_tpu_torch.ops.sharddelivery import (
        build_shard_push_deliveries, resolve_build_workers,
    )

    def build():
        return build_shard_push_deliveries(
            topo, n_padded, num_shards, progress=progress,
            build_workers=build_workers)

    cache_dir = cache_dir or default_cache_dir()
    if cache_dir == "none":
        return build(), "off"
    path = push_entry_path(cache_dir, cache_key(topo), n_padded,
                           num_shards)
    stacked = load_push_shards(path)
    if stacked is not None:
        if progress:
            progress(f"push routed delivery: plan cache hit ({path})"
                     f"{_provenance_note(path)}")
        return stacked, "hit"
    with _single_flight(path) as wait_s:
        if wait_s:
            stacked = load_push_shards(path)
            if stacked is not None:
                if progress:
                    progress(f"push routed delivery: plan cache hit after "
                             f"single-flight wait ({wait_s:.2f}s; {path})"
                             f"{_provenance_note(path)}")
                return stacked, "hit"
        t0 = time.perf_counter()
        stacked = build()
        prov = _provenance(time.perf_counter() - t0,
                           resolve_build_workers(build_workers, num_shards))
        if wait_s:
            prov["single_flight_wait_s"] = round(wait_s, 3)
        try:
            save_push_shards(stacked, path, provenance=prov)
            _evict_over_budget(cache_dir, keep=path)
            if progress:
                progress(f"push routed delivery: plans cached ({path}); "
                         f"built in {prov['build_s']}s with "
                         f"{prov['build_workers']} workers")
        except OSError as e:
            warnings.warn(f"push plan cache write failed ({e}); "
                          "continuing uncached")
    return stacked, "miss"


def _evict_over_budget(cache_dir: str, keep: str) -> None:
    """Drop the oldest entries past ``$GOSSIP_TPU_PLAN_CACHE_GB``
    (default 20). Eviction is by mtime (a load touches the entry it hits);
    the just-written entry ``keep`` is always kept, and a fresh
    ``.tmp<pid>.npz`` (a concurrent writer's) is left alone."""
    try:
        budget = float(os.environ.get("GOSSIP_TPU_PLAN_CACHE_GB", "20"))
    except ValueError:
        budget = 20.0
    try:
        listing = os.listdir(cache_dir)
    except OSError:
        return
    entries = []
    for f in listing:
        # every entry family of both packages starts with "routed"
        if not (f.startswith("routed") and f.endswith(".npz")):
            continue
        p = os.path.join(cache_dir, f)
        if p == keep:
            continue
        try:
            mtime, sz = os.path.getmtime(p), os.path.getsize(p)
        except OSError:
            continue
        if ".tmp" in f:
            # stale debris of a killed build goes after 6 hours
            if time.time() - mtime > 6 * 3600:
                try:
                    os.unlink(p)
                except OSError:
                    pass
            continue
        entries.append((mtime, sz, p))
    total = sum(sz for _, sz, _ in entries) + (
        os.path.getsize(keep) if os.path.exists(keep) else 0)
    for _, sz, p in sorted(entries):
        if total <= budget * 1e9:
            break
        try:
            os.unlink(p)
            total -= sz
        except OSError:
            pass
