"""Probe the primitives a static-routing delivery kernel stands on (the
port of ``experiments/route_probe.py``).

Delivery is ``out = segment_sum(vals[perm], sorted_dst)`` with a
build-time-known permutation ``perm``; a permutation decomposes into
tile-local shuffles plus block transposes. This probe measures, on the
card, every primitive that plan needs: the torch calls the port would
otherwise lean on (an elementwise stream, ``index_add_`` on random,
stacked and sorted ids, ``cumsum``, ``gather`` on both axes, a
``[T, B, P]`` transpose), then the CUDA kernels of the JAX probe's
``pallas_call`` sites — an x2 copy of one 2-16 MB array, the dim-0 and
dim-1 gathers, the tiled lane gather and the x2 copy of 64 MiB in
1,024-row blocks, each checked bitwise against its plain version.

The two x2 copies answer the card's version of the TPU question "does a
2-16 MB block fit VMEM": a block's shared memory holds at most 227 KB, so
every size runs, and 2-16 MB stays in the 50 MB L2 while 64 MiB streams
from device memory. Their rates are the L2-resident copy rate and the
stream ceiling that bounds every bytes-bound kernel of the port.

Usage: python -m gossipprotocol_tpu_torch.probes.route_probe
           [--e 8000000] [--n 1000000] [--skip-kernels]
           [--stream-rows 131072] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gossipprotocol_tpu_torch.ops.build import resolve_device
from gossipprotocol_tpu_torch.ops.probes import (
    probe_gather_lanes, probe_gather_lanes_plain, probe_gather_rows,
    probe_gather_rows_plain, probe_scale2, probe_scale2_plain,
)
from gossipprotocol_tpu_torch.probes import (
    R, check_plain, device_line, report, seconds_per_call,
)
from gossipprotocol_tpu_torch.probes.tile_perm_probe import bank_wavefronts

RESIDENT_MB = (2, 4, 8, 12, 16)
GATHER_ROWS = (8, 256, 1024, 4096)
GATHER_COLS = (128, 512, 4096)
STREAM_ROWS = 64 * 1024 * 1024 // (128 * 4)   # 64 MiB of f32 [rows, 128]
STREAM_TILE_ROWS = 1024


def lane_gather_wavefronts(idx, rows_per_block: int, threads: int) -> dict:
    """Shared-memory wavefronts of ``csrc/probes.cu``'s staged lane
    gather on the indices ``idx`` (``[..., cols]``, values in
    ``0..cols-1``) at the geometry ``(rows_per_block, threads)`` of
    ``ops/probes.py`` ``gather_lanes_geometry``: a block's float4 e sits
    on its row ``e // (cols / 4)``, staged at word ``row * cols``, and
    lanes 32w..32w+31 of a step hold 32 consecutive float4, one request
    for each of their four reads (inactive lanes share the first active
    lane's word). ``{"requests": ..., "wavefronts": ...}``; one wavefront
    a request is conflict-free."""
    cols = idx.shape[-1]
    c4 = cols // 4
    idx = np.asarray(idx, np.int64).reshape(-1, cols)
    rows = idx.shape[0]
    blocks = -(-rows // rows_per_block)
    pad = np.zeros((blocks * rows_per_block, cols), np.int64)
    pad[:rows] = idx
    pad = pad.reshape(blocks, rows_per_block * c4, 4)
    n = np.minimum(rows_per_block, rows - np.arange(blocks)
                   * rows_per_block) * c4                  # float4 a block
    span = -(-rows_per_block * c4 // threads) * threads
    e = np.arange(span)
    row = np.minimum(e // c4, rows_per_block - 1)
    words = (row * cols)[None, :, None] + pad[:, np.minimum(
        e, rows_per_block * c4 - 1)]                         # [b, e, 4]
    live = e[None, :] < n[:, None]                          # [b, e]
    words = words.reshape(blocks, -1, 32, 4).transpose(0, 1, 3, 2)
    live = np.broadcast_to(live.reshape(blocks, -1, 1, 32), words.shape)
    words, live = words.reshape(-1, 32), live.reshape(-1, 32)
    keep = live.any(axis=1)
    words, live = words[keep], live[keep]
    first = words[np.arange(len(words)), live.argmax(axis=1)]
    words = np.where(live, words, first[:, None])
    return {"requests": len(words), "wavefronts": bank_wavefronts(words)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--e", type=int, default=8_000_000)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--skip-kernels", action="store_true",
                    help="time the torch calls only")
    ap.add_argument("--stream-rows", type=int, default=STREAM_ROWS,
                    help="rows of the streamed x2 copy (default 64 MiB)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    e, n = args.e, args.n
    rng = np.random.default_rng(0)
    print(f"device: {device_line(dev)}  E={e} N={n}  R={R}", flush=True)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    tgt = put(rng.integers(0, n, size=e).astype(np.int32))
    tgt_sorted = torch.sort(tgt).values
    vals0 = put(rng.standard_normal(e).astype(np.float32))
    buf = torch.empty_like(vals0)

    # elementwise stream baseline: what "fast" means on this stack
    report("elementwise multiply (stream baseline)", seconds_per_call(
        lambda: torch.mul(vals0, 1.000001, out=buf), dev), 8 * e)

    def segsum(v, ids, width=()):
        return torch.zeros((n, *width), device=dev).index_add_(0, ids, v)

    report("index_add_ random ids (baseline)", seconds_per_call(
        lambda: segsum(vals0, tgt), dev), 8 * e + 4 * n)
    vals2 = torch.stack([vals0, vals0], dim=-1)
    report("index_add_ random ids [E,2] stacked", seconds_per_call(
        lambda: segsum(vals2, tgt, (2,)), dev), 12 * e + 8 * n)
    report("index_add_ SORTED ids", seconds_per_call(
        lambda: segsum(vals0, tgt_sorted), dev), 8 * e + 4 * n)
    report("cumsum over E", seconds_per_call(
        lambda: torch.cumsum(vals0, 0, out=buf), dev), 8 * e)

    # batched gathers (torch.gather takes int64 indices; the byte count is
    # the JAX probe's, int32 indices)
    w = 4096 * 128
    t = max(1, e // w)
    data3 = put(rng.standard_normal((t, 4096, 128)).astype(np.float32))
    idx_r = put(rng.integers(0, 4096, size=(t, 4096, 128)).astype(np.int32))
    idx_c = put(rng.integers(0, 128, size=(t, 4096, 128)).astype(np.int32))
    nb = t * w * 4 * 3
    idx_r64, idx_c64 = idx_r.long(), idx_c.long()
    report("torch.gather dim1 of [T,4096,128] (sublanes)", seconds_per_call(
        lambda: torch.gather(data3, 1, idx_r64), dev), nb)
    report("torch.gather dim2 of [T,4096,128] (lanes)", seconds_per_call(
        lambda: torch.gather(data3, 2, idx_c64), dev), nb)
    b, p = 16, w // 16
    stg = put(rng.standard_normal((t, b, p)).astype(np.float32))
    report("[T,B,P]->[B,T,P] transpose", seconds_per_call(
        lambda: stg.transpose(0, 1).contiguous(), dev), t * b * p * 8)

    if args.skip_kernels:
        return 0

    # x2 copy of one whole array (the JAX probe's VMEM residency ceiling)
    for mb in RESIDENT_MB:
        rows = mb * 1024 * 1024 // (128 * 4)
        xb = put(rng.standard_normal((rows, 128)).astype(np.float32))
        check_plain(f"x2 copy {mb} MB", probe_scale2(xb),
                    probe_scale2_plain(xb))
        report(f"x2 copy {mb:3d} MB, one tile (L2-resident)",
               seconds_per_call(lambda: probe_scale2(xb), dev),
               2 * rows * 128 * 4)

    # dim-0 (sublane) gather, by row count
    for rows in GATHER_ROWS:
        xg = put(rng.standard_normal((rows, 128)).astype(np.float32))
        ig = put(rng.integers(0, rows, size=(rows, 128)).astype(np.int32))
        check_plain(f"dim0 gather rows={rows}", probe_gather_rows(xg, ig),
                    probe_gather_rows_plain(xg, ig))
        report(f"kernel dim0 gather rows={rows:5d}", seconds_per_call(
            lambda: probe_gather_rows(xg, ig), dev), rows * 128 * 12)

    # wide-row (cross-lane) gather, by row width
    for cols in GATHER_COLS:
        xg = put(rng.standard_normal((128, cols)).astype(np.float32))
        ig = put(rng.integers(0, cols, size=(128, cols)).astype(np.int32))
        check_plain(f"dim1 gather cols={cols}", probe_gather_lanes(xg, ig),
                    probe_gather_lanes_plain(xg, ig))
        report(f"kernel dim1 gather cols={cols:5d}", seconds_per_call(
            lambda: probe_gather_lanes(xg, ig), dev), 128 * cols * 12)

    # the tiled lane gather at tile scale
    check_plain("dim1 gather (tiled)", probe_gather_lanes(data3, idx_c),
                probe_gather_lanes_plain(data3, idx_c))
    report("kernel dynamic_gather dim1 (tiled)", seconds_per_call(
        lambda: probe_gather_lanes(data3, idx_c), dev), nb)

    # the streamed x2 copy: the achievable stream ceiling
    xs = put(rng.standard_normal((args.stream_rows, 128)).astype(np.float32))
    check_plain("stream x2 copy", probe_scale2(xs, STREAM_TILE_ROWS),
                probe_scale2_plain(xs))
    report(f"kernel grid stream copy {args.stream_rows * 512 / 2**20:g}MB",
           seconds_per_call(lambda: probe_scale2(xs, STREAM_TILE_ROWS), dev),
           args.stream_rows * 128 * 8)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
