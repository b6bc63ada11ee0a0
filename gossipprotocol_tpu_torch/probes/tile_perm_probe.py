"""Microkernel probe: an arbitrary [128, 128]-tile permutation on the card
(the port of ``experiments/tile_perm_probe.py``).

Theory (3-pass matrix routing / König): any permutation of an R x C
matrix factors as (permute within rows) o (permute within columns) o
(permute within rows). A within-column permutation is T o rowperm o T.
So: perm = L3 o T o L2 o T o L1 with L* = per-row lane gathers and
T = [128, 128] transpose. The routing (which lane each element takes
through the middle stage) is a proper 128-edge-coloring of the bipartite
src-row x dst-row multigraph, computed here by repeated augmenting
matchings (host, numpy; a verbatim copy of the JAX probe's).

This probe: build a random 16K permutation, route it, run the kernel
(``ops/probes.py`` ``probe_tile_perm``: the three gathers composed into
one read per element) on every tile, check it exactly against the
flattened permutation and bitwise against its plain version, and time it.

Usage: python -m gossipprotocol_tpu_torch.probes.tile_perm_probe
           [--tiles 488] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gossipprotocol_tpu_torch.ops.build import resolve_device
from gossipprotocol_tpu_torch.ops.probes import (
    probe_tile_perm, probe_tile_perm_plain,
)
from gossipprotocol_tpu_torch.probes import (
    R, ProbeMismatch, check_plain, device_line, seconds_per_call,
)


# --------------------------------------------------------------------------
# host-side routing: 3-stage Clos decomposition of a tile permutation
# --------------------------------------------------------------------------

def edge_color_bipartite(src_rows: np.ndarray, dst_rows: np.ndarray,
                         n: int = 128) -> np.ndarray:
    """Proper n-edge-coloring of an n-regular bipartite multigraph.

    Edges e: src_rows[e] -> dst_rows[e]; every left and right node has
    degree exactly n (a permutation of an [n, n] tile guarantees this).
    Returns color[e] in [0, n).  Algorithm: peel one perfect matching per
    color via Hopcroft-Karp-ish augmenting paths on the remaining
    multigraph.  O(n^2) edges, n colors — fine for a probe; the real
    plan compiler vectorizes or goes native.
    """
    E = len(src_rows)
    assert E == n * n
    color = np.full(E, -1, np.int32)
    # adjacency: for each left node, list of (edge_id, right)
    adj = [[] for _ in range(n)]
    for e in range(E):
        adj[src_rows[e]].append(e)
    remaining = [list(lst) for lst in adj]
    for c in range(n):
        # find a perfect matching in the remaining multigraph
        match_r = np.full(n, -1, np.int32)   # right -> edge id
        match_l = np.full(n, -1, np.int32)   # left -> edge id

        def try_assign(left, seen):
            for e in remaining[left]:
                if color[e] != -1:
                    continue
                r = dst_rows[e]
                if seen[r]:
                    continue
                seen[r] = True
                if match_r[r] == -1 or try_assign(src_rows[match_r[r]], seen):
                    match_r[r] = e
                    match_l[left] = e
                    return True
            return False

        for left in range(n):
            if match_l[left] == -1:
                seen = np.zeros(n, bool)
                if not try_assign(left, seen):
                    raise RuntimeError("no perfect matching (not regular?)")
        for left in range(n):
            e = match_l[left]
            color[e] = c
            remaining[left].remove(e)
    return color


def route_tile_perm(perm: np.ndarray, n: int = 128):
    """Decompose `out.flat[k] = in.flat[perm[k]]` on an [n, n] tile.

    Returns (idx1, idx2, idx3) int32 [n, n] lane-gather index arrays:
        A = take_along_axis(X,   idx1, axis=1)   # place into color lane
        B = take_along_axis(A.T, idx2, axis=1)   # within-column route
        Y = take_along_axis(B.T, idx3, axis=1)   # final lane placement
    """
    perm = np.asarray(perm, np.int64)
    k = np.arange(n * n, dtype=np.int64)
    src = perm
    src_row, src_col = src // n, src % n
    dst_row, dst_col = k // n, k % n
    color = edge_color_bipartite(src_row, dst_row, n)

    idx1 = np.zeros((n, n), np.int32)   # A[r, c] = X[r, idx1[r, c]]
    idx2 = np.zeros((n, n), np.int32)   # B[c, r] = A[idx2[c, r], c] (as A.T rows)
    idx3 = np.zeros((n, n), np.int32)   # Y[r, c] = B.T[r, idx3[r, c]]
    # stage 1: element e sits at (src_row, src_col); goes to lane color[e]
    idx1[src_row, color] = src_col
    # stage 2: operate on A.T (shape [n cols, n rows]): row c of A.T holds
    # column c of A; element e is at (color, src_row) there and must move
    # to (color, dst_row)
    idx2[color, dst_row] = src_row
    # stage 3: operate on B.T (shape [n rows, n cols]): element e is at
    # (dst_row, color) and must land at (dst_row, dst_col)
    idx3[dst_row, dst_col] = color
    return idx1, idx2, idx3


def apply_route_np(x, idx1, idx2, idx3):
    a = np.take_along_axis(x, idx1, axis=1)
    b = np.take_along_axis(a.T, idx2, axis=1)
    y = np.take_along_axis(b.T, idx3, axis=1)
    return y


# One tile takes seconds to route (pure-Python matchings); a process that
# asks for the same permutation again (a test, chip_smoke.py) gets the
# planes and the first routing's time from here.
_ROUTED = {}


def route_tile_perm_cached(perm: np.ndarray):
    """``(route_tile_perm(perm), seconds the routing took)``, routed once
    per process for each permutation."""
    key = np.asarray(perm, np.int64).tobytes()
    if key not in _ROUTED:
        t0 = time.perf_counter()
        planes = route_tile_perm(perm)
        _ROUTED[key] = (planes, time.perf_counter() - t0)
    return _ROUTED[key]


def tile_planes(planes, tiles: int, device) -> list:
    """The three routing planes as int8 ``[tiles, 128, 128]`` (the same
    permutation in every tile, as the JAX probe streams them)."""
    return [torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        a.astype(np.int8), (tiles, 128, 128)))).to(device) for a in planes]


# --------------------------------------------------------------------------
# shared-memory bank conflicts of the kernel's reads, replayed on the host
# --------------------------------------------------------------------------

def bank_wavefronts(words: np.ndarray) -> int:
    """Wavefronts of warp requests to shared memory: ``words`` is
    ``[requests, 32]``, the 4-byte word each lane touches. A request takes
    as many wavefronts as the most distinct words any one of the 32 banks
    holds (lanes on one word share it)."""
    w = np.sort(np.asarray(words, np.int64), axis=1)
    new = np.ones_like(w, dtype=bool)
    new[:, 1:] = w[:, 1:] != w[:, :-1]
    per_bank = np.zeros((w.shape[0], 32), np.int64)
    req = np.broadcast_to(np.arange(w.shape[0])[:, None], w.shape)
    np.add.at(per_bank, (req[new], w[new] % 32), 1)
    return int(per_bank.max(axis=1).sum())


def pick_wavefronts(idx1, idx2, idx3, transposed: bool = True) -> dict:
    """Wavefronts a tile of ``csrc/probes.cu``'s pick reads, per read and
    in total, on one tile's planes (``[128, 128]``, values 0..127): each
    warp holds one output row r, lane l its four outputs 4l..4l+3, one
    request per output of the four. idx2 row-major (``transposed=False``,
    the byte ``idx2[k, r]`` at ``k * 128 + r``) or staged transposed
    (at ``r * 128 + k``); idx1 row-major bytes, the tile f32 words."""
    i1, i2, i3 = (np.asarray(a, np.int64) for a in (idx1, idx2, idx3))
    r = np.arange(128)[:, None, None]
    k = i3.reshape(128, 32, 4).transpose(0, 2, 1)  # [r, output j, lane]
    r = np.broadcast_to(r, k.shape)
    r2 = i2[k, r]
    s2 = (r * 128 + k) if transposed else (k * 128 + r)
    out = {"s2": bank_wavefronts((s2 // 4).reshape(-1, 32)),
           "s1": bank_wavefronts(((r2 * 128 + k) // 4).reshape(-1, 32)),
           "xs": bank_wavefronts((r2 * 128 + i1[r2, k]).reshape(-1, 32))}
    out["total"] = sum(out.values())
    return out


def transpose_wavefronts() -> int:
    """Wavefronts a tile of the kernel's idx2 transpose: 4 x 4 byte
    blocks (kb, q), q = b % 32 and kb = (q + b // 32) % 32 for block b,
    warps of 32 consecutive b; four word reads (rows 4kb + i, word q) and
    four word writes (rows 4q + j, word kb) each."""
    b = np.arange(1024).reshape(32, 32)
    q = b % 32
    kb = (q + b // 32) % 32
    reads = [(4 * kb + i) * 32 + q for i in range(4)]
    writes = [(4 * q + j) * 32 + kb for j in range(4)]
    return bank_wavefronts(np.concatenate(reads + writes))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", type=int, default=488)  # ~8M elements
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu runs the kernel's plain version")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    print(f"device: {device_line(dev)}", flush=True)

    # one routed random permutation, checked on host
    perm = rng.permutation(128 * 128)
    (idx1, idx2, idx3), t_route = route_tile_perm_cached(perm)
    x_np = rng.standard_normal((128, 128)).astype(np.float32)
    y_np = apply_route_np(x_np, idx1, idx2, idx3)
    ref = x_np.reshape(-1)[perm].reshape(128, 128)
    if not np.array_equal(y_np, ref):
        raise ProbeMismatch("host routing is WRONG")
    print(f"host routing: exact ({t_route * 1e3:.0f} ms to route one tile)",
          flush=True)

    t = args.tiles
    x = torch.from_numpy(rng.standard_normal((t, 128, 128)).astype(
        np.float32)).to(dev)
    i1, i2, i3 = tile_planes((idx1, idx2, idx3), t, dev)
    y = probe_tile_perm(x, i1, i2, i3)
    ref = x.reshape(t, -1)[:, torch.from_numpy(perm).to(dev)].reshape(
        t, 128, 128)
    if not torch.equal(y, ref):
        raise ProbeMismatch("kernel output is WRONG")
    print("kernel: exact on all tiles", flush=True)
    check_plain("tile perm", y, probe_tile_perm_plain(x, i1, i2, i3))

    secs = seconds_per_call(lambda: probe_tile_perm(x, i1, i2, i3), dev)
    nelem = t * 128 * 128
    nbytes = nelem * (4 + 4 + 3)  # data r/w f32 + 3 int8 idx streams
    print(f"tile-perm kernel: {secs * 1e3:9.4f} ms for {nelem / 1e6:.1f}M "
          f"elems  {secs / nelem * 1e9:6.3f} ns/elem  "
          f"{nbytes / secs / 1e9:6.1f} GB/s  (R={R})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
