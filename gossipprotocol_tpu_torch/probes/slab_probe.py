"""Probe the inter-pass regrouping options for the routed delivery
(the port of ``experiments/slab_probe.py``).

A routing pass emits, per input tile, B bucket runs that the next pass
must read bucket-major. Two candidate mechanisms:

  (a) strided slab write: the kernel writes ``[B, T, CR, 128]`` directly,
      B strided runs of CR rows per tile;
  (b) contiguous write ``[T, B, CR, 128]`` plus one transpose to
      ``[B, T, CR, 128]`` between passes (a torch call).

Measures both at delivery scale, and the minor-dim class reduce
(``[n, c]`` summed over its last dim, a torch call) the reduce stage
relies on.

Usage: python -m gossipprotocol_tpu_torch.probes.slab_probe
           [--tiles 512] [--sum-elems 8000000] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gossipprotocol_tpu_torch.ops.build import resolve_device
from gossipprotocol_tpu_torch.ops.probes import probe_slab, probe_slab_plain
from gossipprotocol_tpu_torch.probes import (
    R, check_plain, device_line, report, seconds_per_call,
)

BUCKETS, CR = 102, 1   # B buckets, CR rows per (bucket, tile)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tiles", type=int, default=512,
                    help="T input tiles of [128, 128] f32 (512: the 1M-node "
                         "diffusion pair scale, ~8M f32 per pass)")
    ap.add_argument("--sum-elems", type=int, default=8_000_000,
                    help="elements of each minor-dim sum")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    print(f"device: {device_line(dev)}  R={R}", flush=True)

    t = args.tiles
    x = torch.from_numpy(rng.standard_normal((t, 128, 128)).astype(
        np.float32)).to(dev)
    nbytes = t * 128 * 128 * 8  # read + write, as the JAX probe counts

    # (a) strided slab write
    slab = probe_slab(x, BUCKETS, CR, True)
    check_plain("slab (bucket-major)", slab,
                probe_slab_plain(x, BUCKETS, CR, True))
    secs = seconds_per_call(lambda: probe_slab(x, BUCKETS, CR, True), dev)
    report("kernel strided slab write (B,T,CR,128)", secs, nbytes)

    # (b) contiguous write + transpose
    contig = probe_slab(x, BUCKETS, CR, False)
    check_plain("slab (tile-major)", contig,
                probe_slab_plain(x, BUCKETS, CR, False))
    check_plain("tile-major + transpose against bucket-major",
                contig.transpose(0, 1).contiguous(), slab)

    def op_b():
        return probe_slab(x, BUCKETS, CR, False).transpose(0, 1).contiguous()

    report("kernel contig write + torch transpose",
           seconds_per_call(op_b, dev), nbytes * 2)

    # minor-dim class reduce at delivery scale
    for c in (8, 32, 128):
        n = args.sum_elems // c
        seg = torch.from_numpy(rng.standard_normal((n, c)).astype(
            np.float32)).to(dev)
        report(f"reshape [n,{c}] minor-dim sum",
               seconds_per_call(lambda: seg.sum(-1), dev), n * c * 4)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
