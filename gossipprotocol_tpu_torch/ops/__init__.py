"""Hand-written CUDA kernels of the port and their host-side plans.

``classops`` (the degree-class folds and expands, and the node-major hub
reduce and expand), ``pallasdelivery``
(the two tile gathers, the fused delivery and the sharded edge-share
exchange), ``exec`` (the Clos routing passes of the routed delivery,
``delivery``), ``megakernel`` (K whole rounds per launch), ``probes``
(the measurement probes' copies and gathers) and ``walk`` (a chunk of the
reference walk's hops) each keep a plain PyTorch version beside the
kernel; ``plan`` and ``clos`` compile
the routing plans on the host, ``sharddelivery`` the sharded push
design's per-shard plans; ``plancache`` caches the deliveries' plans on
disk; ``build`` compiles ``csrc/*.cu`` at first use.
"""

from gossipprotocol_tpu_torch.ops import (
    classops, exec, pallasdelivery, probes,
)


def _tables():
    # imported here: ops.megakernel and ops.walk import protocols
    # modules, which import this package
    from gossipprotocol_tpu_torch.ops import megakernel, walk

    return (classops.LAUNCHES, exec.LAUNCHES, pallasdelivery.LAUNCHES,
            megakernel.LAUNCHES, probes.LAUNCHES, walk.LAUNCHES)


def kernel_launches() -> dict:
    """Launch count of every kernel since the last reset."""
    out = {}
    for table in _tables():
        out.update(table)
    return out


def reset_kernel_launches() -> None:
    for table in _tables():
        for k in table:
            table[k] = 0
