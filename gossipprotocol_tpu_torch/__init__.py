"""gossipprotocol_tpu_torch — the PyTorch/CUDA port of gossipprotocol_tpu.

The JAX package (``gossipprotocol_tpu``) is the reference; this package
grows beside it slice by slice and imports neither JAX nor it. Ported so
far: fanout-all diffusion push-sum over the fused gather delivery
(``python -m gossipprotocol_tpu_torch N topology push-sum --fanout all
--delivery pallas``), the Clos-routed delivery (``--delivery routed``),
the K-round megakernel (``--delivery megakernel --rounds-per-kernel K``)
and sharded over S shards with the push design (``--devices S``), with
their ten TPU kernels rewritten as CUDA for Hopper (``csrc/``), and the
plan cache.
Entry points run on ``cuda`` unless asked for ``cpu``, where each
kernel's plain PyTorch version runs instead.
"""

from gossipprotocol_tpu_torch.version import __version__
from gossipprotocol_tpu_torch.topology import (
    Topology,
    available_topologies,
    build_topology,
)
from gossipprotocol_tpu_torch.protocols import PushSumState, pushsum_init
from gossipprotocol_tpu_torch.engine import RunConfig, RunResult, run_simulation

__all__ = [
    "__version__",
    "Topology",
    "build_topology",
    "available_topologies",
    "PushSumState",
    "pushsum_init",
    "RunConfig",
    "RunResult",
    "run_simulation",
]
