"""gossipprotocol_tpu_torch — the PyTorch/CUDA port of gossipprotocol_tpu.

The JAX package (``gossipprotocol_tpu``) is the reference; this package
grows beside it slice by slice and imports neither JAX nor it. Ported so
far: the reference's own surface (``python -m gossipprotocol_tpu_torch N
topology gossip|push-sum``: gossip and fanout-one push-sum over the
scatter delivery, drawing from the counter-based threefry stream),
fanout-all diffusion push-sum over the fused gather delivery (``--fanout
all --delivery pallas``), the Clos-routed delivery (``--delivery
routed``), the K-round megakernel (``--delivery megakernel
--rounds-per-kernel K``) and sharded over S shards with the push design
(``--devices S``), with twelve TPU kernels rewritten as CUDA for Hopper
(``csrc/``), and the plan cache; the reference semantics
(``--semantics reference``), whose push-sum walk runs a chunk of hops as
one kernel on the card (``csrc/walk.cu``); the probes; the host libraries
(``native.py``: routing, graph building, the actor-semantics oracle),
``--check``, ``--backend`` and the curve tools (``experiments``); fault
schedules and loss windows (``utils/faults.py``), topology events and
churn (``events/``), overlay repair (``topology/repair.py``), checkpoints
and resume (``utils/checkpoint.py``) and the health sentinel, on one
card.
Entry points run on ``cuda`` unless asked for ``cpu``, where each
kernel's plain PyTorch version runs instead.
"""

from gossipprotocol_tpu_torch.version import __version__
from gossipprotocol_tpu_torch.topology import (
    Topology,
    available_topologies,
    build_topology,
)
from gossipprotocol_tpu_torch.protocols import (
    GossipState, PushSumState, gossip_init, pushsum_init,
)
from gossipprotocol_tpu_torch.engine import RunConfig, RunResult, run_simulation

__all__ = [
    "__version__",
    "Topology",
    "build_topology",
    "available_topologies",
    "GossipState",
    "PushSumState",
    "gossip_init",
    "pushsum_init",
    "RunConfig",
    "RunResult",
    "run_simulation",
]
