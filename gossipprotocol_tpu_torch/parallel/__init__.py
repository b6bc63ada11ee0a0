"""Sharded execution (port of ``gossipprotocol_tpu/parallel``): the push
design's diffusion push-sum over S shards placed on the run's card."""

from gossipprotocol_tpu_torch.parallel.mesh import (  # noqa: F401
    NODES_AXIS, make_mesh, padded_size, placement_line,
)
from gossipprotocol_tpu_torch.parallel.sharded import (  # noqa: F401
    make_sharded_chunk_runner, pad_state, run_simulation_sharded,
)
