from gossipprotocol_tpu_torch.topology.base import Topology, csr_from_edges
from gossipprotocol_tpu_torch.topology.builders import (
    build_erdos_renyi,
    build_full,
    build_grid3d,
    build_imp3d,
    build_line,
    build_power_law,
    build_small_world,
    cube_side,
)
from gossipprotocol_tpu_torch.topology.registry import (
    available_topologies,
    build_topology,
)

__all__ = [
    "Topology",
    "csr_from_edges",
    "build_line",
    "build_full",
    "build_grid3d",
    "build_imp3d",
    "build_erdos_renyi",
    "build_power_law",
    "build_small_world",
    "cube_side",
    "build_topology",
    "available_topologies",
]
