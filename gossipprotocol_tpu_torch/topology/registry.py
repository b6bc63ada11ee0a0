"""Topology registry (a copy of ``gossipprotocol_tpu/topology/registry.py``).

Unknown names raise with the list of valid options. The ``edgefile:``
loader (streamed import) is not yet ported and raises.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict

from gossipprotocol_tpu_torch.topology import builders
from gossipprotocol_tpu_torch.topology.base import Topology

EDGEFILE_PREFIX = "edgefile:"

_REGISTRY: Dict[str, Callable[..., Topology]] = {
    "line": builders.build_line,
    "full": builders.build_full,
    "3D": builders.build_grid3d,
    "imp3D": builders.build_imp3d,
    "erdos_renyi": builders.build_erdos_renyi,
    "power_law": builders.build_power_law,
    "small_world": builders.build_small_world,
}

# Reference names (Program.fs match arms) plus casual aliases.
_ALIASES = {
    "line": "line",
    "full": "full",
    "3d": "3D",
    "imp3d": "imp3D",
    "imperfect3d": "imp3D",
    "er": "erdos_renyi",
    "erdos_renyi": "erdos_renyi",
    "erdos-renyi": "erdos_renyi",
    "powerlaw": "power_law",
    "small_world": "small_world",
    "small-world": "small_world",
    "smallworld": "small_world",
    "watts_strogatz": "small_world",
    "watts-strogatz": "small_world",
    "ws": "small_world",
    "power_law": "power_law",
    "power-law": "power_law",
}


def available_topologies() -> list[str]:
    return sorted(_REGISTRY)


def canonical_name(name: str) -> str:
    """Resolve a CLI alias to the registered builder name (no checks)."""
    return _ALIASES.get(name.lower(), name)


def build_topology(name: str, num_nodes: int, **kwargs) -> Topology:
    """Build topology ``name`` over ``num_nodes`` nodes.

    Builder-specific kwargs (``seed``, ``avg_degree``, ``m``, ``k``,
    ``beta``) pass through; builders that don't take them have them
    filtered out.
    """
    if name.startswith(EDGEFILE_PREFIX):
        raise NotImplementedError(
            "edgefile: topologies (the streamed edge-list import) are not "
            "yet ported to the PyTorch package")
    canonical = canonical_name(name)
    if canonical not in _REGISTRY:
        raise ValueError(
            f"unknown topology {name!r}; available: {available_topologies()}"
        )
    fn = _REGISTRY[canonical]
    params = inspect.signature(fn).parameters
    kwargs = {k: v for k, v in kwargs.items() if k in params}
    return fn(num_nodes, **kwargs)
