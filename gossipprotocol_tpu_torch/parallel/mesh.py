"""Shard placement (port of ``gossipprotocol_tpu/parallel/mesh.py``).

In the JAX package a mesh is a 1-D ``jax.sharding.Mesh`` over the
``"nodes"`` axis, one device per shard. Here a mesh is a list of S
``torch.device``\\ s, one per shard. The sharded engine
(``parallel/sharded.py``) places every shard on the run's one card
(``cuda``, or ``cpu`` when asked) and runs the shards in lockstep: the
counterpart of the JAX package's 8-device CPU test mesh on one host.
Shards on separate cards are not placed yet.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from gossipprotocol_tpu_torch.ops.build import resolve_device

NODES_AXIS = "nodes"


def make_mesh(num_devices: Optional[int] = None,
              device="cuda") -> List[torch.device]:
    """``num_devices`` shards (default 1), every one on ``device`` (the
    run's card unless the caller asks for ``cpu``; raises when ``cuda``
    is asked for and no card is present)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    num = 1 if num_devices is None else int(num_devices)
    if num < 1:
        raise ValueError(f"a mesh needs at least one shard, got {num}")
    return [dev] * num


def placement_line(mesh: List[torch.device]) -> str:
    """One line naming where the shards live, e.g. ``4 shards on 1 card
    (cuda:0)``."""
    cards = sorted({str(d) for d in mesh})
    where = "card" if mesh[0].type == "cuda" else "host CPU"
    return (f"{len(mesh)} shard{'s' if len(mesh) != 1 else ''} on "
            f"{len(cards)} {where}{'s' if len(cards) != 1 else ''} "
            f"({', '.join(cards)})")


def padded_size(n: int, num_shards: int) -> int:
    """n rounded up to a multiple of the shard count (phantom rows are
    dead-and-converged so they never influence the protocol)."""
    return ((n + num_shards - 1) // num_shards) * num_shards
