"""Decentralized learning on the gossip engine (port of
``gossipprotocol_tpu/learn``): Stochastic Gradient Push and GALA learner
groups over a synthetic least-squares shard per node."""

from gossipprotocol_tpu_torch.learn.data import (
    SGPBundle,
    lsq_node_grad,
    lsq_node_loss,
    make_least_squares,
)
from gossipprotocol_tpu_torch.learn.gala import make_gala_core
from gossipprotocol_tpu_torch.learn.sgp import make_sgp_core, sgp_init

__all__ = [
    "SGPBundle",
    "lsq_node_grad",
    "lsq_node_loss",
    "make_gala_core",
    "make_least_squares",
    "make_sgp_core",
    "sgp_init",
]
