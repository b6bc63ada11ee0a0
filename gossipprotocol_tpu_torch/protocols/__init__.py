from gossipprotocol_tpu_torch.protocols.pushsum import mass, pushsum_done
from gossipprotocol_tpu_torch.protocols.state import (
    GossipState, PushSumState, gossip_init, pushsum_init,
)

__all__ = ["GossipState", "PushSumState", "gossip_init", "pushsum_init",
           "pushsum_done", "mass"]
