from gossipprotocol_tpu_torch.protocols.pushsum import mass, pushsum_done
from gossipprotocol_tpu_torch.protocols.state import PushSumState, pushsum_init

__all__ = ["PushSumState", "pushsum_init", "pushsum_done", "mass"]
