"""Hand-written CUDA kernels of the port and their host-side plans.

``classops`` (the degree-class folds) and ``pallasdelivery`` (the two
tile gathers and the fused delivery) each keep a plain PyTorch version
beside the kernel; ``build`` compiles ``csrc/*.cu`` at first use.
"""

from gossipprotocol_tpu_torch.ops import classops, pallasdelivery


def kernel_launches() -> dict:
    """Launch count of every kernel since the last reset."""
    return {**classops.LAUNCHES, **pallasdelivery.LAUNCHES}


def reset_kernel_launches() -> None:
    for table in (classops.LAUNCHES, pallasdelivery.LAUNCHES):
        for k in table:
            table[k] = 0
