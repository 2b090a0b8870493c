"""balm_tpu_torch: the PyTorch + CUDA port of balm_tpu (lidar bundle
adjustment).

A second package beside the JAX reference `balm_tpu`, with the same
module paths and function names.  It imports torch, numpy and ctypes
only: never jax, never balm_tpu.  Its one-call entry point runs on the
GPU unless the caller passes device='cpu', where every CUDA kernel is
replaced by its plain PyTorch version.
"""

from .config import BalmConfig, FactorConfig, SolverConfig, VoxelConfig


def optimize_poses(*args, **kwargs):
    """One-call BA over a pose window — see balm_tpu_torch.api."""
    from .api import optimize_poses as _f

    return _f(*args, **kwargs)


__version__ = "0.1.0"
