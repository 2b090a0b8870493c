"""Single configuration surface of the PyTorch port.

Counterpart: balm_tpu/config.py:18-103 — the same dataclasses with the
same defaults, as plain frozen dataclasses (no array types).  The
reference (hku-mars/BALM) scatters these across compile-time globals
(src/benchmark/bavoxel.hpp:8-19), launch files and in-code overrides
(src/benchmark/benchmark_realworld.cpp:183-185).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class VoxelConfig:
    """Adaptive voxelization (reference: bavoxel.hpp:8-19, 626-965, 1170-1223)."""

    voxel_size: float = 1.0
    # max octree depth below the root voxel (reference `layer_limit`)
    layer_limit: int = 2
    # planarity gate lambda0/lambda1 per layer (reference
    # `eigen_value_array`; realworld overrides to {1/16,1/16,1/9})
    eigen_ratio: Tuple[float, ...] = (1.0 / 16, 1.0 / 16, 1.0 / 9, 1.0 / 16)
    # minimum points for a voxel to stay alive (reference `min_ps`)
    min_points: int = 15
    # a plane voxel is frozen above this count (reference `layer_size`)
    freeze_size: int = 30
    # a factor must be observed by at least this many scans
    # (reference bavoxel.hpp:37 `process_size < 2`)
    min_observers: int = 2


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Damped Newton / LM loop (reference BALM2::damping_iter,
    bavoxel.hpp:1069-1166)."""

    max_iters: int = 10
    u_init: float = 0.01
    v_init: float = 2.0
    rel_tol: float = 1e-6         # |res1-res2|/res1 (bavoxel.hpp:1155)
    abs_tol: float = 0.0
    # f32-aware stop floor: also stop when |res1-res2| drops below
    # ulp_tol * eps(dtype) * res1 (balm_tpu/config.py:55-66); 0 disables
    ulp_tol: float = 128.0
    # every pose must observe at least this many planes, else the
    # problem is declared degenerate (bavoxel.hpp:1071-1085)
    min_planes_per_pose: int = 20
    # re-anchor the trajectory to pose 0 after optimization
    # (bavoxel.hpp:1159-1164)
    gauge_fix: bool = True


@dataclasses.dataclass(frozen=True)
class FactorConfig:
    """Plane-factor evaluation options."""

    # 'point_count': coe = sum_i N_i (bavoxel.hpp:42-44); 'unit': coe = 1
    weighting: str = "point_count"
    use_lapack_eigh: bool = False
    gap_eps: float = 1e-12


@dataclasses.dataclass(frozen=True)
class BalmConfig:
    voxel: VoxelConfig = VoxelConfig()
    solver: SolverConfig = SolverConfig()
    factor: FactorConfig = FactorConfig()
    # compute dtype of the BA: float64 runs ops/factors.py's evaluators,
    # float32 also the packed path (optimize_poses' dtype argument)
    dtype: str = "float64"

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)


DEFAULT = BalmConfig()
