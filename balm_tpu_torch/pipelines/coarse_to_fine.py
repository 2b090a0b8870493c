"""Coarse-to-fine multi-resolution bundle adjustment.

Counterpart: balm_tpu/pipelines/coarse_to_fine.py (default_stages :27,
run :36).  The reference README's recipe for poor initial trajectories
(README.md:5, "Notes for real-world experiments"): BA with a large voxel
and loose plane criteria first, then re-association at smaller voxels
with stricter criteria from the refined poses.  Association is the host
voxelizer in f64; each stage's solve is lm.damping_iter with its
defaults (backend 'xla'), on `device`.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import SolverConfig, VoxelConfig
from ..ops import factors as Fmod
from ..solver import lm
from ..voxel import grid


def default_stages() -> List[VoxelConfig]:
    """4 -> 2 -> 1 m voxels, 1/9 -> 1/16 ratio (loose -> strict)."""
    return [
        VoxelConfig(voxel_size=4.0, eigen_ratio=(1 / 9, 1 / 9, 1 / 9)),
        VoxelConfig(voxel_size=2.0, eigen_ratio=(1 / 12, 1 / 12, 1 / 12)),
        VoxelConfig(voxel_size=1.0, eigen_ratio=(1 / 16, 1 / 16, 1 / 9)),
    ]


def run(scans: Sequence[np.ndarray], R: np.ndarray, p: np.ndarray,
        stages: Optional[List[VoxelConfig]] = None,
        solver_cfg: SolverConfig = SolverConfig(max_iters=10, u_init=0.01),
        *, dtype: str = "float64", centered: bool = False,
        verbose: bool = False, device="cuda"):
    """Iterate (associate at the current poses -> solve) over the stages.

    Returns (R, p, per-stage summaries) with R, p float64 numpy."""
    if stages is None:
        stages = default_stages()
    tdt = getattr(torch, dtype)
    R = np.asarray(R, np.float64)
    p = np.asarray(p, np.float64)
    history = []
    for si, vcfg in enumerate(stages):
        t0 = time.perf_counter()
        vres = grid.voxelize(scans, R, p, vcfg, dtype=np.float64)
        t_assoc = time.perf_counter() - t0
        f = Fmod.recenter_bodies(vres.factors) if centered else vres.factors
        f = Fmod.factors_from_numpy(f, device=device, dtype=tdt)

        t0 = time.perf_counter()
        res = lm.damping_iter(
            torch.tensor(R, dtype=tdt, device=device),
            torch.tensor(p, dtype=tdt, device=device), f, solver_cfg,
            centered=centered)
        t_solve = time.perf_counter() - t0

        R = res.R.cpu().numpy().astype(np.float64)
        p = res.p.cpu().numpy().astype(np.float64)
        info = {
            "stage": si,
            "voxel_size": vcfg.voxel_size,
            "num_planes": vres.num_planes,
            "iters": int(res.iters),
            "residual_initial": float(res.trace_res1[0]),
            "residual_final": float(res.residual),
            "degenerate": bool(res.degenerate),
            "t_assoc_s": t_assoc,
            "t_solve_s": t_solve,
        }
        history.append(info)
        if verbose:
            print(f"stage {si}: voxel {vcfg.voxel_size} m, "
                  f"{vres.num_planes} planes, "
                  f"{info['residual_initial']:.2f} -> "
                  f"{info['residual_final']:.2f} ({info['iters']} iters)")
    return R, p, history
