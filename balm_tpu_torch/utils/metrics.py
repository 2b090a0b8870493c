"""Accuracy metrics: pose RSME and ATE.

Counterpart: balm_tpu/utils/metrics.py (pose_rsme :14, ate_rmse :29);
reference `rsme` of the virtual benchmark (src/benchmark/benchmark_virtual.cpp:48-62).
"""

from __future__ import annotations

import torch

from ..ops import lie


def pose_rsme(R_est, p_est, R_gt, p_gt):
    """RSME over a window: (rot [rad], trans [m]) as 0-dim tensors.

    rot = sqrt(mean ||Log(R_gt^T R_est)||^2)
    trans = sqrt(mean ||p_est - p_gt||^2)
    """
    R_est, p_est, R_gt, p_gt = (torch.as_tensor(x)
                                for x in (R_est, p_est, R_gt, p_gt))
    # mixed precisions promote, as jnp's do (a float32 solve against
    # float64 ground truth)
    dt = R_est.dtype
    for x in (p_est, R_gt, p_gt):
        dt = torch.promote_types(dt, x.dtype)
    R_est, p_est, R_gt, p_gt = (x.to(dt) for x in (R_est, p_est, R_gt, p_gt))
    dR = torch.einsum("nji,njk->nik", R_gt, R_est)
    w = lie.so3_log(dR)
    rot = torch.sqrt(torch.mean(torch.sum(w * w, dim=-1)))
    dt = p_est - p_gt
    trans = torch.sqrt(torch.mean(torch.sum(dt * dt, dim=-1)))
    return rot, trans


def ate_rmse(p_est, p_gt):
    """Absolute trajectory error RMSE on translations (0-dim tensor)."""
    d = torch.as_tensor(p_est) - torch.as_tensor(p_gt)
    return torch.sqrt(torch.mean(torch.sum(d * d, dim=-1)))
