"""Synthetic plane benchmark — the reference's `benchmark_virtual`.

Counterpart: balm_tpu/pipelines/virtual.py (generate :50, perturb :88,
build_factors :102, run :112); reference
src/benchmark/benchmark_virtual.cpp:524-609 (generator), 486-522
(perturbation + RSME) and its embedded solver (375-482): known
plane/scan association, no voxelization — the solver's ground-truth
oracle.

Protocol (the reference's constants):
  * trajectory: smooth interpolation from identity to a random end pose
    with |rot| = 0.5 rad, |trans| = 1 m
  * planes: 1x1 m patches, the first 3 axis-aligned, centers uniform in
    [-surf_range, surf_range]^3, thickness sigma = point_noise
  * perturbation: 2 deg / sqrt(3) per rotation axis, 0.1 / sqrt(3) m
    per translation axis
  * solver: u0 = 0.1, <= 20 iterations
  * metric: pose RSME against ground truth

Generation and perturbation run on the host in float64 numpy (SO(3)
exponentials through the port's lie on CPU float64 tensors) with the
JAX package's `default_rng` call order, so one seed gives its scene.
The scene then moves to `device` (default 'cuda') for the solve.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SolverConfig
from ..ops import clusters, factors, lie
from ..solver import lm
from ..utils import metrics

_DEG = 57.29577951308232


@dataclasses.dataclass
class VirtualConfig:
    win_size: int = 20          # winSize (launch default 20)
    surf_size: int = 20         # sufSize (launch benchmark_virtual.launch: 20)
    pts_size: int = 40          # ptsSize per (plane, scan)
    point_noise: float = 0.01   # plane thickness sigma
    surf_range: float = 2.0
    rot_noise_deg: float = 2.0
    trans_noise: float = 0.1
    seed: int = 0
    dtype: str = "float64"


def _exp(w):
    """SO(3) exponential of float64 numpy axis-angles, on the host."""
    return lie.so3_exp(torch.as_tensor(np.asarray(w, np.float64))).numpy()


def generate(cfg: VirtualConfig):
    """Ground-truth poses and per-(plane, scan) body-frame points:
    (R_gt (W,3,3), p_gt (W,3), points (G, W, K, 3)), float64 numpy."""
    rng = np.random.default_rng(cfg.seed)
    W, G, K = cfg.win_size, cfg.surf_size, cfg.pts_size

    rot_end = rng.normal(size=3)
    rot_end = rot_end / np.linalg.norm(rot_end) * 0.5
    tra_end = rng.normal(size=3)
    tra_end = tra_end / np.linalg.norm(tra_end) * 1.0

    ratios = np.arange(W) / W
    R_gt = _exp(ratios[:, None] * rot_end[None])
    p_gt = ratios[:, None] * tra_end[None]

    # plane orientations: first 3 axis-aligned (benchmark_virtual.cpp:578-587)
    rots = np.zeros((G, 3, 3))
    for i in range(G):
        if i < 3:
            fd = np.zeros(3)
            fd[i] = np.pi / 2
            rots[i] = _exp(fd)
        else:
            rots[i] = _exp(rng.uniform(-np.pi, np.pi, size=3))
    centers = rng.uniform(-cfg.surf_range, cfg.surf_range, size=(G, 3))

    # points: uniform in the plane patch, gaussian thickness
    uv = rng.uniform(-0.5, 0.5, size=(G, W, K, 2))
    th = rng.normal(0.0, cfg.point_noise, size=(G, W, K, 1))
    local = np.concatenate([uv, th], axis=-1)  # (G, W, K, 3)
    world = np.einsum("gab,gwkb->gwka", rots, local) + centers[:, None, None, :]
    # into body frame of scan w: R^T (x - p)
    body = np.einsum("wba,gwkb->gwka", R_gt, world - p_gt[None, :, None, :])
    return R_gt, p_gt, body


def perturb(R_gt, p_gt, cfg: VirtualConfig):
    """The reference's pose corruption (benchmark_virtual.cpp:491-503)."""
    rng = np.random.default_rng(cfg.seed + 1)
    W = R_gt.shape[0]
    s_rot = (cfg.rot_noise_deg / 57.3) / np.sqrt(3.0)
    s_tra = cfg.trans_noise / np.sqrt(3.0)
    drot = rng.normal(0.0, s_rot, size=(W, 3))
    dtra = rng.normal(0.0, s_tra, size=(W, 3))
    # right-multiplicative rotation noise (line 501)
    R0 = np.einsum("wab,wbc->wac", R_gt, _exp(drot))
    p0 = p_gt + dtra
    return R0, p0


def build_factors(body_points, dtype, device="cpu") -> factors.PlaneFactors:
    """Known-association cluster build (benchmark_virtual.cpp:391-403):
    the moments are summed in `dtype` on `device`."""
    G, W, K, _ = body_points.shape
    pts = torch.as_tensor(body_points.reshape(-1, 3), dtype=dtype,
                          device=device)
    seg = torch.arange(G * W, device=device).repeat_interleave(K)
    C = clusters.from_points(pts, seg, G * W).reshape(G, W, 4, 4)
    # coeffs = winSize * ptsSize (line 391)
    coe = torch.full((G,), float(W * K), dtype=dtype, device=device)
    return factors.PlaneFactors.create(C, coe=coe)


def run(cfg: VirtualConfig = VirtualConfig(),
        solver_cfg: Optional[SolverConfig] = None, *,
        centered: bool = False, verbose: bool = False, device="cuda"):
    """Full experiment on `device` (raises without a card unless
    device='cpu').  Returns a dict with the RSME before and after, iters,
    residual, degenerate and the LMResult."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("virtual.run: no CUDA device; pass "
                           "device='cpu' for the plain PyTorch path")
    if solver_cfg is None:
        solver_cfg = SolverConfig(max_iters=20, u_init=0.1,
                                  min_planes_per_pose=3)
    dtype = getattr(torch, cfg.dtype)

    R_gt, p_gt, body = generate(cfg)
    R0, p0 = perturb(R_gt, p_gt, cfg)
    f = build_factors(body, dtype, device)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    if centered:
        T0 = lie.pose_matrix(dev(R0), dev(p0))
        f = f._replace(centers=factors.estimate_centers(T0, f))

    res = lm.damping_iter(dev(R0), dev(p0), f, solver_cfg,
                          centered=centered)
    # the metric on the host in float64 (pose_rsme takes numpy arrays)
    rot0, tra0 = metrics.pose_rsme(R0, p0, R_gt, p_gt)
    rot1, tra1 = metrics.pose_rsme(
        res.R.to(torch.float64).cpu(), res.p.to(torch.float64).cpu(),
        R_gt, p_gt)
    out = {
        "rsme_rot_deg_initial": float(rot0) * _DEG,
        "rsme_trans_m_initial": float(tra0),
        "rsme_rot_deg": float(rot1) * _DEG,
        "rsme_trans_m": float(tra1),
        "iters": int(res.iters),
        "residual": float(res.residual),
        "degenerate": bool(res.degenerate),
        "result": res,
    }
    if verbose:
        print(lm.format_trace(res))
        print(f"RSME: {out['rsme_rot_deg']:.6f}deg, "
              f"{out['rsme_trans_m']:.6f}m")
    return out
