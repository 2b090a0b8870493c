"""Synthetic corridor benchmark for the large-window solver (W >> 177).

Counterpart: balm_tpu/pipelines/corridor.py — CorridorConfig (:34),
make_corridor (:54), corrupt_poses (:152), pose_rmse (:173) and run
(:184).  A long corridor traversal (floor + two walls tiled with planes
every `plane_spacing` m, x-facing door-frame tiles every
`pillar_spacing` m), each plane observed with per-scan point clusters by
the poses within `vis` m: the canonical large-W mapping workload with
plane locality.  make_corridor emits WindowedFactors directly in
span-compressed form, from the JAX module's np.random.default_rng
streams, so a seed gives the JAX package's scene.  The protocol follows
benchmark_virtual (src/benchmark/benchmark_virtual.cpp): ground truth,
odometry-style corrupted initialization, solve, gauge-aligned RMSE.
run() solves on the card unless the caller passes device='cpu'.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import SolverConfig
from ..ops import factors_windowed as FW
from ..ops import lie
from ..solver import large

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclass
class CorridorConfig:
    W: int = 200               # poses
    step: float = 0.4          # m between poses
    vis: float = 6.0           # plane visibility range (m)
    plane_spacing: float = 2.0  # m between plane tiles along the corridor
    pillar_spacing: float = 6.0  # m between x-facing door-frame tiles
    width: float = 4.0
    height: float = 2.5
    pts: int = 20              # points per (plane, scan) cluster
    noise: float = 0.005       # out-of-plane point noise (m)
    init_rot_noise: float = 0.035   # rad, total RMS of the drift corruption
    init_trans_noise: float = 0.08  # m, total RMS
    seed: int = 0
    dtype: str = "float32"
    max_iters: int = 30
    cg_iters: int = 100
    cg_tol: float = 1e-5


def make_corridor(cfg: CorridorConfig, device="cpu"):
    """-> (R_gt (W,3,3), p_gt (W,3), WindowedFactors), tensors of
    cfg.dtype on `device` (the scene is built in float64 numpy)."""
    rng = np.random.default_rng(cfg.seed)
    W = cfg.W
    x = np.arange(W) * cfg.step
    # gentle heading/pitch wiggle so rotations are informative
    yaw = 0.04 * np.sin(0.05 * x)
    pitch = 0.02 * np.sin(0.03 * x + 1.0)
    wvec = np.stack([np.zeros_like(yaw), pitch, yaw], axis=-1)
    R_gt = lie.so3_exp(torch.as_tensor(wvec, dtype=torch.float64)).numpy()
    p_gt = np.stack(
        [x, 0.15 * np.sin(0.02 * x), 0.05 * np.sin(0.04 * x)], axis=-1)

    # plane tiles: (center, in-plane basis e1/e2, normal, half-extents)
    L = x[-1] + cfg.step
    n_tiles = max(int(L / cfg.plane_spacing), 1)
    tiles = []
    ex = np.array([1.0, 0, 0])
    ey = np.array([0, 1.0, 0])
    ez = np.array([0, 0, 1.0])
    h2 = cfg.plane_spacing / 2
    for k in range(n_tiles):
        cx = (k + 0.5) * cfg.plane_spacing
        # floor (normal z), two walls (normal y)
        tiles.append((np.array([cx, 0, -cfg.height / 2]), ex, ey, ez,
                      (h2, cfg.width / 2)))
        tiles.append((np.array([cx, cfg.width / 2, 0]), ex, ez, ey,
                      (h2, cfg.height / 2)))
        tiles.append((np.array([cx, -cfg.width / 2, 0]), ex, ez, ey,
                      (h2, cfg.height / 2)))
    # x-facing "door frame" tiles: without them the corridor axis is
    # unobservable (every other surface is parallel to x)
    n_pillars = max(int(L / cfg.pillar_spacing), 1)
    for k in range(n_pillars):
        cx = (k + 0.5) * cfg.pillar_spacing
        for sy in (-1.0, 1.0):
            tiles.append((np.array([cx, sy * (cfg.width / 2 - 0.3), 0]),
                          ey, ez, ex, (0.25, cfg.height / 2)))
    G = len(tiles)

    centers = np.stack([t[0] for t in tiles])                  # (G, 3)
    e1 = np.stack([t[1] for t in tiles])
    e2 = np.stack([t[2] for t in tiles])
    nrm = np.stack([t[3] for t in tiles])
    ext = np.stack([t[4] for t in tiles])                      # (G, 2)

    # observation spans: poses within vis of the tile center (along x)
    first = np.searchsorted(p_gt[:, 0], centers[:, 0] - cfg.vis, "left")
    last = np.searchsorted(p_gt[:, 0], centers[:, 0] + cfg.vis, "right") - 1
    first = np.clip(first, 0, W - 1)
    last = np.clip(last, 0, W - 1)
    S = int((last - first + 1).max())

    idx_raw = first[:, None] + np.arange(S)[None, :]           # (G, S)
    valid = idx_raw <= last[:, None]   # BEFORE clipping: clipped slots
    idx = np.minimum(idx_raw, W - 1)   # must be invalid, not duplicates

    K = cfg.pts
    uv = rng.uniform(-1.0, 1.0, size=(G, S, K, 2)) * ext[:, None, None, :]
    th = rng.normal(0.0, cfg.noise, size=(G, S, K))
    world = (
        centers[:, None, None, :]
        + uv[..., 0:1] * e1[:, None, None, :]
        + uv[..., 1:2] * e2[:, None, None, :]
        + th[..., None] * nrm[:, None, None, :]
    )                                                          # (G,S,K,3)
    Rw = R_gt[idx]                                             # (G,S,3,3)
    pw = p_gt[idx]
    body = np.einsum("gskc,gscr->gskr", world - pw[:, :, None, :], Rw)
    body = body * valid[:, :, None, None]

    n = valid.astype(np.float64) * K                           # (G, S)
    v = body.sum(axis=2)                                       # (G, S, 3)
    P = np.einsum("gska,gskb->gsab", body, body)               # (G,S,3,3)

    # recenter about per-cluster centroids (f64, before any f32 cast)
    ns = np.where(n > 0.5, n, 1.0)
    b = v / ns[..., None]
    P = P - v[..., :, None] * v[..., None, :] / ns[..., None, None]

    C = np.zeros((G, S, 4, 4))
    C[..., :3, :3] = P
    C[..., 3, 3] = n
    coe = n.sum(axis=1)

    dt = _DTYPES[cfg.dtype]
    wf = FW.windowed_from_numpy(
        (C, first, coe, centers, b * valid[..., None], np.zeros((G, 4, 4))),
        device=device, dtype=dt)
    T = lambda a: torch.tensor(a, dtype=dt, device=device)
    return T(R_gt), T(p_gt), wf


def corrupt_poses(R_gt, p_gt, cfg: CorridorConfig):
    """Random-walk odometry-style corruption (cf. benchmark_virtual's
    pose noise protocol, benchmark_virtual.cpp:300-340), normalized so
    the end-of-trajectory RMS equals the configured totals at any W."""
    rng = np.random.default_rng(cfg.seed + 1)
    W = R_gt.shape[0]
    dw = rng.normal(0, 1.0, (W, 3)).cumsum(axis=0)
    dt_ = rng.normal(0, 1.0, (W, 3)).cumsum(axis=0)
    dw *= cfg.init_rot_noise / np.sqrt(3 * W)
    dt_ *= cfg.init_trans_noise / np.sqrt(3 * W)
    dw[0] = 0
    dt_[0] = 0
    T = lambda a: torch.as_tensor(a, dtype=R_gt.dtype, device=R_gt.device)
    dR = lie.so3_exp(T(dw))
    return dR @ R_gt, p_gt + T(dt_)


def pose_rmse(R_est, p_est, R_gt, p_gt):
    """Gauge-aligned RMSE (deg, m) — the virtual benchmark's metric."""
    Ra, pa = lie.gauge_fix(R_est, p_est)
    Rb, pb = lie.gauge_fix(R_gt, p_gt)
    dR = torch.einsum("nij,nik->njk", Rb, Ra)     # Rb^T Ra
    ang = lie.so3_log(dR)
    rot = float(torch.sqrt(torch.mean(torch.sum(ang ** 2, -1)))) \
        * 180.0 / np.pi
    trans = float(torch.sqrt(torch.mean(torch.sum((pa - pb) ** 2, -1))))
    return rot, trans


def run(cfg: CorridorConfig = CorridorConfig(), verbose: bool = False,
        device="cuda"):
    """Generate, corrupt, solve (damping_iter_large, its default banded
    solve); returns a result dict.  device: 'cuda' (default) or 'cpu'."""
    import time

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("corridor.run: no CUDA device; pass "
                           "device='cpu' for the plain PyTorch path")
    R_gt, p_gt, wf = make_corridor(cfg, device=device)
    R0, p0 = corrupt_poses(R_gt, p_gt, cfg)
    rot0, trans0 = pose_rmse(R0, p0, R_gt, p_gt)

    scfg = SolverConfig(max_iters=cfg.max_iters, rel_tol=1e-10,
                        min_planes_per_pose=0)
    t0 = time.perf_counter()
    res = large.damping_iter_large(
        R0, p0, wf, scfg, cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt_solve = time.perf_counter() - t0
    rot1, trans1 = pose_rmse(res.R, res.p, R_gt, p_gt)

    out = {
        "W": cfg.W,
        "planes": int(wf.num_planes),
        "span": int(wf.span),
        "iters": int(res.iters),
        "residual": float(res.residual),
        "rmse_rot_deg_init": rot0,
        "rmse_trans_m_init": trans0,
        "rmse_rot_deg": rot1,
        "rmse_trans_m": trans1,
        "solve_s": dt_solve,
        "cg_iters_per_lm": [int(k) for k in res.trace_cg[:int(res.iters)]],
    }
    if verbose:
        print(out)
    return out
