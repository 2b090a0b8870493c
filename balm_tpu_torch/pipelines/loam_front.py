"""LOAM-style feature front end: corner + surf two-stage scan-to-map.

Counterpart: balm_tpu/pipelines/loam_front.py — LoamFrontConfig (:41),
register_features (:60) and run (:103); the reference's alternative
front-end node `loamscan2map` (BALM-old/src/loamscan2map.cpp:1-1223).
Per sweep, the scanlines split into EDGE (high curvature) and SURF (low
curvature) features (features/loam.py), then edge points register
against a CORNER map's line landmarks and surf points against a SURF
map's plane landmarks in one joint Gauss-Newton (the reference runs the
corner and surf cost blocks in the same LM).

  * the two maps are incremental pipelines/odometry.VoxelPlaneMaps
    (host numpy, sorted packed voxel keys, batched eigendecomposition
    refresh) instead of kd-trees rebuilt per sweep;
  * the joint corner x surf IRLS solve is pipelines/odometry.
    _gn_mixed_fused on `device` (default 'cuda'; 'cpu' for the plain
    path) in float64, `reg_iters` steps per association pass with no
    host read inside them.

pipelines/odometry.run stays the primary front end; this module is the
feature-based alternative the reference ships alongside it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from ..features import loam
from . import odometry as odo


@dataclasses.dataclass
class LoamFrontConfig:
    loam: loam.LoamConfig = dataclasses.field(
        default_factory=loam.LoamConfig)
    # surf map: plane landmarks; corner map: LINE landmarks only
    surf_voxel: float = 1.0
    # corner voxels are coarser than surf voxels: an edge cluster is a
    # thin strip plus short arms of bend-adjacent wall picks; a larger
    # voxel keeps the strip's extent dominant in the line eigen test
    # (lambda_1/lambda_2 ~ (arm/extent)^2)
    corner_voxel: float = 1.0
    plane_ratio: float = 1.0 / 9.0
    line_ratio: float = 1.0 / 16.0
    min_points: int = 8
    reg_iters: int = 6
    reg_reassociate: int = 2
    huber: float = 0.1
    min_matches: int = 20


def register_features(surf_pts, edge_pts, smap, cmap,
                      cfg: LoamFrontConfig, R0, p0, *, device="cuda"):
    """Joint surf-to-plane + edge-to-line GN against the two maps, the
    GN on `device`.

    Two-stage like the reference (re-associate between GN passes).
    Returns (R, p, n_surf_used, n_edge_used), R and p numpy."""
    device = torch.device(device)
    Rn = np.asarray(R0, np.float64)
    pn = np.asarray(p0, np.float64)
    R = torch.as_tensor(Rn, device=device)
    p = torch.as_tensor(pn, device=device)
    ns = ne = 0
    for k_pass in range(cfg.reg_reassociate):
        if k_pass:
            Rn, pn = R.cpu().numpy(), p.cpu().numpy()
        sw = surf_pts @ Rn.T + pn
        rows = smap.lookup(sw)
        sel = rows >= 0
        ns = int(sel.sum())
        _, cents, norms = smap.plane_table()
        lkeys, lcents, ldirs = cmap.line_table()
        ew = edge_pts @ Rn.T + pn
        lrows = cmap.lookup_lines(ew) if len(lkeys) else \
            np.full(len(edge_pts), -1)
        lsel = lrows >= 0
        ne = int(lsel.sum())
        if ns + ne < cfg.min_matches:
            break
        m = odo._bucket_pow2(max(ns, 1), 512)
        P = np.zeros((m, 3)); P[:ns] = surf_pts[sel]
        Nn = np.zeros((m, 3)); Nn[:ns] = norms[rows[sel]]
        Cc = np.zeros((m, 3)); Cc[:ns] = cents[rows[sel]]
        mask = np.zeros((m, 1)); mask[:ns] = 1.0
        ml = odo._bucket_pow2(max(ne, 1), 128)
        Pl = np.zeros((ml, 3)); Pl[:ne] = edge_pts[lsel].reshape(-1, 3)
        Dl = np.tile(np.array([0.0, 0.0, 1.0]), (ml, 1))
        Dl[:ne] = ldirs[lrows[lsel]].reshape(-1, 3)
        Cl = np.zeros((ml, 3)); Cl[:ne] = lcents[lrows[lsel]].reshape(-1, 3)
        lmask = np.zeros((ml, 1)); lmask[:ne] = 1.0
        P, Nn, Cc, mask = odo._to_device((P, Nn, Cc, mask), device)
        Pl, Dl, Cl, lmask = odo._to_device((Pl, Dl, Cl, lmask), device)
        R, p, _cost = odo._gn_mixed_fused(
            R, p, P, Nn, Cc, mask[:, 0], Pl, Dl, Cl, lmask[:, 0], cfg.huber,
            iters=cfg.reg_iters)
    return R.cpu().numpy(), p.cpu().numpy(), ns, ne


def run(sweeps: Sequence[List[np.ndarray]],
        cfg: LoamFrontConfig = LoamFrontConfig(), *,
        verbose: bool = False, device="cuda"):
    """Process sweeps (each a list of scanline arrays) sequentially.

    Returns (R (W,3,3), p (W,3), info), numpy float64.  Feature
    extraction -> two-map scan-to-map registration (the GN on `device`)
    -> map insertion, the loamscan2map loop."""
    device = odo._device(device, "loam_front.run")
    W = len(sweeps)
    R = np.tile(np.eye(3), (W, 1, 1))
    p = np.zeros((W, 3))
    smap = odo.VoxelPlaneMap(cfg.surf_voxel, cfg.plane_ratio,
                             cfg.min_points)
    cmap = odo.VoxelPlaneMap(cfg.corner_voxel, 0.0, max(cfg.min_points
                                                        // 2, 4),
                             line_ratio=cfg.line_ratio)
    feats = [loam.extract(list(sw), cfg.loam) for sw in sweeps]
    info = {"surf_used": [], "edge_used": []}

    smap.insert(feats[0][0] @ R[0].T + p[0])
    cmap.insert(feats[0][1] @ R[0].T + p[0])
    for i in range(1, W):
        if i >= 2:
            dR = R[i - 2].T @ R[i - 1]
            dp = R[i - 2].T @ (p[i - 1] - p[i - 2])
            R[i] = odo._project_so3(R[i - 1] @ dR)
            p[i] = R[i - 1] @ dp + p[i - 1]
        else:
            R[i], p[i] = R[i - 1], p[i - 1]
        surf, edge = feats[i]
        R[i], p[i], ns, ne = register_features(
            surf, edge, smap, cmap, cfg, R[i], p[i], device=device)
        info["surf_used"].append(ns)
        info["edge_used"].append(ne)
        smap.insert(surf @ R[i].T + p[i])
        if len(edge):
            cmap.insert(edge @ R[i].T + p[i])
        if verbose and i % 10 == 0:
            print(f"sweep {i}: surf {ns}, edge {ne}")
    return R, p, info
