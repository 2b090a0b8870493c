"""Coplanar voxel fusion: leaf planes of one physical plane merged into
single factors.  Host numpy.

Counterpart: balm_tpu/voxel/merge.py (_leaf_normals :22, merge_coplanar
:30); reference VOXEL_MERGE::push_voxel/reorganize + tras_merge
(src/benchmark/bavoxel.hpp:484-624, 873-906).  Leaves whose normals
agree within `angle_deg` and whose centre line is perpendicular to both
normals (within `perp_deg`) or shorter than `dist_thresh` are grouped
greedily against each group's first member; a group's clusters are
summed per scan and admitted again as one factor.
"""

from __future__ import annotations

import numpy as np

from ..ops.factors import PlaneFactors


def _leaf_normals(C_tot: np.ndarray):
    N = np.maximum(C_tot[:, 3, 3], 1.0)
    vbar = C_tot[:, :3, 3] / N[:, None]
    cov = (C_tot[:, :3, :3] / N[:, None, None]
           - vbar[:, :, None] * vbar[:, None, :])
    _, U = np.linalg.eigh(cov)
    return vbar, U[:, :, 0]


def merge_coplanar(f: PlaneFactors, num_planes: int, *,
                   angle_deg: float = 8.0, perp_deg: float = 80.0,
                   dist_thresh: float = 0.1,
                   weighting: str = "point_count"):
    """-> (merged PlaneFactors of numpy arrays, new_num_planes,
    group_of_leaf (num_planes,)).  `f` holds raw (not recentered)
    moments in numpy leaves, as the host voxelizer emits them.

    Thresholds are the reference's (bavoxel.hpp:513-514: cos(8 deg),
    cos(80 deg); 0.1 m at bavoxel.hpp:543).
    """
    C = np.asarray(f.C)[:num_planes]
    Cfix = np.asarray(f.Cfix)[:num_planes]
    G, W = C.shape[:2]
    if G == 0:
        return f, 0, np.zeros(0, np.int64)

    centers, normals = _leaf_normals(C.sum(axis=1) + Cfix)
    cos1 = np.cos(np.deg2rad(angle_deg))
    cos2 = np.cos(np.deg2rad(perp_deg))

    # greedy grouping against each group's FIRST member
    # (VOXEL_MERGE::reorganize, bavoxel.hpp:516-558), each leaf tested
    # against all current heads at once
    group_of = np.empty(G, np.int64)
    head_n = np.empty((G, 3))
    head_c = np.empty((G, 3))
    n_heads = 0
    for i in range(G):
        c2, d2 = centers[i], normals[i]
        gi = -1
        if n_heads:
            hn = head_n[:n_heads]
            hc = head_c[:n_heads]
            cand = np.abs(hn @ d2) > cos1
            if cand.any():
                c2c = c2 - hc
                dist = np.linalg.norm(c2c, axis=1)
                near = dist < dist_thresh
                with np.errstate(invalid="ignore", divide="ignore"):
                    u = c2c / np.maximum(dist, 1e-30)[:, None]
                perp = (np.abs(np.einsum("hj,hj->h", u, hn)) < cos2) & (
                    np.abs(u @ d2) < cos2)
                idx = np.flatnonzero(cand & (near | perp))
                if len(idx):
                    gi = int(idx[0])     # the FIRST matching head
        if gi < 0:
            gi = n_heads
            head_n[n_heads] = d2
            head_c[n_heads] = c2
            n_heads += 1
        group_of[i] = gi

    Cm = np.zeros((n_heads, W, 4, 4), C.dtype)
    Cfm = np.zeros((n_heads, 4, 4), C.dtype)
    np.add.at(Cm, group_of, C)
    np.add.at(Cfm, group_of, Cfix)

    counts = Cm[..., 3, 3]
    coe = (counts.sum(axis=1) if weighting == "point_count"
           else np.ones(n_heads, C.dtype))
    # the reference's >= 2 observer admission (bavoxel.hpp:602-606)
    coe = np.where((counts > 0).sum(axis=1) >= 2, coe, 0.0)

    Ntot = np.maximum(counts.sum(axis=1) + Cfm[:, 3, 3], 1.0)
    cent = (Cm[..., :3, 3].sum(axis=1) + Cfm[:, :3, 3]) / Ntot[:, None]

    Gpad = max(128, -(-n_heads // 128) * 128)
    pad = lambda x: np.concatenate(
        [x, np.zeros((Gpad - len(x),) + x.shape[1:], x.dtype)])
    fm = PlaneFactors(
        C=pad(Cm), Cfix=pad(Cfm), coe=pad(coe), centers=pad(cent),
        body_centers=np.zeros((Gpad, W, 3), C.dtype))
    return fm, n_heads, group_of
