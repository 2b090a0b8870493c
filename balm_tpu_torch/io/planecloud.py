"""Headless plane-cloud export (the reference's tras_display without ROS).

Counterpart: balm_tpu/io/planecloud.py (leaf_colors :18,
export_plane_cloud :30); reference src/benchmark/bavoxel.hpp:825-871.
Each point is coloured by its plane leaf and written as an ASCII PLY
plus an NPZ of the raw association.  Host numpy.
"""

from __future__ import annotations

import pathlib

import numpy as np


def leaf_colors(num_leaves: int, seed: int = 0) -> np.ndarray:
    """Random saturated RGB colour per leaf (num_leaves, 3) uint8."""
    rng = np.random.default_rng(seed)
    hue = rng.random(num_leaves)
    # HSV -> RGB with s = 0.9, v = 1
    h6 = hue * 6.0
    k = np.stack([(h6 + 5) % 6, (h6 + 3) % 6, (h6 + 1) % 6])
    rgb = 1.0 - 0.9 * np.clip(np.minimum(k, 4 - k), 0, 1)
    return (rgb.T * 255).astype(np.uint8)


def export_plane_cloud(scans, R, p, point_scan, point_leaf, path,
                       *, max_points: int | None = 2_000_000, seed: int = 0):
    """Write <path>.ply and <path>.npz with the world points coloured by
    leaf; returns the PLY's path.

    scans: list of (Ni, 3) body clouds; R (W,3,3), p (W,3) poses (numpy);
    point_scan / point_leaf: the host voxelizer's per-point association
    (grid.VoxelizeResult).  Points with leaf < 0 are dropped, as
    tras_display shows only the surviving plane voxels.
    """
    body = np.concatenate(scans)
    R = np.asarray(R)
    p = np.asarray(p)
    sel = point_leaf >= 0
    body = body[sel]
    sid = point_scan[sel]
    leaf = point_leaf[sel]
    world = np.einsum("nab,nb->na", R[sid], body) + p[sid]
    if max_points is not None and len(world) > max_points:
        step = len(world) // max_points + 1
        world = world[::step]
        leaf = leaf[::step]
    nleaf = int(leaf.max()) + 1 if len(leaf) else 0
    colors = (leaf_colors(nleaf, seed)[leaf] if nleaf
              else np.zeros((0, 3), np.uint8))
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    ply = path.with_suffix(".ply")
    with open(ply, "w") as fh:
        fh.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(world)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n")
        np.savetxt(fh, np.column_stack([world.astype(np.float32), colors]),
                   fmt="%.4f %.4f %.4f %d %d %d")
    np.savez_compressed(path.with_suffix(".npz"),
                        world=world.astype(np.float32),
                        leaf=leaf.astype(np.int32))
    return str(ply)
