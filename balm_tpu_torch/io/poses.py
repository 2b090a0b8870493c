"""Pose CSV reader of the reference dataset format.

Counterpart: balm_tpu/io/poses.py (read_pose_csv :18).  Each pose is 4
lines of 4 comma-separated values: the 4x4 matrix [R | t; 0 0 0 stamp]
row by row (datas/benchmark_realworld/alidarPose.csv; the reference
reads it column-major and transposes, src/benchmark/
benchmark_realworld.cpp:48-65).
"""

from __future__ import annotations

import numpy as np


def read_pose_csv(path, max_poses=None):
    """-> (R (W,3,3), p (W,3), t (W,)) float64 arrays."""
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.strip().rstrip(",")
            if line:
                rows.append([float(x) for x in line.split(",")])
    M = np.asarray(rows, dtype=np.float64)
    if M.shape[0] % 4 != 0:
        raise ValueError(f"{path}: expected multiple of 4 lines, got "
                         f"{M.shape[0]}")
    M = M.reshape(-1, 4, 4)
    if max_poses is not None:
        M = M[:max_poses]
    return M[:, :3, :3].copy(), M[:, :3, 3].copy(), M[:, 3, 3].copy()
