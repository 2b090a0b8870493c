"""Point-cluster sufficient statistics as homogeneous 4x4 moments.

Counterpart: balm_tpu/ops/clusters.py — homogenize (:25), from_points
(:32), count and mean (:60-72): the part of that module the port's
factors code and pipelines call.  The moment of a cluster is

    C = [[P, v], [v^T, N]] = sum_i q_i q_i^T,   q_i = [p_i; 1]

(reference PointCluster, include/tools.hpp:290-349).  Works on numpy
arrays (the host f64 path) and on torch tensors alike.
"""

from __future__ import annotations

import numpy as np
import torch


def homogenize(points):
    """(..., 3) -> (..., 4) by appending 1."""
    one = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                     device=points.device)
    return torch.cat([points, one], dim=-1)


def from_points(points, seg_ids=None, num_segments=None):
    """Cluster moments from (N, 3) points: one (4, 4) moment, or with
    seg_ids (N,) int64 (num_segments, 4, 4) by a segment sum — the batched
    PointCluster::push (tools.hpp:311-316)."""
    q = homogenize(points)
    outer = q[..., :, None] * q[..., None, :]
    if seg_ids is None:
        return outer.sum(0)
    out = torch.zeros((num_segments, 4, 4), dtype=points.dtype,
                      device=points.device)
    return out.index_add_(0, seg_ids, outer)


def count(C):
    """Point count N (reference PointCluster::N)."""
    return C[..., 3, 3]


def mean(C):
    """Centroid v/N with a protected denominator."""
    xp = np if isinstance(C, np.ndarray) else torch
    N = count(C)
    Ns = xp.where(N > 0.5, N, 1.0)
    return C[..., :3, 3] / Ns[..., None]
