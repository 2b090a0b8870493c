"""Point-cluster sufficient statistics as homogeneous 4x4 moments.

Counterpart: balm_tpu/ops/clusters.py:60-72 (count, mean) — the part of
that module the port's factors code calls.  The moment of a cluster is

    C = [[P, v], [v^T, N]] = sum_i q_i q_i^T,   q_i = [p_i; 1]

(reference PointCluster, include/tools.hpp:290-349).  Works on numpy
arrays (the host f64 path) and on torch tensors alike.
"""

from __future__ import annotations

import numpy as np
import torch


def count(C):
    """Point count N (reference PointCluster::N)."""
    return C[..., 3, 3]


def mean(C):
    """Centroid v/N with a protected denominator."""
    xp = np if isinstance(C, np.ndarray) else torch
    N = count(C)
    Ns = xp.where(N > 0.5, N, 1.0)
    return C[..., :3, 3] / Ns[..., None]
