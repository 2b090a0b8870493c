"""Point-cluster sufficient statistics as homogeneous 4x4 moments.

Counterpart: balm_tpu/ops/clusters.py — homogenize (:25), from_points
(:32), transform (:46), count, mean and cov (:53-71), recenter (:74),
_stack_E (:98) and stat_noise_cov (:109).  The moment of a cluster is

    C = [[P, v], [v^T, N]] = sum_i q_i q_i^T,   q_i = [p_i; 1]

(reference PointCluster, include/tools.hpp:290-349): a rigid transform
is T C T^T, a merge is a sum, the covariance P/N - vbar vbar^T.
count, mean, cov and transform work on numpy arrays (the host f64 path)
and on torch tensors alike; the rest on tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import segments


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
    # a stable sort, then each segment summed in row order: the same bits
    # on every run (a float index_add_ adds in the order its atomics land
    # on the card)
    order = torch.argsort(seg_ids, stable=True)
    return segments.sorted_segment_sum(
        outer[order].reshape(-1, 16), seg_ids[order],
        num_segments=num_segments).reshape(num_segments, 4, 4)


def transform(C, T):
    """Rigid transform of moments: T C T^T, broadcasting over batch dims
    (PointCluster::transform, tools.hpp:341-347)."""
    Tt = T.swapaxes(-1, -2) if isinstance(T, np.ndarray) else \
        T.transpose(-1, -2)
    return T @ C @ Tt


def count(C):
    """Point count N (reference PointCluster::N)."""
    return C[..., 3, 3]


def mean(C):
    """Centroid v/N with a protected denominator."""
    xp = np if isinstance(C, np.ndarray) else torch
    N = count(C)
    Ns = xp.where(N > 0.5, N, 1.0)
    return C[..., :3, 3] / Ns[..., None]


def cov(C):
    """Covariance P/N - vbar vbar^T (tools.hpp:318-322), with the
    protected denominator of mean."""
    xp = np if isinstance(C, np.ndarray) else torch
    N = count(C)
    Ns = xp.where(N > 0.5, N, 1.0)
    vbar = C[..., :3, 3] / Ns[..., None]
    return (C[..., :3, :3] / Ns[..., None, None]
            - vbar[..., :, None] * vbar[..., None, :])


def recenter(C, c):
    """Shift moments by -c: S C S^T with S = [[I, -c], [0, 1]] — the f32
    conditioning of a cluster far from the origin."""
    S = torch.eye(4, dtype=C.dtype, device=C.device).expand(
        c.shape[:-1] + (4, 4)).clone()
    S[..., :3, 3] = -c
    return transform(C, S)


# --- first-order noise covariance of the statistics (consistency/NEES) ---
#
# The reference's POINT_NOISE build carries running covariances of the
# stacked statistic s9 = (Pxx, Pxy, Pxz, Pyy, Pyz, Pzz, vx, vy, vz)
# accumulated per point through the stacking matrix B(p) = dP6/dp
# (src/simulation/toolss.hpp:315-344).  B(p) is LINEAR in p, so those
# accumulators are linear functions of (P, v, N): closed form from the
# moments.

def _stack_E(dtype=torch.float64, device="cpu"):
    """(3, 6, 3): B(p) = E_x x + E_y y + E_z z."""
    E = torch.zeros((3, 6, 3), dtype=dtype, device=device)
    E[0, 0, 0], E[0, 1, 1], E[0, 2, 2] = 2.0, 1.0, 1.0
    E[1, 1, 0], E[1, 3, 1], E[1, 4, 2] = 1.0, 2.0, 1.0
    E[2, 2, 0], E[2, 4, 1], E[2, 5, 2] = 1.0, 1.0, 2.0
    return E


def stat_noise_cov(C, sigma):
    """9x9 covariance of s9 under iid point noise sigma^2 I: the
    reference's c_cov accumulator (toolss.hpp:338-341),

        sigma^2 sum_i Bf(p_i) Bf(p_i)^T,   Bf = [B(p); I3],

    from the moments: sum B B^T = sum_{c,d} P_cd E_c E_d^T, sum B =
    sum_c v_c E_c, sum I I^T = N I.  C (..., 4, 4) -> (..., 9, 9).

    Each block is a broadcast multiply-add over the batch: the E
    products are constant (3, 3, 6, 6) and (3, 6, 3) tables contracted
    with the 9 + 3 moment entries, no batched tiny matrix products."""
    E = _stack_E(C.dtype, C.device)
    EE = E[:, None, :, None, :] * E[None, :, None, :, :]     # (3,3,6,6,3)
    EE = EE.sum(-1)                                          # (3,3,6,6)
    P = C[..., :3, :3]
    v = C[..., :3, 3]
    N = C[..., 3, 3]
    BB = sum(P[..., c, d, None, None] * EE[c, d]
             for c in range(3) for d in range(3))            # (..., 6, 6)
    B1 = sum(v[..., c, None, None] * E[c] for c in range(3))  # (..., 6, 3)
    eye3 = torch.eye(3, dtype=C.dtype, device=C.device)
    top = torch.cat([BB, B1], dim=-1)
    bot = torch.cat([B1.transpose(-1, -2), N[..., None, None] * eye3],
                    dim=-1)
    return (sigma ** 2) * torch.cat([top, bot], dim=-2)
