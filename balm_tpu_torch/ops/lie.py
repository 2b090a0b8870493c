"""Batched SO(3)/SE(3) operations on torch tensors.

Counterpart: balm_tpu/ops/lie.py, the whole module (hat/vee :26-50,
so3_exp :63, so3_log :76, so3_jr/so3_jr_inv :121-159, pose_matrix and
the left/right updates :162-187, gauge_fix :190, the centering adjoints
:200-247); reference scalar helpers hku-mars/BALM
include/tools.hpp:56-139.  The products here are float32 or float64
matrix products: callers on the solve path hold ops/precision.fp32_matmul
around them.

Conventions (same as the JAX package):
  * rotations are (..., 3, 3) matrices; translations (..., 3)
  * a pose is the pair (R, p) with world = R @ body + p
  * a twist is (..., 6) ordered (omega, rho): rotation first
  * the solver uses LEFT perturbation: T <- Exp(eps) * T
"""

from __future__ import annotations

import math

import torch

_SMALL = 1e-8


def hat(v):
    """Skew-symmetric matrix of (..., 3) -> (..., 3, 3) (tools.hpp:99-106)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def vee(M):
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack(
        [M[..., 2, 1] - M[..., 1, 2],
         M[..., 0, 2] - M[..., 2, 0],
         M[..., 1, 0] - M[..., 0, 1]],
        dim=-1,
    ) * 0.5


def _sinc_coeffs(theta2):
    """a = sin(t)/t and b = (1-cos(t))/t^2 with Taylor guards."""
    small = theta2 < _SMALL
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    return a, b


def so3_exp(w):
    """Rodrigues exponential of (..., 3) axis-angle -> (..., 3, 3)
    (tools.hpp:56-71)."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b = _sinc_coeffs(theta2)
    K = hat(w)
    K2 = K @ K
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def so3_log(R):
    """Logarithm of (..., 3, 3) rotation -> (..., 3) axis-angle
    (tools.hpp:92-97), with the theta ~ pi branch and a NaN-free small
    branch written in |K|^2 (balm_tpu/ops/lie.py:76-123)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    small = cos_t > 1.0 - 5e-7          # theta < ~1e-3
    safe_cos = torch.where(small, torch.zeros_like(cos_t),
                           torch.clamp(cos_t, -1.0 + 1e-12, 1.0))
    theta = torch.where(small, torch.zeros_like(cos_t),
                        torch.arccos(safe_cos))
    K = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2],
         R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    k2 = 0.25 * torch.sum(K * K, dim=-1)   # sin^2 theta
    sin_t = torch.where(small, torch.ones_like(theta), torch.sin(theta))
    factor = torch.where(small, 0.5 + k2 / 12.0, 0.5 * theta / sin_t)
    w_generic = factor[..., None] * K

    # near-pi branch: axis from the dominant column of R + I
    near_pi = theta > math.pi - 1e-3
    B = R + torch.eye(3, dtype=R.dtype, device=R.device)
    norms = torch.linalg.norm(B, dim=-2)
    col = torch.argmax(norms, dim=-1)
    idx = col[..., None, None].expand(*B.shape[:-1], 1)
    axis = torch.gather(B, -1, idx)[..., 0]
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True),
                              min=1e-12)
    sign = torch.sign(torch.sum(axis * K, dim=-1) + 1e-30)
    w_pi = theta[..., None] * axis * sign[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


def pose_matrix(R, p):
    """(R, p) -> homogeneous (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], p.shape[:-1])
    R = R.expand(*batch, 3, 3)
    p = p.expand(*batch, 3)
    top = torch.cat([R, p[..., None]], dim=-1)
    bottom = torch.zeros(*batch, 1, 4, dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_left_update(R, p, dx):
    """LEFT boxplus: (Exp(w) R, Exp(w) p + t) for twist dx = (w, t)
    (bavoxel.hpp:1122-1125)."""
    dR = so3_exp(dx[..., :3])
    return dR @ R, torch.einsum("...ij,...j->...i", dR, p) + dx[..., 3:]


def gauge_fix(R, p, anchor=0):
    """Re-anchor a trajectory so pose `anchor` becomes identity
    (bavoxel.hpp:1159-1164)."""
    R0 = R[anchor]
    p0 = p[anchor]
    Rf = torch.einsum("ji,njk->nik", R0, R)  # R0^T @ R_n
    pf = torch.einsum("ji,nj->ni", R0, p - p0)
    return Rf, pf


def so3_jr(w):
    """Right Jacobian of SO(3) (reference jr, tools.hpp:108-122).
    Batched (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _SMALL
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2s)
    ra = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    rb = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    axis = w / torch.where(small, torch.ones_like(theta), theta)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    aa = axis[..., :, None] * axis[..., None, :]
    return (ra[..., None, None] * eye
            + (1.0 - ra)[..., None, None] * aa
            - (rb * theta)[..., None, None] * hat(axis))


def so3_jr_inv(w):
    """Inverse right Jacobian (reference jr_inv, tools.hpp:124-139), from
    the axis-angle vector."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _SMALL
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2s)
    half = 0.5 * theta
    ctt = torch.where(small, 1.0 - theta2 / 12.0, half / torch.tan(half))
    axis = w / torch.where(small, torch.ones_like(theta), theta)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    aa = axis[..., :, None] * axis[..., None, :]
    return (ctt[..., None, None] * eye
            + (1.0 - ctt)[..., None, None] * aa
            + half[..., None, None] * hat(axis))


def se3_right_update(R, p, dx):
    """RIGHT boxplus: (R Exp(w), p + t) — the reference's alternative
    update (bavoxel.hpp:1118-1120)."""
    return R @ so3_exp(dx[..., :3]), p + dx[..., 3:]


def adjoint_translation_vec(v6, c):
    """Apply Adj([I, -c; 0, 1])^T to twist-space covectors:
    (g_w, g_r) -> (g_w + c x g_r, g_r).  v6 (..., 6), c (..., 3)
    broadcastable (balm_tpu/ops/lie.py:200)."""
    gw = v6[..., :3]
    gr = v6[..., 3:]
    c = c.expand(gr.shape)
    return torch.cat([gw + torch.linalg.cross(c, gr, dim=-1), gr], dim=-1)


def centering_hessian_correction(g_rho, c):
    """Second-order chain term of the left chart conjugated by the
    centering shift (balm_tpu/ops/lie.py:213): the extra (3, 3) w-w block

        0.5 (g c^T + c g^T) - (g . c) I,   g = shifted-frame g_rho.
    """
    outer = 0.5 * (g_rho[..., :, None] * c[..., None, :]
                   + c[..., :, None] * g_rho[..., None, :])
    dot = torch.sum(g_rho * c, dim=-1)
    return outer - dot[..., None, None] * torch.eye(
        3, dtype=g_rho.dtype, device=g_rho.device)


def adjoint_translation_mat(M66, c):
    """J^T M J with J = Adj(S) = [[I, 0], [-hat(c), I]] (twist order
    (w, r)), the matrix form of adjoint_translation_vec
    (balm_tpu/ops/lie.py:233).  M66 (..., 6, 6), c (..., 3)."""
    hc = hat(c)
    A = M66[..., :3, :3]
    B = M66[..., :3, 3:]
    C = M66[..., 3:, :3]
    D = M66[..., 3:, 3:]
    A2 = A - B @ hc
    C2 = C - D @ hc
    top = torch.cat([A2 + hc @ C2, B + hc @ D], dim=-1)
    bot = torch.cat([C2, D], dim=-1)
    return torch.cat([top, bot], dim=-2)
