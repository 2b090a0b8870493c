"""Closed-form batched symmetric 3x3 eigendecomposition on torch tensors.

Counterpart: balm_tpu/ops/eigh3.py (eigvals3 :77, eigh3 :144).  The same
trigonometric closed form (Smith 1961) with the same Newton polish and
deflation, so f32 results follow the JAX package's rather than a LAPACK
or cuSOLVER iteration's.  Eigenvalues come out ASCENDING; eigenvectors
are the COLUMNS of U and are consumed only through sign-invariant
products.
"""

from __future__ import annotations

import math

import torch


def _char_poly_coeffs(A):
    """p(l) = -l^3 + c2 l^2 + c1 l + c0 = det(A - l I)."""
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]
    c2 = a00 + a11 + a22
    c1 = -(a00 * a11 + a00 * a22 + a11 * a22) + a01 * a01 + a02 * a02 + a12 * a12
    c0 = (
        a00 * a11 * a22
        + 2.0 * a01 * a02 * a12
        - a00 * a12 * a12
        - a11 * a02 * a02
        - a22 * a01 * a01
    )
    return c0, c1, c2


def _polish_deflate(A, lam):
    """Newton-polish the best-separated root, deflate the cubic to a
    quadratic for the other two (balm_tpu/ops/eigh3.py:38-74)."""
    c0, c1, c2 = _char_poly_coeffs(A)

    def p(l):
        return ((-l + c2) * l + c1) * l + c0

    def dp(l):
        return (-3.0 * l + 2.0 * c2) * l + c1

    dps = torch.stack([torch.abs(dp(lam[..., k])) for k in range(3)], dim=-1)
    s = torch.argmax(dps, dim=-1)
    ls = torch.gather(lam, -1, s[..., None])[..., 0]
    one = torch.ones_like(ls)
    for _ in range(3):
        d = dp(ls)
        safe = torch.abs(d) > 1e-300
        ls = torch.where(safe, ls - p(ls) / torch.where(safe, d, one), ls)

    beta = ls - c2
    gamma = ls * beta - c1
    disc = torch.clamp(beta * beta - 4.0 * gamma, min=0.0)
    sq = torch.sqrt(disc)
    qq = -0.5 * (beta + torch.where(beta >= 0, sq, -sq))
    r1 = qq
    nz = torch.abs(qq) > 1e-300
    r2 = torch.where(nz, gamma / torch.where(nz, qq, one), -0.5 * beta)
    out = torch.stack([ls, r1, r2], dim=-1)
    return torch.sort(out, dim=-1).values


def eigvals3(A):
    """Eigenvalues (ascending) of symmetric (..., 3, 3) -> (..., 3)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-1, -2)) / 6.0
    small = p2 < 1e-30
    p = torch.sqrt(torch.where(small, torch.ones_like(p2), p2))
    Bn = B / p[..., None, None]
    b00 = Bn[..., 0, 0]
    b11 = Bn[..., 1, 1]
    b22 = Bn[..., 2, 2]
    b01 = Bn[..., 0, 1]
    b02 = Bn[..., 0, 2]
    b12 = Bn[..., 1, 2]
    det = (b00 * (b11 * b22 - b12 * b12)
           - b01 * (b01 * b22 - b12 * b02)
           + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(det * 0.5, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e2 = q + 2.0 * p * torch.cos(phi)
    e0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e1 = 3.0 * q - e0 - e2
    lam = torch.stack([e0, e1, e2], dim=-1)
    lam = torch.where(small[..., None], q[..., None].expand_as(lam), lam)
    return _polish_deflate(A, lam)


def _null_vector(M):
    """Best unit null vector of (..., 3, 3) via row cross products;
    returns (vector, quality)."""
    r0 = M[..., 0, :]
    r1 = M[..., 1, :]
    r2 = M[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    c = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None],
        c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    nmax = torch.maximum(torch.maximum(n01, n02), n12)
    pos = nmax > 0
    safe = torch.where(
        pos, torch.sqrt(torch.where(pos, nmax, torch.ones_like(nmax))),
        torch.ones_like(nmax))
    return c / safe[..., None], nmax


def _any_orthogonal(u):
    """Some unit vector orthogonal to unit u (..., 3)."""
    ex = torch.zeros_like(u)
    ex[..., 0] = 1.0
    ez = torch.zeros_like(u)
    ez[..., 2] = 1.0
    a = torch.linalg.cross(u, ex)
    small = (torch.sum(a * a, dim=-1) < 1e-8)[..., None]
    a = torch.where(small, torch.linalg.cross(u, ez), a)
    return a / torch.linalg.norm(a, dim=-1, keepdim=True)


def eigh3(A):
    """Full decomposition of symmetric (..., 3, 3) -> (lam ascending,
    U with eigenvectors in columns), like torch.linalg.eigh."""
    eye3 = torch.eye(3, dtype=A.dtype, device=A.device)
    m = torch.amax(torch.abs(A), dim=(-1, -2))
    degenerate_all = m < 1e-30
    ms = torch.where(degenerate_all, torch.ones_like(m), m)
    An = A / ms[..., None, None]
    lam_n = eigvals3(An)

    v0, q0 = _null_vector(An - lam_n[..., 0, None, None] * eye3)
    v2, q2 = _null_vector(An - lam_n[..., 2, None, None] * eye3)

    lam0_sep = (lam_n[..., 1] - lam_n[..., 0]) >= (lam_n[..., 2] - lam_n[..., 1])
    primary = torch.where(lam0_sep[..., None], v0, v2)
    q_primary = torch.where(lam0_sep, q0, q2)
    ez = torch.zeros_like(primary)
    ez[..., 2] = 1.0
    primary = torch.where((q_primary < 1e-24)[..., None], ez, primary)

    other_raw = torch.where(lam0_sep[..., None], v2, v0)
    other = other_raw - torch.sum(other_raw * primary, dim=-1,
                                  keepdim=True) * primary
    n_other = torch.sum(other * other, dim=-1)
    small_o = n_other < 1e-12
    other = torch.where(
        small_o[..., None],
        _any_orthogonal(primary),
        other / torch.sqrt(torch.where(small_o, torch.ones_like(n_other),
                                       n_other))[..., None],
    )

    u0 = torch.where(lam0_sep[..., None], primary, other)
    u2 = torch.where(lam0_sep[..., None], other, primary)
    u1 = torch.linalg.cross(u2, u0)

    U = torch.stack([u0, u1, u2], dim=-1)
    U = torch.where(degenerate_all[..., None, None], eye3.expand_as(U), U)
    lam = torch.where(degenerate_all[..., None], torch.zeros_like(lam_n),
                      lam_n * ms[..., None])
    return lam, U
