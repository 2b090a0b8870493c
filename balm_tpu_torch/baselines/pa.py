"""Plane-Adjustment / BAREG-style baseline: explicit plane parameters,
in cluster form.

Counterpart: balm_tpu/baselines/pa.py — refit_planes (:35), _pose_cost
(:52) and alternate (:69); reference src/compare_test/PA_test.cpp:104-304
and BAREG_test.cpp:129-295.  Both keep explicit planes pi = (n, d) and
minimize point-to-plane distances; in cluster form

    sum_points (n . x + d)^2  =  pi^T (T C T^T) pi

so the method alternates (a) a closed-form plane refit (eliminate d,
then the smallest eigenvector of a 3x3, ops/eigh3) and (b) a
Gauss-Newton pose solve on that quadratic, with torch.func's gradient
and Hessian in place of jax.grad / jax.hessian.
"""

from __future__ import annotations

import torch
from torch import func as tfunc

from ..ops import factors as Fmod
from ..ops import lie
from ..ops import smallmat as sm
from ..ops.eigh3 import eigh3
from ..ops.precision import fp32_matmul
from ._common import solve


def refit_planes(T, f: Fmod.PlaneFactors):
    """Closed-form optimal planes per factor: (n (G,3), d (G,)); the sign
    of (n, d) is eigh3's."""
    with fp32_matmul():
        TC = sm.matmul(T[None], f.C)
        Q = f.Cfix + torch.sum(sm.matmul(TC, T[None], transpose_b=True),
                               dim=1)
    N = torch.clamp(Q[..., 3, 3], min=1.0)
    q = Q[..., :3, 3]
    P = Q[..., :3, :3]
    # eliminate d: cost(n) = n^T (P - q q^T / N) n  -> smallest eigvec
    S = P - q[..., :, None] * q[..., None, :] / N[..., None, None]
    _, U = eigh3(S)
    n = U[..., :, 0]
    d = -torch.sum(q * n, dim=-1) / N
    return n, d


def _pose_cost(eps, R, p, f, n, d):
    with fp32_matmul():
        return _pose_cost_impl(eps, R, p, f, n, d)


def _pose_cost_impl(eps, R, p, f, n, d):
    W = R.shape[0]
    Rn, pn = lie.se3_left_update(R, p, eps.reshape(W, 6))
    T = lie.pose_matrix(Rn, pn)
    TC = sm.matmul(T[None], f.C)
    A = sm.matmul(TC, T[None], transpose_b=True)        # (G, W, 4, 4)
    pi = torch.cat([n, d[..., None]], dim=-1)           # (G, 4)
    cost_gi = torch.einsum("ga,gwab,gb->gw", pi, A, pi)
    valid = (f.coe > 0)[:, None]
    return torch.sum(torch.where(valid, cost_gi, 0.0))


def alternate(R, p, f: Fmod.PlaneFactors, *, outer_iters=20, gn_iters=3,
              rel_tol=1e-7):
    """Alternating plane-refit / pose-GN. Returns (R, p, cost, iters).

    R, p: tensors or arrays, taken in f's dtype on f's device."""
    R = torch.as_tensor(R, dtype=f.C.dtype, device=f.C.device)
    p = torch.as_tensor(p, dtype=f.C.dtype, device=f.C.device)
    W = R.shape[0]
    grad = tfunc.grad(_pose_cost)
    hess = tfunc.hessian(_pose_cost)
    eps0 = torch.zeros(6 * W, dtype=R.dtype, device=R.device)
    eye = torch.eye(6 * W, dtype=R.dtype, device=R.device)

    prev = None
    it = 0
    with fp32_matmul():
        for it in range(outer_iters):
            n, d = refit_planes(lie.pose_matrix(R, p), f)
            for _ in range(gn_iters):
                g = grad(eps0, R, p, f, n, d)
                H = hess(eps0, R, p, f, n, d)
                dx = solve(H + 1e-9 * torch.trace(H) / (6 * W) * eye, -g)
                R, p = lie.se3_left_update(R, p, dx.reshape(W, 6))
            c = float(_pose_cost_impl(eps0, R, p, f, n, d))
            if prev is not None and abs(prev - c) < rel_tol * max(prev,
                                                                  1e-30):
                prev = c
                break
            prev = c
    Rf, pf = lie.gauge_fix(R, p)
    return Rf, pf, prev, it + 1
