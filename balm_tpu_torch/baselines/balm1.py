"""BALM 1.0-style per-point second-order method (comparison baseline).

Counterpart: balm_tpu/baselines/balm1.py — PointPlanes (:26), residual
(:35), evaluate (:59) and damping_iter (:72); reference
src/compare_test/BALM1_test.cpp:103-468.  The same lambda_0 cost as
BALM2's, but with per-POINT derivatives: the cost is a closed
composition of tensor ops over the raw points, so torch.func.grad and a
forward-over-reverse Hessian (torch.func.jvp of the gradient, vmapped
over the 6W tangents) give its exact derivatives — an evaluation path
independent of the cluster kernels.

The Hessian is taken at eps = 0, where so3_exp's Taylor branch is
differentiated twice (ops/lie._sinc_coeffs keeps it NaN-free).  At the
paper's protocol size (30 scans, 512 planes, 128 points per cluster,
~2 M points) all 180 tangents at once hold tens of GB, so they run
HESS_CHUNK at a time (one batch whenever 6W <= HESS_CHUNK).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
from torch import func as tfunc

from ..ops import lie
from ..ops.eigh3 import eigvals3
from ..ops.precision import fp32_matmul
from ._common import solve

HESS_CHUNK = 16     # Hessian tangents differentiated together


class PointPlanes(NamedTuple):
    """Raw-point plane factors: points (G, W, K, 3) body frame, mask
    (G, W, K) valid flags, coe (G,)."""

    points: torch.Tensor
    mask: torch.Tensor
    coe: torch.Tensor


def point_planes_from_numpy(fields, *, device="cpu", dtype=torch.float32):
    """Numpy leaves (points, mask, coe) — e.g. `[np.asarray(x) for x in
    balm_tpu_point_planes]` — -> PointPlanes of torch tensors of `dtype`
    on `device` (ops/factors.factors_from_numpy's counterpart)."""
    return PointPlanes(*[torch.tensor(np.asarray(x), dtype=dtype,
                                      device=device) for x in fields])


def residual(R, p, f: PointPlanes):
    """sum_g coe_g lambda_0(cov of world points of plane g)."""
    with fp32_matmul():
        return _residual_impl(R, p, f)


def _residual_impl(R, p, f: PointPlanes):
    world = torch.einsum("wab,gwkb->gwka", R, f.points) + p[None, :, None, :]
    m = f.mask[..., None]
    n = torch.clamp(torch.sum(f.mask, dim=(1, 2)), min=1.0)
    mean = torch.sum(world * m, dim=(1, 2)) / n[:, None]
    d = (world - mean[:, None, None, :]) * m
    cov = torch.einsum("gwka,gwkb->gab", d, d) / n[:, None, None]
    lam0 = eigvals3(cov)[..., 0]
    return torch.sum(f.coe * lam0)


def _residual_eps(eps, R, p, f):
    W = R.shape[0]
    Rn, pn = lie.se3_left_update(R, p, eps.reshape(W, 6))
    return _residual_impl(Rn, pn, f)


def evaluate(R, p, f: PointPlanes):
    """(residual, gradient, Hessian) by autodiff over the raw points."""
    n = 6 * R.shape[0]
    eps0 = torch.zeros(n, dtype=R.dtype, device=R.device)

    def grad(e):
        return tfunc.grad(_residual_eps)(e, R, p, f)

    def column(v):
        return tfunc.jvp(grad, (eps0,), (v,))[1]

    with fp32_matmul():
        J, res = tfunc.grad_and_value(_residual_eps)(eps0, R, p, f)
        eye = torch.eye(n, dtype=R.dtype, device=R.device)
        # row j of the vmapped output is dJ/de_j, column j of jax.hessian's
        H = tfunc.vmap(column, chunk_size=HESS_CHUNK)(eye).T
    return res, J, H


def damping_iter(R, p, f: PointPlanes, max_iters=20, u=0.1, rel_tol=1e-6,
                 trace=None):
    """Plain (host-loop) LM on the per-point cost — the baseline solver.
    Deliberately unoptimized: it exists to measure the cluster kernels
    against, like the reference's compare_test drivers.  Returns (R, p,
    residual, iters).

    trace: optional list — (perf_counter timestamp, R, p) appended on
    each accepted iteration (Supplementary convergence-curve protocol)."""
    v = 2.0
    res1, J, H = evaluate(R, p, f)
    it = 0
    with fp32_matmul():
        for it in range(max_iters):
            dH = torch.diag(H)
            dx = solve(H + u * torch.diag(dH), -J)
            Rt, pt = lie.se3_left_update(R, p, dx.reshape(-1, 6))
            res2 = _residual_impl(Rt, pt, f)
            gain = float(res1 - res2)
            if gain > 0:
                R, p = Rt, pt
                if trace is not None:
                    trace.append((time.perf_counter(), R.cpu().numpy(),
                                  p.cpu().numpy()))
                q1 = 0.5 * float(torch.dot(dx, u * dH * dx - J))
                rho = gain / q1
                u *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                v = 2.0
                if abs(gain) / max(float(res1), 1e-30) < rel_tol:
                    res1 = res2
                    break
                res1, J, H = evaluate(R, p, f)
            else:
                u *= v
                v *= 2.0
                if abs(gain) / max(float(res1), 1e-30) < rel_tol:
                    break
    return R, p, float(res1), it + 1
