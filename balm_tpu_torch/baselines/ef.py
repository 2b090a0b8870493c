"""Eigen-Factor-style gradient descent (comparison baseline).

Counterpart: balm_tpu/baselines/ef.py — _grad_only (:25) and descend
(:42); reference src/compare_test/EF_test.cpp:105-330: gradient-only
descent of lambda_min of the homogeneous plane moments with a
step-halving line search, the slowest method of the reference's tables
(SURVEY.md section 6).  The gradient comes from the port's analytic
evaluator (ops/factors.evaluate) or, with grad_only, from
torch.func.grad_and_value through ops/factors.residual_only; only the
update rule differs from BALM2's.
"""

from __future__ import annotations

import time

import torch
from torch import func as tfunc

from ..ops import factors as Fmod
from ..ops import lie
from ..ops.precision import fp32_matmul


def _grad_only(R, p, f):
    """Left-perturbation gradient without the (unused-by-EF) Hessian:
    autodiff through residual_only matches the analytic J to ~1e-13 and
    costs ~2 residual evaluations — the full-scale (G in the thousands)
    configuration, where evaluate()'s Hessian would dominate EF's loop."""
    def cost(dx):
        Rt, pt = lie.se3_left_update(R, p, dx.reshape(-1, 6))
        return Fmod.residual_only(lie.pose_matrix(Rt, pt), f)

    W = R.shape[0]
    g, res = tfunc.grad_and_value(cost)(
        torch.zeros(6 * W, dtype=R.dtype, device=R.device))
    return res, g


def descend(R, p, f: Fmod.PlaneFactors, *, max_iters=200, alpha=1.0,
            halvings=12, rel_tol=1e-8, trace=None, grad_only=False):
    """Gradient descent with backtracking. Returns (R, p, residual, iters).

    trace: optional list — on each ACCEPTED iteration, (perf_counter
    timestamp, R, p) is appended (the Supplementary 'time cost'
    convergence-curve protocol, Supplementary/data/readme.txt).
    grad_only: compute the gradient via autodiff of the residual instead
    of the analytic second-order evaluator (same values; scales to
    thousands of planes)."""
    with fp32_matmul():
        return _descend(R, p, f, max_iters, alpha, halvings, rel_tol, trace,
                        grad_only)


def _descend(R, p, f, max_iters, alpha, halvings, rel_tol, trace,
             grad_only):
    if grad_only:
        res1, J = _grad_only(R, p, f)
    else:
        res1, J, _ = Fmod.evaluate(lie.pose_matrix(R, p), f)
    npts = float(torch.clamp(torch.sum(f.C[..., 3, 3]), min=1.0))
    it = 0
    for it in range(max_iters):
        step = alpha / npts
        accepted = False
        for _ in range(halvings):
            dx = (-step * J).reshape(-1, 6)
            Rt, pt = lie.se3_left_update(R, p, dx)
            res2 = float(Fmod.residual_only(lie.pose_matrix(Rt, pt), f))
            if res2 < float(res1):
                accepted = True
                break
            step *= 0.5
        if not accepted:
            break
        R, p = Rt, pt
        if trace is not None:
            trace.append((time.perf_counter(), R.cpu().numpy(),
                          p.cpu().numpy()))
        if (float(res1) - res2) / max(float(res1), 1e-30) < rel_tol:
            res1 = res2
            break
        res1 = res2
        if grad_only:
            _, J = _grad_only(R, p, f)
        else:
            _, J, _ = Fmod.evaluate(lie.pose_matrix(R, p), f)
    return R, p, float(res1), it + 1
