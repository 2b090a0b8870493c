"""BAREG baseline — the reference's actual algorithm.

Counterpart: balm_tpu/baselines/bareg.py — cluster_stats (:35), refit
(:54), _pose_cost (:68), solve (:80), _res_gw (:156) and solve_gn
(:166); reference src/compare_test/BAREG_test.cpp:129-295 and
factors_pr.h:8-101.  A closed-form plane refit alternates with a
pose-only LM over two scalar factor families per (plane g, scan w):

  translation factor (EigenFactorTrans2, factors_pr.h:8-60):
      sqrt(N_gw) * n_g . (R_w mu_gw + t_w - mu_g)
  rotation-axis factors (EigenFactorRotAxis, factors_pr.h:62-101), k=1,2:
      sqrt(N_gw lambda_k(g,w)) * n_g . (R_w e_k(g,w))

with per-cluster body statistics computed once (BAREG_test.cpp:186-192)
and the plane normal / aggregate centroid refit from the current poses
each outer cycle (refine_normal, BAREG_test.cpp:138-160).  Every cost
is a square, so the eigenvector signs of the eigh (ops/eigh3's closed
form on the tensors' device; LAPACK's in the JAX package) do not reach
it.  `solve` is the
small-problem form (torch.func's Hessian over the joint theta);
`solve_gn` the full-scale one (per-(plane, scan) jacobians by vmap of
vmap of jacfwd, W independent 6x6 solves).
"""

from __future__ import annotations

import math
import time

import torch
from torch import func as tfunc

from ..ops import factors as Fmod
from ..ops import lie
from ..ops import smallmat as sm
from ..ops.eigh3 import eigh3
from ..ops.precision import fp32_matmul
from . import _common


def cluster_stats(f: Fmod.PlaneFactors):
    """Per-(g,w) body centroid, sqrt-weights, principal axes:
    (mu, sw_t, sw_r, axes, N) (BAREG_test.cpp:186-192)."""
    N = f.C[..., 3, 3]
    Ns = torch.clamp(N, min=1.0)
    mu = f.C[..., :3, 3] / Ns[..., None]
    cov = f.C[..., :3, :3] / Ns[..., None, None] - (
        mu[..., :, None] * mu[..., None, :])
    lam, U = eigh3(cov)
    lamN = torch.clamp(lam * N[..., None], min=0.0)
    sw_t = torch.sqrt(N)                                 # (G, W)
    sw_r = torch.sqrt(lamN[..., 1:])                     # (G, W, 2)
    axes = U[..., :, 1:]                                 # (G, W, 3, 2)
    return mu, sw_t, sw_r, axes, N


def refit(R, p, f: Fmod.PlaneFactors):
    """refine_normal (BAREG_test.cpp:138-160): aggregate world moment ->
    plane normal (sign: eigh's) + centroid per factor."""
    T = lie.pose_matrix(R, p)
    with fp32_matmul():
        TC = sm.matmul(T[None], f.C)
        Q = f.Cfix + torch.sum(sm.matmul(TC, T[None], transpose_b=True),
                               dim=1)
    Nt = torch.clamp(Q[..., 3, 3], min=1.0)
    mu_g = Q[..., :3, 3] / Nt[..., None]
    cov = (Q[..., :3, :3] / Nt[..., None, None]
           - mu_g[..., :, None] * mu_g[..., None, :])
    _, U = eigh3(cov)
    return U[..., :, 0], mu_g


def _pose_cost(theta, n_g, mu_g, mu, sw_t, sw_r, axes, W):
    rv = theta[: 3 * W].reshape(W, 3)
    pos = theta[3 * W:].reshape(W, 3)
    R = lie.so3_exp(rv)
    Rmu = torch.einsum("wab,gwb->gwa", R, mu)
    rt = sw_t * torch.einsum(
        "ga,gwa->gw", n_g, Rmu + pos[None] - mu_g[:, None])
    Rax = torch.einsum("wab,gwbk->gwak", R, axes)
    rr = sw_r * torch.einsum("ga,gwak->gwk", n_g, Rax)
    return torch.sum(rt * rt) + torch.sum(rr * rr)


def _masked_stats(f):
    """cluster_stats with the empty clusters' weights zeroed."""
    mu, sw_t, sw_r, axes, N = cluster_stats(f)
    sw_t = torch.where(N > 0.5, sw_t, 0.0)
    sw_r = torch.where(N[..., None] > 0.5, sw_r, 0.0)
    return mu, sw_t, sw_r, axes


def solve(R0, p0, f: Fmod.PlaneFactors, *, outer_iters: int = 100,
          inner_iters: int = 100, u_init: float = 1e-4,
          dx_tol: float = 1e-6, trace=None):
    """BAREG alternation. Returns (R, p, cost, total_inner_iters).

    f must hold RAW (uncentered) body moments.
    trace: optional list — (perf_counter timestamp, theta) appended on
    each accepted inner iteration; theta[:3W]/[3W:] recover (rot vecs,
    pos) outside the timed region (Supplementary curve protocol).
    """
    with fp32_matmul():
        return _solve(R0, p0, f, outer_iters, inner_iters, u_init, dx_tol,
                      trace)


def _solve(R0, p0, f, outer_iters, inner_iters, u_init, dx_tol, trace):
    W = R0.shape[0]
    mu, sw_t, sw_r, axes = _masked_stats(f)
    R = torch.as_tensor(R0, dtype=f.C.dtype, device=f.C.device)
    p = torch.as_tensor(p0, dtype=f.C.dtype, device=f.C.device)
    theta = torch.cat([lie.so3_log(R).reshape(-1), p.reshape(-1)])

    def cost(th, n_g, mu_g):
        return _pose_cost(th, n_g, mu_g, mu, sw_t, sw_r, axes, W)

    grad_fn = tfunc.grad(cost)
    hess_fn = tfunc.hessian(cost)

    total_it = 0
    c0 = math.inf
    for _cycle in range(outer_iters):
        rv = theta[: 3 * W].reshape(W, 3)
        pos = theta[3 * W:].reshape(W, 3)
        n_g, mu_g = refit(lie.so3_exp(rv), pos, f)

        last = theta
        u = u_init
        v = 2.0
        c0 = float(cost(theta, n_g, mu_g))
        for _ in range(inner_iters):
            g = grad_fn(theta, n_g, mu_g)
            H = hess_fn(theta, n_g, mu_g)
            step = _common.solve(H + u * torch.diag(torch.diag(H)), -g)
            trial = theta + step
            c1 = float(cost(trial, n_g, mu_g))
            total_it += 1
            accepted, u, v, stop = _common.lm_rule(c0, c1, u, v, 1e-10)
            if accepted:
                theta = trial
                c0 = c1
                if trace is not None:
                    trace.append((time.perf_counter(), theta.cpu().numpy()))
            if stop:
                break
        # outer stop: pose delta (iter_stop, BAREG_test.cpp:262-268)
        if float(torch.max(torch.abs(theta - last))) < dx_tol:
            break

    R = lie.so3_exp(theta[: 3 * W].reshape(W, 3))
    pos = theta[3 * W:].reshape(W, 3)
    R, pos = lie.gauge_fix(R, pos)                 # BAREG_test.cpp:281-288
    return R, pos, c0, total_it


def _res_gw(delta, Rw, pw, n, mu_g, mu, swt, swr, axes):
    """(3,) residual stack [trans, rot1, rot2] for one (plane, scan) as a
    function of the local pose perturbation — GN jacobian source."""
    Rn = lie.so3_exp(delta[None, :3])[0] @ Rw
    pn = pw + delta[3:]
    rt = swt * (n @ (Rn @ mu + pn - mu_g))
    rr = swr * (n @ (Rn @ axes))
    return torch.cat([rt[None], rr])


def _res_and_jac(Rw, pw, n, mu_g, mu, swt, swr, axes):
    z6 = torch.zeros(6, dtype=Rw.dtype, device=Rw.device)
    jac = tfunc.jacfwd(lambda d: _res_gw(d, Rw, pw, n, mu_g, mu, swt, swr,
                                         axes))(z6)
    return _res_gw(z6, Rw, pw, n, mu_g, mu, swt, swr, axes), jac


# over w (poses and the per-cluster statistics), then over g (the plane
# and the statistics): (G, W, 3), (G, W, 3, 6)
_res_and_jac_gw = tfunc.vmap(
    tfunc.vmap(_res_and_jac, in_dims=(0, 0, None, None, 0, 0, 0, 0)),
    in_dims=(None, None, 0, 0, 0, 0, 0, 0))


def _gn_step(R, p, n_g, mu_g, u, stats):
    """One damped GN step over the W independent 6x6 blocks."""
    mu, sw_t, sw_r, axes = stats
    r, J = _res_and_jac_gw(R, p, n_g, mu_g, mu, sw_t, sw_r, axes)
    H = torch.einsum("gwri,gwrj->wij", J, J)             # (W, 6, 6)
    g = torch.einsum("gwri,gwr->wi", J, r)               # (W, 6)
    D = torch.diagonal(H, dim1=-2, dim2=-1)
    A = H + u * D[..., None, :] * torch.eye(6, dtype=H.dtype,
                                            device=H.device)
    dx = _common.solve(A, -g[..., None])[..., 0]         # (W, 6)
    return lie.so3_exp(dx[:, :3]) @ R, p + dx[:, 3:]


def solve_gn(R0, p0, f: Fmod.PlaneFactors, *, outer_iters: int = 100,
             inner_iters: int = 100, u_init: float = 1e-4,
             dx_tol: float = 1e-6, trace=None):
    """BAREG at full problem scale: the same alternation as `solve`, with
    the inner pose solve as Gauss-Newton LM on per-(plane, scan)
    jacobians — the reference's Ceres configuration (BAREG_test.cpp:
    211-274; the Hessian is block-diagonal per pose since every residual
    touches exactly one pose, so the solve is W independent 6x6 blocks).
    trace: (perf_counter timestamp, R, p) on each accepted inner
    iteration."""
    with fp32_matmul():
        return _solve_gn(R0, p0, f, outer_iters, inner_iters, u_init,
                         dx_tol, trace)


def _solve_gn(R0, p0, f, outer_iters, inner_iters, u_init, dx_tol, trace):
    W = R0.shape[0]
    stats = _masked_stats(f)
    R = torch.as_tensor(R0, dtype=f.C.dtype, device=f.C.device)
    p = torch.as_tensor(p0, dtype=f.C.dtype, device=f.C.device)

    def cost(R, p, n_g, mu_g):
        theta = torch.cat([lie.so3_log(R).reshape(-1), p.reshape(-1)])
        return float(_pose_cost(theta, n_g, mu_g, *stats, W))

    total_it = 0
    c0 = math.inf
    for _cycle in range(outer_iters):
        n_g, mu_g = refit(R, p, f)
        R_last, p_last = R, p
        u = u_init
        v = 2.0
        c0 = cost(R, p, n_g, mu_g)
        for _ in range(inner_iters):
            Rt, pt = _gn_step(R, p, n_g, mu_g, u, stats)
            c1 = cost(Rt, pt, n_g, mu_g)
            total_it += 1
            accepted, u, v, stop = _common.lm_rule(c0, c1, u, v, 1e-10)
            if accepted:
                R, p = Rt, pt
                c0 = c1
                if trace is not None:
                    trace.append((time.perf_counter(), R.cpu().numpy(),
                                  p.cpu().numpy()))
            if stop:
                break
        dmax = max(float(torch.max(torch.abs(R - R_last))),
                   float(torch.max(torch.abs(p - p_last))))
        if dmax < dx_tol:
            break

    R, p = lie.gauge_fix(R, p)                   # BAREG_test.cpp:281-288
    return R, p, c0, total_it
