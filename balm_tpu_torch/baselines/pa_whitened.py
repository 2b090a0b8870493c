"""PA (Plane Adjustment) baseline — the reference's actual algorithm.

Counterpart: balm_tpu/baselines/pa_whitened.py — init_planes (:37),
_cost (:53), solve (:68), _rt (:128) and solve_schur (:141); reference
src/compare_test/PA_test.cpp:104-304: joint optimization over poses AND
explicit planes pi (3-vector, n = pi/|pi|, d = |pi|), with the whitened
4-dim point-to-plane residual per (plane, scan)

    r = Gmat_gw [R_w^T n_g ; p_w . n_g + d_g],   Gmat^T Gmat = M_gw

evaluated as the quadratic form rt^T M rt of the raw homogeneous body
moment M_gw.  `solve` is the damped Newton over the joint parameter
vector with torch.func's dense Hessian (the small-problem form);
`solve_schur` is the full-scale form: batched (plane, scan) jacobians
(vmap of vmap of jacfwd) and one (6W, 6W) reduced solve per iteration
with the planes eliminated (PA_test.cpp's Ceres DENSE_SCHUR).  The final
gauge re-anchors pose 0 (PA_test.cpp:296-303).
"""

from __future__ import annotations

import time

import torch
from torch import func as tfunc

from ..ops import factors as Fmod
from ..ops import lie
from ..ops import smallmat as sm
from ..ops.eigh3 import eigh3
from ..ops.precision import fp32_matmul
from . import _common


def _as(x, f):
    return torch.as_tensor(x, dtype=f.C.dtype, device=f.C.device)


def init_planes(T, f: Fmod.PlaneFactors):
    """pi = d*n from the aggregate world covariance (PA_test.cpp:244-249),
    its sign fixed by d > 0."""
    with fp32_matmul():
        TC = sm.matmul(T[None], f.C)
        Q = f.Cfix + torch.sum(sm.matmul(TC, T[None], transpose_b=True),
                               dim=1)
    N = torch.clamp(Q[..., 3, 3], min=1.0)
    center = Q[..., :3, 3] / N[..., None]
    cov = (Q[..., :3, :3] / N[..., None, None]
           - center[..., :, None] * center[..., None, :])
    _, U = eigh3(cov)
    n = U[..., :, 0]
    d = -torch.sum(n * center, dim=-1)
    # the reference parameterizes pi = d n with d = |pi| > 0
    sign = torch.where(d < 0, -1.0, 1.0)
    return (d * sign)[:, None] * (n * sign[:, None])


def _plane_cost(R, pos, pis, M):
    d = torch.linalg.norm(pis, dim=-1)
    n = pis / torch.clamp(d, min=1e-12)[:, None]
    Rtn = torch.einsum("wab,ga->gwb", R, n)                 # R^T n
    pn = torch.einsum("wa,ga->gw", pos, n) + d[:, None]     # (G, W)
    rt = torch.cat([Rtn, pn[..., None]], dim=-1)            # (G, W, 4)
    return torch.sum(torch.einsum("gwa,gwab,gwb->gw", rt, M, rt))


def _cost(theta, M, W, G):
    """theta = [rot_vecs (3W), pos (3W), pis (3G)]; M (G, W, 4, 4)."""
    rv = theta[: 3 * W].reshape(W, 3)
    pos = theta[3 * W: 6 * W].reshape(W, 3)
    pis = theta[6 * W:].reshape(G, 3)
    return _plane_cost(lie.so3_exp(rv), pos, pis, M)


def solve(R0, p0, f: Fmod.PlaneFactors, *, max_iters: int = 100,
          u_init: float = 1e-4, ftol: float = 1e-10, trace=None):
    """Joint damped-Newton PA. Returns (R, p, cost, iters).

    f must hold RAW (uncentered) body moments — f.C IS the M matrix.
    trace: optional list — (perf_counter timestamp, theta) appended on
    each accepted iteration; theta[:3W]/[3W:6W] recover (rot vecs, pos)
    outside the timed region (Supplementary convergence-curve protocol).
    """
    with fp32_matmul():
        return _solve(_as(R0, f), _as(p0, f), f, max_iters, u_init, ftol,
                      trace)


def _solve(R0, p0, f, max_iters, u_init, ftol, trace):
    W = R0.shape[0]
    G = f.num_planes
    M = f.C
    pis = init_planes(lie.pose_matrix(R0, p0), f)
    theta = torch.cat([lie.so3_log(R0).reshape(-1), p0.reshape(-1),
                       pis.reshape(-1)])

    def cost(th):
        return _cost(th, M, W, G)

    grad_fn = tfunc.grad(cost)
    hess_fn = tfunc.hessian(cost)

    u = u_init
    v = 2.0
    c0 = float(cost(theta))
    it = 0
    for it in range(1, max_iters + 1):
        g = grad_fn(theta)
        H = hess_fn(theta)
        step = _common.solve(H + u * torch.diag(torch.diag(H)), -g)
        trial = theta + step
        c1 = float(cost(trial))
        accepted, u, v, stop = _common.lm_rule(c0, c1, u, v, ftol)
        if accepted:
            theta = trial
            c0 = c1
            if trace is not None:
                trace.append((time.perf_counter(), theta.cpu().numpy()))
        if stop:
            break

    R = lie.so3_exp(theta[: 3 * W].reshape(W, 3))
    pos = theta[3 * W: 6 * W].reshape(W, 3)
    R, pos = lie.gauge_fix(R, pos)                       # PA_test.cpp:296-303
    return R, pos, c0, it


def _rt(delta, dpi, R, p, pi):
    """Whitened residual direction [(Exp(d) R)^T n ; (p + dp) . n + d] for
    one (plane, scan) pair, as a function of the local perturbation — the
    jacobian source for the Gauss-Newton Schur solve."""
    Rw = lie.so3_exp(delta[None, :3])[0] @ R
    pw = p + delta[3:]
    piw = pi + dpi
    d = torch.linalg.norm(piw)
    n = piw / torch.clamp(d, min=1e-12)
    return torch.cat([Rw.transpose(-1, -2) @ n, (pw @ n + d)[None]])


def solve_schur(R0, p0, f: Fmod.PlaneFactors, *, max_iters: int = 100,
                u_init: float = 1e-4, ftol: float = 1e-10, trace=None):
    """PA at full problem scale: Gauss-Newton LM with the planes
    eliminated by a dense Schur complement — the reference's Ceres
    DENSE_SCHUR configuration (PA_test.cpp:278-283) expressed as batched
    jacobians + one (6W, 6W) reduced solve per iteration.

    Identical cost/residual model to `solve` (the faithful small-problem
    form); this variant scales to G in the thousands where the joint
    (6W+3G)^2 system is out of reach.  trace: (perf_counter timestamp,
    R, p) on each accepted iteration.
    """
    with fp32_matmul():
        return _solve_schur(_as(R0, f), _as(p0, f), f, max_iters, u_init,
                            ftol, trace)


def _rt_and_jac(R, p, pi):
    """(rt (4,), d rt / d (delta, dpi) (4, 9)) at the current point."""
    z9 = torch.zeros(9, dtype=R.dtype, device=R.device)
    jac = tfunc.jacfwd(lambda dl: _rt(dl[:6], dl[6:], R, p, pi))(z9)
    return _rt(z9[:6], z9[6:], R, p, pi), jac


# over w (R, p), then over g (pi): (G, W, 4), (G, W, 4, 9)
_rt_and_jac_gw = tfunc.vmap(tfunc.vmap(_rt_and_jac, in_dims=(0, 0, None)),
                            in_dims=(None, None, 0))


def _schur_step(R, p, pis, u, M, obs):
    """One damped GN step with the planes eliminated: (dx (W, 6),
    dpi (G, 3))."""
    W = R.shape[0]
    rt, J = _rt_and_jac_gw(R, p, pis)                    # (G,W,4),(G,W,4,9)
    MJ = torch.einsum("gwab,gwbj->gwaj", M, J) * obs[..., None, None]
    # cost = rt^T M rt -> grad = 2 J^T M rt, GN Hessian = 2 J^T M J
    A = 2.0 * torch.einsum("gwai,gwaj->gwij", J, MJ)     # (G, W, 9, 9)
    g_all = 2.0 * torch.einsum("gwa,gwaj->gwj", rt, MJ)  # (G, W, 9)
    Hpp = torch.sum(A[..., :6, :6], dim=0)               # (W, 6, 6)
    Hgg = torch.sum(A[..., 6:, 6:], dim=1)               # (G, 3, 3)
    U = A[..., :6, 6:]                                   # (G, W, 6, 3)
    gp = torch.sum(g_all[..., :6], dim=0)                # (W, 6)
    gg = torch.sum(g_all[..., 6:], dim=1)                # (G, 3)

    eye3 = torch.eye(3, dtype=M.dtype, device=M.device)
    Hgg_d = Hgg + u * eye3 * torch.clamp(
        torch.diagonal(Hgg, dim1=-2, dim2=-1), min=1e-12)[..., None, :]
    K = _common.inv(Hgg_d)                               # (G, 3, 3)

    # reduced system S = blockdiag(Hpp + uD) - sum_g U K U^T; the block
    # diagonal written through a diagonal view of S (no scatter)
    Dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    Hpp_d = Hpp + u * Dpp[..., None, :] * torch.eye(6, dtype=M.dtype,
                                                    device=M.device)
    UK = torch.einsum("gwac,gcd->gwad", U, K)            # (G, W, 6, 3)
    S = -torch.einsum("gwad,gvbd->wavb", UK, U)          # (W, 6, W, 6)
    torch.diagonal(S, dim1=0, dim2=2).add_(Hpp_d.permute(1, 2, 0))
    rhs = -gp.reshape(-1) + torch.einsum("gwad,gd->wa", UK, gg).reshape(-1)
    dx = _common.solve(S.reshape(6 * W, 6 * W), rhs)    # (6W,)
    dxw = dx.reshape(W, 6)
    dpi = -torch.einsum(
        "gcd,gd->gc", K, gg + torch.einsum("gwdc,wd->gc", U, dxw))
    return dxw, dpi


def _solve_schur(R, p, f, max_iters, u_init, ftol, trace):
    M = f.C                                              # (G, W, 4, 4)
    pis = init_planes(lie.pose_matrix(R, p), f)
    obs = (M[..., 3, 3] > 0.5).to(M.dtype)               # (G, W)

    u = u_init
    v = 2.0
    c0 = float(_plane_cost(R, p, pis, M))
    it = 0
    for it in range(1, max_iters + 1):
        dxw, dpi = _schur_step(R, p, pis, u, M, obs)
        Rt = lie.so3_exp(dxw[:, :3]) @ R
        pt = p + dxw[:, 3:]
        pit = pis + dpi
        c1 = float(_plane_cost(Rt, pt, pit, M))
        accepted, u, v, stop = _common.lm_rule(c0, c1, u, v, ftol)
        if accepted:
            R, p, pis = Rt, pt, pit
            c0 = c1
            if trace is not None:
                trace.append((time.perf_counter(), R.cpu().numpy(),
                              p.cpu().numpy()))
        if stop:
            break

    R, p = lie.gauge_fix(R, p)                           # PA_test.cpp:296-303
    return R, p, c0, it
