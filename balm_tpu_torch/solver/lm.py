"""Damped Newton / Levenberg-Marquardt loop over SE(3) pose windows.

Counterpart: balm_tpu/solver/lm.py — damping_iter (:69) with the
'xla' and 'packed' backends, the left and right updates and the
'cholesky', 'cholesky_nofallback' and 'lu' solvers, with the same rules
(reference BALM2::damping_iter, src/benchmark/bavoxel.hpp:1069-1166):

  * solve (H + u D) dx = -J with D = diag(H) floored by the tau shift
    (lm.py:279-294)
  * LEFT update R' = Exp(dw) R, p' = Exp(dw) p + dt (or RIGHT:
    R' = R Exp(dw), p' = p + dt)
  * gain ratio rho = (res1 - res2)/q1, q1 = 0.5 dx.(u D dx - J)
  * accept: u *= max(1/3, 1 - (2 rho - 1)^3), v = 2, recompute Hessian
  * reject: u *= v, v *= 2, reuse Hessian
  * stop on the rel/abs/ULP tests gated by solve_ok (lm.py:295-313,
    380-393) or on u overflow (:394-398)

The JAX loop is one jitted while_loop; here the host drives it.  The
device evaluates, factorizes, solves and computes the trial cost; the
host then reads ONE small tensor per iteration — (res1, res2, q1,
solve_ok) — and runs the scalar accept/damping/stop algebra in numpy in
the solve's dtype (float32 or float64), as the JAX loop carries it.
The evaluate is either ops/factors.py's (backend 'xla': evaluate,
evaluate_right for the right update, residual_only) or the packed path
with the JAX package's `packed_impl` and `chunk_planes` options
(lm.py:190-236): the hybrid evaluate in (j, w)-major order ('auto' and
'hybrid', the `csum` and `rows` kernels and an fp32 product),
evaluate_packed in (w, j)-major order for 'xla', 'pallas', 'pallas2'
and 'pallas3' (the fused kernels B6, B4, B5), or the chunked evaluate
when chunk_planes > 0.  The kernels run on the card, their plain
versions on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SolverConfig
from ..ops import factors as F
from ..ops import lie
from ..ops import packed as packed_mod
from ..ops import packed_evaluate as pe
from ..ops.precision import fp32_matmul

_ROADMAP = "not ported yet (ROADMAP.md, queue A)"


class LMResult(NamedTuple):
    R: torch.Tensor           # (W, 3, 3) refined rotations
    p: torch.Tensor           # (W, 3) refined translations
    residual: float           # final accepted cost
    iters: int                # LM iterations executed
    degenerate: bool          # some pose saw < min_planes_per_pose
    trace_res1: np.ndarray    # (max_iters,) cost before step (nan = unused)
    trace_res2: np.ndarray    # (max_iters,) trial cost
    trace_u: np.ndarray       # (max_iters,) damping
    trace_accept: np.ndarray  # (max_iters,) 1.0 accepted / 0.0 rejected


def _solve(A, b, linear_solver):
    """-> (dx, ok) on the device: ok is 0 when the Cholesky factorization
    failed (cholesky_ex's info > 0) or its step is not finite."""
    if linear_solver == "lu":
        return (torch.linalg.solve(A, b),
                torch.ones((), dtype=A.dtype, device=A.device))
    L, info = torch.linalg.cholesky_ex(A)
    dx = torch.cholesky_solve(b[:, None], L)[:, 0]
    ok = (info == 0) & torch.all(torch.isfinite(dx))
    if linear_solver == "cholesky_nofallback":
        dx = torch.where(ok, dx, torch.zeros_like(dx))
    return dx, ok.to(A.dtype)


def damping_iter(R, p, f: F.PlaneFactors, cfg: SolverConfig = SolverConfig(),
                 *, centered: bool = False, use_lapack_eigh: bool = False,
                 update: str = "left", linear_solver: str = "cholesky",
                 backend: str = "xla", edges=None,
                 pcg_iters: int = 0, pcg_tol: float = 1e-6,
                 hess_precision: str = "high", packed_impl: str = "auto",
                 chunk_planes: int = 0) -> LMResult:
    """Run the LM loop.  R (W,3,3), p (W,3) float32 or float64 tensors;
    f: PlaneFactors with tensor leaves on the same device.  The signature
    and defaults are the JAX package's (balm_tpu/solver/lm.py:69-75).

    backend: 'xla' (ops/factors.py's evaluators, any float dtype; with
    centered=True the factors must be body-recentered and carry centers)
    or 'packed' (alias 'pallas': the packed f32 path of
    ops/packed_evaluate.py, which needs centered=True, the left update,
    float32 and body-recentered factors).
    update: 'left' (production, bavoxel.hpp:1122-1125) or 'right'
    (bavoxel.hpp:1118-1120; raw moments, centered=False, 'xla').
    use_lapack_eigh: torch.linalg.eigh in place of the closed-form 3x3
    eigh ('xla' only).
    packed_impl ('packed' only): 'auto' (= 'hybrid': it gives the same
    result as every other impl), 'hybrid', 'xla', 'pallas', 'pallas2' or
    'pallas3' — see ops.packed_evaluate.evaluate_packed.  chunk_planes > 0
    ('packed' only): the chunked evaluate over plane chunks of that many
    planes; it ignores packed_impl, as in JAX.  hess_precision ('packed'
    only) 'high' and 'highest' both run the exact fp32 product; 'bf16'
    raises (ROADMAP queue B3).  linear_solver 'pcg' (with pcg_iters,
    pcg_tol) and pose-graph `edges` are not ported yet and raise.

    The whole loop runs in full fp32 matrix products (TF32 off,
    ops/precision.fp32_matmul), as the JAX loop pins float32."""
    if update == "right" and centered:
        raise ValueError("right update requires centered=False")
    if update not in ("left", "right"):
        raise ValueError(f"unknown update {update!r}")
    if edges is not None:
        raise NotImplementedError(f"pose-graph edges are {_ROADMAP}")
    if linear_solver == "pcg":
        raise NotImplementedError(f"linear_solver='pcg' is {_ROADMAP}")
    if linear_solver not in ("cholesky", "cholesky_nofallback", "lu"):
        raise ValueError(f"unknown linear_solver {linear_solver!r}")
    if packed_impl == "auto":
        packed_impl = "hybrid"
    if packed_impl not in pe.IMPLS:
        raise ValueError(f"unknown packed_impl {packed_impl!r}")
    if chunk_planes < 0:
        raise ValueError(f"chunk_planes must be >= 0, got {chunk_planes}")
    if backend == "pallas":
        backend = "packed"
    if backend == "packed":
        if not centered or update != "left":
            raise ValueError(
                "packed backend requires centered=True, left update")
        pe._hess_precision(hess_precision)
        if R.dtype != torch.float32:
            raise ValueError("packed backend is the float32 fast path")
    elif backend == "large":
        raise NotImplementedError(f"backend={backend!r} is {_ROADMAP}")
    elif backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    with fp32_matmul():
        return _damping_iter(R, p, f, cfg, centered, use_lapack_eigh,
                             update, linear_solver, backend,
                             hess_precision, packed_impl, chunk_planes)


def _packed_evals(f, hess_precision, packed_impl, chunk_planes):
    """(eval_full, eval_res, jw) of the packed backend: jw is True when
    the evaluate gives H in (j, w)-major order (the hybrid evaluate
    without chunking, balm_tpu/solver/lm.py:198-204)."""
    pkf = packed_mod.pack_factors(f)     # once per solve, reused every iter
    jw = packed_impl == "hybrid" and chunk_planes == 0
    if chunk_planes > 0:
        pkf = packed_mod.pad_planes(pkf, chunk_planes)
        n_chunks = pkf.gp // chunk_planes
        chunks = pe._chunk_pk(pkf, n_chunks)   # copied once per solve

        def eval_full(R, p):
            return pe.evaluate_packed_chunked(
                R, p, pkf, n_chunks=n_chunks, hess_precision=hess_precision,
                chunks=chunks)

        def eval_res(R, p):
            return pe.residual_only_packed_chunked(
                R, p, pkf, n_chunks=n_chunks, chunks=chunks)
    else:
        def eval_full(R, p):
            if jw:
                return pe.evaluate_packed_jw(R, p, pkf,
                                             hess_precision=hess_precision)
            return pe.evaluate_packed(R, p, pkf, impl=packed_impl,
                                      hess_precision=hess_precision)

        def eval_res(R, p):
            return pe.residual_only_packed(R, p, pkf)
    return eval_full, eval_res, jw


def _xla_evals(f, centered, use_lapack_eigh, update):
    """(eval_full, eval_res) of the XLA-formulated evaluators
    (balm_tpu/solver/lm.py:241-254)."""
    def eval_full(R, p):
        T = lie.pose_matrix(R, p)
        if update == "right":
            return F.evaluate_right(T, f, use_lapack_eigh=use_lapack_eigh)
        return F.evaluate(T, f, centered=centered,
                          use_lapack_eigh=use_lapack_eigh)

    def eval_res(R, p):
        return F.residual_only(lie.pose_matrix(R, p), f, centered=centered,
                               use_lapack_eigh=use_lapack_eigh)
    return eval_full, eval_res


def _damping_iter(R, p, f, cfg, centered, use_lapack_eigh, update,
                  linear_solver, backend, hess_precision, packed_impl,
                  chunk_planes):
    W = R.shape[0]
    # the host carries the scalar algebra in the solve's dtype, as the
    # JAX loop does (its ULP floor is ulp_tol * eps(dtype))
    ft = np.float32 if R.dtype == torch.float32 else np.float64
    eps = ft(np.finfo(ft).eps)
    degenerate = bool(int(f.planes_per_pose().min()) < cfg.min_planes_per_pose)
    if backend == "packed":
        eval_full, eval_res, jw = _packed_evals(f, hess_precision,
                                                packed_impl, chunk_planes)
    else:
        eval_full, eval_res = _xla_evals(f, centered, use_lapack_eigh,
                                         update)
        jw = False
    step = lie.se3_right_update if update == "right" else lie.se3_left_update

    def per_pose(dx):
        """dx (6W,) -> (W, 6) in the evaluate's layout."""
        return dx.reshape(6, W).T if jw else dx.reshape(W, 6)

    t_res1 = np.full(cfg.max_iters, np.nan, ft)
    t_res2 = np.full(cfg.max_iters, np.nan, ft)
    t_u = np.full(cfg.max_iters, np.nan, ft)
    t_acc = np.full(cfg.max_iters, np.nan, ft)
    u, v = ft(cfg.u_init), ft(cfg.v_init)
    res1 = ft(0.0)
    res1_d = H = J = None
    calc_hess = True
    it = 0
    done = False
    while not done and it < cfg.max_iters and not degenerate:
        if calc_hess:
            res1_d, J, H = eval_full(R, p)
        D = torch.diagonal(H)
        # damping floor: shift only when some diagonal entry is <= 0
        # (lm.py:279-294)
        tau = 2.0 * torch.clamp(-torch.min(D), min=0.0)
        Dd = D + tau
        A = H + float(u) * torch.diag(Dd)
        dx, ok = _solve(A, -J, linear_solver)
        Rt, pt = step(R, p, per_pose(dx))
        q1 = 0.5 * torch.dot(dx, float(u) * Dd * dx - J)
        res2_d = eval_res(Rt, pt)
        vals = torch.stack([res1_d, res2_d, q1, ok]).cpu().numpy()
        if linear_solver == "cholesky" and vals[3] == 0:
            # failed or non-finite Cholesky step (indefinite H + uD): this
            # iteration's step from the pivoted LU solve (lm.py:329-342)
            dx = torch.linalg.solve(A, -J)
            Rt, pt = step(R, p, per_pose(dx))
            q1 = 0.5 * torch.dot(dx, float(u) * Dd * dx - J)
            res2_d = eval_res(Rt, pt)
            vals = torch.stack([res1_d, res2_d, q1]).cpu().numpy()
            vals = np.concatenate([vals, np.ones(1, vals.dtype)])
        res1, res2, q1h = ft(vals[0]), ft(vals[1]), ft(vals[2])
        # solve_ok gates the stop tests (lm.py:295-313)
        solve_ok = bool(vals[3] != 0)

        q = ft(res1 - res2)
        accept = bool((q > 0) and np.isfinite(res2) and (res2 > 0))
        with np.errstate(all="ignore"):
            rho = ft(q / q1h)
            shrink = ft(ft(1.0) - ft(ft(2.0) * rho - ft(1.0)) ** 3)
            u_acc = ft(u * np.maximum(ft(1.0 / 3.0), shrink))
            u_rej = ft(u * v)
            rel = ft(abs(res1 - res2) / max(res1, ft(1e-30)))
        v_new = ft(2.0) if accept else ft(2.0 * v)
        u_new = u_acc if accept else u_rej
        stop = bool(rel < ft(cfg.rel_tol))
        if cfg.abs_tol > 0:
            stop = stop or bool(abs(res1 - res2) < ft(cfg.abs_tol))
        if cfg.ulp_tol > 0:
            stop = stop or bool(abs(res1 - res2)
                                < ft(cfg.ulp_tol) * eps * abs(res1))
        stop = stop and solve_ok
        stop = stop or bool(u_new > ft(1e30)) or not bool(np.isfinite(u_new))

        t_res1[it], t_res2[it], t_u[it] = res1, res2, u
        t_acc[it] = ft(1.0) if accept else ft(0.0)
        if accept:
            R, p, res1 = Rt, pt, res2
        u, v = u_new, v_new
        calc_hess = accept
        it += 1
        done = stop

    Rf, pf = (lie.gauge_fix(R, p) if cfg.gauge_fix else (R, p))
    final_res = float(res1) if it > 0 else float(eval_res(R, p))
    return LMResult(R=Rf, p=pf, residual=final_res, iters=it,
                    degenerate=degenerate, trace_res1=t_res1,
                    trace_res2=t_res2, trace_u=t_u, trace_accept=t_acc)


def format_trace(result: LMResult) -> str:
    """Render the LM trace in the reference's comparable format
    (bavoxel.hpp:1132: `iter%d: (res1 res2) u: ...`)."""
    lines = []
    for i in range(int(result.iters)):
        r1 = float(result.trace_res1[i])
        r2 = float(result.trace_res2[i])
        u = float(result.trace_u[i])
        acc = "accept" if result.trace_accept[i] > 0.5 else "reject"
        if np.isnan(r1):
            break
        lines.append(f"iter{i}: ({r1:.6f} {r2:.6f}) u: {u:.6f} {acc}")
    return "\n".join(lines)
