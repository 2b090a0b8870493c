"""Damped Newton / Levenberg-Marquardt loop over SE(3) pose windows.

Counterpart: balm_tpu/solver/lm.py — damping_iter (:69) for
backend='packed', update='left' and the 'cholesky', 'cholesky_nofallback'
and 'lu' solvers, with the same rules (reference BALM2::damping_iter,
src/benchmark/bavoxel.hpp:1069-1166):

  * solve (H + u D) dx = -J with D = diag(H) floored by the tau shift
    (lm.py:279-294)
  * LEFT update R' = Exp(dw) R, p' = Exp(dw) p + dt
  * gain ratio rho = (res1 - res2)/q1, q1 = 0.5 dx.(u D dx - J)
  * accept: u *= max(1/3, 1 - (2 rho - 1)^3), v = 2, recompute Hessian
  * reject: u *= v, v *= 2, reuse Hessian
  * stop on the rel/abs/ULP tests gated by solve_ok (lm.py:295-313,
    380-393) or on u overflow (:394-398)

The JAX loop is one jitted while_loop; here the host drives it.  The
device evaluates, factorizes, solves and computes the trial cost; the
host then reads ONE small tensor per iteration — (res1, res2, q1,
solve_ok) — and runs the scalar accept/damping/stop
algebra in numpy float32, the precision the JAX loop carries it in.
The evaluate is the packed path with the JAX package's `packed_impl`
and `chunk_planes` options (lm.py:190-236): the hybrid evaluate in
(j, w)-major order ('auto' and 'hybrid', the `csum` and `rows` kernels
and an fp32 product), evaluate_packed in (w, j)-major order for 'xla',
'pallas', 'pallas2' and 'pallas3' (the fused kernels B6, B4, B5), or the
chunked evaluate when chunk_planes > 0.  The kernels run on the card,
their plain versions on the CPU.
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
                 *, centered: bool = True, update: str = "left",
                 linear_solver: str = "cholesky", backend: str = "packed",
                 edges=None, hess_precision: str = "high",
                 packed_impl: str = "auto",
                 chunk_planes: int = 0) -> LMResult:
    """Run the LM loop.  R (W,3,3), p (W,3) float32 tensors; f:
    PlaneFactors with body-recentered float32 tensor leaves on the same
    device.  Only the packed backend with the left update exists in the
    port (see ROADMAP.md for the rest).

    packed_impl: 'auto' (= 'hybrid': it gives the same result as every
    other impl), 'hybrid', 'xla', 'pallas', 'pallas2' or 'pallas3' — see
    ops.packed_evaluate.evaluate_packed.  chunk_planes > 0: the chunked
    evaluate over plane chunks of that many planes (the plane axis is
    padded to a multiple of it); it ignores packed_impl, as in JAX.
    hess_precision 'high' and 'highest' both run the exact fp32 product;
    'bf16' raises (ROADMAP queue B3)."""
    if backend == "pallas":
        backend = "packed"
    if backend != "packed":
        raise NotImplementedError(f"backend={backend!r} is {_ROADMAP}")
    if update != "left":
        raise NotImplementedError(f"update={update!r} is {_ROADMAP}")
    if not centered:
        raise ValueError("packed backend requires centered=True")
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
    pe._hess_precision(hess_precision)
    if R.dtype != torch.float32:
        raise ValueError("packed backend is the float32 fast path")

    W = R.shape[0]
    f32 = np.float32
    eps = f32(np.finfo(np.float32).eps)
    degenerate = bool(int(f.planes_per_pose().min()) < cfg.min_planes_per_pose)
    pkf = packed_mod.pack_factors(f)     # once per solve, reused every iter
    # (j, w)-major H only for the hybrid evaluate without chunking
    # (balm_tpu/solver/lm.py:198-204)
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

    def per_pose(dx):
        """dx (6W,) -> (W, 6) in the evaluate's layout."""
        return dx.reshape(6, W).T if jw else dx.reshape(W, 6)

    t_res1 = np.full(cfg.max_iters, np.nan, f32)
    t_res2 = np.full(cfg.max_iters, np.nan, f32)
    t_u = np.full(cfg.max_iters, np.nan, f32)
    t_acc = np.full(cfg.max_iters, np.nan, f32)
    u, v = f32(cfg.u_init), f32(cfg.v_init)
    res1 = f32(0.0)
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
        Rt, pt = lie.se3_left_update(R, p, per_pose(dx))
        q1 = 0.5 * torch.dot(dx, float(u) * Dd * dx - J)
        res2_d = eval_res(Rt, pt)
        vals = torch.stack([res1_d, res2_d, q1, ok]).cpu().numpy()
        if linear_solver == "cholesky" and vals[3] == 0:
            # failed or non-finite Cholesky step (indefinite H + uD): this
            # iteration's step from the pivoted LU solve (lm.py:329-342)
            dx = torch.linalg.solve(A, -J)
            Rt, pt = lie.se3_left_update(R, p, per_pose(dx))
            q1 = 0.5 * torch.dot(dx, float(u) * Dd * dx - J)
            res2_d = eval_res(Rt, pt)
            vals = torch.stack([res1_d, res2_d, q1]).cpu().numpy()
            vals = np.concatenate([vals, np.ones(1, vals.dtype)])
        res1, res2, q1h = f32(vals[0]), f32(vals[1]), f32(vals[2])
        # solve_ok gates the stop tests (lm.py:295-313)
        solve_ok = bool(vals[3] != 0)

        q = f32(res1 - res2)
        accept = bool((q > 0) and np.isfinite(res2) and (res2 > 0))
        with np.errstate(all="ignore"):
            rho = f32(q / q1h)
            shrink = f32(f32(1.0) - f32(f32(2.0) * rho - f32(1.0)) ** 3)
            u_acc = f32(u * np.maximum(f32(1.0 / 3.0), shrink))
            u_rej = f32(u * v)
            rel = f32(abs(res1 - res2) / max(res1, f32(1e-30)))
        v_new = f32(2.0) if accept else f32(2.0 * v)
        u_new = u_acc if accept else u_rej
        stop = bool(rel < f32(cfg.rel_tol))
        if cfg.abs_tol > 0:
            stop = stop or bool(abs(res1 - res2) < f32(cfg.abs_tol))
        if cfg.ulp_tol > 0:
            stop = stop or bool(abs(res1 - res2)
                                < f32(cfg.ulp_tol) * eps * abs(res1))
        stop = stop and solve_ok
        stop = stop or bool(u_new > f32(1e30)) or not bool(np.isfinite(u_new))

        t_res1[it], t_res2[it], t_u[it] = res1, res2, u
        t_acc[it] = f32(1.0) if accept else f32(0.0)
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
