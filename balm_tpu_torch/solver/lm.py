"""Damped Newton / Levenberg-Marquardt loop over SE(3) pose windows.

Counterpart: balm_tpu/solver/lm.py — damping_iter (:69) with the
'xla' and 'packed' backends, the left and right updates and the
'cholesky', 'cholesky_nofallback', 'lu' and 'pcg' solvers,
damping_iter_resumable (:461) and damping_iter_timed (:509), all with
pose-graph `edges` (:257-270), with the same rules (reference
BALM2::damping_iter, src/benchmark/bavoxel.hpp:1069-1166):

  * solve (H + u D) dx = -J with D = diag(H) floored by the tau shift
    (lm.py:279-294)
  * LEFT update R' = Exp(dw) R, p' = Exp(dw) p + dt (or RIGHT:
    R' = R Exp(dw), p' = p + dt)
  * gain ratio rho = (res1 - res2)/q1, q1 = 0.5 dx.(u D dx - J)
  * accept: u *= max(1/3, 1 - (2 rho - 1)^3), v = 2, recompute Hessian
  * reject: u *= v, v *= 2, reuse Hessian
  * stop on the rel/abs/ULP tests gated by solve_ok (lm.py:295-313,
    380-393) or on u overflow (:394-398)

The JAX loop is one jitted while_loop over a `_Carry`; here the host
drives one transition, `step`, over a `_Carry` with the same fields,
shapes and dtypes.  The device evaluates, factorizes, solves and
computes the trial cost; the host then reads ONE small tensor per
iteration — (res1, res2, q1, solve_ok) — and runs the scalar
accept/damping/stop algebra in numpy in the solve's dtype (float32 or
float64), as the JAX loop carries it.  damping_iter runs the carry to
its end; damping_iter_resumable runs it in chunks and hands the carry
out as numpy arrays (a state from either package resumes in the other);
damping_iter_timed stamps the wall clock after each synchronized step.

The evaluate is either ops/factors.py's (backend 'xla': evaluate,
evaluate_right for the right update, residual_only) or the packed path
with the JAX package's `packed_impl` and `chunk_planes` options
(lm.py:190-236): the hybrid evaluate in (j, w)-major order ('auto' and
'hybrid', the `csum` and `rows` kernels and an fp32 product, unless the
solver is 'pcg', whose block-Jacobi blocks need (w, j)-major),
evaluate_packed in (w, j)-major order for 'xla', 'pallas', 'pallas2'
and 'pallas3' (the fused kernels B6, B4, B5), or the chunked evaluate
when chunk_planes > 0; with edges the hybrid evaluate too is
(w, j)-major, as in JAX.  The kernels run on the card, their plain
versions on the CPU.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import SolverConfig
from ..ops import factors as F
from ..ops import lie
from ..ops import packed as packed_mod
from ..ops import packed_evaluate as pe
from ..ops.precision import fp32_matmul
from . import large


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


class _Carry(NamedTuple):
    """The loop state, JAX's _Carry (balm_tpu/solver/lm.py:52-66): R, p,
    H and J are tensors on the solve's device; the scalars and traces
    live on the host in the solve's dtype."""
    R: torch.Tensor           # (W, 3, 3)
    p: torch.Tensor           # (W, 3)
    u: np.floating
    v: np.floating
    res1: np.floating         # accepted cost (the cached one on reject)
    H: torch.Tensor           # (6W, 6W) cached for the reject path
    J: torch.Tensor           # (6W,)
    calc_hess: bool
    it: int
    done: bool
    t_res1: np.ndarray        # (max_iters,)
    t_res2: np.ndarray
    t_u: np.ndarray
    t_acc: np.ndarray


def _solve(A, b, linear_solver, W, pcg_iters, pcg_tol):
    """-> (dx, ok) on the device: ok is 0 when the Cholesky factorization
    failed (cholesky_ex's info > 0) or the step is not finite."""
    if linear_solver == "lu":
        return (torch.linalg.solve(A, b),
                torch.ones((), dtype=A.dtype, device=A.device))
    if linear_solver == "pcg":
        # block-Jacobi CG on the damped system (lm.py:343-361)
        Ablk = torch.diagonal(A.view(W, 6, W, 6), dim1=0,
                              dim2=2).permute(2, 0, 1)
        eye = torch.eye(6, dtype=A.dtype, device=A.device)
        bad = ~torch.all(torch.isfinite(large._chol6(Ablk)), dim=(-2, -1))
        Minv = large._inv6(torch.where(bad[:, None, None], eye, Ablk))
        Minv = torch.where(
            torch.all(torch.isfinite(Minv), dim=(-2, -1))[:, None, None],
            Minv, eye)
        dx, _ = large._pcg(lambda v: A @ v, b, Minv,
                           pcg_iters if pcg_iters > 0 else min(6 * W, 400),
                           pcg_tol)
        ok = torch.all(torch.isfinite(dx))
        return torch.where(ok, dx, 0.0), ok.to(A.dtype)
    L, info = torch.linalg.cholesky_ex(A)
    dx = torch.cholesky_solve(b[:, None], L)[:, 0]
    ok = (info == 0) & torch.all(torch.isfinite(dx))
    if linear_solver == "cholesky_nofallback":
        dx = torch.where(ok, dx, torch.zeros_like(dx))
    return dx, ok.to(A.dtype)


def _check(R, cfg, centered, update, linear_solver, backend, edges,
           hess_precision, packed_impl, chunk_planes):
    """Validate damping_iter's options; returns (backend, packed_impl)
    with the aliases resolved."""
    if update == "right" and centered:
        raise ValueError("right update requires centered=False")
    if update not in ("left", "right"):
        raise ValueError(f"unknown update {update!r}")
    if edges is not None and update != "left":
        raise ValueError("pose-graph edges require the left update")
    if linear_solver not in ("cholesky", "cholesky_nofallback", "lu",
                             "pcg"):
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
        raise ValueError("damping_iter has no backend 'large': the "
                         "large-window solve is solver.large."
                         "damping_iter_large (optimize_poses' 'large')")
    elif backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    return backend, packed_impl


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
    linear_solver: 'cholesky' (LU for an iteration whose factorization
    fails), 'cholesky_nofallback', 'lu', or 'pcg' (block-Jacobi CG on
    the damped system; pcg_iters 0 means min(6W, 400), pcg_tol is the
    relative residual stop).
    packed_impl ('packed' only): 'auto' (= 'hybrid': it gives the same
    result as every other impl), 'hybrid', 'xla', 'pallas', 'pallas2' or
    'pallas3' — see ops.packed_evaluate.evaluate_packed.  chunk_planes > 0
    ('packed' only): the chunked evaluate over plane chunks of that many
    planes; it ignores packed_impl, as in JAX.  hess_precision ('packed'
    only) 'high' and 'highest' both run the exact fp32 product; 'bf16'
    raises (ROADMAP queue B3).
    edges: optional ops.pose_graph.RelPoseEdges — SE(3) relative-pose
    factors added to the plane cost, gradient and Hessian
    (pose_graph.evaluate_relpose; balm_tpu/solver/lm.py:257-270); needs
    the left update, and puts the hybrid evaluate in (w, j)-major order.

    The whole loop runs in full fp32 matrix products (TF32 off,
    ops/precision.fp32_matmul), as the JAX loop pins float32."""
    backend, packed_impl = _check(R, cfg, centered, update, linear_solver,
                                  backend, edges, hess_precision,
                                  packed_impl, chunk_planes)
    with fp32_matmul():
        cond, step, c, degenerate, eval_res = _build_loop(
            R, p, f, cfg, centered, use_lapack_eigh, update, linear_solver,
            backend, pcg_iters, pcg_tol, hess_precision, packed_impl,
            chunk_planes, edges)
        while cond(c):
            c = step(c)
        return _finish(c, degenerate, eval_res, cfg.gauge_fix)


def _packed_evals(f, hess_precision, packed_impl, chunk_planes,
                  linear_solver, edges=None):
    """(eval_full, eval_res, jw) of the packed backend: jw is True when
    the evaluate gives H in (j, w)-major order (the hybrid evaluate
    without edges, chunking and pcg, balm_tpu/solver/lm.py:198-205)."""
    pkf = packed_mod.pack_factors(f)     # once per solve, reused every iter
    jw = (packed_impl == "hybrid" and edges is None and chunk_planes == 0
          and linear_solver != "pcg")
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


def _with_edges(eval_full, eval_res, edges):
    """The evaluators with the pose-graph edges' cost, gradient and
    Hessian added (balm_tpu/solver/lm.py:257-270)."""
    if edges is None:
        return eval_full, eval_res
    from ..ops import pose_graph as PG

    def full(R, p):
        res, J, H = eval_full(R, p)
        r2, J2, H2 = PG.evaluate_relpose(R, p, edges)
        return (res + r2.to(res.dtype), J + J2.to(J.dtype),
                H + H2.to(H.dtype))

    def res_only(R, p):
        res = eval_res(R, p)
        return res + PG.relpose_cost(R, p, edges).to(res.dtype)
    return full, res_only


def _build_loop(R, p, f, cfg, centered, use_lapack_eigh, update,
                linear_solver, backend, pcg_iters, pcg_tol, hess_precision,
                packed_impl, chunk_planes, edges=None):
    """(cond, step, init, degenerate, eval_res) of the LM loop, shared by
    damping_iter, damping_iter_resumable and damping_iter_timed (JAX's
    _build_loop, balm_tpu/solver/lm.py:168-430)."""
    W = R.shape[0]
    # the host carries the scalar algebra in the solve's dtype, as the
    # JAX loop does (its ULP floor is ulp_tol * eps(dtype))
    ft = np.float32 if R.dtype == torch.float32 else np.float64
    eps = ft(np.finfo(ft).eps)
    degenerate = bool(int(f.planes_per_pose().min()) < cfg.min_planes_per_pose)
    if backend == "packed":
        eval_full, eval_res, jw = _packed_evals(
            f, hess_precision, packed_impl, chunk_planes, linear_solver,
            edges)
    else:
        eval_full, eval_res = _xla_evals(f, centered, use_lapack_eigh,
                                         update)
        jw = False
    eval_full, eval_res = _with_edges(eval_full, eval_res, edges)
    update_fn = (lie.se3_right_update if update == "right"
                 else lie.se3_left_update)

    def per_pose(dx):
        """dx (6W,) -> (W, 6) in the evaluate's layout."""
        return dx.reshape(6, W).T if jw else dx.reshape(W, 6)

    def trial(c, dx, Dd, J, u):
        Rt, pt = update_fn(c.R, c.p, per_pose(dx))
        q1 = 0.5 * torch.dot(dx, u * Dd * dx - J)
        return Rt, pt, q1, eval_res(Rt, pt)

    def step(c: _Carry) -> _Carry:
        if c.calc_hess:
            res1_d, J, H = eval_full(c.R, c.p)
        else:
            res1_d = torch.tensor(c.res1, dtype=R.dtype, device=R.device)
            J, H = c.J, c.H
        D = torch.diagonal(H)
        # damping floor: shift only when some diagonal entry is <= 0
        # (lm.py:279-294)
        tau = 2.0 * torch.clamp(-torch.min(D), min=0.0)
        Dd = D + tau
        u = float(c.u)
        A = H + u * torch.diag(Dd)
        dx, ok = _solve(A, -J, linear_solver, W, pcg_iters, pcg_tol)
        Rt, pt, q1, res2_d = trial(c, dx, Dd, J, u)
        vals = torch.stack([res1_d, res2_d, q1, ok]).cpu().numpy()
        if linear_solver == "cholesky" and vals[3] == 0:
            # failed or non-finite Cholesky step (indefinite H + uD): this
            # iteration's step from the pivoted LU solve (lm.py:329-342)
            dx = torch.linalg.solve(A, -J)
            Rt, pt, q1, res2_d = trial(c, dx, Dd, J, u)
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
            u_acc = ft(c.u * np.maximum(ft(1.0 / 3.0), shrink))
            u_rej = ft(c.u * c.v)
            rel = ft(abs(res1 - res2) / max(res1, ft(1e-30)))
        v_new = ft(2.0) if accept else ft(2.0 * c.v)
        u_new = u_acc if accept else u_rej
        stop = bool(rel < ft(cfg.rel_tol))
        if cfg.abs_tol > 0:
            stop = stop or bool(abs(res1 - res2) < ft(cfg.abs_tol))
        if cfg.ulp_tol > 0:
            stop = stop or bool(abs(res1 - res2)
                                < ft(cfg.ulp_tol) * eps * abs(res1))
        stop = stop and solve_ok
        stop = stop or bool(u_new > ft(1e30)) or not bool(np.isfinite(u_new))

        i = c.it
        t_res1, t_res2 = c.t_res1.copy(), c.t_res2.copy()
        t_u, t_acc = c.t_u.copy(), c.t_acc.copy()
        t_res1[i], t_res2[i], t_u[i] = res1, res2, c.u
        t_acc[i] = ft(1.0) if accept else ft(0.0)
        return _Carry(
            R=Rt if accept else c.R, p=pt if accept else c.p,
            u=u_new, v=v_new, res1=res2 if accept else res1, H=H, J=J,
            calc_hess=accept, it=i + 1, done=stop, t_res1=t_res1,
            t_res2=t_res2, t_u=t_u, t_acc=t_acc)

    def cond(c: _Carry) -> bool:
        return not c.done and c.it < cfg.max_iters and not degenerate

    n6 = 6 * W
    nan = np.full(cfg.max_iters, np.nan, ft)
    init = _Carry(
        R=R, p=p, u=ft(cfg.u_init), v=ft(cfg.v_init), res1=ft(0.0),
        H=torch.zeros((n6, n6), dtype=R.dtype, device=R.device),
        J=torch.zeros(n6, dtype=R.dtype, device=R.device),
        calc_hess=True, it=0, done=False,
        t_res1=nan, t_res2=nan.copy(), t_u=nan.copy(), t_acc=nan.copy())
    return cond, step, init, degenerate, eval_res


def _finish(c: _Carry, degenerate, eval_res, gauge_fix) -> LMResult:
    Rf, pf = lie.gauge_fix(c.R, c.p) if gauge_fix else (c.R, c.p)
    final_res = float(c.res1) if c.it > 0 else float(eval_res(c.R, c.p))
    return LMResult(R=Rf, p=pf, residual=final_res, iters=c.it,
                    degenerate=degenerate, trace_res1=c.t_res1,
                    trace_res2=c.t_res2, trace_u=c.t_u, trace_accept=c.t_acc)


def _state(c: _Carry) -> dict:
    """The carry as host numpy arrays of JAX's _Carry dtypes."""
    T = lambda x: x.detach().cpu().numpy()
    ft = c.t_res1.dtype.type
    return {"R": T(c.R), "p": T(c.p), "u": np.asarray(c.u, ft),
            "v": np.asarray(c.v, ft), "res1": np.asarray(c.res1, ft),
            "H": T(c.H), "J": T(c.J),
            "calc_hess": np.asarray(bool(c.calc_hess)),
            "it": np.asarray(c.it, np.int32),
            "done": np.asarray(bool(c.done)),
            "t_res1": c.t_res1.copy(), "t_res2": c.t_res2.copy(),
            "t_u": c.t_u.copy(), "t_acc": c.t_acc.copy()}


def _carry_of(state: dict, init: _Carry) -> _Carry:
    """A state dict (either package's) -> a carry shaped like init."""
    ft = init.t_res1.dtype.type
    T = lambda x, ref: torch.tensor(np.asarray(x), dtype=ref.dtype,
                                    device=ref.device)
    return _Carry(
        R=T(state["R"], init.R), p=T(state["p"], init.p),
        u=ft(state["u"]), v=ft(state["v"]), res1=ft(state["res1"]),
        H=T(state["H"], init.H), J=T(state["J"], init.J),
        calc_hess=bool(state["calc_hess"]), it=int(state["it"]),
        done=bool(state["done"]),
        **{k: np.asarray(state[k], ft).copy()
           for k in ("t_res1", "t_res2", "t_u", "t_acc")})


def damping_iter_resumable(R, p, f: F.PlaneFactors,
                           cfg: SolverConfig = SolverConfig(), *,
                           state=None, chunk_iters: int = 0,
                           centered: bool = False, backend: str = "xla",
                           packed_impl: str = "xla", edges=None):
    """Run the LM loop in checkpointable chunks; the JAX package's
    signature and defaults (balm_tpu/solver/lm.py:461).

    Returns (LMResult, state): `state` is the complete carry (poses,
    damping u/v, the cached Hessian and gradient of the reject path, the
    iteration counter, the traces) as host numpy arrays with the names,
    shapes and dtypes of JAX's _Carry.  Persist it with
    utils/checkpoint.save(..., **checkpoint.pack_lm_state(state)) and
    pass it back as `state=` (after checkpoint.unpack_lm_state) to go on
    where the solve stopped: chained chunks reproduce the one-shot
    damping_iter bit for bit (the same transition; a finished carry
    passes through further chunks unchanged).  A state from the JAX
    package resumes here and the other way round.  H and J are in the
    layout of the evaluate: (w, j)-major for backend 'xla' and every
    packed impl but 'hybrid' (packed_impl='auto' here), whose H and J
    are (j, w)-major; such a state resumes only under the same layout.

    chunk_iters: LM iterations per call (0 = on to cfg.max_iters).
    """
    backend, packed_impl = _check(R, cfg, centered, "left", "cholesky",
                                  backend, edges, "high", packed_impl, 0)
    with fp32_matmul():
        cond, step, c, degenerate, eval_res = _build_loop(
            R, p, f, cfg, centered, False, "left", "cholesky", backend, 0,
            1e-6, "high", packed_impl, 0, edges)
        if state is not None:
            c = _carry_of(state, c)
        limit = c.it + chunk_iters if chunk_iters > 0 else cfg.max_iters
        while cond(c) and c.it < limit:
            c = step(c)
        res = _finish(c, degenerate, eval_res, cfg.gauge_fix)
    return res, _state(c)


def damping_iter_timed(R, p, f: F.PlaneFactors,
                       cfg: SolverConfig = SolverConfig(), *,
                       centered: bool = False, use_lapack_eigh: bool = False,
                       backend: str = "xla", edges=None):
    """LM with real per-iteration wall-clock stamps (the Supplementary
    'time cost' convergence-curve protocol; balm_tpu/solver/lm.py:509).

    Runs damping_iter's transition with its defaults (for the packed
    backend the hybrid evaluate), so on one device its trace equals
    damping_iter's bit for bit.  One step on the initial carry, discarded, warms the
    kernels and the allocator outside the timed region; each stamp is
    taken after a torch.cuda.synchronize() on the card.  edges: as
    damping_iter's (the JAX function has none).  Returns (LMResult, times
    (iters,) seconds since the solve's start).
    """
    backend, packed_impl = _check(R, cfg, centered, "left", "cholesky",
                                  backend, edges, "high", "auto", 0)
    cuda = R.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with fp32_matmul():
        cond, step, c, degenerate, eval_res = _build_loop(
            R, p, f, cfg, centered, use_lapack_eigh, "left", "cholesky",
            backend, 0, 1e-6, "high", packed_impl, 0, edges)
        if cond(c):
            step(c)                                # warm-up, discarded
        sync()
        times = []
        t0 = time.perf_counter()
        while cond(c):
            c = step(c)
            sync()
            times.append(time.perf_counter() - t0)
        res = _finish(c, degenerate, eval_res, cfg.gauge_fix)
    return res, np.asarray(times)


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
