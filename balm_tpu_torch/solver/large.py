"""Large-window LM over span-compressed factors: the banded direct solve
or block-Jacobi PCG on the implicit normal equations.

Counterpart: balm_tpu/solver/large.py — LMOps (:42), LargeLMResult
(:77), _chol6 (:89), _inv6 (:94), _precond_apply (:108), _pcg (:114),
windowed_ops (:155), damping_iter_large (:241), _Carry (:293) and
lm_loop (:312).  The reference caps BA at a dense (6W, 6W) LDLT
(bavoxel.hpp:1113-1114); this solver keeps the SAME damping algebra
(solver/lm.py) and replaces the dense factorization by the
block-tridiagonal banded LU (solver/banded.py, linear_solver='banded',
the default) or a block-Jacobi PCG ('pcg') on

    (H + u diag(H)) dx = -J,    H = -R^T R + blockdiag(D)

with R the factored rank rows of ops/factors_windowed.py.  Neither forms
(6W)^2: memory is O(G S + W S^2).

JAX runs the LM loop as one while_loop on the device.  Here the host
drives one transition per iteration over a `_Carry` with JAX's fields:
the device evaluates (only after an accepted step: reject-reuse of the
parts), solves, updates and computes the trial cost; the host then reads
ONE small tensor, (res1, res2, q1, |dx|^2, |J|^2, CG iterations), and
runs the accept / tau-shifted damping / stop algebra in numpy in the
solve's dtype.  The CG loop (`_pcg`) reads its `active` flag once every
_CHECK_EVERY iterations.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..config import SolverConfig
from ..ops import factors_windowed as FW
from ..ops import lie
from ..ops.precision import fp32_matmul
from ..parallel import sharded
from . import banded as _banded

_CHECK_EVERY = 16


def _chol6(A):
    """Batched 6x6 Cholesky factors; NaN where a block is not positive
    definite (jnp.linalg.cholesky's result there)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[:, None, None], L, torch.nan)


def _inv6(A):
    """Batched symmetrized 6x6 inverse of the block-Jacobi
    preconditioner; NaN where a block is singular.  M^-1 only steers CG,
    so the inverse's roundoff is harmless; symmetrizing keeps it a
    valid CG preconditioner."""
    Minv, info = torch.linalg.inv_ex(A)
    Minv = torch.where((info == 0)[:, None, None], Minv, torch.nan)
    return 0.5 * (Minv + Minv.transpose(-1, -2))


def _precond_apply(Minv, r):
    """z = M^-1 r by the cached block inverses; r flat (6W,)."""
    W = Minv.shape[0]
    return (Minv @ r.view(W, 6, 1)).reshape(-1)


def _pcg(matvec, b, Minv, max_iters, tol):
    """Preconditioned CG for A x = b -> (x, iterations (a 0-d tensor)).

    Minv: (W, 6, 6) block-Jacobi inverse blocks (see _inv6).  Truncated
    at non-positive curvature, keeping the partial step (LM then rejects
    and raises u), as in JAX.  Each iteration is guarded (a finished
    carry passes through unchanged by torch.where); the host reads the
    `active` flag once every _CHECK_EVERY iterations, so a finished solve
    costs at most _CHECK_EVERY - 1 guarded no-op iterations.
    """
    x = torch.zeros_like(b)
    r = b
    z = _precond_apply(Minv, r)
    p = z
    rz = torch.dot(r, z)
    bnorm = torch.sqrt(torch.dot(b, b))
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    ok = torch.ones((), dtype=torch.bool, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    n = 0
    while n < max_iters:
        active = ok & (k < max_iters) & (torch.sqrt(torch.dot(r, r)) > tol * bnorm)
        if n % _CHECK_EVERY == 0 and not bool(active):
            break
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        posdef = pAp > 0
        alpha = torch.where(posdef, rz / torch.where(posdef, pAp, one), 0.0)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = _precond_apply(Minv, r_n)
        rz_n = torch.dot(r_n, z)
        beta = rz_n / torch.where(rz == 0, one, rz)
        p_n = z + beta * p
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        p = torch.where(active, p_n, p)
        rz = torch.where(active, rz_n, rz)
        k = torch.where(active, k + 1, k)
        ok = torch.where(active, posdef, ok)
        n += 1
    return x, k


class LMOps(NamedTuple):
    """The solver schedule's linear-algebra engine (JAX :42-74).

    evaluate: (R, p) -> (res, J_flat, diagH_flat, parts)
    residual: (R, p) -> scalar trial cost
    matvec:   (parts, Dd_flat, u, v_flat) -> (H + u diag(Dd)) v, flat
    precond:  (parts, u, Dd_flat) -> (W, 6, 6) block-Jacobi blocks
    dot:      inner product
    update:   (R, p, dx_flat) -> trial poses (left perturbation)
    reduce_min: min of a flat array
    direct:   EXACT direct solve (parts, Dd_flat, u, J_flat) -> (dx, ok),
              the banded LU (linear_solver='banded')
    """

    evaluate: Callable[..., Any]
    residual: Callable[..., Any]
    matvec: Callable[..., Any]
    precond: Callable[..., Any]
    dot: Callable[..., Any]
    update: Callable[..., Any]
    reduce_min: Any = None
    direct: Any = None


class LargeLMResult(NamedTuple):
    R: torch.Tensor
    p: torch.Tensor
    residual: float
    iters: int
    trace_res1: np.ndarray
    trace_res2: np.ndarray
    trace_u: np.ndarray
    trace_accept: np.ndarray
    trace_cg: np.ndarray      # CG iterations used per LM iteration (int32)


def windowed_ops(wf, W: int, supernode: int | None = None,
                 edges=None) -> LMOps:
    """Single-device or plane-sharded engine over WindowedFactors (JAX
    :155-237).

    wf: WindowedFactors on one device, or parallel.sharded.ShardedFactors
    of them (plane-sharded, sorted by base, R and p on the mesh's home
    device): each shard's parts stay on its device; res, J and diag(H)
    are summed over the shards, `matvec` sums the shards' H v, `precond`
    their block-Jacobi blocks and `direct` their bands, each with one
    Mesh.psum (JAX's GSPMD inserts the same psums).

    edges: optional ops.pose_graph.RelPoseEdges — SE(3) relative-pose
    factors added to the plane cost, on the home device.  Every edge must
    satisfy i < j and j - i < span so its Hessian blocks stay inside the
    band.

    The (plane, slot) -> pose map of each shard and the edges' scatter
    orders are sorted once here; every pose reduction of the solve is a
    segment sum over them (deterministic on the card).
    """
    B = max(int(wf.span), 1) if supernode is None else int(supernode)
    S = int(wf.span)
    if isinstance(wf, sharded.ShardedFactors):
        shards, psum = wf.shards, wf.mesh.psum
    else:
        shards, psum = (wf,), (lambda xs: xs[0])
    segs = [FW.pose_segments(s.base, S, W) for s in shards]
    if edges is not None:
        from ..ops import pose_graph as PG

        ei, ej = edges.i, edges.j
        pose_ids = torch.cat([ei, ej])
        pose_order = torch.argsort(pose_ids, stable=True)
        band_ids = ei * S + (ej - ei)          # Hband[i, j - i], flat
        band_order = torch.argsort(band_ids, stable=True)

        def pose_sum(a, b):
            """rows a at poses i plus rows b at poses j -> (W, ...)."""
            return PG.scatter_rows(pose_ids, torch.cat([a, b]), W,
                                   pose_order)

    def on_shards(fn, parts, *home):
        """psum of fn(shard parts, *home tensors on the shard's device)."""
        return psum([fn(q, *(x.to(q.J.device) for x in home))
                     for q in parts])

    def evaluate(R, p):
        parts = [FW.evaluate_windowed(R.to(s.C.device), p.to(s.C.device), s,
                                      seg=seg)
                 for s, seg in zip(shards, segs)]
        diagH = on_shards(lambda q: FW.hess_diag(q, W), parts)
        res = psum([q.res for q in parts])
        J = psum([q.J for q in parts])
        if edges is not None:
            eres, g, h = PG.evaluate_relpose_blocks(R, p, edges)
            res = res + eres.to(res.dtype)
            J = J + pose_sum(g[:, :6], g[:, 6:]).to(J.dtype)
            dii = torch.diagonal(h[:, :6, :6], dim1=-2, dim2=-1)
            djj = torch.diagonal(h[:, 6:, 6:], dim1=-2, dim2=-1)
            diagH = diagH + pose_sum(dii, djj).to(diagH.dtype)
            parts = (parts, h)
        return res, J.reshape(-1), diagH.reshape(-1), parts

    def residual(R, p):
        res = psum([FW.residual_only_windowed(R.to(s.C.device),
                                              p.to(s.C.device), s, seg=seg)
                    for s, seg in zip(shards, segs)])
        if edges is not None:
            res = res + PG.relpose_cost(R, p, edges).to(res.dtype)
        return res

    def matvec(parts, Dd, u, v):
        v2 = v.reshape(W, 6)
        if edges is not None:
            parts, h = parts
        out = on_shards(lambda q, x: FW.hvp(q, x, W), parts, v2)
        if edges is not None:
            vi, vj = v2[ei], v2[ej]
            hi = (torch.sum(h[:, :6, :6] * vi[:, None], -1)
                  + torch.sum(h[:, :6, 6:] * vj[:, None], -1))
            hj = (torch.sum(h[:, 6:, :6] * vi[:, None], -1)
                  + torch.sum(h[:, 6:, 6:] * vj[:, None], -1))
            out = out + pose_sum(hi, hj).to(out.dtype)
        return (out + u * Dd.reshape(W, 6) * v2).reshape(-1)

    def precond(parts, u, Dd):
        if edges is not None:
            parts, h = parts
        A = on_shards(lambda q: FW.block_jacobi(q, W, 0.0), parts)
        if edges is not None:
            A = A + pose_sum(h[:, :6, :6], h[:, 6:, 6:]).to(A.dtype)
        return A + u * Dd.reshape(W, 6)[..., None] * torch.eye(
            6, dtype=A.dtype, device=A.device)

    def update(R, p, dx):
        return lie.se3_left_update(R, p, dx.reshape(-1, 6))

    def direct(parts, Dd, u, J):
        if edges is not None:
            parts, h = parts
        Hband = on_shards(lambda q: FW.band_hessian(q, W), parts)
        if edges is not None:
            hd = Hband.dtype
            Hband[:, 0] += pose_sum(h[:, :6, :6], h[:, 6:, 6:]).to(hd)
            Hband += PG.scatter_rows(band_ids, h[:, :6, 6:], W * S,
                                     band_order).reshape(W, S, 6, 6).to(hd)
        damp = (u * Dd.reshape(W, 6))[..., None] * torch.eye(
            6, dtype=Hband.dtype, device=Hband.device)
        Hband[:, 0] += damp
        return _banded.solve_banded(Hband, -J, B)

    return LMOps(evaluate=evaluate, residual=residual, matvec=matvec,
                 precond=precond, dot=torch.dot, update=update,
                 reduce_min=torch.min, direct=direct)


def damping_iter_large(R, p, wf: FW.WindowedFactors,
                       cfg: SolverConfig = SolverConfig(),
                       *, cg_iters: int = 100, cg_tol: float = 1e-4,
                       linear_solver: str = "banded", edges=None):
    """LM loop over WindowedFactors with solver/lm.py's schedule
    (bavoxel.hpp:1069-1166); the dense solve replaced by the banded LU
    (linear_solver='banded', default: exact dense-quality steps,
    O(W span^2)) or block-Jacobi PCG ('pcg', cg_iters / cg_tol).  R, p
    and wf's tensors on one device, or wf plane-sharded
    (parallel.sharded.shard_factors) with R and p on the mesh's home
    device, where JAX's GSPMD takes the plane-sharded factors; the
    signature and defaults are the JAX package's
    (balm_tpu/solver/large.py:241-266).

    edges: optional ops.pose_graph.RelPoseEdges folded into cost,
    gradient and Hessian; requires i < j, j - i < span (checked here on
    the host)."""
    if linear_solver not in ("banded", "pcg"):
        raise ValueError(f"unknown linear_solver {linear_solver!r}")
    if edges is not None:
        ei = edges.i.cpu().numpy()
        ej = edges.j.cpu().numpy()
        if ei.size and not (np.all(ei < ej) and np.all(ej - ei < wf.span)):
            raise ValueError(
                "edges must satisfy i < j and j - i < span "
                f"(span={wf.span}); got max j-i={int((ej - ei).max())}")
    W = R.shape[0]
    with fp32_matmul():
        ops = windowed_ops(wf, W, edges=edges)
        c = lm_loop(ops, R, p, cfg.max_iters, cfg.u_init, cfg.v_init,
                    cfg.rel_tol, cfg.abs_tol, cg_iters, cg_tol,
                    linear_solver=linear_solver, ulp_tol=cfg.ulp_tol)
        Rf, pf = lie.gauge_fix(c.R, c.p) if cfg.gauge_fix else (c.R, c.p)
        final_res = (float(c.res1) if c.it > 0
                     else float(ops.residual(c.R, c.p)))
    return LargeLMResult(
        R=Rf, p=pf, residual=final_res, iters=c.it, trace_res1=c.t_res1,
        trace_res2=c.t_res2, trace_u=c.t_u, trace_accept=c.t_acc,
        trace_cg=c.t_cg)


class _Carry(NamedTuple):
    """JAX's _Carry (balm_tpu/solver/large.py:293-309): R, p, J, diagH
    and parts live on the solve's device; the scalars and traces on the
    host in the solve's dtype."""
    R: torch.Tensor
    p: torch.Tensor
    u: np.floating
    v: np.floating
    res1: np.floating
    J: Any
    diagH: Any
    parts: Any
    calc_hess: bool
    it: int
    done: bool
    t_res1: np.ndarray
    t_res2: np.ndarray
    t_u: np.ndarray
    t_acc: np.ndarray
    t_cg: np.ndarray


def lm_loop(ops: LMOps, R, p, max_iters, u_init, v_init, rel_tol, abs_tol,
            cg_iters, cg_tol, linear_solver: str = "pcg",
            ulp_tol: float = 128.0) -> _Carry:
    """The damping loop over an engine (JAX :312-446), one host-driven
    transition per iteration; returns the final carry."""
    ft = np.float32 if R.dtype == torch.float32 else np.float64
    eps = ft(np.finfo(ft).eps)
    rmin = ops.reduce_min if ops.reduce_min is not None else torch.min

    def step(c: _Carry) -> _Carry:
        # reject-reuse: the parts are recomputed only after an accepted
        # step (bavoxel.hpp:1134-1149)
        if c.calc_hess:
            res1_d, J, diagH, parts = ops.evaluate(c.R, c.p)
        else:
            res1_d = torch.tensor(c.res1, dtype=R.dtype, device=R.device)
            J, diagH, parts = c.J, c.diagH, c.parts
        # tau-shift damping: a uniform shift at the scale of the most
        # negative diag(H) entry (none when all are positive)
        tau = 2.0 * torch.clamp(-rmin(diagH), min=0.0)
        Dd = diagH + tau
        u = float(c.u)
        if linear_solver == "banded":
            dx, _ = ops.direct(parts, Dd, u, J)
            k_cg = torch.zeros((), dtype=torch.int32, device=R.device)
        else:
            Ablk = ops.precond(parts, u, Dd)
            # identity preconditioning for a block that is not SPD or
            # not invertible; the inverse cached so each CG application
            # is one batched 6x6 product
            bad = ~torch.all(torch.isfinite(_chol6(Ablk)), dim=(-2, -1))
            eye = torch.eye(6, dtype=Ablk.dtype, device=Ablk.device)
            Minv = _inv6(torch.where(bad[:, None, None], eye, Ablk))
            Minv = torch.where(
                torch.all(torch.isfinite(Minv), dim=(-2, -1))[:, None, None],
                Minv, eye)
            dx, k_cg = _pcg(lambda v: ops.matvec(parts, Dd, u, v), -J,
                            Minv, cg_iters, cg_tol)
        nsq = ops.dot(dx, dx)
        dx = torch.where(torch.isfinite(nsq), dx, torch.zeros_like(dx))
        Rt, pt = ops.update(c.R, c.p, dx)
        q1 = 0.5 * ops.dot(dx, (u * Dd) * dx - J)
        res2_d = ops.residual(Rt, pt)
        vals = torch.stack([res1_d.to(R.dtype), res2_d.to(R.dtype),
                            q1, nsq, ops.dot(J, J),
                            k_cg.to(R.dtype)]).cpu().numpy()
        res1, res2, q1h = ft(vals[0]), ft(vals[1]), ft(vals[2])
        solve_ok = bool(np.isfinite(vals[3]) and vals[3] > 0)

        q = ft(res1 - res2)
        # res2 <= 0 means the trial left the region where the f32
        # centered evaluation is trustworthy: reject
        accept = bool((q > 0) and np.isfinite(res2) and (res2 > 0))
        with np.errstate(all="ignore"):
            rho = ft(q / q1h)
            shrink = ft(ft(1.0) - ft(ft(2.0) * rho - ft(1.0)) ** 3)
            u_acc = ft(c.u * np.maximum(ft(1.0 / 3.0), shrink))
            u_rej = ft(c.u * c.v)
            rel = ft(abs(res1 - res2) / max(res1, ft(1e-30)))
        v_new = ft(2.0) if accept else ft(2.0 * c.v)
        u_new = u_acc if accept else u_rej
        stop = bool(rel < ft(rel_tol))
        if abs_tol > 0:
            stop = stop or bool(abs(res1 - res2) < ft(abs_tol))
        if ulp_tol > 0:
            stop = stop or bool(abs(res1 - res2)
                                < ft(ulp_tol) * eps * abs(res1))
        # a failed / zero solve must not read as convergence; J == 0
        # exactly (a true optimum) still stops
        stop = stop and (solve_ok or bool(vals[4] == 0))
        stop = stop or bool(u_new > ft(1e30)) or not bool(np.isfinite(u_new))

        i = c.it
        t = {k: getattr(c, k).copy()
             for k in ("t_res1", "t_res2", "t_u", "t_acc", "t_cg")}
        t["t_res1"][i], t["t_res2"][i], t["t_u"][i] = res1, res2, c.u
        t["t_acc"][i] = ft(1.0) if accept else ft(0.0)
        t["t_cg"][i] = int(vals[5])
        return _Carry(
            R=Rt if accept else c.R, p=pt if accept else c.p, u=u_new,
            v=v_new, res1=res2 if accept else res1, J=J, diagH=diagH,
            parts=parts, calc_hess=accept, it=i + 1, done=stop, **t)

    nan = np.full(max_iters, np.nan, ft)
    c = _Carry(R=R, p=p, u=ft(u_init), v=ft(v_init), res1=ft(np.inf),
               J=None, diagH=None, parts=None, calc_hess=True, it=0,
               done=False, t_res1=nan, t_res2=nan.copy(), t_u=nan.copy(),
               t_acc=nan.copy(), t_cg=np.zeros(max_iters, np.int32))
    while not c.done and c.it < max_iters:
        c = step(c)
    return c
