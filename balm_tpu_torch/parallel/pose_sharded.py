"""Pose-axis-partitioned large-window LM: the distributed-Schur story.

Counterpart: balm_tpu/parallel/pose_sharded.py (make_pose_mesh :53,
PoseShardedProblem :63, prepare :78, _pose_sharded_ops :134,
damping_iter_pose_sharded :208).  solver/large.py shards the PLANE axis
with the poses replicated; this module partitions the POSE axis itself:

  * Shard d owns the contiguous pose block [d*Wb, (d+1)*Wb) and every
    plane whose observation span STARTS in that block (planes are
    span-compressed and sorted by owner, ops/factors_windowed.py); its
    owner-major factors stay resident on its device.
  * A span runs at most S poses past the block edge, so each shard reads
    a halo of the S poses after its block (`halo_ext`: the first S rows
    of the next block, zeros on the last shard) and returns the
    gradient / diagonal-block / Hv contributions it produced for those
    halo poses to their owner (`fold`, an add into the next block's
    first S rows).  JAX does each with one ppermute per evaluation.
  * Every solver decision (CG alpha / beta, LM accept, stopping) derives
    from sums over the shards taken in shard order (`psum`, `dot`,
    `reduce_min`), so the unchanged loop of solver/large.py (`lm_loop`)
    runs over this LMOps engine.

Memory: JAX keeps O(W/D + S + G_d S) per device, the loop's vectors
sharded too.  Here each shard's factors and its evaluate's parts are
O(G_d S) on its device, but the loop's 6W vectors (poses, J, diag(H), the
CG iterates) live on the mesh's home device: O(W), 2.4 MB at W = 100 k in
f32.  The mesh is one process (a mesh with a process group of more than
one rank is refused).

Equality with the replicated solver holds up to floating-point
reassociation of the pose-axis sums (halo fold, the shards' dots), ~1e-13
relative in f64: tests/test_torch_pose_sharded.py holds the full loop's
trajectory and accept schedule against the JAX package's replicated solve
on a well-posed problem with converged CG, and the engine (evaluate /
matvec / precond) against JAX's on an ill-posed one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SolverConfig
from ..ops import factors_windowed as FW
from ..ops import lie
from ..ops.precision import fp32_matmul
from ..solver import large as L
from .sharded import Mesh, make_mesh

POSE_AXIS = "pose"


def make_pose_mesh(n_devices=None, devices=None) -> Mesh:
    """1-D mesh over the pose axis (sharded.make_mesh's devices)."""
    return make_mesh(n_devices, devices)


class PoseShardedProblem(NamedTuple):
    """Host-prepared pose-partitioned problem (numpy arrays, global
    views: pose arrays are (n*Wb, ...), factor arrays (n*Gd, ...) in
    owner-major order with LOCAL base)."""

    R: np.ndarray           # (n*Wb, 3, 3) padded with identity
    p: np.ndarray           # (n*Wb, 3)
    wf: FW.WindowedFactors  # (n*Gd, ...) owner-major, base in [0, Wb)
    W: int                  # true pose count
    Wb: int                 # poses per shard
    n: int                  # shards


def prepare(R, p, wf: FW.WindowedFactors, n: int) -> PoseShardedProblem:
    """Partition poses into n contiguous blocks and planes by owning block.

    Host-side (numpy), once per problem; R, p and wf's leaves may be
    tensors or numpy arrays.  Requires span <= Wb so the halo only ever
    reaches the immediate right neighbour.
    """
    npy = lambda x: (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                     else np.asarray(x))
    R = npy(R)
    p = npy(p)
    W = R.shape[0]
    S = wf.span
    Wb = -(-W // n)
    if S > Wb:
        raise ValueError(
            f"span {S} exceeds pose block {Wb}; use fewer devices or "
            f"cap the span (factors_windowed.from_dense(span=...))")

    Rp = np.tile(np.eye(3, dtype=R.dtype), (n * Wb, 1, 1))
    pp = np.zeros((n * Wb, 3), p.dtype)
    Rp[:W] = R
    pp[:W] = p

    base = npy(wf.base)
    coe = npy(wf.coe)
    owner = np.clip(base // Wb, 0, n - 1)
    owner = np.where(coe > 0, owner, 0)   # padding planes -> shard 0
    valid = np.nonzero(coe > 0)[0]
    counts = np.bincount(owner[valid], minlength=n)
    Gd = max(int(counts.max()), 1)
    order = np.argsort(owner[valid], kind="stable")
    src = valid[order]                               # owner-major plane order
    ov = owner[src]
    slot = np.arange(src.size) - np.concatenate(
        [[0], np.cumsum(counts)])[:-1][ov]           # rank within owner
    dest = ov * Gd + slot

    def scatter(x):
        x = npy(x)
        out = np.zeros((n * Gd,) + x.shape[1:], x.dtype)
        out[dest] = x[src]
        return out

    wf_sh = FW.WindowedFactors(
        C=scatter(wf.C),
        base=scatter(base - owner * Wb).astype(np.int64),
        coe=scatter(coe),
        centers=scatter(wf.centers),
        body_centers=scatter(wf.body_centers),
        Cfix=scatter(wf.Cfix),
    )
    return PoseShardedProblem(R=Rp, p=pp, wf=wf_sh, W=W, Wb=Wb, n=n)


def _pose_sharded_ops(wfs, mesh: Mesh, Wb: int) -> L.LMOps:
    """The LMOps engine over the shards `wfs` (WindowedFactors, shard d on
    mesh.devices[d]); poses and the loop's vectors (n*Wb rows) on the
    mesh's home device."""
    n = len(wfs)
    S = wfs[0].span
    We = Wb + S
    home = mesh.home
    devs = mesh.devices
    segs = [FW.pose_segments(w.base, S, We) for w in wfs]

    def halo_ext(x):
        """(n*Wb, ...) -> per shard (Wb+S, ...) on its device: its block
        and the next block's first S rows (zeros on the last shard — only
        padding slots reference them)."""
        blocks = x.view(n, Wb, *x.shape[1:])
        zeros = torch.zeros((S,) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=x.device)
        return [torch.cat([blocks[d], blocks[d + 1, :S] if d < n - 1
                           else zeros]).to(devs[d]) for d in range(n)]

    def fold(xs):
        """per shard (Wb+S, ...) -> (n*Wb, ...) on the home device: each
        shard's own rows, plus the contributions the left neighbour
        produced for its first S poses (the last shard's halo rows go
        nowhere)."""
        out = []
        for d in range(n):
            own = xs[d][:Wb].to(home)
            if d > 0:
                own = torch.cat([own[:S] + xs[d - 1][Wb:].to(home),
                                 own[S:]])
            out.append(own)
        return torch.cat(out)

    psum = mesh.psum

    def evaluate(R, p):
        Re, pe = halo_ext(R), halo_ext(p)
        parts = [FW.evaluate_windowed(Re[d], pe[d], wfs[d], seg=segs[d])
                 for d in range(n)]
        res = psum([q.res for q in parts])
        J = fold([q.J for q in parts])
        D = fold([q.D for q in parts])
        diagH = fold([FW.hess_diag(q, We) for q in parts])
        # keep the UNFOLDED parts for Hv (rank rows are plane-local) but
        # swap in the folded diagonal blocks for the per-pose D v term
        return res, J.reshape(-1), diagH.reshape(-1), (parts, D)

    def residual(R, p):
        Re, pe = halo_ext(R), halo_ext(p)
        return psum([FW.residual_only_windowed(Re[d], pe[d], wfs[d],
                                               seg=segs[d])
                     for d in range(n)])

    def matvec(state, diagH, u, v):
        parts, D = state
        v2 = v.reshape(n * Wb, 6)
        ve = halo_ext(v2)
        # rank part over the extended window (hvp also adds parts.D v:
        # subtract it and apply the folded D here, so the D v term is not
        # double-counted through the fold)
        hv = [FW.hvp(q, ve[d], We) - torch.einsum("wij,wj->wi", q.D, ve[d])
              for d, q in enumerate(parts)]
        out = fold(hv) + torch.einsum("wij,wj->wi", D, v2)
        return (out + u * diagH.reshape(n * Wb, 6) * v2).reshape(-1)

    def precond(state, u, Dd):
        parts, _ = state
        # the damped term is per-pose local: add it AFTER the fold so
        # halo rows are not double-damped
        A = fold([FW.block_jacobi(q, We, 0.0) for q in parts])
        return A + u * Dd.reshape(n * Wb, 6)[..., None] * torch.eye(
            6, dtype=A.dtype, device=A.device)

    def dot(a, b):
        return psum(list(torch.sum((a * b).view(n, -1), dim=1)))

    def update(R, p, dx):
        return lie.se3_left_update(R, p, dx.reshape(n * Wb, 6))

    return L.LMOps(evaluate=evaluate, residual=residual, matvec=matvec,
                   precond=precond, dot=dot, update=update,
                   reduce_min=torch.min)


def damping_iter_pose_sharded(
        prob: PoseShardedProblem, mesh: Mesh,
        cfg: SolverConfig = SolverConfig(), *, cg_iters: int = 100,
        cg_tol: float = 1e-4) -> L.LargeLMResult:
    """Run the full LM loop (solver/large.lm_loop, pcg) over the pose
    mesh in prob.R's dtype, TF32 off (JAX pins
    default_matmul_precision('float32')); the result is gauge-fixed when
    cfg.gauge_fix."""
    n, Wb, W = prob.n, prob.Wb, prob.W
    if mesh.size != n or mesh.world != 1:
        raise ValueError(f"the pose mesh must be {n} shards of one "
                         f"process, got {mesh}")
    dt = torch.from_numpy(np.asarray(prob.R[:1])).dtype
    T = lambda x, dev: torch.as_tensor(np.asarray(x), dtype=dt, device=dev)
    R = T(prob.R, mesh.home)
    p = T(prob.p, mesh.home)
    Gd = prob.wf.num_planes // n
    wfs = [FW.windowed_from_numpy([np.asarray(x)[d * Gd:(d + 1) * Gd]
                                   for x in prob.wf], device=dev, dtype=dt)
           for d, dev in enumerate(mesh.devices)]
    with fp32_matmul():
        ops = _pose_sharded_ops(wfs, mesh, Wb)
        c = L.lm_loop(ops, R, p, cfg.max_iters, cfg.u_init, cfg.v_init,
                      cfg.rel_tol, cfg.abs_tol, cg_iters, cg_tol)
        final_res = (float(c.res1) if c.it > 0
                     else float(ops.residual(c.R, c.p)))
    Rf, pf = c.R[:W], c.p[:W]
    if cfg.gauge_fix:
        Rf, pf = lie.gauge_fix(Rf, pf)
    return L.LargeLMResult(
        R=Rf, p=pf, residual=final_res, iters=c.it, trace_res1=c.t_res1,
        trace_res2=c.t_res2, trace_u=c.t_u, trace_accept=c.t_acc,
        trace_cg=c.t_cg)
