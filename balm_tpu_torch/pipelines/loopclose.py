"""The pose-graph stage of loop closure: odometry chain edges and the
damped-Newton solve of a pure pose graph (no plane factors).

Counterpart: balm_tpu/pipelines/loopclose.py — chain_edges (:496),
_sparse_newton_step (:514) and pose_graph_optimize (:559).  The rest of
that module (LoopConfig, detect, close_loops: place recognition and
verification) is not ported yet (ROADMAP.md, A13a); the hierarchy's
anchor pose-graph stage (pipelines/hierarchical.run) needs only these
three.

The stage runs on the host in float64 whatever the caller's device, as
balm_tpu/api.py:56-79 pins it to CPU f64: it is a one-time trajectory
correction over a few hundred anchors, not the BA hot loop.  The
per-edge derivatives are ops/pose_graph's (torch.func) on CPU float64
tensors, the sparse solve scipy's splu.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import lie
from ..ops import pose_graph as PG


def _f64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def chain_edges(R, p, sigma_rot: float, sigma_trans: float):
    """Consecutive-pose odometry edges measured from the CURRENT
    trajectory (the relative motions are what the front-end observed;
    only their composition drifted).  RelPoseEdges on the CPU, float64."""
    R = np.asarray(R, np.float64)
    p = np.asarray(p, np.float64)
    W = len(R)
    Zr = np.einsum("wba,wbc->wac", R[:-1], R[1:])
    Zp = np.einsum("wba,wb->wa", R[:-1], p[1:] - p[:-1])
    return PG.edges_from_numpy(
        (np.arange(W - 1), np.arange(1, W), Zr, Zp,
         np.full(W - 1, 1.0 / sigma_rot ** 2),
         np.full(W - 1, 1.0 / sigma_trans ** 2)))


def _sparse_newton_step(ei, ej, g, h, W, u):
    """One damped-Newton direction from per-edge blocks, never
    materializing (6W)^2: H is block-tridiagonal plus a few off-band 6x6
    blocks (the loop edges), a sparse system for splu.  Damping uses
    D = diag(max(diag(H), 0)) + 1e-12: the Hessian of the Huber cost can
    have negative diagonal entries past the Huber point, and scaling
    those negatively would leave H + uD indefinite at every u.

    ei, ej (E,) int, g (E, 12), h (E, 12, 12) numpy float64.
    Returns (J (6W,), dx (6W,), Ddiag (6W,))."""
    from scipy import sparse
    from scipy.sparse.linalg import splu

    J = np.zeros((W, 6))
    np.add.at(J, ei, g[:, :6])
    np.add.at(J, ej, g[:, 6:])
    J = J.reshape(6 * W)

    diag_blocks = np.zeros((W, 6, 6))
    np.add.at(diag_blocks, ei, h[:, :6, :6])
    np.add.at(diag_blocks, ej, h[:, 6:, 6:])
    Ddiag = np.maximum(diag_blocks[:, np.arange(6), np.arange(6)], 0.0
                       ).reshape(6 * W) + 1e-12

    damped = diag_blocks.copy()
    damped[:, np.arange(6), np.arange(6)] += u * Ddiag.reshape(W, 6)
    rows = np.concatenate([np.arange(W), ei, ej])
    cols = np.concatenate([np.arange(W), ej, ei])
    blocks = np.concatenate([damped, h[:, :6, 6:], h[:, 6:, :6]])
    r6 = np.arange(6)
    bi = (rows[:, None, None] * 6 + r6[None, :, None]
          + np.zeros((1, 1, 6), np.int64)).reshape(-1)
    bj = (cols[:, None, None] * 6 + r6[None, None, :]
          + np.zeros((1, 6, 1), np.int64)).reshape(-1)
    A = sparse.coo_matrix((blocks.reshape(-1), (bi, bj)),
                          shape=(6 * W, 6 * W)).tocsc()
    dx = splu(A).solve(-J)
    return J, dx, Ddiag


def pose_graph_optimize(R, p, edges: PG.RelPoseEdges, *,
                        delta=None, max_iters: int = 15, u0: float = 1e-6,
                        rel_tol: float = 1e-9, solver: str = "sparse"):
    """Damped-Newton solve of the pure pose graph, host-stepped in
    float64 on the CPU.

    The left-perturbation chart and damping schedule of solver/lm.py.
    Gauge: re-anchored to pose 0's input value.  delta: optional (E,)
    per-edge Huber thresholds (chi^2 units).  solver: 'sparse' (splu of
    the per-edge 12x12 blocks, the default) or 'dense' (the (6W)^2 LU,
    kept as the equality oracle).  R (W, 3, 3), p (W, 3) numpy or
    tensors; edges on any device.  Returns (R, p, info), R and p float64
    numpy."""
    if solver not in ("sparse", "dense"):
        raise ValueError(f"unknown solver {solver!r}")
    R0_in = np.asarray(R, np.float64)[0].copy()
    p0_in = np.asarray(p, np.float64)[0].copy()
    R = _f64(R)
    p = _f64(p)
    W = R.shape[0]
    edges = PG.RelPoseEdges(
        i=edges.i.cpu().long(), j=edges.j.cpu().long(),
        **{k: getattr(edges, k).detach().cpu().double()
           for k in ("Zr", "Zp", "w_rot", "w_tr")})
    if delta is not None:
        delta = torch.as_tensor(delta).detach().cpu().double()
    sparse_path = solver == "sparse"
    ei = edges.i.numpy()
    ej = edges.j.numpy()

    def blocks(R_, p_):
        r, g, h = PG.evaluate_relpose_blocks(R_, p_, edges, delta)
        return float(r), g.numpy(), h.numpy()

    def dense(R_, p_):
        r, J, H = PG.evaluate_relpose(R_, p_, edges, delta)
        return float(r), J, H

    u, v = u0, 2.0
    if sparse_path:
        res1, g, h = blocks(R, p)
    else:
        res1, J, H = dense(R, p)
    info = {"initial_cost": res1, "iters": 0, "accepted": 0}
    calc = False
    for _ in range(max_iters):
        if calc:
            if sparse_path:
                res1, g, h = blocks(R, p)
            else:
                res1, J, H = dense(R, p)
        if sparse_path:
            Jn, dxn, Ddiag = _sparse_newton_step(ei, ej, g, h, int(W), u)
            dx = torch.from_numpy(dxn)
            uDdx_mJ = torch.from_numpy(u * (Ddiag * dxn) - Jn)
        else:
            Ddiag = torch.clamp(torch.diagonal(H), min=0.0) + 1e-12
            dx = torch.linalg.solve(H + u * torch.diag(Ddiag), -J)
            uDdx_mJ = u * (Ddiag * dx) - J
        Rn, pn = lie.se3_left_update(R, p, dx.reshape(W, 6))
        res2 = float(PG.relpose_cost(Rn, pn, edges, delta))
        q1 = float(0.5 * torch.dot(dx, uDdx_mJ))
        rho = (res1 - res2) / q1 if q1 != 0 else -1.0
        info["iters"] += 1
        if np.isfinite(res2) and res2 < res1:
            R, p = Rn, pn
            u *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            v = 2.0
            stop = abs(res1 - res2) < rel_tol * max(res1, 1e-30)
            res1 = res2
            calc = True
            info["accepted"] += 1
            if stop:
                break
        else:
            u *= v
            v *= 2.0
            calc = False
            if u > 1e12:
                break
    # gauge: the graph cost is invariant to a global rigid motion (the
    # damped solve merely keeps the null-space step small) — re-anchor
    # pose 0 to its input value (bavoxel.hpp:1159-1164)
    Rs = R.numpy()
    ps = p.numpy()
    G = R0_in @ Rs[0].T
    gt = p0_in - G @ ps[0]
    Rs = np.einsum("ab,nbc->nac", G, Rs)
    ps = np.einsum("ab,nb->na", G, ps) + gt
    info["final_cost"] = res1
    return Rs, ps, info
