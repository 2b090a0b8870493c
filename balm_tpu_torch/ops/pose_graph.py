"""SE(3) relative-pose factors (pose-graph edges).

Counterpart: balm_tpu/ops/pose_graph.py — RelPoseEdges (:33, empty :51),
_robust (:59), relpose_cost (:81), _edge_cost (:99),
evaluate_relpose_blocks (:114), evaluate_relpose (:141),
evaluate_relpose_dense (:171), concat_edges (:190), lift_edges (:202)
and consensus_edge (:260).

An edge measures Z = T_i^-1 T_j (pose j in pose i's frame) with cost

    E = w_rot |Log(Zr^T R_i^T R_j)|^2 + w_tr |R_i^T (p_j - p_i) - Zp|^2

(optionally Huber-robustified).  Derivatives are taken by autodiff
(torch.func: vmap of grad / hessian at eps = 0, as JAX's vmap of
jax.grad / jax.hessian) in the SAME left-perturbation chart as the plane
factors, so both factor families add into one damped-Newton system.
lie.so3_log's guarded small branch and _robust's double where keep an
exactly satisfied edge (Log at the identity, sqrt at 0) free of NaN in
the second derivative, in float32 too.

The scatters of per-edge blocks into poses (J, the dense H) are sorted
segment sums (ops/segments), not float index_add_: the same input gives
the same bits on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lie
from .segments import sorted_segment_sum


class RelPoseEdges(NamedTuple):
    """Batch of relative-pose factors.

    i, j:   (E,) integer pose indices (measurement: pose j in pose i frame)
    Zr:     (E, 3, 3) measured relative rotations R_i^T R_j
    Zp:     (E, 3) measured relative translations R_i^T (p_j - p_i)
    w_rot:  (E,) rotation weights (1/sigma^2)
    w_tr:   (E,) translation weights
    """

    i: torch.Tensor
    j: torch.Tensor
    Zr: torch.Tensor
    Zp: torch.Tensor
    w_rot: torch.Tensor
    w_tr: torch.Tensor

    @classmethod
    def empty(cls, dtype=torch.float64, device="cpu"):
        z = torch.zeros((0,), dtype=torch.int64, device=device)
        Z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return cls(i=z, j=z.clone(), Zr=Z(0, 3, 3), Zp=Z(0, 3),
                   w_rot=Z(0), w_tr=Z(0))


def edges_from_numpy(fields, *, device="cpu", dtype=torch.float64):
    """Numpy leaves (i, j, Zr, Zp, w_rot, w_tr) — e.g.
    `[np.asarray(x) for x in balm_tpu_edges]` — -> RelPoseEdges of torch
    tensors on `device`: i, j as int64, the rest of `dtype`."""
    i, j, Zr, Zp, wr, wt = [np.asarray(x) for x in fields]
    I = lambda x: torch.tensor(x, dtype=torch.int64, device=device)
    T = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return RelPoseEdges(i=I(i), j=I(j), Zr=T(Zr), Zp=T(Zp), w_rot=T(wr),
                        w_tr=T(wt))


def _robust(chi2, delta):
    """Huber in the residual-norm chart, in chi^2 units: quadratic to
    chi^2 = delta, linear in ||r|| past it.  Double-where safe sqrt: the
    untaken branch is evaluated at chi2 = 1, so an exactly satisfied edge
    never puts sqrt(0) (infinite derivative) into the derivatives."""
    quad = chi2 <= delta
    safe = torch.where(quad, torch.ones_like(chi2), chi2)
    s = torch.sqrt(safe)
    d = torch.sqrt(delta)
    return torch.where(quad, chi2, 2.0 * d * s - delta)


def _rel(Ri, pi, Rj, pj, Zr, Zp):
    """(rotation error (..., 3), translation error (..., 3))."""
    dR = torch.sum(Ri[..., :, :, None] * Rj[..., :, None, :], dim=-3)
    M = torch.sum(Zr[..., :, :, None] * dR[..., :, None, :], dim=-3)
    rerr = lie.so3_log(M)
    terr = torch.sum(Ri * (pj - pi)[..., :, None], dim=-2) - Zp
    return rerr, terr


def relpose_cost(R, p, edges: RelPoseEdges, delta=None):
    """Total weighted pose-graph cost (scalar).

    delta: optional (E,) per-edge Huber thresholds in chi^2 units
    (None = pure quadratic, the BA-solver path)."""
    rerr, terr = _rel(R[edges.i], p[edges.i], R[edges.j], p[edges.j],
                      edges.Zr, edges.Zp)
    chi2 = (edges.w_rot * torch.sum(rerr * rerr, -1)
            + edges.w_tr * torch.sum(terr * terr, -1))
    if delta is not None:
        chi2 = _robust(chi2, delta)
    return torch.sum(chi2)


def _edge_cost(eps, Ri, pi, Rj, pj, Zr, Zp, wr, wt, delta):
    """One edge's cost as a function of its OWN 12 perturbation dims
    (eps = [eps_i, eps_j], each a left twist (w, t)).

    Everything carries a leading axis of 1: under torch.func's
    forward-over-reverse (hessian), a 0-d torch.where result broadcast
    into a matrix gets a float64 tangent, which breaks a float32 solve.
    """
    e = eps[None]
    dRi = lie.so3_exp(e[:, :3])                      # (1, 3, 3)
    dRj = lie.so3_exp(e[:, 6:9])
    Rni = dRi @ Ri
    pni = (dRi @ pi[:, None])[..., 0] + e[:, 3:6]    # (1, 3)
    Rnj = dRj @ Rj
    pnj = (dRj @ pj[:, None])[..., 0] + e[:, 9:12]
    RniT = Rni.transpose(-1, -2)
    rerr = lie.so3_log(Zr.T @ (RniT @ Rnj))
    terr = (RniT @ (pnj - pni)[..., None])[..., 0] - Zp
    chi2 = (wr * torch.sum(rerr * rerr, -1)
            + wt * torch.sum(terr * terr, -1))
    return _robust(chi2, delta)[0]


def evaluate_relpose_blocks(R, p, edges: RelPoseEdges, delta=None):
    """Per-edge exact derivatives: (res, g (E,12), h (E,12,12)).

    Each edge touches exactly two poses, so its 12-dim gradient and
    12x12 Hessian in the left-update chart are its complete global
    contribution.  delta: optional (E,) per-edge Huber thresholds."""
    E = edges.i.shape[0]
    dtype, dev = R.dtype, R.device
    if delta is None:
        delta = torch.full((E,), 1e30, dtype=dtype, device=dev)
    eps0 = torch.zeros((E, 12), dtype=dtype, device=dev)
    args = (R[edges.i], p[edges.i], R[edges.j], p[edges.j], edges.Zr,
            edges.Zp, edges.w_rot, edges.w_tr, delta)
    vm = torch.func.vmap
    res = torch.sum(vm(_edge_cost)(eps0, *args))
    g = vm(torch.func.grad(_edge_cost))(eps0, *args)
    h = vm(torch.func.hessian(_edge_cost))(eps0, *args)
    return res, g, h


def scatter_rows(ids, vals, n: int, order=None):
    """out[k] = sum of vals[e] with ids[e] == k, (n, ...) — a stable sort
    of the ids (or `order`, that sort made beforehand), then one sorted
    segment sum (no float scatter)."""
    if order is None:
        order = torch.argsort(ids, stable=True)
    flat = vals.reshape(vals.shape[0], -1)[order]
    out = sorted_segment_sum(flat, ids[order], num_segments=n)
    return out.reshape((n,) + tuple(vals.shape[1:]))


def evaluate_relpose(R, p, edges: RelPoseEdges, delta=None):
    """(res, J (6W,), H (6W, 6W)) in the left-update chart: the dense
    scatter of `evaluate_relpose_blocks`."""
    W = R.shape[0]
    E = edges.i.shape[0]
    dtype, dev = R.dtype, R.device
    if E == 0:
        z6 = torch.zeros(6 * W, dtype=dtype, device=dev)
        return (torch.zeros((), dtype=dtype, device=dev), z6,
                torch.zeros((6 * W, 6 * W), dtype=dtype, device=dev))

    res, g, h = evaluate_relpose_blocks(R, p, edges, delta)
    i, j = edges.i, edges.j
    J = scatter_rows(torch.cat([i, j]), torch.cat([g[:, :6], g[:, 6:]]), W)
    Hb = scatter_rows(
        torch.cat([i * W + i, i * W + j, j * W + i, j * W + j]),
        torch.cat([h[:, :6, :6], h[:, :6, 6:], h[:, 6:, :6], h[:, 6:, 6:]]),
        W * W).reshape(W, W, 6, 6)
    H = Hb.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
    return res, J.reshape(6 * W), H


def evaluate_relpose_dense(R, p, edges: RelPoseEdges):
    """Reference implementation: autodiff through the full 6W-dim chart
    (the equality oracle for `evaluate_relpose`; small W only)."""
    W = R.shape[0]

    def cost(eps):
        Rn, pn = lie.se3_left_update(R, p, eps.reshape(W, 6))
        return relpose_cost(Rn, pn, edges)

    eps0 = torch.zeros(6 * W, dtype=R.dtype, device=R.device)
    return (cost(eps0), torch.func.grad(cost)(eps0),
            torch.func.hessian(cost)(eps0))


def concat_edges(a: RelPoseEdges | None, b: RelPoseEdges | None):
    """Concatenate two edge batches (either may be None)."""
    if a is None:
        return b
    if b is None:
        return a
    return RelPoseEdges(*[torch.cat([x, y]) for x, y in zip(a, b)])


def lift_edges(edges: RelPoseEdges, owner: np.ndarray, rel_R, rel_p):
    """Lift scan-level relative-pose edges onto the anchor (block) graph
    (JAX :202-257): scan a decomposes as T_a = T_A(owner[a]) T_rel(a), so
    Z_ab induces Zr' = Ra Zr Rb^T, Zp' = Ra Zp + pa - Zr' pb between the
    anchors; in-block edges are dropped (None when none is left).
    Host numpy; the result's tensors are on the edges' device."""
    ei = edges.i.cpu().numpy()
    ej = edges.j.cpu().numpy()
    keep = [k for k in range(len(ei)) if owner[ei[k]] != owner[ej[k]]]
    if not keep:
        return None
    Zr = edges.Zr.cpu().numpy()
    Zp = edges.Zp.cpu().numpy()
    li, lj, Zr_l, Zp_l = [], [], [], []
    for k in keep:
        a, b = int(ei[k]), int(ej[k])
        Ra, pa = np.asarray(rel_R[a]), np.asarray(rel_p[a])
        Rb, pb = np.asarray(rel_R[b]), np.asarray(rel_p[b])
        Zr2 = Ra @ Zr[k] @ Rb.T
        li.append(int(owner[a]))
        lj.append(int(owner[b]))
        Zr_l.append(Zr2)
        Zp_l.append(Ra @ Zp[k] + pa - Zr2 @ pb)
    dev, dt = edges.Zr.device, edges.Zr.dtype
    return edges_from_numpy(
        (li, lj, np.stack(Zr_l), np.stack(Zp_l),
         edges.w_rot.cpu().numpy()[keep], edges.w_tr.cpu().numpy()[keep]),
        device=dev, dtype=dt)


def consensus_edge(rel_Ri, rel_pi, rel_Rj, rel_pj):
    """Consensus relative pose between two anchors from shared scans
    (JAX :260-294): the Lie-algebra mean of T_i^s (T_j^s)^-1 over the
    shared scans s at the first one.  Returns (Zr, Zp, spread), spread =
    the max deviation from the mean (rad + m).  Host numpy in float64."""
    Ts = []
    for (Ri, pi, Rj, pj) in zip(rel_Ri, rel_pi, rel_Rj, rel_pj):
        Rij = np.asarray(Ri) @ np.asarray(Rj).T
        Ts.append((Rij, np.asarray(pi) - Rij @ np.asarray(pj)))
    R0, p0 = Ts[0]
    if len(Ts) == 1:
        return R0, p0, 0.0
    ws = np.stack([lie.so3_log(torch.as_tensor(R0.T @ Rk)).numpy()
                   for Rk, _ in Ts])
    vs = np.stack([pk - p0 for _, pk in Ts])
    wbar = np.mean(ws, axis=0)
    vbar = np.mean(vs, axis=0)
    spread = max(float(np.max(np.linalg.norm(ws - wbar, axis=-1))),
                 float(np.max(np.linalg.norm(vs - vbar, axis=-1))))
    Rm = R0 @ lie.so3_exp(torch.as_tensor(wbar)).numpy()
    return Rm, p0 + vbar, spread
