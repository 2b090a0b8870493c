"""Plane factors: storage, the host-side f64 conditioning step, and the
XLA-formulated evaluators (residual, gradient and analytic Hessian).

Counterpart: balm_tpu/ops/factors.py — PlaneFactors (:51, create :77,
astype :91, num_planes :95, window :99), recenter_bodies (:113),
_shifted_poses (:145), _shifted_fix (:161), _plane_moment (:189),
estimate_centers (:210), evaluate_right (:221), residual_only (:340) and
evaluate (:378, _evaluate_impl :404); reference VOX_HESS
left_evaluate_acc2, acc_evaluate2 and evaluate_only_residual
(src/benchmark/bavoxel.hpp:53-158, 304-470).  The f32 solve of
optimize_poses evaluates through ops/packed_evaluate.py instead; these
evaluators are the f64 path (and the f32 centered 'xla' backend).

Each plane factor holds per-scan body-frame cluster moments C_gi, an
optional marginalized world-frame moment Cfix_g, a weight coe_g, a
world-frame conditioning center c_g and per-cluster body centroids b_gi
(reference VOX_HESS, src/benchmark/bavoxel.hpp:20-51).  With pose
matrices T_i the world plane moment is Csum = Cfix + sum_i T_i C_i T_i^T
and the cost coe * lambda_0 of its covariance; the Hessian over all pose
pairs is one product of stacked per-(plane, pose) rank rows,
H = -(rows^T rows), plus block-diagonal corrections.

Leaves may be numpy arrays (host, as the voxelizer emits them) or torch
tensors (device); `factors_from_numpy` moves a set of numpy leaves — the
JAX package's PlaneFactors leaves included — onto a device.  The
evaluators take tensor leaves; in float32 their products run in full
fp32 (ops/precision.fp32_matmul), never TF32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import clusters, lie, moments
from . import smallmat as sm
from .eigh3 import eigh3, eigvals3
from .precision import fp32_matmul


def _zeros_like_kind(ref, shape):
    if isinstance(ref, np.ndarray):
        return np.zeros(shape, ref.dtype)
    return torch.zeros(shape, dtype=ref.dtype, device=ref.device)


class PlaneFactors(NamedTuple):
    """Padded batch of plane factors.

    C:       (G, W, 4, 4) body-frame cluster moments per (plane, scan);
             all-zero where a scan does not observe the plane.
    Cfix:    (G, 4, 4) marginalized world-frame moments (zeros if none).
    coe:     (G,) factor weights (0 marks padding).
    centers: (G, 3) approximate world-frame plane centers (conditioning).
    body_centers: (G, W, 3) per-cluster body centroids subtracted from C.
    """

    C: object
    Cfix: object
    coe: object
    centers: object
    body_centers: object

    @classmethod
    def create(cls, C, Cfix=None, coe=None, centers=None, body_centers=None):
        G, W = C.shape[:2]
        if Cfix is None:
            Cfix = _zeros_like_kind(C, (G, 4, 4))
        if coe is None:
            coe = clusters.count(C).sum(-1)
        if centers is None:
            centers = _zeros_like_kind(C, (G, 3))
        if body_centers is None:
            body_centers = _zeros_like_kind(C, (G, W, 3))
        return cls(C=C, Cfix=Cfix, coe=coe, centers=centers,
                   body_centers=body_centers)

    def astype(self, dtype):
        """Cast every leaf: a numpy dtype for numpy leaves, a torch dtype
        for tensor leaves."""
        if isinstance(dtype, torch.dtype):
            return PlaneFactors(*[x.to(dtype) for x in self])
        return PlaneFactors(*[np.asarray(x, dtype) for x in self])

    @property
    def num_planes(self):
        return self.C.shape[0]

    @property
    def window(self):
        return self.C.shape[1]

    def observes(self):
        """(G, W) bool: scan i contributes to plane g."""
        return clusters.count(self.C) > 0.5

    def planes_per_pose(self):
        """(W,) number of valid planes observed by each pose
        (reference degeneracy guard, bavoxel.hpp:1071-1078); (B, W) for
        factors with a leading batch axis."""
        valid = (self.coe > 0)[..., None]
        return (self.observes() & valid).sum(-2)


def factors_from_numpy(fields, *, device="cpu", dtype=torch.float32):
    """Numpy leaves (C, Cfix, coe, centers, body_centers) — e.g.
    `[np.asarray(x) for x in balm_tpu_factors]` — -> PlaneFactors of
    torch tensors of `dtype` on `device`."""
    leaves = [torch.tensor(np.asarray(x), dtype=dtype, device=device)
              for x in fields]
    return PlaneFactors(*leaves)


def recenter_bodies(f: PlaneFactors) -> PlaneFactors:
    """Recenter every (plane, scan) body moment about its own centroid.

    Must run in float64 BEFORE casting to float32: P - v v^T / N is the
    cancellation the f32 path must avoid (balm_tpu/ops/factors.py:113-158).
    Works on numpy or torch leaves in kind.
    """
    xp = np if isinstance(f.C, np.ndarray) else torch
    cat = np.concatenate if xp is np else torch.cat
    N = clusters.count(f.C)
    Ns = xp.where(N > 0.5, N, 1.0)
    v = f.C[..., :3, 3]
    b = clusters.mean(f.C)                                # (G, W, 3)
    P2 = f.C[..., :3, :3] - v[..., :, None] * v[..., None, :] / Ns[..., None, None]
    zero3 = xp.zeros_like(v)
    top = cat([P2, zero3[..., :, None]], -1)
    bot = cat([zero3[..., None, :], N[..., None, None]], -1)
    Cc = cat([top, bot], -2)
    return f._replace(C=Cc, body_centers=f.body_centers + b)


def _shifted_fix(f: PlaneFactors):
    """Recenter the world-frame fixed moment by -centers, in the explicit
    parallel-axis form (balm_tpu/ops/factors.py:161-189):

        P' = P - c v^T - v c^T + N c c^T,   v' = v - N c
    """
    P = f.Cfix[..., :3, :3]
    v = f.Cfix[..., :3, 3]
    N = f.Cfix[..., 3, 3]
    c = f.centers
    Pn = (P - c[..., :, None] * v[..., None, :]
          - v[..., :, None] * c[..., None, :]
          + N[..., None, None] * c[..., :, None] * c[..., None, :])
    vn = v - N[..., None] * c
    out = torch.zeros_like(f.Cfix)
    out[..., :3, :3] = Pn
    out[..., :3, 3] = vn
    out[..., 3, :3] = vn
    out[..., 3, 3] = N
    return out


# --------------------------------------------------------------------------
# the XLA-formulated evaluators
# --------------------------------------------------------------------------

def _eigh(covM, use_lapack_eigh):
    if use_lapack_eigh:
        return torch.linalg.eigh(covM)
    return eigh3(covM)


def _add_diag_blocks(H, D):
    """H (6W, 6W) += blockdiag(D), D (W, 6, 6), in place."""
    W = D.shape[0]
    torch.diagonal(H.view(W, 6, W, 6), dim1=0, dim2=2).add_(
        D.permute(1, 2, 0))
    return H


def _shifted_poses(T, f: PlaneFactors):
    """T_i composed with the body offset, then world-shifted by -c_g:
    rotation R_i, translation R_i b_gi + t_i - c_g -> (G, W, 4, 4)."""
    G = f.centers.shape[0]
    W = T.shape[0]
    t_new = (sm.matvec(T[None, :, :3, :3], f.body_centers)
             + T[None, :, :3, 3] - f.centers[:, None, :])
    Rb = T[None, :, :3, :3].expand(G, W, 3, 3)
    top = torch.cat([Rb, t_new[..., None]], dim=-1)
    bot = torch.zeros((G, W, 1, 4), dtype=T.dtype, device=T.device)
    bot[..., 0, 3] = 1.0
    return torch.cat([top, bot], dim=-2)


def _plane_moment(T, f: PlaneFactors, centered: bool):
    """Common prefix: world moments and the eigen decomposition inputs."""
    if centered:
        Tg = _shifted_poses(T, f)
        Cfix = _shifted_fix(f)
        TC = sm.matmul(Tg, f.C)
        TCT = sm.matmul(TC, Tg, transpose_b=True)
    else:
        Tg = None
        Cfix = f.Cfix
        TC = sm.matmul(T[None], f.C)
        TCT = sm.matmul(TC, T[None], transpose_b=True)
    Csum = Cfix + torch.sum(TCT, dim=1)
    return (Tg, TC, TCT) + _moment_stats(Csum)


def _moment_stats(Csum):
    """(NNs, NN, vbar, covM) of world moments Csum (G, 4, 4)."""
    NN = Csum[..., 3, 3]
    NNs = torch.where(NN > 0.5, NN, 1.0)
    Cn = Csum / NNs[..., None, None]
    vbar = Cn[..., :3, 3]
    covM = Cn[..., :3, :3] - vbar[..., :, None] * vbar[..., None, :]
    return NNs, NN, vbar, covM


def estimate_centers(T, f: PlaneFactors):
    """World-frame plane centroids under poses T — fills
    PlaneFactors.centers for the f32 conditioning mode."""
    with fp32_matmul():
        TC = torch.einsum("wab,gwbc->gwac", T, f.C)
        TCT = torch.einsum("gwac,wdc->gwad", TC, T)
    Csum = f.Cfix + torch.sum(TCT, dim=1)
    N = Csum[..., 3, 3]
    Ns = torch.where(N > 0.5, N, 1.0)
    return Csum[..., :3, 3] / Ns[..., None]


def residual_only(T, f: PlaneFactors, *, centered: bool = False,
                  use_lapack_eigh: bool = False, l_set=(0,),
                  use_pallas: bool = False):
    """Total cost sum_g coe_g * sum_{l in l_set} lambda_l(g) (reference
    evaluate_only_residual, bavoxel.hpp:428-470).

    use_pallas (centered mode only): the world moments from kernel B7
    (ops/moments.py) — on CUDA tensors its CUDA kernel, on CPU tensors
    its plain version; G must be a multiple of 128.  Without centering
    it falls through to the moment path, as in JAX."""
    with fp32_matmul():
        if use_pallas and centered:
            Csum = moments.residual_moments(T, f) + _shifted_fix(f)
            _, NN, _, covM = _moment_stats(Csum)
        else:
            _, _, _, _, NN, _, covM = _plane_moment(T, f, centered)
        if use_lapack_eigh:
            lam = torch.linalg.eigvalsh(covM)
        else:
            lam = eigvals3(covM)
        valid = (NN > 0.5) & (f.coe > 0)
        cost = sum(lam[..., l] for l in l_set)
        return torch.sum(torch.where(valid, f.coe * cost, 0.0))


def evaluate(T, f: PlaneFactors, *, centered: bool = False,
             use_lapack_eigh: bool = False, gap_eps: float = 1e-9,
             l_set=(0,)):
    """Residual, gradient (6W,) and full Newton Hessian (6W, 6W) under
    LEFT perturbations, in (w, j)-major twist order (w_0, t_0, w_1, ...)
    (reference left_evaluate_acc2, bavoxel.hpp:304-426).

    l_set: (0,) = plane factors (cost lambda_0); (0, 1) = line factors
    (lambda_0 + lambda_1), keeping only the eigen-gaps to the complement
    (the intra-set terms cancel).  centered: evaluate each plane in the
    frame shifted by -centers (with body-recentered moments) and map the
    gradient and Hessian back through the SE(3) adjoint."""
    with fp32_matmul():
        return _evaluate_impl(T, f, centered=centered,
                              use_lapack_eigh=use_lapack_eigh,
                              gap_eps=gap_eps, l_set=tuple(l_set))


def _evaluate_impl(T, f: PlaneFactors, *, centered, use_lapack_eigh,
                   gap_eps, l_set=(0,)):
    G, W = f.C.shape[:2]
    dtype, dev = f.C.dtype, f.C.device
    Tg, TC, TCT, NNs, NN, vbar, covM = _plane_moment(T, f, centered)
    lam, U = _eigh(covM, use_lapack_eigh)

    valid = (NN > 0.5) & (f.coe > 0)
    coe = torch.where(valid, f.coe, 0.0)
    residual = torch.sum(coe * sum(lam[..., l] for l in l_set))

    uT = U.transpose(-1, -2)                 # (G, 3k, 3) rows are u_k
    # U_k 6x4 operators (bavoxel.hpp:354-360): [[-hat(u_k), 0], [0, u_k]]
    Uk = torch.zeros((G, 3, 6, 4), dtype=dtype, device=dev)
    Uk[..., :3, :3] = -lie.hat(uT)
    Uk[..., 3:, 3] = uT

    # temp = T[:3, :] with its translation column shifted by -vbar
    # (bavoxel.hpp:368-369)
    if centered:
        temp = Tg[..., :3, :].clone()
    else:
        temp = T[None, :, :3, :].expand(G, W, 3, 4).clone()
    temp[..., :, 3] -= vbar[:, None, :]
    X = sm.matmul(TC, temp, transpose_b=True)    # (G, W, 4, 3)

    inv_NN = (1.0 / NNs)[:, None]                # (G, 1)
    scale = torch.clamp(lam[..., 2], min=1e-30)
    ks_all = [k for k in range(3) if k not in l_set]
    nk = len(ks_all)

    jvec_total = torch.zeros((G, W, 6), dtype=dtype, device=dev)
    Dblk = torch.zeros((G, W, 6, 6), dtype=dtype, device=dev)
    row_groups = []
    for l in l_set:
        u_l = U[..., :, l]                       # (G, 3)
        Ul = Uk[:, l]                            # (G, 6, 4)

        # g_kl vectors (bavoxel.hpp:372-378)
        Xul = sm.matvec(X, u_l[:, None])                          # (G, W, 4)
        g1 = torch.sum(Uk[:, :, None, :, :] * Xul[:, None, :, None, :],
                       dim=-1)                                    # (G,3,W,6)
        UlX = sm.matmul(Ul[:, None], X)                           # (G,W,6,3)
        g2 = torch.sum(UlX[:, None] * uT[:, :, None, None, :], dim=-1)
        g_kl = (g1 + g2) * inv_NN[..., None, None]

        # a_i = U_l (TC_i) e_3 (bavoxel.hpp:380)
        a = sm.matvec(Ul[:, None], TC[..., :, 3])                 # (G, W, 6)

        # block-diagonal corrections (bavoxel.hpp:385-401)
        UlTCT = sm.matmul(Ul[:, None], TCT)                       # (G,W,6,4)
        Hb = sm.matmul(UlTCT, Ul[:, None], transpose_b=True)
        Hb = Hb * (2.0 * inv_NN)[..., None, None]
        y = sm.matvec(X[..., :3, :], u_l[:, None])                # (G, W, 3)
        Ell = sm.matmul(lie.hat(y), lie.hat(u_l)[:, None]) \
            * inv_NN[..., None, None]
        Dl = Hb.clone()
        Dl[..., :3, :3] += Ell + Ell.transpose(-1, -2)

        jvec = g_kl[:, l]                                         # (G, W, 6)
        g_k = torch.stack([g_kl[:, k] for k in ks_all], dim=1)

        if centered:
            c = f.centers[:, None, :]
            a = lie.adjoint_translation_vec(a, c)
            jvec = lie.adjoint_translation_vec(jvec, c)
            g_k = lie.adjoint_translation_vec(
                g_k.reshape(G, nk * W, 6), c).reshape(G, nk, W, 6)
            Dl = lie.adjoint_translation_mat(Dl, c)
            # exact second-order chain term of the conjugated left chart
            Dl[..., :3, :3] += lie.centering_hessian_correction(
                jvec[..., 3:], c)

        jvec_total = jvec_total + jvec
        Dblk = Dblk + Dl

        # eigen-gap weights to the complement of l_set (bavoxel.hpp:390-392)
        gapk = torch.stack([lam[..., k] - lam[..., l] for k in ks_all],
                           dim=-1)
        wk = torch.where(gapk > gap_eps * scale[..., None],
                         2.0 * coe[..., None]
                         / torch.clamp(gapk, min=1e-30), 0.0)
        wa = 2.0 * coe / (NNs * NNs)
        row_groups.append(
            (torch.sqrt(wa)[:, None, None] * a).reshape(G, 6 * W)[:, None])
        row_groups.append(
            (torch.sqrt(wk)[..., None, None] * g_k).reshape(G, nk, 6 * W))

    # gradient (bavoxel.hpp:381)
    JacT = torch.sum(coe[:, None, None] * jvec_total, dim=0).reshape(6 * W)
    # all (i, j) blocks at once from the stacked scaled rows
    rows = torch.cat(row_groups, dim=1).reshape(-1, 6 * W)
    H = -(rows.T @ rows)
    D = torch.sum(coe[:, None, None, None] * Dblk, dim=0)         # (W, 6, 6)
    return residual, JacT, _add_diag_blocks(H, D)


def evaluate_right(T, f: PlaneFactors, *, use_lapack_eigh: bool = False,
                   gap_eps: float = 1e-9):
    """Residual, gradient and Hessian under RIGHT perturbation
    (R <- R Exp(w), p <- p + t) (reference acc_evaluate2,
    bavoxel.hpp:53-158).  Needs RAW body moments (no body_centers, no
    centering).  Like the reference, H carries the antisymmetric
    -0.5 hat(grad_rot) term on its rotation-rotation diagonal blocks
    (bavoxel.hpp:124), which vanishes at critical points."""
    with fp32_matmul():
        return _evaluate_right_impl(T, f, use_lapack_eigh, gap_eps)


def _evaluate_right_impl(T, f, use_lapack_eigh, gap_eps):
    G, W = f.C.shape[:2]
    dtype, dev = f.C.dtype, f.C.device
    _, TC, TCT, NNs, NN, vbar, covM = _plane_moment(T, f, centered=False)
    lam, U = _eigh(covM, use_lapack_eigh)

    valid = (NN > 0.5) & (f.coe > 0)
    coe = torch.where(valid, f.coe, 0.0)
    residual = torch.sum(coe * lam[..., 0])

    R = T[:, :3, :3]
    pfull = T[:, :3, 3]
    u0 = U[..., :, 0]                                 # (G, 3)
    uT = U.transpose(-1, -2)                          # (G, 3k, 3)

    Pi = f.C[..., :3, :3]                             # (G, W, 3, 3)
    vi = f.C[..., :3, 3]                              # (G, W, 3)
    ni = f.C[..., 3, 3]                               # (G, W)
    inv_NN = (1.0 / NNs)[:, None]                     # (G, 1)

    Rt = R.transpose(-1, -2)
    RiTuk = sm.matvec(Rt[None], u0[:, None])          # (G, W, 3)
    RiTukhat = lie.hat(RiTuk)
    PiRiTuk = sm.matvec(Pi, RiTuk)
    viRiTuk = torch.linalg.cross(vi, RiTuk, dim=-1)
    ti_v = pfull[None] - vbar[:, None]                # (G, W, 3)
    ukTti_v = torch.sum(u0[:, None] * ti_v, dim=-1)   # (G, W)

    combo1 = lie.hat(PiRiTuk) + lie.hat(vi) * ukTti_v[..., None, None]
    combo2 = sm.matvec(R[None], vi) + ni[..., None] * ti_v

    RP_tv = sm.matmul(R[None], Pi) + ti_v[..., :, None] * vi[..., None, :]
    left3 = sm.matmul(RP_tv, RiTukhat) - sm.matmul(R[None], combo1)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    right3 = (combo2[..., :, None] * u0[:, None, None, :]
              + torch.sum(combo2 * u0[:, None], dim=-1)[..., None, None]
              * eye3)
    Auk = torch.cat([left3, right3], dim=-1) * inv_NN[..., None, None]
    # (G, W, 3, 6)

    jjt = sm.matvec(Auk.transpose(-1, -2), u0[:, None])          # (G, W, 6)
    JacT = torch.sum(coe[:, None, None] * jjt, dim=0).reshape(6 * W)

    # rank-1 assembly over all pose pairs: b_m = Auk^T u_m (m = 1, 2),
    # weight 2 coe / (lam_m - lam_0)
    b = torch.sum(Auk[:, None] * uT[:, 1:, None, :, None], dim=-2)
    scale = torch.clamp(lam[..., 2], min=1e-30)
    gap = lam[..., 1:] - lam[..., 0:1]
    wk = torch.where(gap > gap_eps * scale[..., None],
                     2.0 * coe[..., None] / torch.clamp(gap, min=1e-30), 0.0)
    # c = [viRiTuk ; ni u0], weight 2 coe / NN^2
    c = torch.cat([viRiTuk, ni[..., None] * u0[:, None]], dim=-1)
    wc = 2.0 * coe / (NNs * NNs)
    rows = torch.cat([
        (torch.sqrt(wk)[..., None, None] * b).reshape(G, 2, 6 * W),
        (torch.sqrt(wc)[:, None, None] * c).reshape(G, 6 * W)[:, None, :],
    ], dim=1).reshape(3 * G, 6 * W)
    H = -(rows.T @ rows)

    # diagonal-only corrections
    tl = (sm.matmul(combo1 - sm.matmul(RiTukhat, Pi), RiTukhat)
          * (2.0 * inv_NN)[..., None, None]
          - 0.5 * lie.hat(jjt[..., :3]))
    tr = (2.0 * inv_NN)[..., None, None] * (
        viRiTuk[..., :, None] * u0[:, None, None, :])
    br = (2.0 * ni * inv_NN)[..., None, None] * (
        u0[:, None, :, None] * u0[:, None, None, :])
    Dblk = torch.cat([torch.cat([tl, tr], dim=-1),
                      torch.cat([tr.transpose(-1, -2), br], dim=-1)], dim=-2)
    D = torch.sum(coe[:, None, None, None] * Dblk, dim=0)
    return residual, JacT, _add_diag_blocks(H, D)
