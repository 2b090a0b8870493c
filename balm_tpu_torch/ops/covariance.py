"""First-order pose-covariance propagation (BALM2 paper sec. V).

Counterpart: balm_tpu/ops/covariance.py — _stat_basis (:44), _g1 (:62),
_g2 (:67), scatter_jacobian_rhs (:77, _scatter_rhs_impl :92) and
pose_covariance (:221); reference `left_jacobian_point` +
`multi_second` (src/simulation/BAs_left.hpp:342-473, 995-1023) and the
final Rcov = H^{-1} (sum_gj L c L^T) H^{-T} (BAs_left.hpp:1089-1096).

The converged gradient J(x*, s) = 0 defines x*(s) implicitly, s_gj the
9 statistics (6 of P, 3 of v) of the (plane, scan) clusters under iid
point noise.  To first order

    cov(x*) = H^{-1} [ sum_{g,j} L_gj ccov_gj L_gj^T ] H^{-T}

with L_gj = dJ/ds_gj (6W x 9) and ccov_gj from clusters.stat_noise_cov.
The rows of L decompose as

    L_gj[p] = 2/NN * ( A_gp G_gj - (1/NN) a_gp q_gj^T + delta_jp D_gj )

with per-(g,p) A (6x3), a (6,) and per-(g,j) G (3x9), q (9,), D (6x9).
With V_gj = [G_gj ; -q_gj^T/NN] (4x9), S_g = sum_j V c V^T (4x4) and
P_gp = [A_gp | a_gp] (6x4):

    sum_j L c L^T = P S P^T + P N + (P N)^T + blockdiag_j(D c D^T),
    N_gq = V_gq ccov_gq D_gq^T (4x6).

Every per-(plane, scan) product here is a broadcast multiply-add over
the small contraction index (no batched tiny matrix products); only
the two sums over planes, Pcols^T (S P) and Pcols^T Ncols, are large
products (torch.matmul, as the JAX package leaves them to XLA's dot).
The experiment runs in float64.
"""

from __future__ import annotations

import torch

from . import factors as F
from . import lie
from .eigh3 import eigh3
from .factors_windowed import _mm, _mmT, _mv

# the statistic order (Pxx, Pxy, Pxz, Pyy, Pyz, Pzz, vx, vy, vz)
_P6 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _stat_basis(dtype=torch.float64, device="cpu"):
    """E4 (9, 4, 4): C(s) = sum_i s_i E4_i in the statistic order —
    the reference's g1 stacking (BAs_left.hpp:322-331)."""
    E = torch.zeros((9, 4, 4), dtype=dtype, device=device)
    for i, (a, b) in enumerate(_P6):
        E[i, a, b] = 1.0
        E[i, b, a] = 1.0
    for i in range(3):
        E[6 + i, i, 3] = 1.0
        E[6 + i, 3, i] = 1.0
    return E


def _g1(w):
    """g1(w) (..., 4, 9) = d(C(s) w)/ds (BAs_left.hpp:322-331): column i
    is E4_i w, written out entry by entry."""
    z = torch.zeros_like(w[..., 0])
    x, y, zc, h = w[..., 0], w[..., 1], w[..., 2], w[..., 3]
    # columns: Pxx Pxy Pxz Pyy Pyz Pzz vx vy vz
    r0 = [x, y, zc, z, z, z, h, z, z]
    r1 = [z, x, z, y, zc, z, z, h, z]
    r2 = [z, z, x, z, y, zc, z, z, h]
    r3 = [z, z, z, z, z, z, x, y, zc]
    return torch.stack([torch.stack(r, -1) for r in (r0, r1, r2, r3)], -2)


def _g2(w):
    """(..., 4) -> (..., 6, 3): [[hat(w[:3])], [w3 I]]
    (BAs_left.hpp:333-340)."""
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return torch.cat([lie.hat(w[..., :3]), w[..., 3, None, None] * eye],
                     dim=-2)


def scatter_jacobian_rhs(T, f: F.PlaneFactors, ccov, *,
                         gap_eps: float = 1e-9):
    """sum_{g,j} L_gj ccov_gj L_gj^T (6W, 6W).

    T (W, 4, 4) converged poses, f PlaneFactors of tensor leaves with
    raw body moments (no centering; coe must be 1 for the consistency
    protocol, BAs_left.hpp:43-45), ccov (G, W, 9, 9) the statistic
    covariances.  Reference VOX_HESS::left_jacobian_point
    (BAs_left.hpp:342-473)."""
    G, W = f.C.shape[:2]
    dtype, dev = f.C.dtype, f.C.device

    _, TC, TCT, NNs, NN, vbar, covM = F._plane_moment(T, f, centered=False)
    lam, U = eigh3(covM)
    valid = (NN > 0.5) & (f.coe > 0)
    coe = torch.where(valid, f.coe, 0.0)

    u_l = U[..., :, 0]                               # (G, 3)
    uT = U.transpose(-1, -2)                         # (G, k, 3)
    # U_l (6, 4) = [[-hat(u_l), 0], [0, u_l]]
    Ul = torch.zeros((G, 6, 4), dtype=dtype, device=dev)
    Ul[:, :3, :3] = -lie.hat(u_l)
    Ul[:, 3:, 3] = u_l

    # the normalized world moment Cn (the reference's C after /NN)
    Cn = (f.Cfix + TCT.sum(1)) / NNs[:, None, None]
    SpTul = torch.cat([u_l, torch.zeros((G, 1), dtype=dtype, device=dev)],
                      -1)                            # (G, 4)

    # T_FC[p] = T[p]^T - F Cn, the bottom row of F Cn is Cn[3, :]
    Tt = T.transpose(-1, -2)                         # (W, 4, 4)
    FC = torch.zeros((G, 4, 4), dtype=dtype, device=dev)
    FC[:, 3, :] = Cn[:, 3, :]
    T_FC = Tt[None] - FC[:, None]                    # (G, W, 4, 4)
    inv_NN = 1.0 / NNs                               # (G,)

    # --- per-(g,p) pieces ---
    UlTC = _mm(Ul[:, None], TC)                      # (G, W, 6, 4)
    a = UlTC[..., :, 3]                              # (G, W, 6)
    w2 = _mv(_mm(TC, T_FC), SpTul[:, None])          # (G, W, 4)
    A = _g2(w2) + _mm(UlTC, T_FC[..., :3])           # (G, W, 6, 3)

    # --- per-(g,j) pieces ---
    wj = _mv(Tt[None], SpTul[:, None])               # (G, W, 4)
    # Gkl = T_FC[j]^T g1(T[j]^T Sp^T u_l) - T[j] g1(F Cn Sp^T u_l),
    # F Cn Sp^T u_l = e3 (vbar . u_l)
    vu = torch.sum(vbar * u_l, -1)                   # (G,)
    w_fc = torch.zeros((G, 4), dtype=dtype, device=dev)
    w_fc[:, 3] = vu
    Gkl = (_mm(T_FC.transpose(-1, -2), _g1(wj))
           - _mm(T[None], _g1(w_fc)[:, None]))       # (G, W, 4, 9)

    gap = lam[..., 1:] - lam[..., 0:1]               # (G, 2) >= 0
    scale = torch.clamp(lam[..., 2], min=1e-30)
    wgap = torch.where(
        gap > gap_eps * scale[..., None],
        -1.0 / (torch.clamp(gap, min=1e-30) * NNs[..., None]),
        0.0)                                         # 1/((lam_l-lam_k) NN)
    ukuk = uT[:, 1:, :, None] * uT[:, 1:, None, :]   # (G, 2, 3, 3)
    Pgap = torch.sum(wgap[..., None, None] * ukuk, 1)    # (G, 3, 3)
    Gj = _mm(Pgap[:, None], Gkl[..., :3, :])         # (G, W, 3, 9)

    # q_j (9,): nonzero only in the v slot, = R_j^T u_l
    qj = torch.cat([torch.zeros((G, W, 6), dtype=dtype, device=dev),
                    wj[..., :3]], -1)                # (G, W, 9)

    # D_j = U_l T[j] g1(T_FC[j] Sp^T u_l)
    wD = _mv(T_FC, SpTul[:, None])                   # (G, W, 4)
    Dj = _mm(_mm(Ul[:, None], T[None]), _g1(wD))     # (G, W, 6, 9)

    # clusters without points contribute nothing
    obs = (f.C[..., 3, 3] > 0.5) & valid[:, None]    # (G, W)
    ccov = ccov * obs.to(dtype)[..., None, None]

    V = torch.cat([Gj, -inv_NN[:, None, None, None] * qj[..., None, :]],
                  -2)                                # (G, W, 4, 9)
    Vc = _mm(V, ccov)                                # (G, W, 4, 9)
    S = _mmT(Vc, V).sum(1)                           # (G, 4, 4)
    Ncross = _mmT(Vc, Dj)                            # (G, W, 4, 6)
    Dblk = _mmT(_mm(Dj, ccov), Dj)                   # (G, W, 6, 6)

    # L_gj carries 2 coe_g / NN_g overall
    wplane = 2.0 * coe * inv_NN                      # (G,)
    n6 = 6 * W
    P = torch.cat([A, a[..., None]], -1) * wplane[:, None, None, None]
    Ncross = Ncross * wplane[:, None, None, None]

    # block layouts: rows (g, i < 4), columns (p, e < 6)
    Pmat = P.permute(0, 3, 1, 2).reshape(G, 4, n6)
    Pcols = Pmat.reshape(G * 4, n6)
    Ncols = Ncross.permute(0, 2, 1, 3).reshape(G * 4, n6)
    SP = _mm(S, Pmat)                                # (G, 4, 6W)
    main = Pcols.T @ SP.reshape(G * 4, n6)
    cross = Pcols.T @ Ncols
    rhs = main + cross + cross.T

    # block-diagonal D c D^T with weight wplane^2
    Dsum = torch.sum((wplane ** 2)[:, None, None, None] * Dblk, 0)
    return F._add_diag_blocks(rhs, Dsum)


def pose_covariance(T, f: F.PlaneFactors, ccov, *, gap_eps: float = 1e-9):
    """Full first-order pose covariance H^{-1} rhs H^{-T}
    (BAs_left.hpp:1089-1096), H from ops/factors.evaluate."""
    rhs = scatter_jacobian_rhs(T, f, ccov, gap_eps=gap_eps)
    _, _, H = F.evaluate(T, f, gap_eps=gap_eps)
    X = torch.linalg.solve(H, rhs)
    return torch.linalg.solve(H, X.T).T
