"""Span-compressed plane factors for large pose windows (W >> 10^2).

Counterpart: balm_tpu/ops/factors_windowed.py — WindowedFactors (:44),
from_dense (:71), to_dense (:109), HessParts (:125), _segment_pose_sum
(:143), _gathered_poses (:152), _window_moment (:166), _lambda0_rayleigh
(:223), residual_only_windowed (:276), evaluate_windowed (:286), hvp
(:380), hess_diag (:394), block_jacobi (:407) and band_hessian (:424).

Each plane is seen from a short CONTIGUOUS stretch of the trajectory, so
its moments are stored over its observation span [base_g, base_g + S)
only (memory O(G S)), and the Hessian H = -R^T R + blockdiag(D) stays
factored (HessParts): hvp applies it in O(G S), band_hessian assembles
its exact block band for the banded direct solve (solver/banded.py).
The math is ops/factors.evaluate(centered=True)'s over span-local slots.

Two rules of the port, both about the card:
  * Every reduction over poses is a segment sum over the sorted (plane,
    slot) -> pose map (`PoseSegments`, built once per solve), through
    ops/segments.sorted_segment_sum: no float scatter, so the same input
    gives the same bits.  The clipped padding slots (base + s > W - 1,
    clipped onto pose W - 1 in JAX) carry exact zeros and are dropped
    from the map; every in-range slot stays (an unobserved one adds
    zeros).
  * The per-(plane, slot) products of 3x3/4x4/6x4 matrices are broadcast
    multiply-adds (`_mm`, `_mmT`, `_mv`), never batched torch.matmul: on
    the card those lower to cuBLAS batched tiny GEMMs, which took 85% of
    the dense XLA-formulated solve's device time (PERF.md §5).
The evaluate runs in full fp32 (ops/precision.fp32_matmul), as JAX pins
float32 (:276-297).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import lie
from .eigh3 import eigh3
from .factors import PlaneFactors
from .precision import fp32_matmul
from .segments import sorted_segment_sum


def _mm(A, B):
    """(..., m, k) @ (..., k, n), batch dims broadcast, elementwise."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def _mmT(A, B):
    """(..., m, k) @ (..., n, k)^T, batch dims broadcast, elementwise."""
    return torch.sum(A[..., :, None, :] * B[..., None, :, :], dim=-1)


def _mv(A, v):
    """(..., m, k) @ (..., k) -> (..., m), elementwise."""
    return torch.sum(A * v[..., None, :], dim=-1)


class WindowedFactors(NamedTuple):
    """Padded span-local batch of plane factors.

    C:            (G, S, 4, 4) body moments; slot s maps to pose base+s.
    base:         (G,) integer first observing pose.
    coe:          (G,) weights (0 = padding plane).
    centers:      (G, 3) world conditioning centers.
    body_centers: (G, S, 3) per-cluster body centroids (see PlaneFactors).
    Cfix:         (G, 4, 4) marginalized world moments.
    """

    C: object
    base: object
    coe: object
    centers: object
    body_centers: object
    Cfix: object

    @property
    def num_planes(self):
        return self.C.shape[0]

    @property
    def span(self):
        return self.C.shape[1]


def from_dense(f: PlaneFactors, span: int | None = None) -> WindowedFactors:
    """Compress a dense PlaneFactors batch of numpy leaves to its
    observation spans: host numpy preprocessing, run once per problem
    (JAX :71-106); windowed_from_numpy moves the result to a device.
    `span` caps the slot count; planes observed over a longer stretch
    keep their first `span` observers.
    """
    C = np.asarray(f.C)
    G, W = C.shape[:2]
    obs = C[..., 3, 3] > 0.5                                  # (G, W)
    any_obs = obs.any(axis=1)
    first = np.where(any_obs, obs.argmax(axis=1), 0)
    last = np.where(any_obs, W - 1 - obs[:, ::-1].argmax(axis=1), 0)
    S = int((last - first + 1).max()) if span is None else int(span)
    assert S >= 1

    idx = first[:, None] + np.arange(S)[None, :]              # (G, S)
    valid = idx <= np.minimum(last, W - 1)[:, None]
    idx_c = np.minimum(idx, W - 1)
    gC = np.take_along_axis(C, idx_c[:, :, None, None], axis=1)
    gB = np.take_along_axis(np.asarray(f.body_centers), idx_c[:, :, None],
                            axis=1)
    return WindowedFactors(
        C=gC * valid[:, :, None, None], base=first.astype(np.int64),
        coe=np.asarray(f.coe), centers=np.asarray(f.centers),
        body_centers=gB * valid[:, :, None], Cfix=np.asarray(f.Cfix))


def to_dense(wf: WindowedFactors, W: int) -> PlaneFactors:
    """Expand numpy windowed factors back to the dense (G, W, ...) layout
    (testing / small W)."""
    wC = np.asarray(wf.C)
    G, S = wC.shape[:2]
    idx = np.clip(np.asarray(wf.base)[:, None] + np.arange(S)[None, :], 0,
                  W - 1)
    C = np.zeros((G, W, 4, 4), dtype=wC.dtype)
    B = np.zeros((G, W, 3), dtype=C.dtype)
    gi = np.repeat(np.arange(G), S)
    np.add.at(C, (gi, idx.reshape(-1)), wC.reshape(G * S, 4, 4))
    np.add.at(B, (gi, idx.reshape(-1)),
              np.asarray(wf.body_centers).reshape(G * S, 3))
    return PlaneFactors(C=C, Cfix=wf.Cfix, coe=wf.coe, centers=wf.centers,
                        body_centers=B)


def windowed_from_numpy(fields, *, device="cpu", dtype=torch.float32):
    """Numpy leaves (C, base, coe, centers, body_centers, Cfix) — e.g.
    `[np.asarray(x) for x in balm_tpu_windowed_factors]` — ->
    WindowedFactors of torch tensors on `device`: base as int64, the rest
    of `dtype`."""
    C, base, coe, centers, body_centers, Cfix = [np.asarray(x)
                                                 for x in fields]
    T = lambda x: torch.tensor(x, dtype=dtype, device=device)
    return WindowedFactors(
        C=T(C), base=torch.tensor(base, dtype=torch.int64, device=device),
        coe=T(coe), centers=T(centers), body_centers=T(body_centers),
        Cfix=T(Cfix))


class PoseSegments(NamedTuple):
    """The (plane, slot) -> pose map of one solve, sorted by pose.

    idx:  (G, S) clipped pose index of each slot (the gather map).
    perm: (N,) flat (g * S + s) slots in range (base + s <= W - 1),
          stably sorted by pose.
    seg:  (N,) their poses, ascending.
    W:    number of poses.
    """

    idx: torch.Tensor
    perm: torch.Tensor
    seg: torch.Tensor
    W: int


def pose_segments(base, S: int, W: int) -> PoseSegments:
    """Build the sorted slot -> pose map of span S over W poses (once
    per solve: `base` is fixed for a whole solve)."""
    raw = base.to(torch.int64)[:, None] + torch.arange(
        S, dtype=torch.int64, device=base.device)[None, :]
    flat = raw.reshape(-1)
    keep = torch.nonzero(flat <= W - 1)[:, 0]
    order = torch.argsort(flat[keep], stable=True)
    perm = keep[order]
    return PoseSegments(idx=torch.clamp(raw, 0, W - 1), perm=perm,
                        seg=flat[perm], W=W)


def _segments(base, S, W, seg):
    return seg if seg is not None else pose_segments(base, S, W)


def _segment_pose_sum(vals, seg: PoseSegments):
    """sum_{(g,s) -> pose} vals (G, S, ...) -> (W, ...)."""
    G, S = vals.shape[:2]
    tail = vals.shape[2:]
    flat = vals.reshape(G * S, -1)[seg.perm]
    out = sorted_segment_sum(flat, seg.seg, num_segments=seg.W)
    return out.reshape((seg.W,) + tuple(tail))


class HessParts(NamedTuple):
    """Factored normal equations:  H = -sum_g rows_g^T rows_g + diag(D).

    res:   scalar cost.
    J:     (W, 6) assembled gradient.
    rows:  (G, 3, S, 6) sqrt-weighted rank rows (types: a, g_1, g_2),
           span-local.
    D:     (W, 6, 6) assembled block-diagonal correction (coe-weighted).
    base:  (G,) span offsets (copied from the factors for convenience).
    seg:   the solve's PoseSegments (the port's; None builds one).
    """

    res: torch.Tensor
    J: torch.Tensor
    rows: torch.Tensor
    D: torch.Tensor
    base: torch.Tensor
    seg: object = None


def _gathered_poses(R, p, wf: WindowedFactors, seg: PoseSegments):
    """Per-(plane, slot) shifted pose blocks (G, S, 3, 3), (G, S, 3)."""
    Rg = R[seg.idx]                                          # (G, S, 3, 3)
    tg = p[seg.idx]                                          # (G, S, 3)
    t_new = _mv(Rg, wf.body_centers) + tg - wf.centers[:, None, :]
    return Rg, t_new


def _window_moment(R, p, wf: WindowedFactors, seg: PoseSegments):
    """World plane moments over the span (centered frame), with JAX's
    TWO-PASS centered accumulation (:166-220): pass 1 forms the mean
    vbar, pass 2 sums R P R^T + (R v) d^T + d (R v)^T + n d d^T with
    d = t - vbar, whose terms are all O(spread^2)."""
    Rg, t_new = _gathered_poses(R, p, wf, seg)
    G, S = Rg.shape[:2]
    top = torch.cat([Rg, t_new[..., None]], dim=-1)
    bot = torch.zeros((G, S, 1, 4), dtype=R.dtype, device=R.device)
    bot[..., 0, 3] = 1.0
    Tg = torch.cat([top, bot], dim=-2)                       # (G, S, 4, 4)
    TC = _mm(Tg, wf.C)
    TCT = _mmT(TC, Tg)

    # fixed moment, shifted then recentered about its own centroid
    Sfix = torch.eye(4, dtype=wf.Cfix.dtype, device=wf.Cfix.device
                     ).expand(wf.Cfix.shape).clone()
    Sfix[..., :3, 3] = -wf.centers
    Cfix = _mmT(_mm(Sfix, wf.Cfix), Sfix)
    nf = Cfix[..., 3, 3]
    nfs = torch.where(nf > 0.5, nf, 1.0)
    vf = Cfix[..., :3, 3]
    bf = vf / nfs[..., None]
    Pf = (Cfix[..., :3, :3]
          - vf[..., :, None] * vf[..., None, :] / nfs[..., None, None])

    n = wf.C[..., 3, 3]                                      # (G, S)
    v = wf.C[..., :3, 3]                                     # (G, S, 3)
    # pass 1: count + mean
    NN = torch.sum(n, dim=1) + nf
    NNs = torch.where(NN > 0.5, NN, 1.0)
    Rv = _mv(Rg, v)                                          # (G, S, 3)
    vsum = torch.sum(Rv + n[..., None] * t_new, dim=1) + vf
    vbar = vsum / NNs[..., None]
    # pass 2: centered second moment
    d = t_new - vbar[:, None, :]                             # (G, S, 3)
    RPRt = _mmT(_mm(Rg, wf.C[..., :3, :3]), Rg)
    cross = Rv[..., :, None] * d[..., None, :]
    covN = torch.sum(
        RPRt + cross + cross.transpose(-1, -2)
        + n[..., None, None] * d[..., :, None] * d[..., None, :], dim=1)
    df = bf - vbar
    covN = covN + Pf + nfs[..., None, None] * torch.where(
        (nf > 0.5)[..., None, None],
        df[..., :, None] * df[..., None, :], 0.0)
    covM = covN / NNs[..., None, None]
    aux = (Rg, d, Rv, Pf, nf, df)
    return Tg, TC, TCT, NNs, NN, vbar, covM, aux


def _lambda0_rayleigh(wf: WindowedFactors, NNs, covM, aux, lam=None,
                      U=None):
    """PROJECT-FIRST refinement of the eigenvalues (JAX :223-273): take
    u_k from the eigensolve, project every moment term onto u_k first,
    then accumulate

        lam_k = (sum_s [w^T P w + 2 (w^T v)(u_k.d) + n (u_k.d)^2]
                 + u_k^T Pf u_k + nf (u_k.df)^2) / NN,   w = R_s^T u_k

    — u_k.d has no cancellation against the in-plane spread, where the
    direct f32 eigenvalue carries +-eps * lambda_2 noise.  Sorted
    ascending with a stable sort (jnp.argsort's)."""
    if U is None:
        lam, U = eigh3(covM)
    Rg, d, Rv, Pf, nf, df = aux
    C = wf.C
    P = C[..., :3, :3]                                   # (G, S, 3, 3)
    v = C[..., :3, 3]
    n = C[..., 3, 3]
    Ug = U[:, None]                                      # (G, 1, 3, 3)
    # w[g,s,b,k] = sum_a Rg[g,s,a,b] U[g,a,k] ;  ud[g,s,k] = u_k . d
    w = torch.sum(Rg[..., :, :, None] * Ug[..., :, None, :], dim=-3)
    ud = torch.sum(Ug * d[..., :, None], dim=-2)
    wPw = torch.sum(w * _mm(P, w), dim=-2)
    wv = torch.sum(w * v[..., :, None], dim=-2)
    terms = wPw + 2.0 * wv * ud + n[..., None] * ud * ud   # (G, S, k)
    uPfu = torch.sum(U * _mm(Pf, U), dim=-2)
    udf = torch.sum(U * df[..., :, None], dim=-2)
    fix = uPfu + torch.where((nf > 0.5)[..., None],
                             nf[..., None] * udf * udf, 0.0)
    lamR = (torch.sum(terms, dim=1) + fix) / NNs[..., None]
    # keep the eigensolve's ordering guarantees: sort ascending
    order = torch.argsort(lamR, dim=-1, stable=True)
    lamR = torch.gather(lamR, -1, order)
    U = torch.gather(U, -1, order[:, None, :].expand(U.shape))
    return lamR, U


def residual_only_windowed(R, p, wf: WindowedFactors, *, seg=None):
    """Total cost sum_g coe_g lambda_0 (evaluate_only_residual,
    bavoxel.hpp:428-470, in span-local form).  seg: the solve's
    PoseSegments (None builds one)."""
    seg = _segments(wf.base, wf.span, R.shape[0], seg)
    with fp32_matmul():
        _, _, _, NNs, NN, _, covM, aux = _window_moment(R, p, wf, seg)
        lam, _ = _lambda0_rayleigh(wf, NNs, covM, aux)
        valid = (NN > 0.5) & (wf.coe > 0)
        return torch.sum(torch.where(valid, wf.coe * lam[..., 0], 0.0))


def evaluate_windowed(R, p, wf: WindowedFactors, *, gap_eps: float = 1e-9,
                      use_lapack_eigh: bool = False, seg=None) -> HessParts:
    """Residual, gradient, and factored Hessian parts (JAX :286-377).

    Math identical to factors.evaluate(centered=True, l_set=(0,))
    (left_evaluate_acc2, bavoxel.hpp:304-426) but over span-local slots,
    never materializing (6W, 6W).  seg: the solve's PoseSegments (None
    builds one); it rides on the parts for hvp and the assemblies.
    """
    seg = _segments(wf.base, wf.span, R.shape[0], seg)
    with fp32_matmul():
        return _evaluate_windowed_impl(R, p, wf, gap_eps, use_lapack_eigh,
                                       seg)


def _evaluate_windowed_impl(R, p, wf, gap_eps, use_lapack_eigh, seg):
    G, S = wf.C.shape[:2]
    dtype, dev = wf.C.dtype, wf.C.device

    Tg, TC, TCT, NNs, NN, vbar, covM, maux = _window_moment(R, p, wf, seg)
    if use_lapack_eigh:
        lam, U = torch.linalg.eigh(covM)
    else:
        lam, U = eigh3(covM)
    lam, U = _lambda0_rayleigh(wf, NNs, covM, maux, lam, U)

    valid = (NN > 0.5) & (wf.coe > 0)
    coe = torch.where(valid, wf.coe, 0.0)
    res = torch.sum(coe * lam[..., 0])

    uT = U.transpose(-1, -2)                         # (G, 3, 3) rows u_k
    Uk = torch.zeros((G, 3, 6, 4), dtype=dtype, device=dev)
    Uk[..., :3, :3] = -lie.hat(uT)
    Uk[..., 3:, 3] = uT

    temp = Tg[..., :3, :].clone()
    temp[..., :, 3] -= vbar[:, None, :]
    X = _mmT(TC, temp)                               # (G, S, 4, 3)
    inv_NN = (1.0 / NNs)[:, None]
    scale = torch.clamp(lam[..., 2], min=1e-30)

    u_l = U[..., :, 0]
    Ul = Uk[:, 0]                                    # (G, 6, 4)

    Xul = _mv(X, u_l[:, None])                       # (G, S, 4)
    g1 = torch.sum(Uk[:, :, None, :, :] * Xul[:, None, :, None, :], dim=-1)
    UlX = _mm(Ul[:, None], X)                        # (G, S, 6, 3)
    g2 = torch.sum(UlX[:, None] * uT[:, :, None, None, :], dim=-1)
    g_kl = (g1 + g2) * inv_NN[..., None, None]       # (G, 3, S, 6)

    a = _mv(Ul[:, None], TC[..., :, 3])              # (G, S, 6)

    Hb = _mmT(_mm(Ul[:, None], TCT), Ul[:, None])
    Hb = Hb * (2.0 * inv_NN)[..., None, None]
    y = _mv(X[..., :3, :], u_l[:, None])
    Ell = _mm(lie.hat(y), lie.hat(u_l)[:, None]) * inv_NN[..., None, None]
    Dl = Hb.clone()
    Dl[..., :3, :3] += Ell + Ell.transpose(-1, -2)

    jvec = g_kl[:, 0]
    g_k = g_kl[:, 1:]                                # (G, 2, S, 6)

    c = wf.centers[:, None, :]
    a = lie.adjoint_translation_vec(a, c)
    jvec = lie.adjoint_translation_vec(jvec, c)
    g_k = lie.adjoint_translation_vec(
        g_k.reshape(G, 2 * S, 6), c).reshape(G, 2, S, 6)
    Dl = _adjoint_translation_mat(Dl, c)
    Dl[..., :3, :3] += lie.centering_hessian_correction(jvec[..., 3:], c)

    gapk = lam[..., 1:] - lam[..., 0:1]
    wk = torch.where(gapk > gap_eps * scale[..., None],
                     2.0 * coe[..., None] / torch.clamp(gapk, min=1e-30),
                     0.0)
    wa = 2.0 * coe / (NNs * NNs)

    rows = torch.cat([torch.sqrt(wa)[:, None, None, None] * a[:, None],
                      torch.sqrt(wk)[..., None, None] * g_k], dim=1)

    J = _segment_pose_sum(coe[:, None, None] * jvec, seg)          # (W, 6)
    D = _segment_pose_sum(coe[:, None, None, None] * Dl, seg)      # (W,6,6)
    return HessParts(res=res, J=J, rows=rows, D=D, base=wf.base, seg=seg)


def _adjoint_translation_mat(M66, c):
    """lie.adjoint_translation_mat (J^T M J, J = [[I, 0], [-hat(c), I]])
    with its 3x3 products elementwise."""
    hc = lie.hat(c).expand(M66.shape[:-2] + (3, 3))
    A = M66[..., :3, :3]
    B = M66[..., :3, 3:]
    C = M66[..., 3:, :3]
    D = M66[..., 3:, 3:]
    A2 = A - _mm(B, hc)
    C2 = C - _mm(D, hc)
    top = torch.cat([A2 + _mm(hc, C2), B + _mm(hc, D)], dim=-1)
    bot = torch.cat([C2, D], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _parts_segments(parts: HessParts, W: int):
    return _segments(parts.base, parts.rows.shape[2], W, parts.seg)


def hvp(parts: HessParts, v, W: int):
    """H v for v (W, 6):  -R^T (R v) + D v, O(G S)."""
    seg = _parts_segments(parts, W)
    vg = v[seg.idx]                                           # (G, S, 6)
    y = torch.sum(parts.rows * vg[:, None], dim=(-2, -1))     # (G, 3)
    z = torch.sum(parts.rows * y[..., None, None], dim=1)     # (G, S, 6)
    return -_segment_pose_sum(z, seg) + _mv(parts.D, v)


def hess_diag(parts: HessParts, W: int):
    """diag(H) (W, 6) — the LM damping scale D = diag(H)
    (bavoxel.hpp:1113)."""
    seg = _parts_segments(parts, W)
    sq = torch.sum(parts.rows ** 2, dim=1)                    # (G, S, 6)
    return -_segment_pose_sum(sq, seg) + torch.diagonal(
        parts.D, dim1=-2, dim2=-1)


def _outer_rows(rows, other):
    """sum_t rows[g,t,s,i] other[g,t,s,j] -> (G, S, 6, 6)."""
    return torch.sum(rows[..., :, None] * other[..., None, :], dim=1)


def block_jacobi(parts: HessParts, W: int, damp, Dd=None):
    """The W (6, 6) diagonal blocks of H + damp * diag(Dd) — the
    preconditioner for the Krylov solve.  Dd (W, 6) is the (possibly
    tau-shifted) damping scale; None uses diag(H)."""
    seg = _parts_segments(parts, W)
    A = -_segment_pose_sum(_outer_rows(parts.rows, parts.rows), seg) \
        + parts.D
    dd = torch.diagonal(A, dim1=-2, dim2=-1) if Dd is None else Dd
    return A + damp * dd[..., None] * torch.eye(6, dtype=A.dtype,
                                                device=A.device)


def band_hessian(parts: HessParts, W: int):
    """The EXACT block band of H as Hband (W, S, 6, 6) with
    Hband[w, d] = H[6w:6w+6, 6(w+d):6(w+d)+6] for d in [0, S) (JAX
    :424-457): every factor observes a contiguous pose stretch of length
    <= S, so H is block-banded with half-bandwidth S-1.  O(G S^2) flops,
    O(G S + W S) memory: one pass per diagonal offset, as JAX's scan."""
    G, _, S, _ = parts.rows.shape
    seg = _parts_segments(parts, W)
    rows = parts.rows
    band = []
    for d in range(S):
        # slot s pairs with slot s + d (zero past the span end)
        sh = torch.zeros_like(rows)
        sh[:, :, :S - d] = rows[:, :, d:]
        band.append(_segment_pose_sum(_outer_rows(rows, sh), seg))
    band = -torch.stack(band, dim=1)                          # (W, S, 6, 6)
    band[:, 0] += parts.D
    return band
