"""Packed plane-factor evaluate: the two CUDA kernels and their glue.

Counterpart: balm_tpu/ops/pallas_evaluate.py — csum_packed (:180,
Pallas `_csum_kernel` :115, XLA form `csum_packed_xla` :229),
rows_packed_pallas (:1155, Pallas `_rows_only_kernel` :1126, math of
`_rows_channels_xla` :789), `_aux_from_csum` (:947), hess_packed_hybrid
(:1214), evaluate_packed_jw (:1232) and residual_only_packed (:1030).

Each kernel wrapper (`csum_packed`, `rows_packed`) takes its plain
PyTorch version (`*_plain`, beside it) only for tensors on the CPU.  For
CUDA tensors it checks dtype, shape and contiguity, launches the CUDA
kernel of csrc/packed_kernels.cu on the current stream, counts the
launch in its `launches` attribute, or raises: there is no fallback.

The Hessian product H = sum_k M_k M_k^T of the hybrid path is a plain
matrix product outside any kernel (torch.matmul, as the JAX package
leaves it to XLA's dot), run in full fp32: TF32 is switched off around
it, because TF32's 10-bit mantissa on moment math is the same silent
corruption as one bf16 pass on the TPU's MXU.
"""

from __future__ import annotations

import contextlib

import torch

from . import _cuda
from .eigh3 import eigh3, eigvals3
from .packed import PackedFactors, csum_to_cov, pad_poses

# aux channels: 0-2 u0 | 3-5 u1 | 6-8 u2 | 9-11 vbar | 12 invN | 13 sqrt_wa
#               | 14 sqrt_w1 | 15 sqrt_w2 | 16 coe(masked)
AUX_CH = 17
_VECH = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


@contextlib.contextmanager
def fp32_matmul():
    """Full-fp32 matrix products on the card (TF32 off), restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _on_cpu(*ts) -> bool:
    """True when every tensor lies on the CPU; False when every one lies
    on a CUDA device; raises on anything else."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return False
    raise ValueError(f"tensors must all lie on the CPU or on one CUDA "
                     f"device, got {[str(t.device) for t in ts]}")


def _check(name, t, shape):
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _packed_shapes(pose, mom):
    if mom.dim() != 3 or mom.shape[1] != 10:
        raise ValueError(f"mom must be (Wp, 10, Gp), got {tuple(mom.shape)}")
    Wp, _, Gp = mom.shape
    if Wp == 0 or Gp == 0:
        raise ValueError("empty packed problem (Wp or Gp is 0)")
    return Wp, Gp


# --------------------------------------------------------------------------
# B1: plane moments
# --------------------------------------------------------------------------

def _sym_square_op(R):
    """(W,3,3) -> (W,6,6) S with vech(R P R^T) = S @ vech(P)."""
    rows = []
    for (i, j) in _VECH:
        row = []
        for (k, l) in _VECH:
            s = R[:, i, k] * R[:, j, l]
            if k != l:
                s = s + R[:, i, l] * R[:, j, k]
            row.append(s)
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def csum_packed_plain(pose, mom, cen, cfix):
    """Plain version of the `csum` kernel (from csum_packed_xla,
    pallas_evaluate.py:229): pose (Wp,12), mom (Wp,10,Gp), cen (3,Gp),
    cfix (10,Gp) -> (10, Gp) channels [N*cov (6), vsum (3), N], two-pass
    centered (vbar first, then n (t - vbar)(t - vbar)^T)."""
    Wp = mom.shape[0]
    R = pose[:, :9].reshape(Wp, 3, 3)
    tw = pose[:, 9:12]
    P6 = mom[:, :6, :]
    b = mom[:, 6:9, :]
    n = mom[:, 9, :]
    nf = cfix[9]
    bf = cfix[6:9]

    with fp32_matmul():
        rpr = torch.einsum("wck,wkg->cg", _sym_square_op(R), P6)
    t = torch.stack([
        R[:, i, 0, None] * b[:, 0] + R[:, i, 1, None] * b[:, 1]
        + R[:, i, 2, None] * b[:, 2] + tw[:, i, None] - cen[None, i]
        for i in range(3)], dim=1)                  # (Wp, 3, Gp)

    Nn = n.sum(0) + nf
    vsum = (n[:, None, :] * t).sum(0) + nf * bf
    Ns = torch.where(Nn > 0.5, Nn, 1.0)
    vbar = vsum / Ns
    d = t - vbar[None]
    nd = n[:, None, :] * d
    cN = torch.stack([(nd[:, i] * d[:, j]).sum(0) for (i, j) in _VECH])
    df = bf - vbar
    fixq = torch.where(nf > 0.5, nf, 0.0)
    fixdd = torch.stack([fixq * df[i] * df[j] for (i, j) in _VECH])
    covN = rpr + cN + cfix[:6] + fixdd
    return torch.cat([covN, vsum, Nn[None]], dim=0)


def csum_packed(pose, mom, cen, cfix):
    """B1 wrapper: world plane moments (10, Gp) — the CUDA `csum` kernel
    on CUDA tensors, csum_packed_plain on CPU tensors."""
    if _on_cpu(pose, mom, cen, cfix):
        return csum_packed_plain(pose, mom, cen, cfix)
    Wp, Gp = _packed_shapes(pose, mom)
    _check("pose", pose, (Wp, 12))
    _check("mom", mom, (Wp, 10, Gp))
    _check("cen", cen, (3, Gp))
    _check("cfix", cfix, (10, Gp))
    out = torch.empty((10, Gp), dtype=torch.float32, device=mom.device)
    rc = _cuda.lib().balm_csum_packed(
        pose.data_ptr(), mom.data_ptr(), cen.data_ptr(), cfix.data_ptr(),
        out.data_ptr(), Wp, Gp, mom.device.index, _cuda.stream_of(mom))
    _cuda.check_launch(rc, "csum")
    csum_packed.launches += 1
    return out


csum_packed.launches = 0


# --------------------------------------------------------------------------
# B2: rank rows, gradient and diagonal blocks
# --------------------------------------------------------------------------

def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sym3(pch):
    return [[pch[0], pch[1], pch[2]],
            [pch[1], pch[3], pch[4]],
            [pch[2], pch[4], pch[5]]]


def _rprt(r, P):
    A = [[r[3 * i + 0] * P[0][j] + r[3 * i + 1] * P[1][j]
          + r[3 * i + 2] * P[2][j] for j in range(3)] for i in range(3)]
    return [[A[i][0] * r[3 * j + 0] + A[i][1] * r[3 * j + 1]
             + A[i][2] * r[3 * j + 2] for j in range(3)] for i in range(3)]


def rows_packed_plain(pose, mom, cen, aux):
    """Plain version of the `rows` kernel (from _rows_channels_xla,
    pallas_evaluate.py:789-909): -> (rows (3, 6, Wp, Gp) with
    rows[k, j] the j-th entry of rank row k, J (Wp, 6), D (Wp, 36))."""
    r = [pose[:, k:k + 1] for k in range(9)]        # (Wp, 1) each
    tw = [pose[:, 9 + k:10 + k] for k in range(3)]
    pch = [mom[:, k, :] for k in range(6)]          # (Wp, Gp)
    b = [mom[:, 6 + k, :] for k in range(3)]
    n = mom[:, 9, :]
    c = [cen[k][None, :] for k in range(3)]         # (1, Gp)

    u = [[aux[3 * k + m][None, :] for m in range(3)] for k in range(3)]
    vb = [aux[9 + m][None, :] for m in range(3)]
    invN = aux[12][None, :]
    sqa = aux[13][None, :]
    sqk = [aux[14][None, :], aux[15][None, :]]
    coew = aux[16][None, :]
    u0 = u[0]

    t = [r[3 * i] * b[0] + r[3 * i + 1] * b[1] + r[3 * i + 2] * b[2]
         + tw[i] - c[i] for i in range(3)]
    RPRt = _rprt(r, _sym3(pch))
    d3 = [t[m] - vb[m] for m in range(3)]
    nt = [n * t[m] for m in range(3)]
    X3 = [[RPRt[a][bb] + nt[a] * d3[bb] for bb in range(3)]
          for a in range(3)]
    X4 = [n * d3[m] for m in range(3)]

    def x3_dot(v):
        return [X3[a][0] * v[0] + X3[a][1] * v[1] + X3[a][2] * v[2]
                for a in range(3)]

    Xu = [x3_dot(u[k]) for k in range(3)]
    Xu3 = [_dot3(X4, u[k]) for k in range(3)]

    a_rot = _cross(nt, u0)
    a_tr = [n * u0[m] for m in range(3)]
    jrot = [2.0 * invN * v for v in _cross(Xu[0], u0)]
    jtr = [2.0 * invN * u0[m] * Xu3[0] for m in range(3)]

    g_rot, g_tr = [], []
    for k in (1, 2):
        g1r = _cross(Xu[0], u[k])
        g2r = _cross(Xu[k], u0)
        g_rot.append([invN * (g1r[m] + g2r[m]) for m in range(3)])
        g_tr.append([invN * (u[k][m] * Xu3[0] + u0[m] * Xu3[k])
                     for m in range(3)])

    # block-diagonal correction (derivation at pallas_evaluate.py:284-440)
    Y = [[X3[a][bb] + nt[a] * vb[bb] for bb in range(3)] for a in range(3)]
    B1c = [[-v for v in _cross(u0, [Y[0][j], Y[1][j], Y[2][j]])]
           for j in range(3)]
    B1r = [[B1c[j][a] for j in range(3)] for a in range(3)]
    TL = [[-v for v in _cross(u0, B1r[a])] for a in range(3)]
    y = Xu[0]
    ydu = _dot3(y, u0)
    two_invN = 2.0 * invN
    Dtl = [[invN * (u0[a] * y[bb] + y[a] * u0[bb]) + two_invN * TL[a][bb]
            for bb in range(3)] for a in range(3)]
    for a in range(3):
        Dtl[a][a] = Dtl[a][a] - two_invN * ydu
    Dtr = [[two_invN * a_rot[a] * u0[bb] for bb in range(3)]
           for a in range(3)]
    Dbr = [[two_invN * n * u0[a] * u0[bb] for bb in range(3)]
           for a in range(3)]
    Dbl = [[Dtr[bb][a] for bb in range(3)] for a in range(3)]

    def adj_vec(rot, tr):
        cx = _cross(c, tr)
        return [rot[m] + cx[m] for m in range(3)], tr

    a_rot, a_tr = adj_vec(a_rot, a_tr)
    jrot, jtr = adj_vec(jrot, jtr)
    for k in range(2):
        g_rot[k], g_tr[k] = adj_vec(g_rot[k], g_tr[k])

    def rows_pluscross(Mr, Nr):
        return [[Mr[a][bb] + _cross(c, Nr[a])[bb] for bb in range(3)]
                for a in range(3)]

    def cols_pluscross(Mc, Nc):
        out = [[None] * 3 for _ in range(3)]
        for bb in range(3):
            cx = _cross(c, [Nc[0][bb], Nc[1][bb], Nc[2][bb]])
            for a in range(3):
                out[a][bb] = Mc[a][bb] + cx[a]
        return out

    A2 = rows_pluscross(Dtl, Dtr)
    C2 = rows_pluscross(Dbl, Dbr)
    Dtl = cols_pluscross(A2, C2)
    Dtr = cols_pluscross(Dtr, Dbr)
    Dbl = C2
    gdc = _dot3(jtr, c)
    for a in range(3):
        for bb in range(3):
            Dtl[a][bb] = Dtl[a][bb] + 0.5 * (jtr[a] * c[bb] + c[a] * jtr[bb])
        Dtl[a][a] = Dtl[a][a] - gdc

    av = a_rot + a_tr
    jv = jrot + jtr
    g1v = g_rot[0] + g_tr[0]
    g2v = g_rot[1] + g_tr[1]
    rows = torch.stack([
        torch.stack([sqa * av[j] for j in range(6)]),
        torch.stack([sqk[0] * g1v[j] for j in range(6)]),
        torch.stack([sqk[1] * g2v[j] for j in range(6)]),
    ])                                              # (3, 6, Wp, Gp)
    J = torch.stack([(coew * jv[j]).sum(1) for j in range(6)], dim=1)
    Dfull = [[Dtl, Dtr], [Dbl, Dbr]]
    D = torch.stack([(coew * Dfull[a // 3][bb // 3][a % 3][bb % 3]).sum(1)
                     for a in range(6) for bb in range(6)], dim=1)
    return rows, J, D


def rows_packed(pose, mom, cen, aux):
    """B2 wrapper: (rows (3, 6, Wp, Gp), J (Wp, 6), D (Wp, 36)) — the CUDA
    `rows` kernel on CUDA tensors, rows_packed_plain on CPU tensors."""
    if _on_cpu(pose, mom, cen, aux):
        return rows_packed_plain(pose, mom, cen, aux)
    Wp, Gp = _packed_shapes(pose, mom)
    _check("pose", pose, (Wp, 12))
    _check("mom", mom, (Wp, 10, Gp))
    _check("cen", cen, (3, Gp))
    _check("aux", aux, (AUX_CH, Gp))
    lib = _cuda.lib()
    bg = lib.balm_rows_block_planes()
    ntiles = -(-Gp // bg)
    dev = mom.device
    rows = torch.empty((3, 6, Wp, Gp), dtype=torch.float32, device=dev)
    partial = torch.empty((Wp, ntiles, 42), dtype=torch.float32, device=dev)
    J = torch.empty((Wp, 6), dtype=torch.float32, device=dev)
    D = torch.empty((Wp, 36), dtype=torch.float32, device=dev)
    rc = lib.balm_rows_packed(
        pose.data_ptr(), mom.data_ptr(), cen.data_ptr(), aux.data_ptr(),
        rows.data_ptr(), partial.data_ptr(), J.data_ptr(), D.data_ptr(),
        Wp, Gp, dev.index, _cuda.stream_of(mom))
    _cuda.check_launch(rc, "rows")
    rows_packed.launches += 1
    return rows, J, D


rows_packed.launches = 0


# --------------------------------------------------------------------------
# Glue: full evaluate / residual
# --------------------------------------------------------------------------

def _aux_from_csum(csum, pk: PackedFactors, gap_eps):
    """Eigendecomposition + per-plane weights -> (res, aux (17, Gp))."""
    N, Ns, valid, vbar, cov = csum_to_cov(csum, pk.coe)
    lam, U = eigh3(cov)                                   # (Gp,3), (Gp,3,3)
    coew = torch.where(valid, pk.coe[0], 0.0)
    res = torch.sum(coew * lam[:, 0])
    invN = 1.0 / Ns
    sqa = torch.sqrt(2.0 * coew) * invN
    scale = torch.clamp(lam[:, 2], min=1e-30)
    gap = lam[:, 1:] - lam[:, 0:1]
    wk = torch.where(gap > gap_eps * scale[:, None],
                     2.0 * coew[:, None] / torch.clamp(gap, min=1e-30), 0.0)
    sqw = torch.sqrt(wk)                                  # (Gp, 2)
    aux = torch.cat([
        U[:, :, 0].T, U[:, :, 1].T, U[:, :, 2].T,
        vbar,
        invN[None], sqa[None], sqw[:, 0][None], sqw[:, 1][None],
        coew[None],
    ], dim=0).to(torch.float32).contiguous()              # (17, Gp)
    return res, aux


def _hess_precision(hess_precision):
    """'high'/'highest'/None -> fp32; 'bf16' waits for ROADMAP queue B3."""
    if hess_precision in (None, "high", "highest"):
        return
    if hess_precision == "bf16":
        raise NotImplementedError(
            "hess_precision='bf16' is not ported yet (ROADMAP.md, queue B3)")
    raise ValueError(f"unknown hess_precision {hess_precision!r}")


def hess_packed_hybrid(pose, mom, cen, aux, *, hess_precision=None):
    """-> (Htilde (6Wp, 6Wp) in (j, w)-major order, J (Wp, 6),
    D (Wp, 36)): the `rows` kernel, then H = sum_k M_k M_k^T in fp32."""
    _hess_precision(hess_precision)
    rows, J, D = rows_packed(pose, mom, cen, aux)
    Wp, Gp = mom.shape[0], mom.shape[2]
    M = rows.view(3, 6 * Wp, Gp)            # layout-free (j, w)-major
    with fp32_matmul():
        H = torch.mm(M[0], M[0].T)
        H.addmm_(M[1], M[1].T)
        H.addmm_(M[2], M[2].T)
    return H, J, D


def evaluate_packed_jw(R, p, pk: PackedFactors, *, gap_eps: float = 1e-9,
                       hess_precision=None):
    """Residual, gradient and Newton Hessian in (j, w)-MAJOR order
    (index = j * W + w): (res, J_jw (6W,), H_jw (6W, 6W))."""
    W = R.shape[0]
    Wp = pk.wp
    pose = pad_poses(R, p, Wp).to(torch.float32)
    csum = csum_packed(pose, pk.mom, pk.cen, pk.cfix)
    res, aux = _aux_from_csum(csum, pk, gap_eps)
    Ht, Jt, Dt = hess_packed_hybrid(pose, pk.mom, pk.cen, aux,
                                    hess_precision=hess_precision)
    H = -Ht.view(6, Wp, 6, Wp)[:, :W, :, :W]
    D = Dt[:W, :36].reshape(W, 6, 6)
    # H[a, w, b, w] += D[w, a, b]: the (1, 3) diagonal is a view of H
    torch.diagonal(H, dim1=1, dim2=3).add_(D.permute(1, 2, 0))
    J = Jt[:W, :6].T.reshape(6 * W)
    return res, J, H.reshape(6 * W, 6 * W)


def residual_only_packed(R, p, pk: PackedFactors):
    """Total cost sum_g coe_g lambda_0(g): the `csum` kernel + eigvals."""
    pose = pad_poses(R, p, pk.wp).to(torch.float32)
    csum = csum_packed(pose, pk.mom, pk.cen, pk.cfix)
    N, Ns, valid, vbar, cov = csum_to_cov(csum, pk.coe)
    lam = eigvals3(cov)
    coew = torch.where(valid, pk.coe[0], 0.0)
    return torch.sum(coew * lam[:, 0])
