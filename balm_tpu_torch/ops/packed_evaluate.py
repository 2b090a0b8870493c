"""Packed plane-factor evaluate: the CUDA kernels and their glue.

Counterpart: balm_tpu/ops/pallas_evaluate.py — csum_packed (:180,
Pallas `_csum_kernel` :115, XLA form `csum_packed_xla` :229),
rows_packed_pallas (:1155, Pallas `_rows_only_kernel` :1126, math of
`_rows_channels_xla` :789), the fused-Hessian kernels hess_packed (:444,
Pallas `_hess_kernel` :284), hess_packed_v2 (:552, `_hess_kernel_v2`
:491) and hess_packed_v3 (:697, `_hess_kernel_v3` :604),
hess_packed_xla (:912), `_aux_from_csum` (:947), evaluate_packed (:970),
residual_only_packed (:1030), `_chunk_pk`, evaluate_packed_chunked and
residual_only_packed_chunked (:1042-1123), hess_packed_hybrid (:1214)
and evaluate_packed_jw (:1232).

The device-batched hierarchy's evaluate (evaluate_packed_batched,
residual_only_packed_batched) is evaluate_packed(impl='xla') under the
JAX package's jax.vmap (balm_tpu/pipelines/hierarchical.py:711-713): B1
and B2 with a batch grid axis (csum_packed_batched, rows_packed_batched,
one launch each whatever the batch).

Each kernel wrapper (`csum_packed`, `rows_packed`, their `_batched`
forms, `hess_packed`, `hess_packed_v2`, `hess_pairs_v3`) takes its plain
PyTorch version
(`*_plain`, beside it) only for tensors on the CPU.  For CUDA tensors it
checks dtype, shape and contiguity, launches its CUDA kernel (csrc/) on
the current stream, counts the launch in its `launches` attribute, or
raises: there is no fallback.

The Hessian product H = sum_k M_k M_k^T of the hybrid and xla paths is a
plain matrix product outside any kernel (torch.matmul, as the JAX package
leaves it to XLA's dot), run in full fp32: TF32 is switched off around
it (precision.fp32_matmul; the LM loop holds the same context), because TF32's 10-bit mantissa on moment math is the same silent
corruption as one bf16 pass on the TPU's MXU.  Only a caller who asks
for hess_precision='bf16' gets that one pass (_bf16_product, the JAX
package's Precision.DEFAULT).  The fused kernels B4,
B5 and B6 compute the product on the tensor cores as the TPU kernels do,
from bf16 pieces of each value (split_bf16): `'bf16x3'` (three products
of hi/lo pieces, the default of B4 and B5 and JAX's) or `'f32'` (six
products of hi/mid/lo pieces, exact to fp32; B6 always, B4 and B5 when
asked).  B4 and B6 build the rank rows inside the product kernel; B5
writes the pieces of the rows to device memory once, then forms its pose
block pairs from them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from ._cuda import check as _check
from ._cuda import on_cpu as _on_cpu
from .eigh3 import eigh3, eigvals3
from .packed import PackedFactors, csum_to_cov, pad_poses
from .precision import fp32_matmul

# pose rows per block of the pose-block-pair grid of hess_packed_v3 (the
# JAX package's BW_HESS3, pallas_evaluate.py:600)
BW_HESS3 = 128

# aux channels: 0-2 u0 | 3-5 u1 | 6-8 u2 | 9-11 vbar | 12 invN | 13 sqrt_wa
#               | 14 sqrt_w1 | 15 sqrt_w2 | 16 coe(masked)
AUX_CH = 17
_VECH = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


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
# B1 and B2 over a batch of equal-shape problems (the hierarchy's blocks)
# --------------------------------------------------------------------------

def _batched_shapes(pose, mom):
    if mom.dim() != 4 or mom.shape[2] != 10:
        raise ValueError(f"mom must be (B, Wp, 10, Gp), got "
                         f"{tuple(mom.shape)}")
    B, Wp, _, Gp = mom.shape
    if B == 0 or Wp == 0 or Gp == 0:
        raise ValueError("empty batched problem (B, Wp or Gp is 0)")
    return B, Wp, Gp


def csum_packed_batched_plain(pose, mom, cen, cfix):
    """Plain version of the batched `csum` launch: csum_packed_plain on
    each problem of pose (B, Wp, 12), mom (B, Wp, 10, Gp), cen (B, 3, Gp),
    cfix (B, 10, Gp) -> (B, 10, Gp)."""
    return torch.stack([csum_packed_plain(*a)
                        for a in zip(pose, mom, cen, cfix)])


def csum_packed_batched(pose, mom, cen, cfix):
    """B1 over a batch, one launch whatever B: (B, 10, Gp) world plane
    moments — the CUDA `csum` kernel with the problem on a grid axis on
    CUDA tensors, csum_packed_batched_plain on CPU tensors."""
    if _on_cpu(pose, mom, cen, cfix):
        return csum_packed_batched_plain(pose, mom, cen, cfix)
    B, Wp, Gp = _batched_shapes(pose, mom)
    _check("pose", pose, (B, Wp, 12))
    _check("mom", mom, (B, Wp, 10, Gp))
    _check("cen", cen, (B, 3, Gp))
    _check("cfix", cfix, (B, 10, Gp))
    out = torch.empty((B, 10, Gp), dtype=torch.float32, device=mom.device)
    rc = _cuda.lib().balm_csum_packed_batched(
        pose.data_ptr(), mom.data_ptr(), cen.data_ptr(), cfix.data_ptr(),
        out.data_ptr(), B, Wp, Gp, mom.device.index, _cuda.stream_of(mom))
    _cuda.check_launch(rc, "csum batched")
    csum_packed_batched.launches += 1
    return out


csum_packed_batched.launches = 0


def rows_packed_batched_plain(pose, mom, cen, aux):
    """Plain version of the batched `rows` launch: rows_packed_plain on
    each problem -> (rows (B, 3, 6, Wp, Gp), J (B, Wp, 6), D (B, Wp,
    36))."""
    outs = [rows_packed_plain(*a) for a in zip(pose, mom, cen, aux)]
    return tuple(torch.stack(x) for x in zip(*outs))


def rows_packed_batched(pose, mom, cen, aux):
    """B2 over a batch, one launch whatever B (its partial-sum pass
    included): (rows (B, 3, 6, Wp, Gp), J (B, Wp, 6), D (B, Wp, 36)) —
    the CUDA `rows` kernel with the problem on a grid axis on CUDA
    tensors, rows_packed_batched_plain on CPU tensors."""
    if _on_cpu(pose, mom, cen, aux):
        return rows_packed_batched_plain(pose, mom, cen, aux)
    B, Wp, Gp = _batched_shapes(pose, mom)
    _check("pose", pose, (B, Wp, 12))
    _check("mom", mom, (B, Wp, 10, Gp))
    _check("cen", cen, (B, 3, Gp))
    _check("aux", aux, (B, AUX_CH, Gp))
    lib = _cuda.lib()
    ntiles = -(-Gp // lib.balm_rows_block_planes())
    dev = mom.device
    rows = _empty(dev, B, 3, 6, Wp, Gp)
    partial = _empty(dev, B, Wp, ntiles, 42)
    J = _empty(dev, B, Wp, 6)
    D = _empty(dev, B, Wp, 36)
    rc = lib.balm_rows_packed_batched(
        pose.data_ptr(), mom.data_ptr(), cen.data_ptr(), aux.data_ptr(),
        rows.data_ptr(), partial.data_ptr(), J.data_ptr(), D.data_ptr(),
        B, Wp, Gp, dev.index, _cuda.stream_of(mom))
    _cuda.check_launch(rc, "rows batched")
    rows_packed_batched.launches += 1
    return rows, J, D


rows_packed_batched.launches = 0


# --------------------------------------------------------------------------
# Glue: full evaluate / residual
# --------------------------------------------------------------------------

def _aux_from_csum(csum, pk: PackedFactors, gap_eps):
    """Eigendecomposition + per-plane weights -> (res, aux (17, Gp)); a
    leading batch axis (csum (B, 10, Gp)) gives res (B,), aux (B, 17,
    Gp)."""
    N, Ns, valid, vbar, cov = csum_to_cov(csum, pk.coe)
    lam, U = eigh3(cov)                                   # (Gp,3), (Gp,3,3)
    coew = torch.where(valid, pk.coe[..., 0, :], 0.0)
    res = torch.sum(coew * lam[..., 0], dim=-1)
    invN = 1.0 / Ns
    sqa = torch.sqrt(2.0 * coew) * invN
    scale = torch.clamp(lam[..., 2], min=1e-30)
    gap = lam[..., 1:] - lam[..., 0:1]
    wk = torch.where(gap > gap_eps * scale[..., None],
                     2.0 * coew[..., None] / torch.clamp(gap, min=1e-30),
                     0.0)
    sqw = torch.sqrt(wk)                                  # (Gp, 2)
    T = lambda x: x.transpose(-1, -2)
    aux = torch.cat([
        T(U[..., 0]), T(U[..., 1]), T(U[..., 2]),
        vbar,
        invN[..., None, :], sqa[..., None, :], sqw[..., 0][..., None, :],
        sqw[..., 1][..., None, :], coew[..., None, :],
    ], dim=-2).to(torch.float32).contiguous()             # (17, Gp)
    return res, aux


def _hess_precision(hess_precision):
    """Check a hess_precision: None, 'high', 'highest' or 'bf16'."""
    if hess_precision not in (None, "high", "highest", "bf16"):
        raise ValueError(f"unknown hess_precision {hess_precision!r}")


def _split(split):
    """The fused kernels' `split`: 'f32' (the exact fp32 product) or
    'bf16x3' (hi/lo bf16 pieces, three products: the JAX kernel's)."""
    if split not in ("f32", "bf16x3"):
        raise ValueError(f"unknown split {split!r}")


def split_of(hess_precision):
    """The JAX package's split of the fused kernels for a hess_precision
    (pallas_evaluate.py:999-1018 after lm.py:195): None and 'highest'
    give 'f32', 'high' and 'bf16' give 'bf16x3'."""
    return "f32" if hess_precision in (None, "highest") else "bf16x3"


def split_bf16(x, pieces):
    """The bf16 pieces of an fp32 tensor, each rounded to nearest even as
    JAX's astype: pieces=2 gives (hi, lo) with lo = bf16(x - hi), the
    TPU kernel's bf16x3 split; pieces=3 gives (hi, mid, lo) with mid =
    bf16(x - hi) and lo = bf16(x - hi - mid), whose sum is x exactly."""
    if pieces not in (2, 3):
        raise ValueError(f"pieces must be 2 or 3, got {pieces}")
    out, r = [], x
    for i in range(pieces):
        p = r.to(torch.bfloat16)
        out.append(p)
        if i + 1 < pieces:
            r = r - p.to(torch.float32)
    return tuple(out)


def _jw_product(rows, hess_precision=None):
    """rows (3, 6, Wp, Gp) -> H = sum_k M_k M_k^T (6Wp, 6Wp), fp32,
    (j, w)-major: the views M_k (6Wp, Gp) are layout-free.  Exact fp32
    products, or at hess_precision='bf16' _bf16_product."""
    Wp, Gp = rows.shape[2], rows.shape[3]
    M = rows.view(3, 6 * Wp, Gp)
    if hess_precision == "bf16":
        return _bf16_product(M)
    with fp32_matmul():
        H = torch.mm(M[0], M[0].T)
        H.addmm_(M[1], M[1].T)
        H.addmm_(M[2], M[2].T)
    return H


def _bf16_product(M):
    """sum_k M_k M_k^T for M (3, n, Gp) fp32 as ONE bf16 pass with fp32
    accumulation — the TPU's Precision.DEFAULT, hess_precision='bf16' of
    the xla, hybrid and chunked paths (pallas_evaluate.py:928-936,
    :1222-1228).  The rows are rounded to bf16 once (to nearest even, as
    JAX's astype); on the card one bf16 torch.mm with an fp32 result over
    the three rank rows side by side (K = 3 Gp); its plain version, for
    CPU tensors, multiplies the rounded rows in fp32 (each product of two
    bf16 values is exact in fp32)."""
    n = M.shape[1]
    A = M.to(torch.bfloat16).permute(1, 0, 2).reshape(n, -1)
    if A.device.type == "cpu":
        A = A.to(torch.float32)
        with fp32_matmul():
            return torch.mm(A, A.T)
    return torch.mm(A, A.T, out_dtype=torch.float32)


def hess_packed_hybrid(pose, mom, cen, aux, *, hess_precision=None):
    """-> (Htilde (6Wp, 6Wp) in (j, w)-major order, J (Wp, 6),
    D (Wp, 36)): the `rows` kernel, then H = sum_k M_k M_k^T in fp32
    (one bf16 pass at hess_precision='bf16')."""
    _hess_precision(hess_precision)
    rows, J, D = rows_packed(pose, mom, cen, aux)
    return _jw_product(rows, hess_precision), J, D


def hess_packed_xla(pose, mom, cen, aux, *, hess_precision=None):
    """The XLA formulation: -> (Htilde (6Wp, 6Wp) in (w, j)-MAJOR order,
    J (Wp, 6), D (Wp, 36)).  The `rows` kernel and the product as in
    hess_packed_hybrid, then Htilde (9.4 MB at Wp = 256) is permuted to
    (w, j)-major order, not the rows (212 MB)."""
    H, J, D = hess_packed_hybrid(pose, mom, cen, aux,
                                 hess_precision=hess_precision)
    Wp = mom.shape[0]
    H = H.view(6, Wp, 6, Wp).permute(1, 0, 3, 2).reshape(6 * Wp, 6 * Wp)
    return H, J, D


# --------------------------------------------------------------------------
# B4, B5, B6: fused rank rows + Hessian product
# --------------------------------------------------------------------------

def _hess_checked(pose, mom, cen, aux):
    Wp, Gp = _packed_shapes(pose, mom)
    _check("pose", pose, (Wp, 12))
    _check("mom", mom, (Wp, 10, Gp))
    _check("cen", cen, (3, Gp))
    _check("aux", aux, (AUX_CH, Gp))
    return Wp, Gp


def _bf16x3_mm(A, B):
    """sum_k hi_A[k] hi_B[k]^T + hi_A[k] lo_B[k]^T + lo_A[k] hi_B[k]^T for
    A (3, n, Gp), B (3, m, Gp) fp32, hi and lo their split_bf16 pieces:
    the JAX kernel's bf16x3 dot, each product an fp32 torch.mm on the
    upcast pieces, in this order."""
    ha, la = (p.to(torch.float32) for p in split_bf16(A, 2))
    hb, lb = (ha, la) if B is A else (
        p.to(torch.float32) for p in split_bf16(B, 2))
    terms = [(a[k], b[k]) for k in range(3)
             for a, b in ((ha, hb), (ha, lb), (la, hb))]
    with fp32_matmul():
        H = torch.mm(terms[0][0], terms[0][1].T)
        for a, b in terms[1:]:
            H.addmm_(a, b.T)
    return H


def _jw_product_bf16x3(rows):
    """_jw_product as the JAX kernel's bf16x3 dot (_bf16x3_mm)."""
    Wp, Gp = rows.shape[2], rows.shape[3]
    M = rows.view(3, 6 * Wp, Gp)
    return _bf16x3_mm(M, M)


def hess_packed_plain(pose, mom, cen, aux, *, split="f32"):
    """Plain version of the B4 and B6 kernels (they compute one function):
    -> (Htilde (6Wp, 6Wp) (j, w)-major, J (Wp, 6), D (Wp, 36)) from the
    plain rank rows and an fp32 product: exact (split 'f32', which the
    kernels' six bf16 products reach) or the bf16x3 one."""
    _split(split)
    rows, J, D = rows_packed_plain(pose, mom, cen, aux)
    prod = _jw_product if split == "f32" else _jw_product_bf16x3
    return prod(rows), J, D


def _hess_tri(name, pose, mom, cen, aux, split):
    """Launch B6 (name 'hess_v1') or B4 ('hess_v2'), one kernel at the
    given split, on CUDA tensors: the split partials of the lower-triangle
    tiles, then their sum in split order into both triangles of Htilde, J
    and D."""
    Wp, Gp = _hess_checked(pose, mom, cen, aux)
    lib = _cuda.lib()
    dev = mom.device
    nsplit = lib.balm_hess_splits(Wp, Gp, dev.index)
    if nsplit < 1:
        raise RuntimeError(f"{name}: could not read the SM count")
    n6 = 6 * Wp
    Hpart = _empty(dev, nsplit, lib.balm_hess_tile_floats(Wp))
    JDpart = _empty(dev, nsplit, Wp, 42)
    H, J, D = _empty(dev, n6, n6), _empty(dev, Wp, 6), _empty(dev, Wp, 36)
    rc = lib.balm_hess_tri(
        pose.data_ptr(), mom.data_ptr(), cen.data_ptr(), aux.data_ptr(),
        Hpart.data_ptr(), JDpart.data_ptr(), H.data_ptr(), J.data_ptr(),
        D.data_ptr(), Wp, Gp, nsplit, int(split == "bf16x3"), dev.index,
        _cuda.stream_of(mom))
    _cuda.check_launch(rc, name)
    return H, J, D


def hess_packed(pose, mom, cen, aux):
    """B6 wrapper, the v1 fused kernel (`_hess_kernel`): -> (Htilde
    (6Wp, 6Wp) (j, w)-major, J (Wp, 6), D (Wp, 36)).  CUDA tensors: the
    `hess_v1` kernel, the lower-triangle tiles per plane split on the
    tensor cores, with the exact split (six bf16 products), as the TPU
    kernel's HIGHEST dot; CPU tensors: hess_packed_plain."""
    if _on_cpu(pose, mom, cen, aux):
        return hess_packed_plain(pose, mom, cen, aux)
    out = _hess_tri("hess_v1", pose, mom, cen, aux, "f32")
    hess_packed.launches += 1
    return out


hess_packed.launches = 0


def hess_packed_v2(pose, mom, cen, aux, *, split="bf16x3"):
    """B4 wrapper, the v2 fused kernel (`_hess_kernel_v2`): -> (Htilde
    (6Wp, 6Wp) (j, w)-major, J (Wp, 6), D (Wp, 36)).  CUDA tensors: the
    `hess_v2` kernel, the body of B6 with the product of `split`: 'bf16x3'
    (hi/lo pieces, three products, the JAX kernel's) or 'f32' (exact);
    CPU tensors: hess_packed_plain with the same split."""
    _split(split)
    if _on_cpu(pose, mom, cen, aux):
        return hess_packed_plain(pose, mom, cen, aux, split=split)
    out = _hess_tri("hess_v2", pose, mom, cen, aux, split)
    hess_packed_v2.launches += 1
    return out


hess_packed_v2.launches = 0


def _pairs(nB):
    """Lower-triangle pose-block pairs (I, J), I >= J, in grid order."""
    return [(i, j) for i in range(nB) for j in range(i + 1)]


def hess_pairs_v3_plain(pose, mom, cen, aux, bw, *, split="bf16x3"):
    """Plain version of the B5 kernel: -> (raw pair blocks
    (n_pairs * 6bw, 6bw), each (j, w)-major inside, J (WpB, 6),
    D (WpB, 36)) with WpB = bw * ceil(Wp / bw); scans past Wp are zero.
    Each pair block is the product of `split` (hess_packed_plain's): the
    exact fp32 one at 'f32', _bf16x3_mm at 'bf16x3'."""
    _split(split)
    rows, J, D = rows_packed_plain(pose, mom, cen, aux)
    Wp, Gp = mom.shape[0], mom.shape[2]
    nB = -(-Wp // bw)
    WpB = nB * bw
    rows = torch.nn.functional.pad(rows, (0, 0, 0, WpB - Wp))
    blocks = []
    for I, J_ in _pairs(nB):
        Mi = rows[:, :, I * bw:(I + 1) * bw].reshape(3, 6 * bw, Gp)
        Mj = rows[:, :, J_ * bw:(J_ + 1) * bw].reshape(3, 6 * bw, Gp)
        if split == "bf16x3":
            blocks.append(_bf16x3_mm(Mi, Mj))
        else:
            with fp32_matmul():
                blocks.append(sum(Mi[k] @ Mj[k].T for k in range(3)))
    pad_w = lambda t: torch.nn.functional.pad(t, (0, 0, 0, WpB - Wp))
    return torch.cat(blocks), pad_w(J), pad_w(D)


# bf16 pieces of each rank-row value in B5's split
_PIECES = {"bf16x3": 2, "f32": 3}


def _hess_v3_plan(Wp, Gp, bw, split, dev):
    """B5's scratch sizes at this shape (balm_hess_v3_plan): (bf16 values
    of the pieces, floats of the J/D partials, floats of one plane split's
    partial tiles, plane splits)."""
    out = (ctypes.c_int64 * 4)()
    rc = _cuda.lib().balm_hess_v3_plan(Wp, Gp, bw, _PIECES[split],
                                       dev.index, out)
    _cuda.check_launch(rc, "hess_v3 plan")
    return tuple(out)


def _hess_v3_pieces(pose, mom, cen, aux, bw, split, plan):
    """B5 stage 1 on CUDA tensors: -> (pieces, J/D partials), the split's
    bf16 pieces of every rank-row value in wgmma's shared-memory layout."""
    Wp, Gp = mom.shape[0], mom.shape[2]
    dev = mom.device
    pieces = torch.empty(plan[0], dtype=torch.bfloat16, device=dev)
    JDpart = _empty(dev, plan[1])
    rc = _cuda.lib().balm_hess_v3_pieces(
        pose.data_ptr(), mom.data_ptr(), cen.data_ptr(), aux.data_ptr(),
        pieces.data_ptr(), JDpart.data_ptr(), Wp, Gp, bw, _PIECES[split],
        dev.index, _cuda.stream_of(mom))
    _cuda.check_launch(rc, "hess_v3 pieces")
    return pieces, JDpart


def _hess_v3_pairs(pieces, JDpart, Wp, Gp, bw, split, plan):
    """B5 stage 2 and its sum pass on CUDA tensors: -> (raw pair blocks,
    J, D) as hess_pairs_v3_plain."""
    nB = -(-Wp // bw)
    dev = pieces.device
    nsplit = plan[3]
    Hpart = _empty(dev, nsplit, plan[2])
    Hblk = _empty(dev, len(_pairs(nB)) * 6 * bw, 6 * bw)
    J, D = _empty(dev, nB * bw, 6), _empty(dev, nB * bw, 36)
    rc = _cuda.lib().balm_hess_v3_pairs(
        pieces.data_ptr(), JDpart.data_ptr(), Hpart.data_ptr(),
        Hblk.data_ptr(), J.data_ptr(), D.data_ptr(), Wp, Gp, bw,
        _PIECES[split], nsplit, dev.index, _cuda.stream_of(pieces))
    _cuda.check_launch(rc, "hess_v3 pairs")
    return Hblk, J, D


def hess_pairs_v3(pose, mom, cen, aux, bw, *, split="bf16x3"):
    """B5 wrapper, the v3 kernel (`_hess_kernel_v3`): the raw pair blocks,
    J and D of hess_pairs_v3_plain with the product of `split`.  CUDA
    tensors: the `hess_v3` kernel in two stages, the split's bf16 pieces
    of the rank rows built once into device memory (_hess_v3_pieces), then
    the lower-triangle pair blocks from them on the tensor cores and a sum
    of the plane splits (_hess_v3_pairs); CPU tensors:
    hess_pairs_v3_plain."""
    _split(split)
    if not 1 <= bw <= mom.shape[0]:
        raise ValueError(f"bw must lie in [1, Wp={mom.shape[0]}], got {bw}")
    if _on_cpu(pose, mom, cen, aux):
        return hess_pairs_v3_plain(pose, mom, cen, aux, bw, split=split)
    Wp, Gp = _hess_checked(pose, mom, cen, aux)
    plan = _hess_v3_plan(Wp, Gp, bw, split, mom.device)
    pieces, JDpart = _hess_v3_pieces(pose, mom, cen, aux, bw, split, plan)
    out = _hess_v3_pairs(pieces, JDpart, Wp, Gp, bw, split, plan)
    hess_pairs_v3.launches += 1
    return out


hess_pairs_v3.launches = 0


def hess_packed_v3(pose, mom, cen, aux, *, split="bf16x3", bw=None):
    """B5, the pose-block-pair form: -> (Htilde (6Wp, 6Wp) in (w, j)-MAJOR
    order — the layout of hess_packed_xla — J (Wp, 6), D (Wp, 36)).

    Pose blocks of Bw = min(bw or BW_HESS3, Wp) scans; the last block is
    ragged when Bw does not divide Wp (zero rows, cropped here).  The JAX
    wrapper's `bg` is a TPU plane tile and has no counterpart: the CUDA
    kernel picks its own plane chunk.  `split` is the product's, as the
    JAX kernel's: 'bf16x3' (hi/lo pieces, three products) or 'f32'
    (exact), for the kernel and its plain version alike.  The mirror of
    the lower-triangle pair blocks into the full matrix is torch glue, the
    same for the kernel and its plain version (pallas_evaluate.py:
    770-782).
    """
    _split(split)
    Wp = mom.shape[0]
    Bw = min(bw or BW_HESS3, Wp)
    nB = -(-Wp // Bw)
    WpB = nB * Bw
    Hblk, J, D = hess_pairs_v3(pose, mom, cen, aux, Bw, split=split)
    pairs = _pairs(nB)
    Hp = Hblk.view(len(pairs), 6, Bw, 6, Bw)
    Hb = Hblk.new_empty(nB, nB, 6, Bw, 6, Bw)
    for q, (I, Jb) in enumerate(pairs):     # the diagonal pair last wins
        Hb[I, Jb] = Hp[q]
        Hb[Jb, I] = Hp[q].permute(2, 3, 0, 1)
    # (I, J, j, w, j', w') -> (I, w, j, J, w', j'): (w, j)-major
    H = Hb.permute(0, 3, 2, 1, 5, 4).reshape(WpB, 6, WpB, 6)
    H = H[:Wp, :, :Wp, :].reshape(6 * Wp, 6 * Wp)
    return H, J[:Wp], D[:Wp]


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


def pallas2_to_pallas3(Wp: int) -> bool:
    """The JAX package's dispatch rule (pallas_evaluate.py:988-992):
    impl='pallas2' runs as 'pallas3' when the v2 kernel's H window and dot
    accumulator, 2 * 36 Wp^2 f32, exceed 100 MiB of the TPU's scoped
    VMEM, i.e. from Wp = 608.  It is kept for parity; it is not a limit
    of the B4 kernel on the card, whose shared memory use is fixed."""
    return 2 * 36 * Wp * Wp * 4 > 100 * 1024 * 1024


def _assemble_wj(Ht, Jt, Dt, W):
    """(w, j)-major Htilde (..., 6Wp, 6Wp), J (..., Wp, 6), D (..., Wp,
    36) -> the evaluate's J (..., 6W) and H (..., 6W, 6W): crop, negate
    the rank part, add the diagonal blocks (leading batch dims carry
    over)."""
    lead, Wp = Jt.shape[:-2], Jt.shape[-2]
    H = (-Ht.view(*lead, Wp, 6, Wp, 6)[..., :W, :, :W, :]).contiguous()
    # H[w, a, w, b] += D[w, a, b]: the (w, w) diagonal is a view of H
    torch.diagonal(H, dim1=-4, dim2=-2).add_(
        Dt[..., :W, :].reshape(*lead, W, 6, 6).movedim(-3, -1))
    return (Jt[..., :W, :].reshape(*lead, 6 * W),
            H.view(*lead, 6 * W, 6 * W))


# the evaluate's impls, as the JAX package names them
IMPLS = ("xla", "hybrid", "pallas", "pallas2", "pallas3")


def evaluate_packed(R, p, pk: PackedFactors, *, gap_eps: float = 1e-9,
                    impl: str = "xla", hess_precision=None):
    """Residual, gradient (6W,) and Newton Hessian (6W, 6W) in (w, j)-major
    order (index = w * 6 + j), by way of any of the JAX package's impls:

      'xla'      B2 `rows` + fp32 torch.mm, Htilde permuted to (w, j)
      'hybrid'   B2 `rows` + fp32 torch.mm, (j, w)-major
      'pallas'   B6 fused kernel (hess_packed)
      'pallas2'  B4 fused kernel (hess_packed_v2); 'pallas3' from
                 Wp = 608 (pallas2_to_pallas3)
      'pallas3'  B5 pose-block-pair kernel (hess_packed_v3)

    The plane moments are the B1 `csum` kernel for every impl.
    hess_precision: None, 'high', 'highest' or 'bf16'.  The xla and
    hybrid products are exact fp32 at the first three and one bf16 pass
    at 'bf16' (_bf16_product, the TPU's DEFAULT); the fused kernels take
    the JAX package's split (split_of): 'f32' at None and 'highest',
    'bf16x3' at 'high' and 'bf16'; 'pallas' (B6) is exact at every
    setting, as the JAX kernel ignores it."""
    _hess_precision(hess_precision)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}")
    W = R.shape[0]
    Wp = pk.wp
    if impl == "pallas2" and pallas2_to_pallas3(Wp):
        impl = "pallas3"
    split = split_of(hess_precision)
    jw_major = {"hybrid": lambda *a: hess_packed_hybrid(
                    *a, hess_precision=hess_precision),
                "pallas": hess_packed,
                "pallas2": lambda *a: hess_packed_v2(*a, split=split)}
    pose = pad_poses(R, p, Wp).to(torch.float32)
    csum = csum_packed(pose, pk.mom, pk.cen, pk.cfix)
    res, aux = _aux_from_csum(csum, pk, gap_eps)
    if impl == "xla":
        Ht, Jt, Dt = hess_packed_xla(pose, pk.mom, pk.cen, aux,
                                     hess_precision=hess_precision)
    elif impl == "pallas3":
        Ht, Jt, Dt = hess_packed_v3(pose, pk.mom, pk.cen, aux, split=split)
    else:
        Ht, Jt, Dt = jw_major[impl](pose, pk.mom, pk.cen, aux)
        # (j, w)-major -> (w, j)-major
        Ht = Ht.view(6, Wp, 6, Wp).permute(1, 0, 3, 2).reshape(
            6 * Wp, 6 * Wp)
    J, H = _assemble_wj(Ht, Jt, Dt, W)
    return res, J, H


def _residual(pose, pk: PackedFactors, csum_fn=None):
    csum = (csum_fn or csum_packed)(pose, pk.mom, pk.cen, pk.cfix)
    N, Ns, valid, vbar, cov = csum_to_cov(csum, pk.coe)
    lam = eigvals3(cov)
    coew = torch.where(valid, pk.coe[..., 0, :], 0.0)
    return torch.sum(coew * lam[..., 0], dim=-1)


def residual_only_packed(R, p, pk: PackedFactors):
    """Total cost sum_g coe_g lambda_0(g): the `csum` kernel + eigvals."""
    return _residual(pad_poses(R, p, pk.wp).to(torch.float32), pk)


def evaluate_packed_batched(R, p, pk: PackedFactors, *,
                            gap_eps: float = 1e-9, hess_precision="high"):
    """evaluate_packed(impl='xla') over a batch of problems of one shape,
    the JAX package's vmap of it: R (B, W, 3, 3), p (B, W, 3), pk from
    pack_factors_batched -> (res (B,), J (B, 6W), H (B, 6W, 6W)), J and
    H in (w, j)-major order.

    One batched B1 launch, eigh3 and the aux channels elementwise over
    the batch, one batched B2 launch, then H = sum_k M_k M_k^T as
    batched fp32 products (torch.bmm, TF32 off: the JAX package's dot
    outside any kernel) and the per-problem assembly.  The launch count
    does not depend on B."""
    if hess_precision != "high":
        raise NotImplementedError(
            f"the batched evaluate runs hess_precision='high' (the exact "
            f"fp32 product, damping_iter's default); {hess_precision!r} "
            f"is not ported to it (ROADMAP.md, queue B)")
    B, W = R.shape[:2]
    Wp, Gp = pk.wp, pk.gp
    pose = pad_poses(R, p, Wp).to(torch.float32)
    csum = csum_packed_batched(pose, pk.mom, pk.cen, pk.cfix)
    res, aux = _aux_from_csum(csum, pk, gap_eps)
    rows, Jt, Dt = rows_packed_batched(pose, pk.mom, pk.cen, aux)
    M = rows.view(B, 3, 6 * Wp, Gp)
    with fp32_matmul():
        Ht = torch.bmm(M[:, 0], M[:, 0].transpose(1, 2))
        Ht.baddbmm_(M[:, 1], M[:, 1].transpose(1, 2))
        Ht.baddbmm_(M[:, 2], M[:, 2].transpose(1, 2))
    # (j, w)-major -> (w, j)-major
    Ht = Ht.view(B, 6, Wp, 6, Wp).permute(0, 2, 1, 4, 3).reshape(
        B, 6 * Wp, 6 * Wp)
    J, H = _assemble_wj(Ht, Jt, Dt, W)
    return res, J, H


def residual_only_packed_batched(R, p, pk: PackedFactors):
    """residual_only_packed over a batch: (B,) costs, one batched B1
    launch + eigvals."""
    return _residual(pad_poses(R, p, pk.wp).to(torch.float32), pk,
                     csum_packed_batched)


# --------------------------------------------------------------------------
# Chunked evaluate: a Python loop over plane chunks (lax.scan in JAX)
# --------------------------------------------------------------------------

def _chunk_pk(pk: PackedFactors, n_chunks: int):
    """Split the plane axis into n_chunks PackedFactors of Gp / n_chunks
    planes each.  Every slice is copied: the wrappers take contiguous
    tensors only.  A solve makes the list once and passes it to the
    chunked evaluates as `chunks`."""
    Gp = pk.gp
    if Gp % n_chunks:
        raise ValueError(f"{n_chunks} chunks do not divide Gp={Gp}")
    Gc = Gp // n_chunks
    return [PackedFactors(*(t[..., i * Gc:(i + 1) * Gc].contiguous()
                            for t in pk)) for i in range(n_chunks)]


def evaluate_packed_chunked(R, p, pk: PackedFactors, *, n_chunks: int,
                            gap_eps: float = 1e-9, hess_precision=None,
                            chunks=None):
    """evaluate_packed (impl 'xla') as a loop over plane chunks: per chunk
    the `csum` kernel, eigh3/aux and hess_packed_xla (`rows` + the fp32
    product); res, Htilde, J and D summed over chunks in order.  Same
    (w, j)-major outputs as evaluate_packed.  chunks: `_chunk_pk(pk,
    n_chunks)` made once by the caller, else made here."""
    _hess_precision(hess_precision)
    W = R.shape[0]
    pose = pad_poses(R, p, pk.wp).to(torch.float32)
    res = Ht = Jt = Dt = None
    for pc in chunks or _chunk_pk(pk, n_chunks):
        csum = csum_packed(pose, pc.mom, pc.cen, pc.cfix)
        res_c, aux = _aux_from_csum(csum, pc, gap_eps)
        H_c, J_c, D_c = hess_packed_xla(pose, pc.mom, pc.cen, aux,
                                        hess_precision=hess_precision)
        if res is None:
            res, Ht, Jt, Dt = res_c, H_c, J_c, D_c
        else:
            res = res + res_c
            Ht.add_(H_c)
            Jt.add_(J_c)
            Dt.add_(D_c)
    J, H = _assemble_wj(Ht, Jt, Dt, W)
    return res, J, H


def residual_only_packed_chunked(R, p, pk: PackedFactors, *,
                                 n_chunks: int, chunks=None):
    """residual_only_packed as a loop over plane chunks (`chunks` as in
    evaluate_packed_chunked)."""
    pose = pad_poses(R, p, pk.wp).to(torch.float32)
    res = None
    for pc in chunks or _chunk_pk(pk, n_chunks):
        r = _residual(pose, pc)
        res = r if res is None else res + r
    return res
