"""Fused one-pass plane-moment accumulation: kernel B7 and its glue.

Counterpart: balm_tpu/ops/pallas_moments.py — the Pallas `_kernel`
(:41) behind `accumulate_moments` (:89), `pack_inputs` (:114) and
`residual_moments` (:136).  Per plane g it forms

    Csum[g] = sum_w T'_gw C_gw T'_gw^T,   T'_gw = [R_w | t'_gw],

the centered, body-recentered world moment of ops/factors._plane_moment,
over 10 channels (xx, xy, xz, yy, yz, zz, x, y, z, N), without the
(G, W, 4, 4) intermediates of that path.  Layout, channels-major with
the plane axis contiguous:

    R9  (W, 9)      row-major rotations
    CH  (W, 10, G)  body moment channels
    OFS (W, 3, G)   effective translations t'_gw = R_w b_gw + t_w - c_g

G is a multiple of LANES = 128, as in JAX (the voxelizer pads to it).

`accumulate_moments` launches the CUDA kernel (csrc/moments_kernels.cu,
float32 or float64, following CH) on CUDA tensors, counting the launch
in its `launches` attribute, and runs `accumulate_moments_plain` on CPU
tensors; there is no fallback.  The translations are formed here in the
glue, with the same operations as factors._shifted_poses, so that their
cancellation rounds exactly as on the path without the kernel.

The kernel relies on an invariant of its inputs: an entry with N == 0
(CH channel 9) has P == 0 and v == 0 (channels 0-8).  Such an entry adds
exactly zero to every output, so the kernel reads N first and skips it.
`pack_inputs` enforces the invariant (`zero_empty`), as packed.
pack_factors does for B1/B2; recentered factors built from points hold
it already (ops/factors.recenter_bodies), so this departs from the JAX
package's pack_inputs only on inputs that no such factor produces.  An
empty entry with a non-finite t' (OFS) is skipped too, where a dense
sum would have turned 0 * inf into NaN.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import smallmat as sm
from .precision import fp32_matmul

LANES = 128
# CH channel -> (row, col) of the symmetric 4x4 moment
_CH = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2),
       (0, 3), (1, 3), (2, 3), (3, 3))
_SYM3 = ((0, 1, 2), (1, 3, 4), (2, 4, 5))


def zero_empty(CH):
    """CH (W, 10, G) with channels 0-8 (P, v) zeroed wherever channel 9
    (N) is 0: the invariant kernel B7 relies on."""
    return torch.cat([torch.where(CH[:, 9:10] == 0, 0.0, CH[:, :9]),
                      CH[:, 9:]], dim=1)


def pack_inputs(T, f):
    """(R9, CH, OFS) from poses T (W, 4, 4) and centered PlaneFactors;
    CH holds the invariant of accumulate_moments (zero_empty)."""
    G, W = f.C.shape[:2]
    R = T[:, :3, :3]
    R9 = R.reshape(W, 9).contiguous()
    CH = torch.stack([f.C[..., i, j] for i, j in _CH], dim=-1)   # (G, W, 10)
    CH = zero_empty(CH.permute(1, 2, 0)).contiguous()
    with fp32_matmul():
        t_eff = (sm.matvec(R[None], f.body_centers) + T[None, :, :3, 3]
                 - f.centers[:, None, :])                         # (G, W, 3)
    OFS = t_eff.permute(1, 2, 0).contiguous()
    return R9, CH, OFS


def _shapes(R9, CH, OFS):
    if CH.dim() != 3 or CH.shape[1] != 10:
        raise ValueError(f"CH must be (W, 10, G), got {tuple(CH.shape)}")
    W, _, G = CH.shape
    if W == 0 or G == 0:
        raise ValueError("empty problem (W or G is 0)")
    if G % LANES:
        raise ValueError(f"pad the plane axis to a multiple of {LANES}, "
                         f"got G={G}")
    return W, G


def accumulate_moments_plain(R9, CH, OFS):
    """Plain version of B7: the einsum form of _plane_moment's centered
    sum over scans, R9 (W, 9), CH (W, 10, G), OFS (W, 3, G) -> (10, G)."""
    W, G = _shapes(R9, CH, OFS)
    R = R9.reshape(W, 3, 3)
    P = torch.stack([torch.stack([CH[:, k] for k in row], 1)
                     for row in _SYM3], 1)                        # (W,3,3,G)
    v, n, t = CH[:, 6:9], CH[:, 9], OFS
    with fp32_matmul():
        M = torch.einsum("wik,wklg,wjl->ijg", R, P, R)
        Rv = torch.einsum("wik,wkg->wig", R, v)
        X = torch.einsum("wig,wjg->ijg", Rv, t)
        NT = torch.einsum("wg,wig,wjg->ijg", n, t, t)
    S = M + X + X.transpose(0, 1) + NT
    vs = Rv.sum(0) + (n[:, None] * t).sum(0)
    return torch.stack([S[0, 0], S[0, 1], S[0, 2], S[1, 1], S[1, 2],
                        S[2, 2], vs[0], vs[1], vs[2], n.sum(0)])


def accumulate_moments(R9, CH, OFS):
    """B7 wrapper: R9 (W, 9), CH (W, 10, G), OFS (W, 3, G) -> (10, G), in
    CH's dtype (float32 or float64) — the CUDA kernel on CUDA tensors,
    accumulate_moments_plain on CPU tensors.  CH must hold the invariant
    P == 0 and v == 0 wherever N == 0 (as pack_inputs makes it): the
    kernel skips those entries unread."""
    if _cuda.on_cpu(R9, CH, OFS):
        return accumulate_moments_plain(R9, CH, OFS)
    W, G = _shapes(R9, CH, OFS)
    dt = CH.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"CH must be float32 or float64, got {dt}")
    _cuda.check("R9", R9, (W, 9), dt)
    _cuda.check("CH", CH, (W, 10, G), dt)
    _cuda.check("OFS", OFS, (W, 3, G), dt)
    out = torch.empty((10, G), dtype=dt, device=CH.device)
    lib = _cuda.lib()
    fn = lib.balm_moments_f32 if dt == torch.float32 else lib.balm_moments_f64
    rc = fn(R9.data_ptr(), CH.data_ptr(), OFS.data_ptr(), out.data_ptr(),
            W, G, CH.device.index, _cuda.stream_of(CH))
    _cuda.check_launch(rc, "moments")
    accumulate_moments.launches += 1
    return out


accumulate_moments.launches = 0


def residual_moments(T, f):
    """Csum channels -> (G, 4, 4) world moments (centered frame), without
    the fixed moment."""
    out = accumulate_moments(*pack_inputs(T, f))                  # (10, G)
    G = out.shape[1]
    C = torch.zeros((G, 4, 4), dtype=out.dtype, device=out.device)
    for k, (i, j) in enumerate(_CH):
        C[:, i, j] = out[k]
        C[:, j, i] = out[k]
    return C
