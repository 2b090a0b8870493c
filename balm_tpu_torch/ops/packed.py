"""Packed channel-major factor layout for the CUDA evaluation path.

Counterpart: balm_tpu/ops/packed.py (PackedFactors, pack_factors :72,
csum_to_cov :118, pad_planes :138, pad_poses :154); pack_factors_batched
is pack_factors under the hierarchy's jax.vmap (balm_tpu/pipelines/
hierarchical.py:711-713).  The same
information as PlaneFactors, re-laid-out channel-major with the PLANE
axis contiguous:

    mom  (Wp, 10, Gp)  per-scan channels (pxx,pxy,pxz,pyy,pyz,pzz,
                       bx,by,bz, n): recentered body moment vech(P),
                       body centroid b, point count n
    cen  (3, Gp)       world-frame conditioning centers c_g
    coe  (1, Gp)       factor weights (0 = padding)
    cfix (10, Gp)      marginalized fixed moment, shifted by -c_g

so that consecutive CUDA threads (one per plane) read consecutive
addresses of every channel.  Padding follows the CUDA tiles: Gp is a
multiple of GPAD = 128 (the plane tile of both kernels), Wp a multiple of
WPAD = 8.  Padding scans carry zero moments and padding planes zero coe,
so both contribute exactly zero downstream (everything scales with n, P
or coe).  The kernels also take unpadded (ragged) shapes.

The layout's invariant: P == 0 wherever n == 0 (an entry whose scan does
not see the plane).  Factors built from points satisfy it already;
pack_factors enforces it on the float32 channels.  b at such an entry is
left as it is: it is finite and every use multiplies it by n = 0.  So an
empty entry adds exactly +-0 to every output of B1 and B2, and their
CUDA kernels (csrc/packed_kernels.cu) read n first and skip the entry's
other channels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import factors as F

GPAD = 128  # plane-axis padding multiple (CUDA plane tile)
WPAD = 8    # scan-axis padding multiple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class PackedFactors(NamedTuple):
    mom: torch.Tensor    # (Wp, 10, Gp)
    cen: torch.Tensor    # (3, Gp)
    coe: torch.Tensor    # (1, Gp)
    cfix: torch.Tensor   # (10, Gp)

    @property
    def wp(self):
        return self.mom.shape[-3]

    @property
    def gp(self):
        return self.mom.shape[-1]


def _sym_channels(M):
    """(..., 3+, 3+) symmetric -> 6 channels (xx,xy,xz,yy,yz,zz)."""
    return [M[..., 0, 0], M[..., 0, 1], M[..., 0, 2],
            M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]]


def pack_factors(f: F.PlaneFactors, *, gpad: int = GPAD,
                 wpad: int = WPAD) -> PackedFactors:
    """PlaneFactors (torch leaves, body-recentered) -> PackedFactors,
    float32 on the factors' device.  Pose-independent: call once per
    solve.  Leading batch dims of the leaves (C (..., G, W, 4, 4)) carry
    over to every packed tensor (pack_factors_batched)."""
    G, W = f.C.shape[-4:-2]
    dt = torch.float32
    Gp = _round_up(max(G, 1), gpad)
    Wp = _round_up(max(W, 1), wpad)

    n = f.C[..., 3, 3]                                    # (G, W)
    ns = torch.where(n > 0.5, n, 1.0)
    v = f.C[..., :3, 3]                                   # (G, W, 3)
    # fold any residual first moment into the body centroid (exact; a
    # no-op when recenter_bodies already ran)
    b = f.body_centers + v / ns[..., None]
    P = f.C[..., :3, :3] - v[..., :, None] * v[..., None, :] / ns[..., None, None]

    chans = _sym_channels(P) + [b[..., 0], b[..., 1], b[..., 2], n]
    mom = torch.stack(chans, dim=-1).movedim(-3, -1)      # (W, 10, G)
    mom = torch.nn.functional.pad(mom, (0, Gp - G, 0, 0, 0, Wp - W))

    cen = torch.nn.functional.pad(f.centers.transpose(-1, -2), (0, Gp - G))
    coe = torch.nn.functional.pad(f.coe[..., None, :], (0, Gp - G))

    # fixed moment: shift, then recenter about its own centroid so the
    # two-pass covariance never sees large-offset products
    Cfs = F._shifted_fix(f)                               # (G, 4, 4)
    nf = Cfs[..., 3, 3]
    nfs = torch.where(nf > 0.5, nf, 1.0)
    vf = Cfs[..., :3, 3]
    bf = vf / nfs[..., None]
    Pf = Cfs[..., :3, :3] - vf[..., :, None] * vf[..., None, :] / nfs[..., None, None]
    cfx = torch.stack(
        _sym_channels(Pf) + [bf[..., 0], bf[..., 1], bf[..., 2], nf],
        dim=-2)
    cfix = torch.nn.functional.pad(cfx, (0, Gp - G))

    mom = mom.to(dt)
    # the invariant the kernels rely on: P == 0 wherever n == 0
    mom = torch.cat([torch.where(mom[..., 9:10, :] == 0, 0.0,
                                 mom[..., :6, :]), mom[..., 6:, :]], dim=-2)
    return PackedFactors(mom=mom.contiguous(),
                         cen=cen.to(dt).contiguous(),
                         coe=coe.to(dt).contiguous(),
                         cfix=cfix.to(dt).contiguous())


def pack_factors_batched(f: F.PlaneFactors, *, gpad: int = GPAD,
                         wpad: int = WPAD) -> PackedFactors:
    """B blocks' PlaneFactors stacked on a leading axis (C (B, G, W, 4,
    4), ...) -> PackedFactors of one common (Wp, Gp): mom (B, Wp, 10,
    Gp), cen (B, 3, Gp), coe (B, 1, Gp), cfix (B, 10, Gp); padding planes
    at zero coe, as pack_factors (the JAX package's vmap of it)."""
    if f.C.dim() != 5:
        raise ValueError(f"batched factors need C (B, G, W, 4, 4), got "
                         f"{tuple(f.C.shape)}")
    return pack_factors(f, gpad=gpad, wpad=wpad)


def csum_to_cov(out, coe):
    """Moment channels (..., 10, Gp) = [N*cov (6), vsum (3), N] ->
    (N, Ns, valid, vbar (..., 3, Gp), cov (..., Gp, 3, 3))."""
    N = out[..., 9, :]
    Ns = torch.where(N > 0.5, N, 1.0)
    valid = (N > 0.5) & (coe[..., 0, :] > 0)
    vbar = out[..., 6:9, :] / Ns[..., None, :]
    c = out[..., :6, :] / Ns[..., None, :]
    c = [c[..., k, :] for k in range(6)]
    row0 = torch.stack([c[0], c[1], c[2]], dim=-1)
    row1 = torch.stack([c[1], c[3], c[4]], dim=-1)
    row2 = torch.stack([c[2], c[4], c[5]], dim=-1)
    cov = torch.stack([row0, row1, row2], dim=-2)         # (Gp, 3, 3)
    return N, Ns, valid, vbar, cov


def pad_planes(pk: PackedFactors, multiple: int) -> PackedFactors:
    """Extend the plane axis with zeros to a multiple of `multiple`
    (padding planes carry n = coe = 0 and contribute exactly zero)."""
    ext = _round_up(pk.gp, multiple) - pk.gp
    if ext == 0:
        return pk
    pad = lambda t: torch.nn.functional.pad(t, (0, ext)).contiguous()
    return PackedFactors(*map(pad, pk))


def pad_poses(R, p, Wp):
    """(..., W,3,3),(..., W,3) -> (..., Wp, 12) row-major [R | t] pose
    channels, zero rows for padding scans (never observable: their
    moments are zero)."""
    W = R.shape[-3]
    pose = torch.cat([R.reshape(*R.shape[:-2], 9), p], dim=-1)
    return torch.nn.functional.pad(pose, (0, 0, 0, Wp - W)).contiguous()
