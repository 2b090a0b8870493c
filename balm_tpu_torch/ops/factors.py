"""Plane-factor storage and the host-side f64 conditioning step.

Counterpart: balm_tpu/ops/factors.py — PlaneFactors (:51, create :77,
astype :91), recenter_bodies (:113) and _shifted_fix (:161).  The
evaluators of that module (the f64 XLA oracle path) are not part of this
slice; the port evaluates through ops/packed_evaluate.py.

Each plane factor holds per-scan body-frame cluster moments C_gi, an
optional marginalized world-frame moment Cfix_g, a weight coe_g, a
world-frame conditioning center c_g and per-cluster body centroids b_gi
(reference VOX_HESS, src/benchmark/bavoxel.hpp:20-51).

Leaves may be numpy arrays (host, as the voxelizer emits them) or torch
tensors (device); `factors_from_numpy` moves a set of numpy leaves — the
JAX package's PlaneFactors leaves included — onto a device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import clusters


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

    def observes(self):
        """(G, W) bool: scan i contributes to plane g."""
        return clusters.count(self.C) > 0.5

    def planes_per_pose(self):
        """(W,) number of valid planes observed by each pose
        (reference degeneracy guard, bavoxel.hpp:1071-1078)."""
        valid = (self.coe > 0)[:, None]
        return (self.observes() & valid).sum(0)


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
