"""Sliding-window marginalization on factor tensors (host, numpy).

Counterpart: balm_tpu/voxel/marginalize.py (marginalize :21); reference
OCTO_TREE_NODE::to_margi / OCTO_TREE_ROOT::marginalize
(src/benchmark/bavoxel.hpp:778-816, 948-963; consistency variant
src/simulation/BAs_left.hpp:754-792, 926-941): the oldest `mg_size`
scans of every plane are absorbed into the fixed world-frame cluster
(the paper's P_fix prior) and the window shifts down — a transform and
sum into Cfix, a slice of the scan axis and a weight refresh.
"""

from __future__ import annotations

import numpy as np

from ..ops.factors import PlaneFactors


def marginalize(
    f: PlaneFactors,
    T_margi: np.ndarray,
    mg_size: int,
    *,
    fix_cap: float = 50.0,
    weighting: str = "point_count",
) -> PlaneFactors:
    """Absorb scans [0, mg_size) into Cfix and shift the window.

    T_margi: (mg_size, 4, 4) world poses that transform the absorbed
    body-frame clusters.  fix_cap: a plane stops absorbing once its
    fixed cluster holds >= this many points (reference `fix_point.N <
    50`, bavoxel.hpp:789); the marginalized scans of such planes are
    dropped.  weighting: 'point_count' (coe = the window's points) or
    'unit' (coe = 1), as voxel.grid.voxelize's.

    Host numpy, once per window step: takes numpy leaves (or anything
    np.asarray reads), returns numpy leaves.
    """
    if weighting not in ("point_count", "unit"):
        raise ValueError(weighting)
    C = np.asarray(f.C)
    Cfix = np.asarray(f.Cfix).copy()
    G, W = C.shape[:2]
    if not 0 < mg_size < W:
        raise ValueError(f"mg_size must lie in (0, {W}), got {mg_size}")

    absorb = Cfix[:, 3, 3] < fix_cap                       # (G,)
    for i in range(mg_size):
        T = np.asarray(T_margi[i])
        TCT = np.einsum("ab,gbc,dc->gad", T, C[:, i], T)
        Cfix[absorb] += TCT[absorb]

    C_new = C[:, mg_size:].copy()
    n_win = C_new[..., 3, 3].sum(axis=1)
    coe = n_win if weighting == "point_count" else \
        (n_win > 0).astype(C.dtype)
    # planes without window points carry no weight (and planes with
    # neither window nor fixed points die)
    coe = np.where(n_win > 0, coe, 0.0)

    return PlaneFactors(
        C=C_new,
        Cfix=Cfix,
        coe=coe,
        centers=np.asarray(f.centers),
        body_centers=np.asarray(f.body_centers)[:, mg_size:],
    )
