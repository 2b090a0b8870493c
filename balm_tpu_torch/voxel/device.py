"""Association on the GPU: scans -> recentered plane factors, on the card.

Counterpart: balm_tpu/voxel/device.py — DeviceVoxelizeResult (:93),
_pack_keys (:111), _boundaries (:137), _paxis_shift (:144),
_rot_moments (:168), _voxelize_core (:198) and its vmap, pad_scans
(:638) and voxelize_device (:654).  The JAX module is XLA-formulated
(no Pallas kernel); here it is torch ops on the card, with the same
dataflow, the same capacities and overflow flags, and the same retry
loop:

  1. rigid transform of every point, elementwise (never a matmul: a
     TF32 product would flip borderline planarity gates, as a bf16 pass
     did on the TPU), under ops/precision.fp32_matmul all the same
  2. quantize to the finest octree cell voxel/2^L as floor(world / fine)
     and sort ONCE, stably, by the packed (fine cell, scan) key: the
     JAX package's two non-negative int32 words (hi, lo) as one int64
     (hi << 31 | lo), which orders exactly as the pair
  3. one per-point moment pass at (fine cell, scan) granularity, about
     each point's cell centre (ops/segments.sorted_segment_sum)
  4. everything after at table granularity: fine-cell classification,
     coarser layers by the parallel-axis theorem, the closed-form 3x3
     eigenvalues (ops/eigh3) gating lambda0/lambda1 < eigen_ratio[layer],
     the root->fine cascade (a cell is a leaf iff it passes and no
     ancestor did)
  5. emission: the (cell, scan) rows re-sorted stably by (leaf, scan),
     shifted by exact integer-cell deltas, reduced to compact pairs and
     rotated to the body frame
  6. admission (>= min_observers scans) and a stable compaction: the
     admitted leaves first, padding rows exactly zero

JAX's scatters with mode="drop" write here into tables with one dump
row (the `cap + 1` rows JAX allocates) that is sliced off.  Its index
scatters of run boundaries (`.at[].set/min/max` of positions) become
`torch.searchsorted` over the sorted ids: on the card a scatter that
sends every non-head row to one dump address serializes millions of
atomics there.  No float sum scatters (ops/segments), and no
overwriting scatter has two live rows with one index, so the same input
gives the same bits on the card.

voxelize_core_batched runs B independent problems in one pass: the JAX
package's jax.vmap of _voxelize_core in the device-batched hierarchy
(balm_tpu/pipelines/hierarchical.py:704-706).  The block index is a
second, leading sort key (a stable sort after the cell-key one), every
table is pooled with B times each capacity, and each block's counts are
held against its own capacities (a per-block overflow flag).  The
single-problem core is its B = 1 case.

The scan id rides in the low key bits: ceil(log2 W) + 3 layer_limit
<= 16, with the JAX package's ValueError beyond it.  The fine grid must
fit 2^16 x 2^15 x 2^15 root cells relative to the cloud minimum; more
sets the overflow flag.  The dtype is the caller's choice (float32 by
default, float64 for the oracle tests), where the JAX function follows
its x64 switch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from ..config import VoxelConfig
from ..ops import eigh3
from ..ops import segments
from ..ops.factors import PlaneFactors
from ..ops.precision import fp32_matmul

_I32MAX = (1 << 31) - 1


@dataclasses.dataclass
class DeviceVoxelizeResult:
    """Tensor analogue of grid.VoxelizeResult, on the device.

    `factors` is already recentered (body_centers set, per-(leaf, scan)
    first moments zero) and padded to Gcap rows; `num_planes` is a
    device scalar, so the hot path forces no device->host transfer.
    `attempts` holds one dict per call of the core: its seconds (up to
    the host read of its overflow flag), the flag and the capacities.
    """

    factors: PlaneFactors
    num_planes: torch.Tensor       # () int64 admitted leaf count
    point_leaf: torch.Tensor       # (W, Nmax) leaf id or -1
                                   # ((W, 0) when want_point_leaf=False)
    leaf_layer: torch.Tensor       # (Gcap,) octree layer (admitted first)
    leaf_decision: torch.Tensor    # (Gcap,) lambda0/lambda1 at admission
    overflow: torch.Tensor         # () bool: a capacity was exceeded
    attempts: tuple = ()


def _pack_keys(qrel, L):
    """(N, 3) non-negative fine coords -> coarse-major (hi, lo) words.

      hi = root_x << 15 | root_y            (root_x < 2^16, root_y < 2^15)
      lo = root_z << 3L | o_1 .. o_L        (root_z < 2^15)

    with o_l the octant bits at layer l, so every layer's cell key is a
    prefix of one sort order: (hi, lo >> 3 (L - l)).
    """
    qroot = qrel >> L
    hi = (qroot[:, 0] << 15) | qroot[:, 1]
    lo = qroot[:, 2]
    sub = qrel & ((1 << L) - 1)
    for l in range(L):
        bits = (sub >> (L - 1 - l)) & 1
        lo = (lo << 3) | (bits[:, 0] << 2) | (bits[:, 1] << 1) | bits[:, 2]
    return hi, lo


def _boundaries(key):
    """First-of-run flags of a sorted key sequence (..., N) or, for a
    2-D (N, k) key, of its rows."""
    new = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    diff = key[1:] != key[:-1]
    new[1:] = diff.any(dim=1) if key.dim() == 2 else diff
    return new


def _paxis_shift(M, d):
    """Parallel-axis move of packed moments (..., 10) by anchor delta d.

    M holds [xx, xy, xz, yy, yz, zz, x, y, z, n] about anchor a; returns
    the moments about a' = a - d (coordinates c' = c + d).
    """
    v0, v1, v2, n = M[..., 6], M[..., 7], M[..., 8], M[..., 9]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([
        M[..., 0] + 2 * v0 * dx + n * dx * dx,
        M[..., 1] + v0 * dy + v1 * dx + n * dx * dy,
        M[..., 2] + v0 * dz + v2 * dx + n * dx * dz,
        M[..., 3] + 2 * v1 * dy + n * dy * dy,
        M[..., 4] + v1 * dz + v2 * dy + n * dy * dz,
        M[..., 5] + 2 * v2 * dz + n * dz * dz,
        v0 + n * dx,
        v1 + n * dy,
        v2 + n * dz,
        n,
    ], dim=-1)


def _matvec(R, v):
    """R (..., 3, 3) @ v (..., 3), elementwise."""
    return (R[..., :, 0] * v[..., None, 0] + R[..., :, 1] * v[..., None, 1]
            + R[..., :, 2] * v[..., None, 2])


def _rot_moments(M, R):
    """Rotate packed anchored moments (..., 10) by R (..., 3, 3):
    R P R^T and R v (rigid invariance), as elementwise products."""
    P = torch.stack([
        torch.stack([M[..., 0], M[..., 1], M[..., 2]], -1),
        torch.stack([M[..., 1], M[..., 3], M[..., 4]], -1),
        torch.stack([M[..., 2], M[..., 4], M[..., 5]], -1),
    ], dim=-2)
    RP = torch.stack([_matvec(R, P[..., :, k]) for k in range(3)], -1)
    Pw = torch.stack([_matvec(RP, R[..., j, :]) for j in range(3)], -1)
    vw = _matvec(R, M[..., 6:9])
    return torch.cat([
        torch.stack([Pw[..., 0, 0], Pw[..., 0, 1], Pw[..., 0, 2],
                     Pw[..., 1, 1], Pw[..., 1, 2], Pw[..., 2, 2]], -1),
        vw, M[..., 9:10],
    ], dim=-1)


def _run_heads(new, cap, n_runs):
    """(first, have) of `cap` runs flagged by `new` (ids: the cumsum of
    `new`): run s starts where cumsum(new) first reaches s + 1 (a
    searchsorted, no scatter); `first` is 0 past the last run."""
    dev = new.device
    c = torch.cumsum(new.long(), 0)
    heads = torch.searchsorted(c, torch.arange(1, cap + 1, device=dev))
    have = torch.arange(cap, device=dev) < n_runs
    return torch.where(have, heads, 0), have


def _dense_ids(new, live, cap):
    """cumsum ids of the runs flagged by `new`, clamped to cap - 1 and
    `cap` (the dump row) where not live; and the run count."""
    seg = torch.cumsum(new.long(), 0) - 1
    n = new.long().sum()
    return torch.where(live, torch.clamp(seg, max=cap - 1), cap), n


def _voxelize_core(body, mask, R, p, *, voxel_size: float, layer_limit: int,
                   eigen_ratio: tuple, min_points: int, min_observers: int,
                   unit_coe: bool, cell_caps: tuple, Gcap: int,
                   cs_cap: int | None = None, pair_cap: int | None = None,
                   want_point_leaf: bool = True, _stage: int = 99):
    """scans -> DeviceVoxelizeResult on body's device: one sort and one
    moment pass over the points, everything else over tables.

    body (W, Nmax, 3), mask (W, Nmax) bool, R (W, 3, 3), p (W, 3), all on
    one device in one float dtype.  `overflow` (a device bool) says a
    capacity was exceeded; the result is then not to be used.
    _stage=2 returns the (fine cell, scan) moments after the per-point
    pass (transform, sort, moment sums) alone, for timing it, as the
    JAX function's _stage does.
    """
    with fp32_matmul():
        return _core(body, mask, R, p, voxel_size, layer_limit,
                     eigen_ratio, min_points, min_observers, unit_coe,
                     cell_caps, Gcap, cs_cap, pair_cap, want_point_leaf,
                     _stage)


def _core(body, mask, R, p, voxel_size, L, eigen_ratio, min_points,
          min_observers, unit_coe, cell_caps, Gcap, cs_cap, pair_cap,
          want_point_leaf, _stage):
    """One problem: the batched core at B = 1, its leading axis
    dropped."""
    out = _core_batched(body[None], mask[None], R[None], p[None],
                        voxel_size, L, eigen_ratio, min_points,
                        min_observers, unit_coe, cell_caps, Gcap, cs_cap,
                        pair_cap, want_point_leaf, _stage)
    if _stage == 2:
        return out
    return DeviceVoxelizeResult(
        factors=PlaneFactors(*[x[0] for x in out.factors]),
        num_planes=out.num_planes[0], point_leaf=out.point_leaf[0],
        leaf_layer=out.leaf_layer[0], leaf_decision=out.leaf_decision[0],
        overflow=out.overflow[0])


def _count_by(flags, blk, B):
    """(B,) int64: the number of set `flags` rows of each block; rows
    with blk == B (padding) are dropped.  An integer scatter-add, exact
    in any order."""
    out = torch.zeros(B + 1, dtype=torch.long, device=flags.device)
    return out.scatter_add_(0, blk, flags.long())[:B]


def _core_batched(body, mask, R, p, voxel_size, L, eigen_ratio, min_points,
                  min_observers, unit_coe, cell_caps, Gcap, cs_cap,
                  pair_cap, want_point_leaf, _stage):
    """B independent problems of W scans in one pass: body (B, W, Nmax,
    3), mask (B, W, Nmax), R (B, W, 3, 3), p (B, W, 3).

    The block index is the leading sort key (a second stable sort; the
    (fine cell, scan) key keeps its 62 bits) and a boundary of every run,
    so each block's rows are contiguous in every table.  The tables are
    pooled, B times each per-block capacity, with ids dense over the
    pool; each block's own run counts are held against its own
    capacities (per-block `overflow`).  Leaf ids are dense within their
    block (row b * Gcap + id of the pooled leaf tables), so the emission
    scatters each plane straight into its block's (Gcap, W) rows."""
    B, W, Nmax = body.shape[:3]
    NB = W * Nmax                                # points per block
    N = B * NB
    dtype = body.dtype
    dev = body.device
    if cs_cap is None:
        cs_cap = int(min(max(4 * int(cell_caps[L]), 1 << 16),
                         max(NB, 1 << 16)))
    if pair_cap is None:
        pair_cap = int(min(Gcap * W, max(32 * Gcap, 1 << 16)))
    S = max((W - 1).bit_length(), 1)             # scan bits in the key
    # lo holds 15 root_z bits, 3L octant bits and S scan bits in 31
    if 15 + 3 * L + S > 31:
        raise ValueError(
            f"W={W} scans need {S} key bits; at layer_limit={L} the "
            f"packed key would overflow int32 (need ceil(log2(W)) + "
            f"3*layer_limit <= 16)")
    ssum = lambda data, seg, n: segments.sorted_segment_sum(
        data, seg, num_segments=n)
    arange = lambda n: torch.arange(n, device=dev)
    CS = B * cs_cap                              # pooled capacities
    BG = B * Gcap

    # --- 1. transform, elementwise ---
    world = (R[:, :, None, :, 0] * body[..., 0, None]
             + R[:, :, None, :, 1] * body[..., 1, None]
             + R[:, :, None, :, 2] * body[..., 2, None]) + p[:, :, None, :]
    world = world.reshape(N, 3)
    valid = mask.reshape(N)
    blk_pt = arange(N) // NB

    # --- 2. fine quantization + the sort ---
    fine = voxel_size / (1 << L)
    qf = torch.floor(world / fine).to(torch.int32)               # (N, 3)
    qmin = torch.where(valid[:, None], qf, _I32MAX).view(
        B, NB, 3).amin(dim=1)                                    # (B, 3)
    # each block's shift base aligned DOWN to a multiple of 2^L, so
    # qrel >> s groups cells exactly as the world grid does at every layer
    qbase = qmin & ~((1 << L) - 1)
    qrel = qf - qbase[blk_pt]
    lim = torch.tensor([1 << (16 + L), 1 << (15 + L), 1 << (15 + L)],
                       dtype=torch.int32, device=dev)
    overflow = torch.any((valid[:, None] & ((qrel < 0) | (qrel >= lim)))
                         .view(B, NB * 3), dim=1)                # (B,)
    qrel = torch.minimum(torch.clamp(qrel, min=0), lim - 1)
    hi, lo = _pack_keys(qrel, L)
    scan_pt = ((arange(N) // Nmax) % W).to(torch.int32)          # W-major
    lo = (lo << S) | scan_pt
    hi = torch.where(valid, hi, _I32MAX)       # invalid points sort last
    key, perm = torch.sort((hi.long() << 31) | lo.long(), stable=True)
    # block-major: a stable sort by block keeps each block's key order;
    # invalid points (block B) last
    blk_s = torch.where(valid, blk_pt, B)[perm]
    if B > 1:
        blk_s, order = torch.sort(blk_s, stable=True)
        key, perm = key[order], perm[order]
        del order
    hi = key >> 31
    lo = key & _I32MAX
    valid_s = blk_s < B
    del qf, qrel, scan_pt, blk_pt

    ratios = tuple(eigen_ratio) + (eigen_ratio[-1],) * max(
        0, L + 1 - len(eigen_ratio))

    # --- 3. one moment pass at (fine cell, scan) granularity, about each
    # point's cell centre ---
    newcs = (_boundaries(key) | _boundaries(blk_s)) & valid_s
    seg_cs, n_cs = _dense_ids(newcs, valid_s, CS)
    overflow = overflow | (_count_by(newcs, blk_s, B) > cs_cap)
    first, have_cs = _run_heads(newcs, CS, n_cs)

    world_s = world[perm]
    qb_s = qbase[torch.clamp(blk_s, max=B - 1)]
    qrel_s = torch.minimum(torch.clamp(
        torch.floor(world_s / fine).to(torch.int32) - qb_s, min=0), lim - 1)
    center_s = ((qrel_s + qb_s).to(dtype) + 0.5) * fine
    c = (world_s - center_s) * valid_s[:, None].to(dtype)
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    data = torch.stack([cx * cx, cx * cy, cx * cz, cy * cy, cy * cz,
                        cz * cz, cx, cy, cz, valid_s.to(dtype)], dim=-1)
    del world, world_s, qrel_s, qb_s, center_s, c, cx, cy, cz
    M_cs = ssum(data, seg_cs, CS)                                # (CS, 10)
    del data
    if _stage == 2:
        return M_cs

    # ======== table granularity from here ========
    # --- 4a. unpack per-row keys ---
    hi_tab = hi[first]
    lo_tab = lo[first]
    blk_tab = torch.where(have_cs, blk_s[first], B)
    scan_tab = torch.where(have_cs, lo_tab & ((1 << S) - 1), 0)
    cell_lo = lo_tab >> S                        # root_z + octant path
    rootx = hi_tab >> 15
    rooty = hi_tab & 0x7FFF
    rootz = cell_lo >> (3 * L)
    octs = cell_lo & ((1 << (3 * L)) - 1)
    sx = torch.zeros_like(octs)
    sy = torch.zeros_like(octs)
    sz = torch.zeros_like(octs)
    for l in range(L):
        bits = (octs >> (3 * (L - 1 - l))) & 7
        sx = (sx << 1) | ((bits >> 2) & 1)
        sy = (sy << 1) | ((bits >> 1) & 1)
        sz = (sz << 1) | (bits & 1)
    qabs_tab = (torch.stack([(rootx << L) | sx, (rooty << L) | sy,
                             (rootz << L) | sz], -1)
                + qbase[torch.clamp(blk_tab, max=B - 1)].long())
    qabs_tab = torch.where(have_cs[:, None], qabs_tab, 0)

    # --- 4b. classification: the rows of a fine cell share its centre,
    # so its moments are a straight sum ---
    capL = int(cell_caps[L])
    newf_tab = (_boundaries(torch.stack([hi_tab, cell_lo], 1))
                | _boundaries(blk_tab)) & have_cs
    segf_tab, n_cells_f = _dense_ids(newf_tab, have_cs, B * capL)
    overflow = overflow | (_count_by(newf_tab, blk_tab, B) > capL)
    M_f = ssum(M_cs, segf_tab, B * capL)
    qabs_f = segments.segment_first(qabs_tab, segf_tab,
                                    num_segments=B * capL)
    blk_f = torch.where(arange(B * capL) < n_cells_f, segments.segment_first(
        blk_tab[:, None], segf_tab, num_segments=B * capL)[:, 0], B)

    # --- 4c. coarser layers: parallel-axis aggregation on cell tables ---
    tables = {L: (M_f, qabs_f, n_cells_f, None, blk_f)}
    for l in range(L - 1, -1, -1):
        cap_c = B * int(cell_caps[l + 1])
        cap_l = B * int(cell_caps[l])
        M_c, qabs_c, n_c, _, blk_c = tables[l + 1]
        real_c = arange(cap_c) < n_c
        qp = qabs_c >> 1
        newp = (_boundaries(qp) | _boundaries(blk_c)) & real_c
        seg_p, n_p = _dense_ids(newp, real_c, cap_l)
        overflow = overflow | (_count_by(newp, blk_c, B) > int(cell_caps[l]))
        # child-cell-local -> parent-cell-local by the exact integer delta
        # (qabs_c - 2 qp is 0 or 1 per axis)
        sz_c = voxel_size / (1 << (l + 1))
        d = ((qabs_c - 2 * qp).to(dtype) - 0.5) * sz_c
        M_p = ssum(_paxis_shift(M_c, d), seg_p, cap_l)
        qabs_p = segments.segment_first(qp, seg_p, num_segments=cap_l)
        blk_p = torch.where(arange(cap_l) < n_p, segments.segment_first(
            blk_c[:, None], seg_p, num_segments=cap_l)[:, 0], B)
        tables[l] = (M_p, qabs_p, n_p, None, blk_p)
        tables[l + 1] = (M_c, qabs_c, n_c, seg_p, blk_c)  # child -> parent

    # --- 4d. per-layer stats + root->fine decision cascade; leaf ids
    # dense within each block, numbered layer by layer ---
    meta_center = torch.zeros((BG + 1, 3), dtype=dtype, device=dev)
    meta_layer = torch.zeros(BG + 1, dtype=torch.int32, device=dev)
    meta_decision = torch.zeros(BG + 1, dtype=dtype, device=dev)
    n_leaves = torch.zeros(B + 1, dtype=torch.long, device=dev)
    leaf_of_cell = {}
    can_split_parent = None     # rows of the layer above that may split
    for l in range(L + 1):
        cap = B * int(cell_caps[l])
        cell_sz = voxel_size / (1 << l)
        M, qabs, n_cells, seg_to_parent, blk = tables[l]
        cnt = M[:, 9]
        cnt1 = torch.clamp(cnt, min=1.0)
        mean = M[:, 6:9] / cnt1[:, None]
        cxx = M[:, 0] / cnt1 - mean[:, 0] * mean[:, 0]
        cxy = M[:, 1] / cnt1 - mean[:, 0] * mean[:, 1]
        cxz = M[:, 2] / cnt1 - mean[:, 0] * mean[:, 2]
        cyy = M[:, 3] / cnt1 - mean[:, 1] * mean[:, 1]
        cyz = M[:, 4] / cnt1 - mean[:, 1] * mean[:, 2]
        czz = M[:, 5] / cnt1 - mean[:, 2] * mean[:, 2]
        cov = torch.stack([
            torch.stack([cxx, cxy, cxz], -1),
            torch.stack([cxy, cyy, cyz], -1),
            torch.stack([cxz, cyz, czz], -1),
        ], dim=-2)
        lam = eigh3.eigvals3(cov)                              # ascending
        decision = lam[:, 0] / torch.clamp(lam[:, 1], min=1e-30)

        alive = cnt > min_points           # strict >, grid.py semantics
        is_real = arange(cap) < n_cells
        passes = alive & (decision < ratios[l])
        is_plane = passes & is_real
        if can_split_parent is not None:
            ancestor_ok = can_split_parent[torch.clamp(
                seg_to_parent, max=can_split_parent.shape[0] - 1)][:cap]
            is_plane = is_plane & ancestor_ok
            can_split = alive & ~passes & is_real & ancestor_ok
        else:
            can_split = alive & ~is_plane & is_real

        # rank within the block: the pooled rank less the planes of the
        # blocks before (rows are block-major)
        n_new = _count_by(is_plane, blk, B)
        before = torch.cumsum(n_new, 0) - n_new
        prank = (torch.cumsum(is_plane.long(), 0) - 1
                 - torch.nn.functional.pad(before, (0, 1))[blk])
        overflow = overflow | ((n_leaves[:B] + n_new) > Gcap)
        local = n_leaves[blk] + prank
        lc = torch.where(is_plane & (local < Gcap),
                         torch.clamp(blk, max=B - 1) * Gcap + local, BG)
        leaf_of_cell[l] = lc
        n_leaves = n_leaves + torch.nn.functional.pad(n_new, (0, 1))

        # live rows of lc are distinct; the rest land in the dump row
        cell_center = (qabs.to(dtype) + 0.5) * cell_sz
        meta_center[lc] = mean + cell_center
        meta_layer[lc] = l
        meta_decision[lc] = decision
        meta_center[BG] = 0.0
        meta_decision[BG] = 0.0
        can_split_parent = can_split

    # leaf of each FINE cell = its nearest plane ancestor (the cascade
    # leaves at most one plane cell on any root->fine path)
    leaf_fine_tab = leaf_of_cell[L]
    fine_to_l = None     # fine row -> layer-l row, composed incrementally
    bg_t = torch.full((1,), BG, dtype=torch.long, device=dev)
    for l in range(L - 1, -1, -1):
        up = tables[l + 1][3]            # layer-(l+1) row -> layer-l row
        fine_to_l = (up if fine_to_l is None else up[torch.clamp(
            fine_to_l, max=B * int(cell_caps[l + 1]) - 1)])
        lc_l = torch.cat([leaf_of_cell[l], bg_t])
        cand = lc_l[torch.clamp(fine_to_l, max=B * int(cell_caps[l]))]
        leaf_fine_tab = torch.where(cand < BG, cand, leaf_fine_tab)
    leaf_cs = torch.cat([leaf_fine_tab, bg_t])[torch.clamp(
        segf_tab, max=B * capL)]
    del tables, leaf_of_cell, M_f

    # --- 5. emission: shift in the world frame, reduce to compact
    # (leaf, scan) pairs, rotate once per pair ---
    GW = BG * W
    PC = B * pair_cap
    center_tab = (qabs_tab.to(dtype) + 0.5) * fine
    key_e = torch.where((leaf_cs < BG) & have_cs,
                        leaf_cs * W + scan_tab, GW)
    key_e, operm = torch.sort(key_e, stable=True)
    Mw = M_cs[operm]
    cw = center_tab[operm]
    qa_e = qabs_tab[operm]                                 # exact int cells
    live_e = key_e < GW
    new_e = _boundaries(key_e) & live_e
    seg_e, n_pairs = _dense_ids(new_e, live_e, PC)
    overflow = overflow | (_count_by(
        new_e, torch.clamp(key_e // (Gcap * W), max=B), B) > pair_cap)
    first_p, have_p = _run_heads(new_e, PC, n_pairs)
    del M_cs, center_tab

    cw_tgt = torch.where(have_p[:, None], cw[first_p], 0.0)     # (pairs, 3)
    pairkey = torch.where(have_p, key_e[first_p], GW)
    qa_tgt = torch.where(have_p[:, None], qa_e[first_p], 0)
    # exact integer-cell deltas: fine * (qabs - qabs_tgt)
    d_w = torch.where(
        live_e[:, None],
        (qa_e - qa_tgt[torch.clamp(seg_e, max=PC - 1)]).to(dtype)
        * fine, 0.0)
    Mp = ssum(_paxis_shift(Mw, d_w) * live_e[:, None].to(dtype), seg_e,
              PC)                                               # (pairs, 10)
    del Mw, cw, qa_e, d_w

    scan_p = torch.where(have_p, pairkey % W, 0)
    blk_pp = torch.where(have_p, pairkey // (Gcap * W), 0)
    Rt_p = R[blk_pp, scan_p].transpose(-1, -2)                  # (pairs,3,3)
    Mp_b = _rot_moments(Mp, Rt_p)                               # body frame
    a_b = torch.where(have_p[:, None],
                      _matvec(Rt_p, cw_tgt - p[blk_pp, scan_p]), 0.0)
    cnt_p = Mp_b[:, 9]
    m_p = Mp_b[:, 6:9] / torch.clamp(cnt_p[:, None], min=1.0)  # local mean
    P_p = torch.stack([
        Mp_b[:, 0] - cnt_p * m_p[:, 0] * m_p[:, 0],
        Mp_b[:, 1] - cnt_p * m_p[:, 0] * m_p[:, 1],
        Mp_b[:, 2] - cnt_p * m_p[:, 0] * m_p[:, 2],
        Mp_b[:, 3] - cnt_p * m_p[:, 1] * m_p[:, 1],
        Mp_b[:, 4] - cnt_p * m_p[:, 1] * m_p[:, 2],
        Mp_b[:, 5] - cnt_p * m_p[:, 2] * m_p[:, 2],
    ], dim=-1)                                                  # (pairs, 6)
    bmean_p = torch.where(cnt_p[:, None] > 0, a_b + m_p, 0.0)

    # the compact pairs into the dense (B, Gcap, W) layout: live pair
    # keys are distinct, the rest land in the dump row
    tgt = torch.where(have_p, pairkey, GW)

    def dense(vals):
        out = torch.zeros((GW + 1,) + vals.shape[1:], dtype=dtype,
                          device=dev)
        out[tgt] = vals
        return out[:GW]

    cnt_ls = dense(cnt_p).view(B, Gcap, W)
    P = dense(P_p).view(B, Gcap, W, 6)
    bmean = dense(bmean_p).view(B, Gcap, W, 3)
    del Mp, Mp_b, P_p, bmean_p

    # --- 6. admission + stable compaction per block: admitted leaves
    # first ---
    observers = (cnt_ls > 0).sum(-1)
    total = cnt_ls.sum(-1)
    admit = (observers >= min_observers) & (total > 0)          # (B, Gcap)
    order = torch.sort((~admit).to(torch.int32), dim=-1, stable=True).indices
    bix = arange(B)[:, None]
    adm_o = admit[bix, order]
    Po = P[bix, order] * adm_o[..., None, None]
    cnt_o = cnt_ls[bix, order] * adm_o[..., None]
    b_o = bmean[bix, order] * adm_o[..., None, None]

    C = torch.zeros((B, Gcap, W, 4, 4), dtype=dtype, device=dev)
    for k, (i, j) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                (2, 2))):
        C[..., i, j] = Po[..., k]
        C[..., j, i] = Po[..., k]
    C[..., 3, 3] = cnt_o
    coe = (adm_o.to(dtype) if unit_coe else cnt_o.sum(-1))
    meta_o = lambda m: m[:-1].view((B, Gcap) + m.shape[1:])[bix, order]
    centers = meta_o(meta_center) * adm_o[..., None]
    factors = PlaneFactors(
        C=C, Cfix=torch.zeros((B, Gcap, 4, 4), dtype=dtype, device=dev),
        coe=coe, centers=centers, body_centers=b_o)

    num_planes = admit.long().sum(-1)
    if want_point_leaf:
        # point_leaf in the input (B, W, Nmax) layout, compacted ids
        inv = torch.zeros(BG + 1, dtype=torch.long, device=dev)
        inv[(bix * Gcap + order).reshape(-1)] = arange(Gcap).repeat(B)
        leaf_pt = leaf_cs[torch.clamp(seg_cs, max=CS - 1)]      # (N,)
        lp = torch.clamp(leaf_pt, max=BG - 1)
        pl_sorted = torch.where(
            (leaf_pt < BG) & valid_s & admit.reshape(-1)[lp], inv[lp], -1)
        point_leaf = torch.empty(N, dtype=torch.long, device=dev)
        point_leaf[perm] = pl_sorted
        point_leaf = point_leaf.view(B, W, Nmax)
    else:
        point_leaf = torch.zeros((B, W, 0), dtype=torch.long, device=dev)

    return DeviceVoxelizeResult(
        factors=factors, num_planes=num_planes, point_leaf=point_leaf,
        leaf_layer=meta_o(meta_layer), leaf_decision=meta_o(meta_decision),
        overflow=overflow)


def voxelize_core_batched(body, mask, R, p, *, voxel_size: float,
                          layer_limit: int, eigen_ratio: tuple,
                          min_points: int, min_observers: int,
                          unit_coe: bool, cell_caps: tuple, Gcap: int,
                          cs_cap: int | None = None,
                          pair_cap: int | None = None,
                          want_point_leaf: bool = False):
    """B independent association problems in one pass: the JAX
    package's jax.vmap of _voxelize_core (balm_tpu/pipelines/
    hierarchical.py:704-706).

    body (B, W, Nmax, 3), mask (B, W, Nmax), R (B, W, 3, 3), p (B, W, 3)
    on one device in one float dtype; every capacity is per block, as
    under vmap.  Returns a DeviceVoxelizeResult with a leading B axis:
    factors (B, Gcap, W, ...), num_planes (B,), leaf_layer and
    leaf_decision (B, Gcap), point_leaf (B, W, Nmax) (or (B, W, 0)), and
    overflow (B,): a block that exceeds any of its own capacities sets
    its flag, though the pooled tables would hold it."""
    with fp32_matmul():
        return _core_batched(body, mask, R, p, voxel_size, layer_limit,
                             eigen_ratio, min_points, min_observers,
                             unit_coe, cell_caps, Gcap, cs_cap, pair_cap,
                             want_point_leaf, 99)


def pad_scans(points: Sequence[np.ndarray], dtype=np.float32,
              multiple: int = 1024):
    """Host helper: list of (Ni, 3) scans -> ((W, Nmax, 3), (W, Nmax)
    mask) numpy arrays, Nmax rounded up to `multiple`."""
    W = len(points)
    Nmax = max(len(s) for s in points)
    Nmax = max(multiple, -(-Nmax // multiple) * multiple)
    body = np.zeros((W, Nmax, 3), dtype)
    mask = np.zeros((W, Nmax), bool)
    for i, s in enumerate(points):
        body[i, :len(s)] = s
        mask[i, :len(s)] = True
    return body, mask


def trim_planes(f: PlaneFactors, num_planes: int) -> PlaneFactors:
    """The first `num_planes` rows of padded factors.  The padding rows
    are exactly zero, so they change no cost, gradient or Hessian; the
    solve then sweeps only the admitted planes."""
    return PlaneFactors(*[x[:num_planes] for x in f])


def voxelize_device(points, R, p, cfg: VoxelConfig = VoxelConfig(), *,
                    weighting: str = "point_count",
                    cell_caps: tuple | None = None, Gcap: int = 1 << 13,
                    cs_cap: int | None = None, pair_cap: int | None = None,
                    want_point_leaf: bool = True, max_retries: int = 2,
                    dtype=torch.float32, device="cuda"
                    ) -> DeviceVoxelizeResult:
    """Associate scans into plane factors on `device` (the card unless
    the caller passes device='cpu').

    points: a list of (Ni, 3) host scans, or a pre-padded (body (W, Nmax,
    3), mask (W, Nmax)) pair of arrays or tensors.  R (W, 3, 3), p (W, 3).
    The returned factors are recentered, in `dtype`, padded to Gcap rows;
    they feed lm.damping_iter(centered=True) directly.  A capacity
    overflow is found by one host read of the flag per attempt, and the
    call retries with every capacity 4x, up to max_retries times, as the
    JAX function does; `attempts` records each attempt's seconds.
    want_point_leaf=False skips the per-point leaf map.
    """
    if weighting not in ("point_count", "unit"):
        raise ValueError(weighting)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("voxelize_device: no CUDA device; pass "
                           "device='cpu' for the CPU")
    if (isinstance(points, tuple) and len(points) == 2
            and getattr(points[0], "ndim", 0) == 3):
        body, mask = points                     # pre-padded (body, mask)
    else:
        body, mask = pad_scans(points, np.float32 if dtype == torch.float32
                               else np.float64)
    N = int(np.prod(body.shape[:2]))
    if cell_caps is None:
        # a practical default, retried on overflow
        base = max(1 << 14, min(N // 8, 1 << 20))
        cell_caps = tuple(min(base * (4 ** l), 1 << 21)
                          for l in range(cfg.layer_limit + 1))
    if cs_cap is None:
        cs_cap = int(min(max(4 * cell_caps[-1], 1 << 16), max(N, 1 << 16)))

    T = lambda x, dt: torch.as_tensor(x).to(device=device, dtype=dt)
    body = T(body, dtype)
    mask = T(mask, torch.bool)
    Rt = T(R, dtype)
    pt = T(p, dtype)

    attempts = []
    for attempt in range(max_retries + 1):
        t0 = time.perf_counter()
        out = _voxelize_core(
            body, mask, Rt, pt, voxel_size=float(cfg.voxel_size),
            layer_limit=int(cfg.layer_limit),
            eigen_ratio=tuple(float(r) for r in cfg.eigen_ratio),
            min_points=int(cfg.min_points),
            min_observers=int(cfg.min_observers),
            unit_coe=(weighting == "unit"),
            cell_caps=tuple(int(c) for c in cell_caps), Gcap=int(Gcap),
            cs_cap=int(cs_cap),
            pair_cap=None if pair_cap is None else int(pair_cap),
            want_point_leaf=want_point_leaf)
        over = bool(out.overflow)               # the one host read
        attempts.append({"seconds": time.perf_counter() - t0,
                         "overflow": over, "Gcap": int(Gcap),
                         "cell_caps": tuple(cell_caps),
                         "cs_cap": int(cs_cap)})
        if attempt == max_retries or not over:
            break
        cell_caps = tuple(min(c * 4, 1 << 22) for c in cell_caps)
        cs_cap = int(min(cs_cap * 4, max(N, 1 << 16)))
        if pair_cap is not None:
            pair_cap = int(pair_cap * 4)
        Gcap *= 4
    return dataclasses.replace(out, attempts=tuple(attempts))
