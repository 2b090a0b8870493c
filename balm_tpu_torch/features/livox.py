"""Livox rule-based feature extractor.

Counterpart: balm_tpu/features/livox.py (extract_scanline :324,
split_rings_velodyne :345, extract :356 and their helpers), copied:
host numpy, no tensors.

Re-implementation of the reference's per-scanline classifier
(BALM-old/src/features/livox_feature.cpp:476-813 give_feature +
plane_judge:824-940 + edge_jump_judge) — the Edge_Jump / Real_Plane /
Edge_Plane / Wire state machine for solid-state (MID/HORIZON) and
spinning (VELO16/OUST64) lidars.

Structure (host-side preprocessing, like the reference's ROS node):
  * plane_judge is precomputed for EVERY index as vectorized numpy
    tables (group extension, length/width ratio, sorted-gap gates) —
    the reference recomputes it per sweep position inside the scan loop.
  * the sweep itself (Poss/Real/Edge_Plane states with skip-ahead,
    give_feature:502-599) iterates ~N/group_size times in Python over
    those tables.
  * edge-jump classification (give_feature:602-690) and the small-plane
    upgrade (give_feature:698-735) are fully vectorized; the small-plane
    pass applies all upgrades in one shot from the pre-pass types (the
    reference applies them in scan order, which can chain upgrades —
    a deliberate, documented simplification).
  * surf output averages runs of point_filter_num consecutive plane
    points; corn output collects Edge_Jump/Edge_Plane points
    (give_feature:761-813).

Feature enum values mirror livox_feature.cpp:14.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Feature types (livox_feature.cpp:14)
NOR = 0
POSS_PLANE = 1
REAL_PLANE = 2
EDGE_JUMP = 3
EDGE_PLANE = 4
WIRE = 5
ZERO_POINT = 6

# neighbor jump states (livox_feature.cpp:16)
NR_NOR = 0
NR_ZERO = 1
NR_180 = 2
NR_INF = 3
NR_BLIND = 4


@dataclasses.dataclass
class LivoxConfig:
    """Defaults = the reference launch defaults (livox_feature.cpp main)."""

    lidar_type: str = "horizon"    # 'mid' | 'horizon' | 'velo16' | 'oust64'
    blind: float = 0.5
    inf_bound: float = 10.0
    group_size: int = 8
    disA: float = 0.01
    disB: float = 0.1
    p2l_ratio: float = 400.0
    limit_maxmid: float = 9.0
    limit_midmin: float = 16.0
    limit_maxmin: float = 3.24
    jump_up_deg: float = 175.0
    jump_down_deg: float = 5.0
    cos160_deg: float = 160.0
    edgea: float = 3.0
    edgeb: float = 0.05
    smallp_intersect_deg: float = 170.0
    smallp_ratio: float = 1.2
    point_filter_num: int = 4
    max_group_extend: int = 12     # cap on the group extension loop


def _plane_judge_tables(pts, rng, dista, cfg: LivoxConfig):
    """Vectorized plane_judge for every start index.

    Returns (ptype (N,), i_nex (N,), direct (N, 3)):
      ptype 1 = plane group, 0 = not planar, 2 = hits blind region.
    """
    N = len(pts)
    gs = cfg.group_size
    E = gs + cfg.max_group_extend
    idx = np.minimum(np.arange(N)[:, None] + np.arange(E)[None, :], N - 1)
    prng = rng[idx]                                    # (N, E)
    group_dis = (cfg.disA * rng + cfg.disB) ** 2       # (N,)

    # blind hit inside the base group -> type 2
    blind_any = (prng[:, :gs] < cfg.blind).any(axis=1)

    # extension: first j >= gs with |p_j - p_i|^2 >= group_dis
    rel = pts[idx] - pts[:, None, :]                   # (N, E, 3)
    two = np.einsum("nej,nej->ne", rel, rel)
    beyond = two[:, gs:] >= group_dis[:, None]         # (N, E-gs)
    ext = np.where(beyond.any(axis=1), beyond.argmax(axis=1),
                   E - gs - 1)                         # extension length
    i_nex = np.arange(N) + gs + ext                    # index of group end
    i_nex = np.minimum(i_nex, N - 1)
    # blind inside the extension (reference breaks with type 2)
    in_ext = (np.arange(E)[None, :] >= gs) & (
        np.arange(E)[None, :] <= (gs + ext)[:, None])
    blind_any |= ((prng < cfg.blind) & in_ext).any(axis=1)

    # direction + length/width test over j in (i, i_nex)
    sel = np.arange(E)[None, :]
    vend = pts[i_nex] - pts[np.arange(N)]              # (N, 3)
    two_dis = np.einsum("nj,nj->n", vend, vend)
    cross = np.cross(rel, vend[:, None, :])            # (N, E, 3)
    lw = np.einsum("nej,nej->ne", cross, cross)
    interior = (sel >= 1) & (sel < (i_nex - np.arange(N))[:, None])
    leng_wid = np.where(interior, lw, 0.0).max(axis=1)
    leng_wid = np.maximum(leng_wid, 1e-30)
    not_planar = (two_dis * two_dis / leng_wid) < cfg.p2l_ratio

    # sorted point-gap gates over the group's dista values
    in_grp = sel <= (gs + ext - 1)[:, None]            # dista indices used
    dvals = np.where(in_grp, dista[idx], -1.0)
    dsort = np.sort(dvals, axis=1)[:, ::-1]            # descending
    cnt = in_grp.sum(axis=1)
    second_last = dsort[np.arange(N), np.maximum(cnt - 2, 0)]
    not_planar |= second_last < 1e-16
    mid = dsort[np.arange(N), cnt // 2]
    mids = np.maximum(mid, 1e-30)
    if cfg.lidar_type in ("mid", "horizon"):
        not_planar |= (dsort[:, 0] / mids) >= cfg.limit_maxmid
        not_planar |= (mid / np.maximum(second_last, 1e-30)) >= cfg.limit_midmin
    else:
        not_planar |= (
            dsort[:, 0] / np.maximum(second_last, 1e-30)
        ) >= cfg.limit_maxmin

    nrm = np.sqrt(np.maximum(two_dis, 1e-30))
    direct = vend / nrm[:, None]
    ptype = np.where(blind_any, 2, np.where(not_planar, 0, 1))
    direct = np.where((ptype == 1)[:, None], direct, 0.0)
    return ptype, i_nex, direct


def _sweep_planes(ptype, i_nex, direct, rng, cfg: LivoxConfig, N):
    """The skip-ahead surf state machine (give_feature:502-599)."""
    ftype = np.zeros(N, np.int8)
    head = 0
    while head < N and rng[head] < cfg.blind:
        head += 1
    last_state = 0
    last_direct = np.zeros(3)
    last_i = 0
    last_i_nex = 0
    i = head
    end = N - cfg.group_size
    while i < end:
        if rng[i] < cfg.blind:
            i += 1
            continue
        i2 = i
        pt = ptype[i]
        cur_nex = int(i_nex[i])
        cur_dir = direct[i]
        if pt == 1:
            j0, j1 = i, cur_nex
            ftype[j0 + 1:j1] = np.maximum(ftype[j0 + 1:j1], REAL_PLANE)
            for j in (j0, j1):
                if ftype[j] < POSS_PLANE:
                    ftype[j] = POSS_PLANE
            if last_state == 1 and np.linalg.norm(last_direct) > 0.1:
                mod = float(last_direct @ cur_dir)
                ftype[i] = EDGE_PLANE if -0.707 < mod < 0.707 else REAL_PLANE
            last_state = 1
            i = j1 - 1
        elif pt == 2:
            i = cur_nex
            last_state = 0
        else:
            # recovery branch (give_feature:549-594): re-judge forward
            # from inside the previous plane run so the plane state
            # carries through a corner and the NEXT group can be tagged
            # Edge_Plane
            if last_state == 1:
                i_nex_tem = last_i_nex
                j = last_i + 1
                while j <= last_i_nex:
                    if ptype[j] != 1:
                        break
                    i_nex_tem = int(i_nex[j])
                    cur_dir = direct[j]
                    j += 1
                if j == last_i + 1:
                    last_state = 0
                else:
                    ftype[last_i_nex:i_nex_tem] = np.maximum(
                        ftype[last_i_nex:i_nex_tem], REAL_PLANE)
                    if ftype[i_nex_tem] < POSS_PLANE:
                        ftype[i_nex_tem] = POSS_PLANE
                    i = i_nex_tem - 1
                    cur_nex = i_nex_tem
                    i2 = j - 1
                    last_state = 1
            else:
                last_state = 0
        last_i = i2
        last_i_nex = cur_nex
        if last_state == 1:
            last_direct = cur_dir
        else:
            last_direct = np.zeros(3)
        i += 1
    return ftype


def _edge_jump_pass(pts, rng, dista, ftype, cfg: LivoxConfig):
    """Vectorized Edge_Jump / Wire classification (give_feature:602-690)."""
    N = len(pts)
    if N < 7:
        return ftype, np.ones(N)
    jump_up = np.cos(np.deg2rad(cfg.jump_up_deg))
    jump_down = np.cos(np.deg2rad(cfg.jump_down_deg))
    cos160 = np.cos(np.deg2rad(cfg.cos160_deg))

    i = np.arange(3, N - 3)
    va = pts[i]
    nrm_a = np.linalg.norm(va, axis=1)
    edj = np.full((N, 2), NR_NOR, np.int8)
    vecs = np.zeros((N, 2, 3))
    for j, m in ((0, -1), (1, 1)):
        vj = pts[i + m] - va
        nv = np.linalg.norm(vj, axis=1)
        ang = np.einsum("nj,nj->n", va, vj) / np.maximum(
            nrm_a * nv, 1e-30)
        st = np.where(ang < jump_up, NR_180,
                      np.where(ang > jump_down, NR_ZERO, NR_NOR))
        nb_blind = rng[i + m] < cfg.blind
        st = np.where(nb_blind & (rng[i] > cfg.inf_bound), NR_INF, st)
        st = np.where(nb_blind & (rng[i] <= cfg.inf_bound), NR_BLIND, st)
        edj[i, j] = st
        vecs[i, j] = vj

    inter = np.einsum("nj,nj->n", vecs[i, 0], vecs[i, 1]) / np.maximum(
        np.linalg.norm(vecs[i, 0], axis=1)
        * np.linalg.norm(vecs[i, 1], axis=1), 1e-30)
    intersect = np.zeros(N)
    intersect[i] = inter

    def ejj(ii, nor_dir):
        """edge_jump_judge (vectorized)."""
        ok = np.ones(len(ii), bool)
        off = np.where(nor_dir == 0, -1, 1)
        ok &= rng[np.clip(ii + off, 0, N - 1)] >= cfg.blind
        ok &= rng[np.clip(ii + 2 * off, 0, N - 1)] >= cfg.blind
        d1 = dista[np.clip(ii + nor_dir - 1, 0, N - 1)]
        d2 = dista[np.clip(ii + 3 * nor_dir - 2, 0, N - 1)]
        hi = np.sqrt(np.maximum(d1, d2))
        lo = np.sqrt(np.minimum(d1, d2))
        ok &= ~((hi > cfg.edgea * lo) | ((hi - lo) > cfg.edgeb))
        return ok

    cand = (ftype[i] < REAL_PLANE) & (rng[i] >= cfg.blind)
    cand &= (dista[i - 1] >= 1e-16) & (dista[i] >= 1e-16)
    ep, en = edj[i, 0], edj[i, 1]
    c1 = cand & (ep == NR_NOR) & (en == NR_ZERO) & (dista[i] > 0.0225) \
        & (dista[i] > 4 * dista[i - 1]) & (inter > cos160) & ejj(i, 0)
    c2 = cand & (ep == NR_ZERO) & (en == NR_NOR) & (dista[i - 1] > 0.0225) \
        & (dista[i - 1] > 4 * dista[i]) & (inter > cos160) & ejj(i, 1)
    c3 = cand & (ep == NR_NOR) & (en == NR_INF) & ejj(i, 0)
    c4 = cand & (ep == NR_INF) & (en == NR_NOR) & ejj(i, 1)
    jump = c1 | c2 | c3 | c4
    wire = cand & (ep > NR_NOR) & (en > NR_NOR) & (ftype[i] == NOR) & ~jump
    ftype[i[jump]] = EDGE_JUMP
    ftype[i[wire]] = WIRE
    return ftype, intersect


def _smallp_pass(rng, dista, ftype, intersect, cfg: LivoxConfig):
    """Small-plane upgrade (give_feature:698-735), one-shot application."""
    N = len(rng)
    if N < 3:
        return ftype
    smallp_int = np.cos(np.deg2rad(cfg.smallp_intersect_deg))
    i = np.arange(1, N - 1)
    ok = (rng[i] >= cfg.blind) & (rng[i - 1] >= cfg.blind) & (
        rng[i + 1] >= cfg.blind)
    ok &= (dista[i - 1] >= 1e-8) & (dista[i] >= 1e-8)
    ok &= ftype[i] == NOR
    hi = np.maximum(dista[i - 1], dista[i])
    lo = np.maximum(np.minimum(dista[i - 1], dista[i]), 1e-30)
    ok &= (intersect[i] < smallp_int) & (hi / lo < cfg.smallp_ratio)
    up = np.zeros(N, bool)
    up[i[ok]] = True
    mark = up.copy()
    mark[:-1] |= up[1:]
    mark[1:] |= up[:-1]
    ftype[mark & (ftype == NOR)] = REAL_PLANE
    ftype[up] = REAL_PLANE
    return ftype


def _collect(pts, rng, ftype, cfg: LivoxConfig):
    """Output selection + surf averaging (give_feature:761-813)."""
    surf, corn = [], []
    is_plane = (ftype == POSS_PLANE) | (ftype == REAL_PLANE)
    last_surface = -1
    head = 0
    N = len(pts)
    while head < N and rng[head] < cfg.blind:
        head += 1
    for j in range(head, N):
        if is_plane[j]:
            if last_surface == -1:
                last_surface = j
            if j == last_surface + cfg.point_filter_num - 1:
                surf.append(pts[last_surface:j + 1].mean(axis=0))
                last_surface = -1
        else:
            if ftype[j] in (EDGE_JUMP, EDGE_PLANE):
                corn.append(pts[j])
            if last_surface != -1:
                surf.append(pts[last_surface:j].mean(axis=0))
            last_surface = -1
    surf = np.asarray(surf).reshape(-1, 3)
    corn = np.asarray(corn).reshape(-1, 3)
    return surf, corn


def extract_scanline(pts: np.ndarray, cfg: LivoxConfig = LivoxConfig()):
    """Classify one ORDERED scanline (N, 3).

    Returns (surf (S,3), corn (C,3), ftype (N,)) — surface points are
    averaged groups; corner points are Edge_Jump/Edge_Plane."""
    pts = np.asarray(pts, np.float64)
    N = len(pts)
    if N < cfg.group_size + 4:
        return np.zeros((0, 3)), np.zeros((0, 3)), np.zeros(N, np.int8)
    rng = np.hypot(pts[:, 0], pts[:, 1])
    d = pts[:-1] - pts[1:]
    dista = np.concatenate([np.einsum("nj,nj->n", d, d), [0.0]])

    ptype, i_nex, direct = _plane_judge_tables(pts, rng, dista, cfg)
    ftype = _sweep_planes(ptype, i_nex, direct, rng, cfg, N)
    ftype, intersect = _edge_jump_pass(pts, rng, dista, ftype, cfg)
    ftype = _smallp_pass(rng, dista, ftype, intersect, cfg)
    surf, corn = _collect(pts, rng, ftype, cfg)
    return surf, corn, ftype


def split_rings_velodyne(pts: np.ndarray, n_scans: int = 16,
                         fov_low_deg: float = -15.0,
                         ring_step_deg: float = 2.0):
    """Assign spinning-lidar points to rings by elevation
    (velo16 handler, livox_feature.cpp:335-355)."""
    rng = np.hypot(pts[:, 0], pts[:, 1])
    ang = np.rad2deg(np.arctan2(pts[:, 2], rng))
    ring = ((ang - fov_low_deg) / ring_step_deg + 0.5).astype(int)
    return [pts[ring == k] for k in range(n_scans)]


def extract(pts: np.ndarray, cfg: LivoxConfig = LivoxConfig(),
            n_scans: int = 1):
    """Extract features from a full scan.  For solid-state ('mid',
    'horizon') the cloud is one ordered line (n_scans=1); for spinning
    types pass n_scans to split rings by elevation first."""
    if n_scans <= 1:
        surf, corn, _ = extract_scanline(pts, cfg)
        return surf, corn
    surfs, corns = [], []
    for ring in split_rings_velodyne(pts, n_scans):
        s, c, _ = extract_scanline(ring, cfg)
        surfs.append(s)
        corns.append(c)
    return np.concatenate(surfs), np.concatenate(corns)
