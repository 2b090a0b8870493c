"""Place recognition and loop-closure edges for large-scale BA.

Counterpart: balm_tpu/pipelines/loopclose.py — LoopConfig (:63),
scan_context (:155), descriptors (:184), ring_keys (:200), sc_distance
(:207), shift_to_yaw (:237), _local_map (:253), _register (:267),
_yaw_mat (:298), _pcm_filter (:303), detect (:378), chain_edges (:496),
_sparse_newton_step (:514), pose_graph_optimize (:559) and close_loops
(:651).  The reference repo has no loop closure (its README points at
HBA / Voxel-SLAM); once cumulative drift exceeds the voxel size, voxel
association alone never forms the revisit constraints.  The pipeline:

  1. descriptors — rotation-invariant polar "scan context" images
     (n_rings x n_sectors, occupancy + max height), one (N, Nr, Ns)
     array for the whole trajectory;
  2. retrieval — ring keys (per-ring sector means) compared with one
     matmul, with temporal-separation and position-prior gates;
  3. scoring — the column-cosine scan-context distance, minimized over
     all sector shifts from one batched product of column dots;
  4. verification — the odometry front end's IRLS point-to-plane GN
     (pipelines/odometry.register_scan) of the query scan against a
     local plane map around the candidate, then the drift bound and the
     pairwise-consistency (PCM) filter;
  5. output — ops.pose_graph.RelPoseEdges between scan indices, weighted
     in the plane cost's units (w_tr ~ K/3, w_rot ~ K r^2/3 for K inlier
     points with mean-square lever arm r^2).

Where it runs: descriptors, retrieval, scoring, PCM and the edges'
assembly are host numpy (the descriptors float32, as in JAX, the rest
float64); the verification GN runs on `device` (default 'cuda'; 'cpu'
for the plain path) in float64.  The edges are RelPoseEdges on the CPU
in float64 (ops/pose_graph.edges_from_numpy).  The pose-graph stage
(chain_edges, pose_graph_optimize, close_loops' solve) runs on the host
in float64 whatever the device, as balm_tpu/api.py:56-79 pins it to CPU
f64: a one-time trajectory correction, not the BA hot loop; the
per-edge derivatives are ops/pose_graph's (torch.func) on CPU float64
tensors, the sparse solve scipy's splu.

The flow for large maps is the classic SLAM decomposition (detect ->
pose-graph optimize -> BA): close_loops warps the trajectory with the
odometry chain and the loop edges only, so the follow-up BA
re-associates from poses already inside the correct basin.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import numpy as np
import torch

from ..ops import lie
from ..ops import pose_graph as PG
from ..voxel import grid
from . import odometry as odo


@dataclasses.dataclass
class LoopConfig:
    # descriptor
    n_rings: int = 12
    n_sectors: int = 60
    r_max: float = 0.0          # 0 -> auto (95th pct point radius)
    # retrieval
    min_separation: int = 40    # min |i - j| in scans
    query_every: int = 4        # query every k-th scan
    max_dist: float = 8.0       # position-prior gate on CURRENT estimate
    topk: int = 2               # ring-key candidates scored per query
    sc_accept: float = 0.30     # max scan-context distance to verify
    min_valid_cols: int = 12    # min co-occupied sectors for a score
    # geometric verification
    nbr_half: int = 2           # local map = scans [j-h .. j+h]
    reg_voxel: float = 1.0
    reg_downsample: float = 0.25
    min_matches: int = 80       # associated points (post-downsample)
    inlier_res: float = 0.1     # [m] point-to-plane inlier bound
    min_inlier_frac: float = 0.6
    max_med_res: float = 0.06   # [m] median inlier residual
    # drift bound: a loop edge CORRECTS accumulated drift, so its
    # measured relative pose cannot legitimately differ from the current
    # estimate by more than the worst plausible drift.  Bounding the
    # correction kills the symmetric-scene failure mode (a straight
    # street verifies perfectly under a 180 deg flip — low residual,
    # high inliers; the flip is only identifiable as "not a drift").
    max_correction_rot: float = 0.6    # [rad] ~34 deg
    max_correction_trans: float = 0.0  # [m]; 0 -> use max_dist
    # output.  The nominal per-edge information is K/3 (K inlier points,
    # unit point weight — the same units as the plane cost).  The default
    # over-weighting compensates for what the quadratic model cannot
    # represent: plane factors formed from DRIFTED association are
    # biased, not noisy, so at the information weight the (correct,
    # verified) loop edges lose the tug-of-war against them.  Verified
    # edges are ~25 mm accurate and near-zero-residual at the true poses,
    # so over-weighting is benign (square-scene study: w=1 leaves 0.39 m
    # of the recoverable drift, w=10 reaches 0.014 m vs the 0.007 m
    # from-gt floor; tests/test_loopclose.py).
    edge_weight: float = 10.0   # scale on the K/3 information weights
    max_edges_per_query: int = 1
    # pose-graph stage (pose_graph_optimize / close_loops): odometry
    # chain measurement noise per step — sets how the loop corrections
    # distribute along the trajectory (stiff chain = local kinks, soft
    # chain = smooth warp)
    chain_sigma_rot: float = 0.002   # [rad/step]
    chain_sigma_trans: float = 0.01  # [m/step]
    # PGO edge treatment: loop edges keep their (x edge_weight) strength
    # — against a stiff odometry chain, information-weight edges lose the
    # tug-of-war and the loops never close (square study: t_ba regresses
    # 0.014 -> 0.127 m at scale 0.1) — but get a Huber kernel sized to
    # the verification accuracy, because the edge-error TAIL (city study:
    # median 0.14 deg/12 mm but max 2.0 deg/0.12 m) otherwise kinks the
    # chain at full weight (artifacts/loopclose_city.json ablation).
    # Edges inside the Huber point behave exactly as before.
    pgo_edge_scale: float = 1.0      # scale on detect()'s edge weights
    pgo_robust_rot: float = 0.02     # [rad] Huber point, rotation part
    pgo_robust_trans: float = 0.05   # [m] Huber point, translation part
    # pairwise consistency (PCM-style): two edges whose endpoints are
    # within pcm_span scans of each other must agree through the current
    # estimate's short-span relative motion.  Self-similar scenes (a
    # corridor with a repeating patch lattice) admit TRANSLATED
    # registrations that pass every per-edge residual gate; mutual
    # consistency is the only signal that identifies them.  Edges are
    # dropped max-conflicts-first until the comparable set is
    # conflict-free (majority voting — robust as long as correct edges
    # outnumber lattice aliases among comparable groups).
    pcm_span: int = 24          # scans; max endpoint distance to compare
    pcm_rot: float = 0.05       # [rad] consistency tolerance
    pcm_trans: float = 0.15     # [m] base tolerance (2x meas error)
    # the comparison rides the estimate's relative motion over the
    # endpoint spans, which accumulates drift — widen the tolerance
    # accordingly (random-walk drift per scan of the front-end)
    pcm_trans_per_scan: float = 0.02  # [m/scan of endpoint span]
    # positive support requirement.  Conflict elimination alone cannot
    # catch COHERENT aliases: on a self-similar street, neighboring
    # query/candidate pairs can all register slid by the same lattice
    # offset and mutually agree.  True revisits are corroborated by
    # bursts of independent nearby edges AND verify with many inliers;
    # aliases are thin (city-grid study: the rule below kept 58/76 true
    # edges and 0/21 aliases — scripts/loopclose_city_demo.py).  An edge
    # survives if it has >= 2 agreeing comparable partners, or >= 1
    # agreeing partner and support_min_inliers, or — when it has no
    # comparable partner at all — solo_min_inliers.
    require_support: bool = True
    support_min_inliers: int = 150
    solo_min_inliers: int = 300


# ---------------------------------------------------------------------------
# descriptors


def scan_context(pts: np.ndarray, n_rings: int, n_sectors: int,
                 r_max: float, z_lo: float, z_hi: float) -> np.ndarray:
    """Polar occupancy+height image of one body-frame scan.

    Bin value: 0 if empty, else 0.25 + 0.75 * normalized max height —
    the 0.25 floor makes pure occupancy count even where the scene has
    no height variation (the cosine metric then degrades gracefully to
    occupancy-pattern matching).
    """
    out = np.zeros((n_rings, n_sectors), np.float32)
    if len(pts) == 0:
        return out
    r = np.hypot(pts[:, 0], pts[:, 1])
    keep = (r > 1e-3) & (r < r_max)
    if not keep.any():
        return out
    r = r[keep]
    th = np.arctan2(pts[keep, 1], pts[keep, 0])
    z = pts[keep, 2]
    ring = np.minimum((r / r_max * n_rings).astype(np.int64), n_rings - 1)
    sec = ((th + np.pi) / (2 * np.pi) * n_sectors).astype(np.int64) % n_sectors
    zmax = np.full((n_rings, n_sectors), -np.inf, np.float64)
    np.maximum.at(zmax, (ring, sec), z)
    occ = np.isfinite(zmax)
    h = np.clip((zmax[occ] - z_lo) / max(z_hi - z_lo, 1e-6), 0.0, 1.0)
    out[occ] = 0.25 + 0.75 * h.astype(np.float32)
    return out


def descriptors(scans: Sequence[np.ndarray], cfg: LoopConfig):
    """(N, Nr, Ns) scan-context stack + the resolved r_max."""
    r_max = cfg.r_max
    samp = [s for s in scans[:: max(len(scans) // 64, 1)] if len(s)]
    if r_max <= 0:
        rr = np.concatenate([np.hypot(s[:, 0], s[:, 1]) for s in samp])
        r_max = float(np.percentile(rr, 95))
    zz = np.concatenate([s[:, 2] for s in samp]) if samp else np.zeros(1)
    z_lo, z_hi = float(np.percentile(zz, 5)), float(np.percentile(zz, 95))
    desc = np.stack([
        scan_context(s, cfg.n_rings, cfg.n_sectors, r_max, z_lo, z_hi)
        for s in scans
    ])
    return desc, r_max


def ring_keys(desc: np.ndarray) -> np.ndarray:
    """(N, Nr) rotation-invariant keys (sector means), L2-normalized."""
    k = desc.mean(axis=2)
    n = np.linalg.norm(k, axis=1, keepdims=True)
    return k / np.maximum(n, 1e-12)



def sc_distance(descA: np.ndarray, descB: np.ndarray, min_valid_cols: int):
    """Batched scan-context distance over all sector shifts, host numpy
    in the descriptors' float32 (JAX takes it on its default device).
    On the host, detection on the card and on the CPU scores every pair
    with the same bits, and these distances decide which pairs are
    verified (sc_accept) and in what order.

    descA/descB: (P, Nr, Ns) paired descriptors.  Returns
    (dist (P,), shift (P,) int): dist = 1 - best mean column cosine over
    shifts (columns where either side is empty are excluded; a pair with
    fewer than min_valid_cols co-occupied sectors at its best shift
    scores 2.0 = reject).  The column-dot matrices for all pairs are one
    einsum -> (P, Ns, Ns); per-shift scores are its wrapped diagonals.
    """
    A = np.asarray(descA)
    B = np.asarray(descB)
    P, _, Ns = A.shape
    M = np.einsum("prs,prt->pst", A, B)
    na = np.sqrt(np.einsum("prs,prs->ps", A, A))
    nb = np.sqrt(np.einsum("prt,prt->pt", B, B))
    Mn = M / (na[:, :, None] * nb[:, None, :] + 1e-12)
    valid = ((na[:, :, None] > 0) & (nb[:, None, :] > 0)).astype(Mn.dtype)
    s = np.arange(Ns)
    col = (s[None, :] + s[:, None]) % Ns            # (shift, s) -> column
    G = Mn[:, s[None, :], col]                      # (P, shift, s)
    V = valid[:, s[None, :], col]
    cnt = V.sum(-1)
    score = (G * V).sum(-1) / np.maximum(cnt, 1.0)
    score = np.where(cnt >= min_valid_cols, score, -1.0).astype(Mn.dtype)
    best = np.argmax(score, axis=1)
    dist = 1.0 - np.take_along_axis(score, best[:, None], 1)[:, 0]
    return dist, best.astype(np.int64)


def shift_to_yaw(shift: int, n_sectors: int) -> float:
    """Yaw implied by the best sector shift of sc_distance(A, B).

    Convention (pinned by tests/test_loopclose.py): if body B is body A
    rotated by psi about z (R_B = R_A Rz(psi)), the best shift satisfies
    shift_to_yaw(shift) = -psi — which is exactly the yaw of the
    registration init R_B^T R_A (pose of A expressed in B's frame).
    """
    ang = 2 * np.pi * shift / n_sectors
    return float((ang + np.pi) % (2 * np.pi) - np.pi)


# ---------------------------------------------------------------------------
# geometric verification


def _local_map(scans, R, p, j, cfg: LoopConfig):
    """Plane map of scans [j-h .. j+h] in scan j's (estimated) frame.
    Intra-neighborhood drift over +-h scans is far below the voxel size,
    so the map frame is 'scan j per the current estimate'."""
    vmap = odo.VoxelPlaneMap(cfg.reg_voxel, ratio=1.0 / 9.0, min_points=20)
    lo = max(j - cfg.nbr_half, 0)
    hi = min(j + cfg.nbr_half, len(scans) - 1)
    for k in range(lo, hi + 1):
        Rjk = R[j].T @ R[k]
        pjk = R[j].T @ (p[k] - p[j])
        vmap.insert(scans[k] @ Rjk.T + pjk)
    return vmap


def _register(pts_ds, R0, p0, vmap, cfg: LoopConfig, device="cuda"):
    """IRLS point-to-plane GN into the local map, the GN on `device`;
    -> (R, p, stats)."""
    ocfg = odo.OdometryConfig(
        voxel_size=cfg.reg_voxel, use_lines=False, downsample=0.0,
        reg_iters=6, reg_reassociate=3, huber=cfg.inlier_res,
    )
    Rr, pr, n_used = odo.register_scan(pts_ds, R0, p0, vmap, ocfg,
                                       device=device)
    # residual audit at the converged pose (register_scan returns only
    # the match count)
    _, cents, norms = vmap.plane_table()
    world = pts_ds @ Rr.T + pr
    rows = vmap.lookup(world)
    sel = rows >= 0
    n_match = int(sel.sum())
    if n_match < cfg.min_matches or n_used == 0:
        return Rr, pr, None
    res = np.abs(np.sum((world[sel] - cents[rows[sel]]) * norms[rows[sel]],
                        axis=1))
    inl = res < cfg.inlier_res
    if not inl.any():
        return Rr, pr, None
    stats = {
        "n_match": n_match,
        "n_inlier": int(inl.sum()),
        "inlier_frac": float(inl.mean()),
        "med_res": float(np.median(res[inl])),
        "lever_sq": float(np.mean(np.sum(pts_ds[sel][inl] ** 2, axis=1))),
    }
    return Rr, pr, stats


def _yaw_mat(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _pcm_filter(cand, R, p, cfg: LoopConfig):
    """Drop mutually-inconsistent edges (majority voting).

    cand: list of dicts with keys a, b, Zr, Zp (edge a->b measuring
    T_a^-1 T_b).  Two edges k, l with |a_k-a_l| + |b_k-b_l| <= pcm_span
    are comparable; the prediction of edge l from edge k through the
    current estimate's short-span increments is

        Z_l ~ (T_al^-1 T_ak)_est  Z_k  (T_bk^-1 T_bl)_est

    (short spans accumulate negligible drift).  Conflicting pairs are
    resolved by iteratively dropping the edge with the most conflicts.
    Returns (kept indices, n_dropped).
    """
    n = len(cand)
    if n <= 1:
        return list(range(n)), 0

    def rel(i, j):
        """(R, p) of T_i^-1 T_j per the current estimate."""
        return R[i].T @ R[j], R[i].T @ (p[j] - p[i])

    conflicts = [set() for _ in range(n)]
    compat = [set() for _ in range(n)]
    for k in range(n):
        ak, bk = cand[k]["a"], cand[k]["b"]
        for l in range(k + 1, n):
            al, bl = cand[l]["a"], cand[l]["b"]
            span = abs(ak - al) + abs(bk - bl)
            if span > cfg.pcm_span:
                continue
            Raa, paa = rel(al, ak)
            Rbb, pbb = rel(bk, bl)
            # predicted Z_l
            Rp_ = Raa @ cand[k]["Zr"] @ Rbb
            pp_ = Raa @ (cand[k]["Zr"] @ pbb + cand[k]["Zp"]) + paa
            dR = Rp_.T @ cand[l]["Zr"]
            ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0))
            dt = np.linalg.norm(pp_ - cand[l]["Zp"])
            if ang > cfg.pcm_rot or \
                    dt > cfg.pcm_trans + cfg.pcm_trans_per_scan * span:
                conflicts[k].add(l)
                conflicts[l].add(k)
            else:
                compat[k].add(l)
                compat[l].add(k)
    alive = set(range(n))
    while True:
        # drop max-conflicts first; ties resolved by verification
        # quality (worse median residual goes first)
        worst = max(alive, key=lambda k: (len(conflicts[k] & alive),
                                          cand[k]["meta"]["med_res"]))
        if not (conflicts[worst] & alive):
            break
        alive.remove(worst)
    if cfg.require_support:
        # positive-support pass (see LoopConfig.require_support); agree
        # counts are taken among the conflict-free survivors
        kept = set()
        for k in alive:
            agree = len(compat[k] & alive)
            comparable = len((compat[k] | conflicts[k]) & alive)
            nin = cand[k]["meta"]["n_inlier"]
            if agree >= 2 or (agree >= 1
                              and nin >= cfg.support_min_inliers) or \
                    (comparable == 0 and nin >= cfg.solo_min_inliers):
                kept.add(k)
        alive = kept
    return sorted(alive), n - len(alive)


# ---------------------------------------------------------------------------
# the detector


def detect(scans: Sequence[np.ndarray], R: np.ndarray, p: np.ndarray,
           cfg: LoopConfig = LoopConfig(), *, verbose: bool = False,
           device="cuda"):
    """Find loop-closure edges over a trajectory estimate.

    scans: body-frame clouds; R (W,3,3), p (W,3): the current pose
    estimate (drifted odometry is fine — it is used only for the
    position-prior gate and the registration init).  The verification
    GN runs on `device`.  Returns (RelPoseEdges on the CPU in float64,
    or None; info dict).  Edge (i=j_scan, j=i_scan) measures the pose of
    the query scan in the candidate's frame: Zr = R_j^T R_i, Zp = R_j^T
    (p_i - p_j) per the RelPoseEdges convention.  info["seconds"]
    holds the host-clock seconds of each stage: descriptors, retrieval,
    scoring, local_maps and registration (the verification), pcm.
    """
    device = odo._device(device, "loopclose.detect")
    W = len(scans)
    R = np.asarray(R, np.float64)
    p = np.asarray(p, np.float64)
    t0 = time.perf_counter()
    secs = dict.fromkeys(("descriptors", "retrieval", "scoring",
                          "local_maps", "registration", "pcm"), 0.0)

    def lap(stage):
        nonlocal t0
        t1 = time.perf_counter()
        secs[stage] += t1 - t0
        t0 = t1

    desc, r_max = descriptors(scans, cfg)
    keys = ring_keys(desc)
    lap("descriptors")
    info = {"r_max": r_max, "n_queries": 0, "n_scored": 0, "n_verified": 0,
            "pairs": [], "seconds": secs}

    # retrieval: ring-key similarity (one matmul), gated
    pairs: List[tuple] = []
    sim_all = keys @ keys.T                           # (W, W)
    for i in range(cfg.min_separation, W, cfg.query_every):
        js = np.arange(0, i - cfg.min_separation + 1)
        js = js[np.linalg.norm(p[js, :2] - p[i, :2], axis=1) < cfg.max_dist]
        if len(js) == 0:
            continue
        info["n_queries"] += 1
        order = np.argsort(-sim_all[i, js])[: cfg.topk]
        for j in js[order]:
            pairs.append((i, int(j)))
    lap("retrieval")
    if not pairs:
        return None, info

    ii = np.array([a for a, _ in pairs])
    jj = np.array([b for _, b in pairs])
    dist, shift = sc_distance(desc[ii], desc[jj], cfg.min_valid_cols)
    info["n_scored"] = len(pairs)
    lap("scoring")

    # verification, best candidates first, at most max_edges_per_query
    accepted: List[dict] = []
    taken: dict = {}
    for k in np.argsort(dist):
        if dist[k] > cfg.sc_accept:
            break
        qi, cj = int(ii[k]), int(jj[k])
        if taken.get(qi, 0) >= cfg.max_edges_per_query:
            continue
        lap("registration")
        vmap = _local_map(scans, R, p, cj, cfg)
        lap("local_maps")
        pts = scans[qi]
        if cfg.reg_downsample > 0:
            pts = grid.down_sample_voxel(pts, cfg.reg_downsample)
        # init: current relative estimate (drift-bounded by the gate)
        R0 = R[cj].T @ R[qi]
        p0 = R[cj].T @ (p[qi] - p[cj])
        Rr, pr, stats = _register(pts, R0, p0, vmap, cfg, device)
        if stats is None or stats["inlier_frac"] < cfg.min_inlier_frac \
                or stats["med_res"] > cfg.max_med_res:
            # fallback init: replace the estimate rotation by the
            # descriptor yaw (sc_distance(A=query, B=cand) shift gives
            # the yaw of R_cand^T R_query directly; roll/pitch ~ 0),
            # estimate translation kept — covers the case where the
            # estimate's relative yaw is outside the GN basin
            yaw = shift_to_yaw(int(shift[k]), cfg.n_sectors)
            Rr2, pr2, stats2 = _register(pts, _yaw_mat(yaw), p0, vmap,
                                         cfg, device)
            if stats2 is not None and stats2["inlier_frac"] >= \
                    cfg.min_inlier_frac and stats2["med_res"] <= \
                    cfg.max_med_res:
                Rr, pr, stats = Rr2, pr2, stats2
            else:
                continue
        # drift-bound gate (see LoopConfig.max_correction_rot)
        cosang = np.clip((np.trace(R0.T @ Rr) - 1.0) / 2.0, -1.0, 1.0)
        max_tr = cfg.max_correction_trans or cfg.max_dist
        if np.arccos(cosang) > cfg.max_correction_rot or \
                np.linalg.norm(pr - p0) > max_tr:
            info["n_drift_rejected"] = info.get("n_drift_rejected", 0) + 1
            continue
        info["n_verified"] += 1
        taken[qi] = taken.get(qi, 0) + 1
        K = stats["n_inlier"]
        accepted.append({
            "a": cj, "b": qi, "Zr": Rr, "Zp": pr,
            "w_tr": cfg.edge_weight * K / 3.0,
            "w_rot": cfg.edge_weight * K * stats["lever_sq"] / 3.0,
            "meta": {"query": qi, "cand": cj, "sc_dist": float(dist[k]),
                     **stats},
        })
        if verbose:
            print(f"loop {qi}<->{cj} sc={dist[k]:.3f} "
                  f"inl={stats['inlier_frac']:.2f} "
                  f"med={stats['med_res']*1e3:.1f}mm", flush=True)

    lap("registration")
    if not accepted:
        return None, info
    keep, n_drop = _pcm_filter(accepted, R, p, cfg)
    info["n_pcm_rejected"] = n_drop
    lap("pcm")
    if not keep:
        return None, info
    accepted = [accepted[k] for k in keep]
    info["pairs"] = [e["meta"] for e in accepted]
    out = PG.edges_from_numpy(
        (np.array([e["a"] for e in accepted]),
         np.array([e["b"] for e in accepted]),
         np.stack([e["Zr"] for e in accepted]),
         np.stack([e["Zp"] for e in accepted]),
         np.array([e["w_rot"] for e in accepted]),
         np.array([e["w_tr"] for e in accepted])))
    return out, info


# ---------------------------------------------------------------------------
# pose-graph stage


def _f64(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def chain_edges(R, p, sigma_rot: float, sigma_trans: float):
    """Consecutive-pose odometry edges measured from the CURRENT
    trajectory (the relative motions are what the front-end observed;
    only their composition drifted).  RelPoseEdges on the CPU, float64."""
    R = np.asarray(R, np.float64)
    p = np.asarray(p, np.float64)
    W = len(R)
    Zr = np.einsum("wba,wbc->wac", R[:-1], R[1:])
    Zp = np.einsum("wba,wb->wa", R[:-1], p[1:] - p[:-1])
    return PG.edges_from_numpy(
        (np.arange(W - 1), np.arange(1, W), Zr, Zp,
         np.full(W - 1, 1.0 / sigma_rot ** 2),
         np.full(W - 1, 1.0 / sigma_trans ** 2)))


def _sparse_newton_step(ei, ej, g, h, W, u):
    """One damped-Newton direction from per-edge blocks, never
    materializing (6W)^2: H is block-tridiagonal plus a few off-band 6x6
    blocks (the loop edges), a sparse system for splu.  Damping uses
    D = diag(max(diag(H), 0)) + 1e-12: the Hessian of the Huber cost can
    have negative diagonal entries past the Huber point, and scaling
    those negatively would leave H + uD indefinite at every u.

    ei, ej (E,) int, g (E, 12), h (E, 12, 12) numpy float64.
    Returns (J (6W,), dx (6W,), Ddiag (6W,))."""
    from scipy import sparse
    from scipy.sparse.linalg import splu

    J = np.zeros((W, 6))
    np.add.at(J, ei, g[:, :6])
    np.add.at(J, ej, g[:, 6:])
    J = J.reshape(6 * W)

    diag_blocks = np.zeros((W, 6, 6))
    np.add.at(diag_blocks, ei, h[:, :6, :6])
    np.add.at(diag_blocks, ej, h[:, 6:, 6:])
    Ddiag = np.maximum(diag_blocks[:, np.arange(6), np.arange(6)], 0.0
                       ).reshape(6 * W) + 1e-12

    damped = diag_blocks.copy()
    damped[:, np.arange(6), np.arange(6)] += u * Ddiag.reshape(W, 6)
    rows = np.concatenate([np.arange(W), ei, ej])
    cols = np.concatenate([np.arange(W), ej, ei])
    blocks = np.concatenate([damped, h[:, :6, 6:], h[:, 6:, :6]])
    r6 = np.arange(6)
    bi = (rows[:, None, None] * 6 + r6[None, :, None]
          + np.zeros((1, 1, 6), np.int64)).reshape(-1)
    bj = (cols[:, None, None] * 6 + r6[None, None, :]
          + np.zeros((1, 6, 1), np.int64)).reshape(-1)
    A = sparse.coo_matrix((blocks.reshape(-1), (bi, bj)),
                          shape=(6 * W, 6 * W)).tocsc()
    dx = splu(A).solve(-J)
    return J, dx, Ddiag


def pose_graph_optimize(R, p, edges: PG.RelPoseEdges, *,
                        delta=None, max_iters: int = 15, u0: float = 1e-6,
                        rel_tol: float = 1e-9, solver: str = "sparse"):
    """Damped-Newton solve of the pure pose graph, host-stepped in
    float64 on the CPU.

    The left-perturbation chart and damping schedule of solver/lm.py.
    Gauge: re-anchored to pose 0's input value.  delta: optional (E,)
    per-edge Huber thresholds (chi^2 units).  solver: 'sparse' (splu of
    the per-edge 12x12 blocks, the default) or 'dense' (the (6W)^2 LU,
    kept as the equality oracle).  R (W, 3, 3), p (W, 3) numpy or
    tensors; edges on any device.  Returns (R, p, info), R and p float64
    numpy."""
    if solver not in ("sparse", "dense"):
        raise ValueError(f"unknown solver {solver!r}")
    R0_in = np.asarray(R, np.float64)[0].copy()
    p0_in = np.asarray(p, np.float64)[0].copy()
    R = _f64(R)
    p = _f64(p)
    W = R.shape[0]
    edges = PG.RelPoseEdges(
        i=edges.i.cpu().long(), j=edges.j.cpu().long(),
        **{k: getattr(edges, k).detach().cpu().double()
           for k in ("Zr", "Zp", "w_rot", "w_tr")})
    if delta is not None:
        delta = torch.as_tensor(delta).detach().cpu().double()
    sparse_path = solver == "sparse"
    ei = edges.i.numpy()
    ej = edges.j.numpy()

    def blocks(R_, p_):
        r, g, h = PG.evaluate_relpose_blocks(R_, p_, edges, delta)
        return float(r), g.numpy(), h.numpy()

    def dense(R_, p_):
        r, J, H = PG.evaluate_relpose(R_, p_, edges, delta)
        return float(r), J, H

    u, v = u0, 2.0
    if sparse_path:
        res1, g, h = blocks(R, p)
    else:
        res1, J, H = dense(R, p)
    info = {"initial_cost": res1, "iters": 0, "accepted": 0}
    calc = False
    for _ in range(max_iters):
        if calc:
            if sparse_path:
                res1, g, h = blocks(R, p)
            else:
                res1, J, H = dense(R, p)
        if sparse_path:
            Jn, dxn, Ddiag = _sparse_newton_step(ei, ej, g, h, int(W), u)
            dx = torch.from_numpy(dxn)
            uDdx_mJ = torch.from_numpy(u * (Ddiag * dxn) - Jn)
        else:
            Ddiag = torch.clamp(torch.diagonal(H), min=0.0) + 1e-12
            dx = torch.linalg.solve(H + u * torch.diag(Ddiag), -J)
            uDdx_mJ = u * (Ddiag * dx) - J
        Rn, pn = lie.se3_left_update(R, p, dx.reshape(W, 6))
        res2 = float(PG.relpose_cost(Rn, pn, edges, delta))
        q1 = float(0.5 * torch.dot(dx, uDdx_mJ))
        rho = (res1 - res2) / q1 if q1 != 0 else -1.0
        info["iters"] += 1
        if np.isfinite(res2) and res2 < res1:
            R, p = Rn, pn
            u *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            v = 2.0
            stop = abs(res1 - res2) < rel_tol * max(res1, 1e-30)
            res1 = res2
            calc = True
            info["accepted"] += 1
            if stop:
                break
        else:
            u *= v
            v *= 2.0
            calc = False
            if u > 1e12:
                break
    # gauge: the graph cost is invariant to a global rigid motion (the
    # damped solve merely keeps the null-space step small) — re-anchor
    # pose 0 to its input value (bavoxel.hpp:1159-1164)
    Rs = R.numpy()
    ps = p.numpy()
    G = R0_in @ Rs[0].T
    gt = p0_in - G @ ps[0]
    Rs = np.einsum("ab,nbc->nac", G, Rs)
    ps = np.einsum("ab,nb->na", G, ps) + gt
    info["final_cost"] = res1
    return Rs, ps, info


def close_loops(scans, R, p, cfg: LoopConfig = LoopConfig(), *,
                verbose: bool = False, edges=None, detect_info=None,
                device="cuda"):
    """Detect loops and return the pose-graph-corrected trajectory.

    The classic SLAM decomposition: loop edges + the odometry chain are
    solved alone first (no plane factors), so the loop corrections warp
    the trajectory smoothly instead of fighting drift-locked plane
    association; BA then runs from poses already inside the correct
    association basin.  Detection's GN runs on `device`, the pose-graph
    solve on the host in float64.  Returns (R, p, edges, info); when no
    loop survives verification the input poses are returned unchanged.

    edges/detect_info: precomputed `detect(...)` results — pass them when
    the caller already ran detection, so it does not run twice.
    """
    if edges is None and detect_info is None:
        edges, info = detect(scans, R, p, cfg, verbose=verbose,
                             device=device)
    else:
        info = dict(detect_info or {})
    if edges is None:
        return np.asarray(R), np.asarray(p), None, info
    chain = chain_edges(R, p, cfg.chain_sigma_rot, cfg.chain_sigma_trans)
    scale = cfg.pgo_edge_scale
    loop_pg = PG.RelPoseEdges(*[x.cpu() for x in edges])
    loop_pg = loop_pg._replace(w_rot=loop_pg.w_rot.double() * scale,
                               w_tr=loop_pg.w_tr.double() * scale)
    # Huber point at the verification-accuracy chi^2 of each edge (the
    # weights carry the inlier count, so this adapts per edge)
    delta = torch.cat([
        torch.full((chain.i.shape[0],), 1e30, dtype=torch.float64),
        loop_pg.w_rot * cfg.pgo_robust_rot ** 2
        + loop_pg.w_tr * cfg.pgo_robust_trans ** 2,
    ])
    R1, p1, pinfo = pose_graph_optimize(
        R, p, PG.concat_edges(chain, loop_pg), delta=delta)
    info["pgo"] = pinfo
    return R1, p1, edges, info
