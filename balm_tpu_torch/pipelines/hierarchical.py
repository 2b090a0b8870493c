"""Hierarchical (HBA / Voxel-SLAM style) global bundle adjustment.

Counterpart: balm_tpu/pipelines/hierarchical.py — HierarchicalConfig
(:40), _solve_window (:163), solve_blocks_batched (:186),
refeature_super_scan (:227), _edges_in_block (:244), run (:267) with its
anchor pose-graph stage (:426-498), run_device_batched (:618),
consensus_scan_edges (:832) and run_batched_consensus (:947).  The
reference caps its window at W = 177 poses with one dense (6W)^2 solve
(bavoxel.hpp:1104-1157); this is the large-W design:

  1. BOTTOM: partition the trajectory into overlapping keyframe blocks;
     each block is a small BA (voxelize + damped Newton in the
     block-anchor frame)
  2. TOP: freeze the refined intra-block geometry, merge each block's
     scans into one "super-scan" in its anchor frame, and run BA over the
     anchor poses only, with overlap-consensus edges between consecutive
     anchors (ops/pose_graph.consensus_edge)
  3. COMPOSE: scan pose = refined anchor o refined intra-block relative
     pose; optional global sweeps, a cycle guard and a flat polish

run is host driven: association, composition and the edges are float64
numpy on the host; every solve is the port's float64 damping_iter
(backend 'xla', ops/factors.py's evaluators) on `device` (default
'cuda'; 'cpu' for the plain path), the global sweep past 512 scans
solver/large.damping_iter_large.  Its bottom level solves its blocks one
after another, also under batched_bottom (solve_blocks_batched is a
loop; the JAX package vmaps its while-loop).  Lifted loop edges past
anchor_pgo_gate voxels go through the anchor pose-graph stage
(pipelines/loopclose.pose_graph_optimize, host float64) first.

run_device_batched is the device-batched form: every level one batched
program on the card (voxel/device.voxelize_core_batched,
solver/lm.damping_iter_batched with the batched B1/B2 launches, the f32
'xla' anchor solve); run_batched_consensus couples its blocks through
consensus_scan_edges and a chunked banded polish (solver/large.py).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import SolverConfig, VoxelConfig
from ..ops import factors as Fmod
from ..ops import factors_windowed as FW
from ..ops import lie
from ..ops import pose_graph as PG
from ..solver import large, lm
from ..voxel import grid
from . import loopclose

@dataclasses.dataclass
class HierarchicalConfig:
    block: int = 10              # keyframes per block
    stride: int = 8              # block start spacing (block - stride overlap)
    voxel: VoxelConfig = VoxelConfig(min_observers=2)
    top_voxel: VoxelConfig = VoxelConfig(min_observers=2)
    solver: SolverConfig = SolverConfig(
        max_iters=10, u_init=0.01, min_planes_per_pose=1
    )
    top_solver: SolverConfig = SolverConfig(
        max_iters=30, u_init=0.01, min_planes_per_pose=1
    )
    # final flat refinement over all poses (skip for very large W)
    polish: bool = True
    polish_solver: SolverConfig = SolverConfig(
        max_iters=5, u_init=0.01, min_planes_per_pose=1
    )
    # downsample super-scans before the top-level association
    super_downsample: float = 0.0
    # solve the bottom blocks through solve_blocks_batched (equal-size
    # blocks, no scan edges); the same result as the per-block loop
    batched_bottom: bool = False
    # repeat (bottom blocks -> anchor solve -> compose) this many times,
    # re-associating at the refined poses each cycle
    cycles: int = 3
    # overlap-consensus relative-pose edges between consecutive anchors,
    # weight edge_weight * sigma_pt^2 / max(spread, edge_spread_floor)^2:
    # sigma_pt^2 (the median per-point plane variance of the bottom
    # solves) puts the edge in the plane cost's units, spread is the
    # shared scans' consensus disagreement
    use_overlap_edges: bool = True
    edge_weight: float = 1.0
    edge_spread_floor: float = 1e-3
    # recurse the top level when more than this many anchors remain
    recurse_at: int = 512
    # super-scan feature re-extraction before the next level: keep only
    # the points in admitted planar leaves of each super-scan voxelized
    # solo; 'recursive' applies it when this run recurses, 'always' |
    # 'off' force it
    refeature_supers: str = "recursive"
    refeature_voxel: VoxelConfig = VoxelConfig(min_observers=1)
    # coarse-to-fine top level: one anchor solve per stage, re-associating
    # the super-scans at the refined anchors between stages
    top_stages: Sequence[VoxelConfig] | None = None
    # LM iterations of a global solve over all scans after each cycle's
    # compose (0 = off); past 512 scans ('auto') or with 'large', the
    # span-compressed solve (solver/large.py)
    global_sweep: int = 0
    global_sweep_cg: int = 100
    global_sweep_solver: str = "auto"
    # accept a cycle only if the re-associated full-problem cost fell
    cycle_guard: bool = True
    # anchor-level pose-graph stage: when a lifted loop edge's
    # correction exceeds anchor_pgo_gate voxels, solve the pure anchor
    # pose graph (consensus chain + lifted loops, Huber on the loops,
    # pipelines/loopclose.pose_graph_optimize) before the top plane
    # solve, which then starts from its anchors; anchor_pgo_only keeps
    # the lifted edges out of that plane solve
    anchor_pgo: bool = True
    anchor_pgo_only: bool = True
    anchor_pgo_gate: float = 0.5   # [voxels]
    anchor_pgo_sigma_rot: float = 0.002   # [rad/step]
    anchor_pgo_sigma_trans: float = 0.01  # [m/step]
    anchor_pgo_robust_rot: float = 0.02   # [rad]
    anchor_pgo_robust_trans: float = 0.05  # [m]


def _t64(a, device):
    return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float64,
                           device=device)


def _solve_window(scans, R, p, vcfg, scfg, edges=None, device="cuda"):
    """-> (R, p, num_planes, sigma2) where sigma2 = plane residual /
    sum(coe), the per-point out-of-plane noise variance that weights the
    pose-graph edges in the plane cost's units."""
    vres = grid.voxelize(list(scans), R, p, vcfg, dtype=np.float64)
    if vres.num_planes == 0:
        return R, p, 0, 0.0
    fj = Fmod.factors_from_numpy(vres.factors, device=device,
                                 dtype=torch.float64)
    res = lm.damping_iter(_t64(R, device), _t64(p, device), fj, scfg,
                          edges=edges)
    plane_res = float(res.residual)
    if edges is not None:
        # res.residual holds the edge cost too; sigma2 is the plane noise
        plane_res = float(Fmod.residual_only(
            lie.pose_matrix(res.R, res.p), fj))
    sigma2 = plane_res / max(float(np.sum(vres.factors.coe)), 1.0)
    return (res.R.cpu().numpy(), res.p.cpu().numpy(), vres.num_planes,
            sigma2)


def solve_blocks_batched(block_factors, Rs, ps, scfg: SolverConfig, *,
                         device="cuda"):
    """Solve equal-window blocks: ((B, Wb, 3, 3), (B, Wb, 3), sigma2
    (B,)), sigma2 each block's residual / sum(coe).

    block_factors: PlaneFactors of numpy leaves, one per block.  The JAX
    package vmaps one while-loop over the blocks, padded to a common
    plane count (finished blocks iterate on their converged state, which
    changes nothing); here each block is its own damping_iter, one after
    another, which gives the same result."""
    Rout, pout, sigma2 = [], [], []
    for f, R, p in zip(block_factors, Rs, ps):
        res = lm.damping_iter(
            _t64(R, device), _t64(p, device),
            Fmod.factors_from_numpy(f, device=device, dtype=torch.float64),
            scfg)
        Rout.append(res.R.cpu().numpy())
        pout.append(res.p.cpu().numpy())
        sigma2.append(float(res.residual)
                      / max(float(np.sum(np.asarray(f.coe))), 1.0))
    return np.stack(Rout), np.stack(pout), np.asarray(sigma2)


def refeature_super_scan(sp: np.ndarray, vcfg: VoxelConfig) -> np.ndarray:
    """Planar-inlier filter: keep only the points of `sp` (one
    super-scan, anchor frame) inside admitted planar leaves when the
    cloud is voxelized solo — the hierarchy's feature re-extraction."""
    if len(sp) < vcfg.min_points:
        return sp
    vres = grid.voxelize(
        [np.asarray(sp, np.float64)], np.eye(3)[None], np.zeros((1, 3)),
        dataclasses.replace(vcfg, min_observers=1), dtype=np.float64)
    keep = vres.point_leaf >= 0
    if not keep.any():
        return sp
    return np.asarray(sp)[keep]


def _edges_in_block(scan_edges, idx):
    """The scan-level edges with both ends in `idx`, remapped to
    block-local indices (None if none)."""
    if scan_edges is None:
        return None
    pos = {i: j for j, i in enumerate(idx)}
    ei = scan_edges.i.cpu().numpy()
    ej = scan_edges.j.cpu().numpy()
    keep = [k for k in range(len(ei)) if ei[k] in pos and ej[k] in pos]
    if not keep:
        return None
    sel = torch.as_tensor(keep, device=scan_edges.Zr.device)
    dev = scan_edges.Zr.device
    return scan_edges._replace(
        i=torch.as_tensor([pos[int(ei[k])] for k in keep], device=dev),
        j=torch.as_tensor([pos[int(ej[k])] for k in keep], device=dev),
        Zr=scan_edges.Zr[sel], Zp=scan_edges.Zp[sel],
        w_rot=scan_edges.w_rot[sel], w_tr=scan_edges.w_tr[sel])


def _block_starts(W, cfg):
    starts = list(range(0, max(W - cfg.block, 0) + 1, cfg.stride))
    if not starts or starts[-1] + cfg.block < W:
        starts.append(max(W - cfg.block, 0))
    return sorted(set(starts))


def _overlap_edges(solved, sigma2_blocks, cfg, device):
    """Overlap-consensus anchor edges: every scan shared by blocks k and
    k+1 was refined in both anchor frames, and the Lie mean of its
    measurements of T_ak^-1 T_ak+1 is a relative-pose factor that
    survives the super-scan compression.  -> RelPoseEdges or None."""
    ei, Zr_l, Zp_l, wr_l = [], [], [], []
    sigma2 = float(np.median(sigma2_blocks)) if sigma2_blocks else 1e-5
    for k in range(len(solved) - 1):
        ia, Ra_, pa_ = solved[k]
        ib, Rb_, pb_ = solved[k + 1]
        shared = sorted(set(ia) & set(ib))
        if not shared:
            continue
        la = [ia.index(s) for s in shared]
        lb = [ib.index(s) for s in shared]
        Zr, Zp, spread = PG.consensus_edge(
            [Ra_[x] for x in la], [pa_[x] for x in la],
            [Rb_[x] for x in lb], [pb_[x] for x in lb])
        ei.append(k)
        Zr_l.append(Zr)
        Zp_l.append(Zp)
        wr_l.append(cfg.edge_weight * sigma2
                    / max(spread, cfg.edge_spread_floor) ** 2)
    if not ei:
        return None
    return PG.edges_from_numpy(
        (ei, np.asarray(ei) + 1, np.stack(Zr_l), np.stack(Zp_l), wr_l,
         wr_l), device=device, dtype=torch.float64)


def _loop_drift(lifted, R, p, anchors):
    """The largest effective displacement of revisited geometry over the
    lifted edges: translation correction + rotation correction times
    the scene radius."""
    li = lifted.i.cpu().numpy()
    lj = lifted.j.cpu().numpy()
    lZr = lifted.Zr.cpu().numpy()
    lZp = lifted.Zp.cpu().numpy()
    r_scene = float(np.max(np.linalg.norm(p - p.mean(axis=0), axis=1)))
    eff = 0.0
    for k in range(len(li)):
        a, b = anchors[li[k]], anchors[lj[k]]
        dR = R[a].T @ R[b]
        dp = R[a].T @ (p[b] - p[a])
        ang = np.arccos(np.clip((np.trace(lZr[k].T @ dR) - 1) / 2, -1, 1))
        eff = max(eff, float(np.linalg.norm(dp - lZp[k]) + ang * r_scene))
    return eff


def _anchor_pgo(consensus, lifted, R, p, anchors, nb, cfg):
    """The anchor pose-graph stage: the pure anchor graph (chain + the
    lifted loop edges, Huber on the loops) solved alone before the top
    plane solve.  The chain is the overlap consensus when it covers
    every consecutive anchor pair, else the current anchor estimate;
    its weights scale with the anchor gaps.  -> (Ra, pa, info)."""
    if consensus is not None and int(consensus.i.shape[0]) == nb - 1:
        chain = consensus
    else:
        chain = loopclose.chain_edges(R[anchors], p[anchors], 1.0, 1.0)
    ci = chain.i.cpu().numpy()
    cj = chain.j.cpu().numpy()
    gaps = np.maximum(anchors[cj] - anchors[ci], 1).astype(np.float64)
    T = lambda a: torch.as_tensor(a, dtype=chain.Zr.dtype,
                                  device=chain.Zr.device)
    chain = chain._replace(
        w_rot=T(1.0 / (cfg.anchor_pgo_sigma_rot * gaps) ** 2),
        w_tr=T(1.0 / (cfg.anchor_pgo_sigma_trans * gaps) ** 2))
    delta = np.concatenate([
        np.full(len(ci), 1e30),
        lifted.w_rot.cpu().double().numpy() * cfg.anchor_pgo_robust_rot ** 2
        + lifted.w_tr.cpu().double().numpy()
        * cfg.anchor_pgo_robust_trans ** 2])
    edges = PG.concat_edges(PG.RelPoseEdges(*[x.cpu() for x in chain]),
                            PG.RelPoseEdges(*[x.cpu() for x in lifted]))
    return loopclose.pose_graph_optimize(R[anchors], p[anchors], edges,
                                         delta=delta)


def run(
    scans: Sequence[np.ndarray],
    R: np.ndarray,
    p: np.ndarray,
    cfg: HierarchicalConfig = HierarchicalConfig(),
    *,
    verbose: bool = False,
    scan_edges=None,
    device="cuda",
):
    """Returns (R, p, info dict), R and p float64 numpy.

    scan_edges: optional ops.pose_graph.RelPoseEdges between the input
    scan indices, float64 on `device` (the recursive top level passes
    the previous level's inter-block constraints this way).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("hierarchical.run: no CUDA device; pass "
                           "device='cpu' for the plain PyTorch path")
    W = len(scans)
    if cfg.stride > cfg.block:
        raise ValueError(
            f"stride ({cfg.stride}) > block ({cfg.block}) leaves scans in "
            "no block (unowned poses would compose against garbage)")
    R = np.asarray(R, np.float64).copy()
    p = np.asarray(p, np.float64).copy()
    info = {"blocks": [], "W": W}
    starts = _block_starts(W, cfg)
    nb = len(starts)

    def _global_residual(Rc, pc):
        """The full problem's mean per-point plane cost at the given
        poses, re-associated — the cycle acceptance metric, normalized by
        sum(coe) (an improved trajectory admits more planes); scan edges
        add their cost in the same normalization."""
        vres = grid.voxelize(list(scans), Rc, pc, cfg.voxel,
                             dtype=np.float64)
        if vres.num_planes == 0:
            return np.inf
        fj = Fmod.factors_from_numpy(vres.factors, device=device,
                                     dtype=torch.float64)
        Rt, pt = _t64(Rc, device), _t64(pc, device)
        cost = float(Fmod.residual_only(lie.pose_matrix(Rt, pt), fj))
        if scan_edges is not None:
            cost += float(PG.relpose_cost(Rt, pt, scan_edges))
        return cost / max(float(np.sum(vres.factors.coe)), 1.0)

    res_prev = _global_residual(R, p) if cfg.cycle_guard else np.inf
    for cycle in range(max(cfg.cycles, 1)):
        R_snap, p_snap = R.copy(), p.copy()
        # --- bottom level: per-block BA in anchor frames ---
        rel_R = [None] * W   # refined pose of scan i relative to its anchor
        rel_p = [None] * W
        owner = np.empty(W, np.int64)
        anchors = np.asarray(starts, np.int64)
        block_local = []
        for s0 in starts:
            idx = list(range(s0, min(s0 + cfg.block, W)))
            Ra, pa = R[idx[0]], p[idx[0]]
            block_local.append((idx, np.einsum("ba,nbc->nac", Ra, R[idx]),
                                np.einsum("ba,nb->na", Ra, p[idx] - pa)))

        sigma2_blocks = []
        if (cfg.batched_bottom and scan_edges is None
                and len({len(b[0]) for b in block_local}) == 1):
            facs = []
            for idx, Rb, pb in block_local:
                vres = grid.voxelize([scans[i] for i in idx], Rb, pb,
                                     cfg.voxel, dtype=np.float64)
                facs.append(vres.factors)
                info["blocks"].append({"start": idx[0], "size": len(idx),
                                       "planes": vres.num_planes})
            Rall, pall, sig2_all = solve_blocks_batched(
                facs, [b[1] for b in block_local],
                [b[2] for b in block_local], cfg.solver, device=device)
            sigma2_blocks.extend(float(s) for s in sig2_all)
            solved = [(block_local[k][0], Rall[k], pall[k])
                      for k in range(nb)]
        else:
            solved = []
            for idx, Rb, pb in block_local:
                Rb, pb, nplanes, sig2 = _solve_window(
                    [scans[i] for i in idx], Rb, pb, cfg.voxel, cfg.solver,
                    edges=_edges_in_block(scan_edges, idx), device=device)
                sigma2_blocks.append(sig2)
                info["blocks"].append({"start": idx[0], "size": len(idx),
                                       "planes": nplanes})
                solved.append((idx, Rb, pb))

        for k, (idx, Rb, pb) in enumerate(solved):
            s0 = idx[0]
            for j, i in enumerate(idx):
                if (rel_R[i] is None or s0 <= i < s0 + cfg.stride
                        or k == nb - 1):
                    owner[i] = k
                    rel_R[i] = Rb[j]
                    rel_p[i] = pb[j]

        # --- inter-block constraints: overlap-consensus anchor edges ---
        anchor_edges = None
        if cfg.use_overlap_edges and nb > 1:
            anchor_edges = _overlap_edges(solved, sigma2_blocks, cfg, device)
            if anchor_edges is not None:
                info["n_edges"] = int(anchor_edges.i.shape[0])

        # loop-closure (and other long-range) scan edges span blocks:
        # re-express them on the anchor graph (pose_graph.lift_edges)
        anchor_pgo_poses = None
        if scan_edges is not None:
            consensus = anchor_edges
            lifted = PG.lift_edges(scan_edges, owner, rel_R, rel_p)
            if lifted is not None:
                info["n_lifted_edges"] = int(lifted.i.shape[0])
                eff = _loop_drift(lifted, R, p, anchors)
                info["loop_drift_effective_m"] = eff
                pgo_needed = (cfg.anchor_pgo and eff > cfg.anchor_pgo_gate
                              * cfg.voxel.voxel_size)
                if not (pgo_needed and cfg.anchor_pgo_only):
                    anchor_edges = PG.concat_edges(anchor_edges, lifted)
                if pgo_needed:
                    Ra_pg, pa_pg, pinfo = _anchor_pgo(
                        consensus, lifted, R, p, anchors, nb, cfg)
                    info["anchor_pgo"] = pinfo
                    anchor_pgo_poses = (Ra_pg, pa_pg)
                    if cycle == 0:
                        # the PGO-composed trajectory before any top
                        # plane solve touches it (a diagnostic)
                        info["anchor_pgo_provisional"] = (
                            np.stack([Ra_pg[owner[i]] @ rel_R[i]
                                      for i in range(W)]),
                            np.stack([Ra_pg[owner[i]] @ rel_p[i]
                                      + pa_pg[owner[i]] for i in range(W)]))

        # --- top level: super-scans in anchor frames ---
        will_recurse = nb > cfg.recurse_at
        refeature = (cfg.refeature_supers == "always"
                     or (cfg.refeature_supers == "recursive"
                         and will_recurse))
        super_scans = []
        for k in range(nb):
            pts = [scans[i] @ np.asarray(rel_R[i]).T + rel_p[i]
                   for i in range(W) if owner[i] == k]
            sp = np.concatenate(pts) if pts else np.zeros((0, 3))
            if refeature and len(sp):
                sp = refeature_super_scan(sp, cfg.refeature_voxel)
            if cfg.super_downsample > 0 and len(sp):
                sp = grid.down_sample_voxel(sp, cfg.super_downsample)
            super_scans.append(sp)

        Ra0, pa0 = R[anchors], p[anchors]
        if anchor_pgo_poses is not None:
            # start the top solve from the pose-graph-corrected anchors:
            # their super-scan association is in-basin
            Ra0, pa0 = anchor_pgo_poses
        if will_recurse:
            # the anchors become the next level's scan poses
            sub = dataclasses.replace(cfg, polish=False, cycles=1)
            Ra1, pa1, sub_info = run(super_scans, Ra0, pa0, sub,
                                     verbose=verbose,
                                     scan_edges=anchor_edges, device=device)
            # re-anchor the recursive gauge to this level's first anchor
            Ra1 = np.einsum("ab,nbc->nac", R[anchors[0]], Ra1)
            pa1 = np.einsum("ab,nb->na", R[anchors[0]], pa1) + p[anchors[0]]
            top_planes = sub_info.get("top_planes", 0)
            info["recursed"] = sub_info
        elif cfg.top_stages:
            Ra1, pa1, top_planes = Ra0, pa0, 0
            for vcfg_stage in cfg.top_stages:
                Ra1, pa1, top_planes, _ = _solve_window(
                    super_scans, Ra1, pa1, vcfg_stage, cfg.top_solver,
                    edges=anchor_edges, device=device)
        else:
            Ra1, pa1, top_planes, _ = _solve_window(
                super_scans, Ra0, pa0, cfg.top_voxel, cfg.top_solver,
                edges=anchor_edges, device=device)
        info["top_planes"] = top_planes
        info["n_blocks"] = nb

        # --- compose ---
        for i in range(W):
            k = owner[i]
            R[i] = Ra1[k] @ rel_R[i]
            p[i] = Ra1[k] @ rel_p[i] + pa1[k]

        # --- alternating global sweep ---
        if cfg.global_sweep > 0:
            R, p = _global_sweep(scans, R, p, cfg, scan_edges, device, info)

        # --- cycle guard: accept only if the full-problem cost fell ---
        if cfg.cycle_guard:
            res_now = _global_residual(R, p)
            info.setdefault("cycle_residuals", []).append(res_now)
            if not np.isfinite(res_now) or res_now > res_prev:
                R, p = R_snap, p_snap
                info["cycles_reverted"] = info.get("cycles_reverted", 0) + 1
                break
            res_prev = res_now
        elif not np.all(np.isfinite(R)) or not np.all(np.isfinite(p)):
            R, p = R_snap, p_snap
            info["cycles_reverted"] = info.get("cycles_reverted", 0) + 1
            break

    # --- optional flat polish, with the scan edges applied directly ---
    if cfg.polish:
        R, p, nplanes, _ = _solve_window(
            list(scans), R, p, cfg.voxel, cfg.polish_solver,
            edges=scan_edges, device=device)
        info["polish_planes"] = nplanes

    Rj, pj = lie.gauge_fix(torch.as_tensor(R), torch.as_tensor(p))
    if verbose:
        print(f"hierarchical: {nb} blocks, top planes {top_planes}")
    return Rj.numpy(), pj.numpy(), info


def _global_sweep(scans, R, p, cfg, scan_edges, device, info):
    """global_sweep LM iterations over all scans, freshly associated at
    the composed poses: the dense solve up to 512 scans ('auto'), the
    span-compressed banded one past it or with 'large'."""
    vres = grid.voxelize(list(scans), R, p, cfg.voxel, dtype=np.float64)
    if vres.num_planes == 0:
        return R, p
    scfg = dataclasses.replace(cfg.polish_solver, max_iters=cfg.global_sweep)
    W = len(scans)
    if (cfg.global_sweep_solver == "large"
            or (cfg.global_sweep_solver == "auto" and W > 512)):
        wf = FW.windowed_from_numpy(FW.from_dense(vres.factors),
                                    device=device, dtype=torch.float64)
        res = large.damping_iter_large(_t64(R, device), _t64(p, device), wf,
                                       scfg, cg_iters=cfg.global_sweep_cg)
    else:
        fj = Fmod.factors_from_numpy(vres.factors, device=device,
                                     dtype=torch.float64)
        res = lm.damping_iter(_t64(R, device), _t64(p, device), fj, scfg,
                              edges=scan_edges)
    info["global_sweeps"] = info.get("global_sweeps", 0) + 1
    return res.R.cpu().numpy(), res.p.cpu().numpy()


# --------------------------------------------------------------------------
# the device-batched hierarchy
# --------------------------------------------------------------------------

def _proj(Rm):
    """Nearest rotation (SVD projection) of a 3x3 f64 numpy matrix."""
    u, _, vt = np.linalg.svd(Rm)
    return u @ vt


def run_device_batched(
    scans,
    R0: np.ndarray,
    p0: np.ndarray,
    *,
    block: int = 16,
    stride: int | None = None,
    cycles: int = 2,
    voxel: VoxelConfig = VoxelConfig(min_observers=2),
    top_voxel: VoxelConfig | None = None,
    solver: SolverConfig = SolverConfig(
        max_iters=8, u_init=0.01, min_planes_per_pose=0, gauge_fix=False),
    top_solver: SolverConfig = SolverConfig(
        max_iters=10, u_init=0.01, min_planes_per_pose=0,
        gauge_fix=False),
    block_caps=(1 << 10, 1 << 12, 1 << 14),
    Gcap_block: int = 256,
    cs_cap_block: int = 1 << 15,
    top_caps=(1 << 14, 1 << 16, 1 << 18),
    Gcap_top: int = 1 << 13,
    cs_cap_top: int = 1 << 21,
    top: bool = True,
    verbose: bool = False,
    device="cuda",
):
    """Hierarchical BA where every level is one batched device program:
    the large-W configuration.

    Per cycle:
      1. bottom: all blocks' association as ONE batched voxelization
         (voxel/device.voxelize_core_batched) over the (B, block) block
         axis, in block-anchor frames; all blocks' window BAs as ONE
         batched packed damped-Newton solve (lm.damping_iter_batched:
         per iteration one batched B1 and one batched B2 launch for all
         blocks)
      2. top: every refined block becomes a super-scan (its points in
         the anchor frame at the refined relative poses, an elementwise
         device transform); the B anchor poses are associated on the
         device and solved with the f32 'xla' evaluator
      3. compose scan poses = top anchor o refined block-relative

    top=False keeps the anchors and lands the re-anchored block
    solutions (the caller couples the blocks, run_batched_consensus).
    Blocks start every `stride` scans (default `block`), the last at
    W - block.  info["timings"] holds each cycle's host-clock seconds
    by stage, each taken after a device synchronize; info["block_rel"]
    the per-block solutions (idx (B, block), R (B, block, 3, 3), p).
    Returns (R, p, info), float64 numpy."""
    import time as _time

    from ..ops.precision import fp32_matmul
    from ..voxel import device as vdev

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_device_batched: no CUDA device; pass "
                           "device='cpu' for the plain PyTorch path")
    W = len(scans)
    stride = stride or block
    if not (0 < stride <= block):
        raise ValueError("need 0 < stride <= block")
    # overlapping blocks (stride < block) share scans, which couples the
    # anchor problem strongly enough to kill its spurious optima
    starts = list(range(0, max(W - block, 0) + 1, stride))
    if starts[-1] != W - block:
        starts.append(W - block)
    B = len(starts)
    top_voxel = top_voxel or voxel
    idx = np.stack([np.arange(s, s + block) for s in starts])

    body_h, mask_h = vdev.pad_scans(
        [np.asarray(s, np.float32) for s in scans], np.float32)
    Nmax = body_h.shape[1]
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=device)
    flat = torch.as_tensor(idx.reshape(-1), device=device)
    bb = f32(body_h)[flat].view(B, block, Nmax, 3)
    mb = torch.as_tensor(mask_h, device=device)[flat].view(B, block, Nmax)

    def core_kw(vcfg, caps, Gcap, cs_cap):
        return dict(
            voxel_size=float(vcfg.voxel_size),
            layer_limit=int(vcfg.layer_limit),
            eigen_ratio=tuple(float(r) for r in vcfg.eigen_ratio),
            min_points=int(vcfg.min_points),
            min_observers=int(vcfg.min_observers),
            unit_coe=False, cell_caps=tuple(int(c) for c in caps),
            Gcap=int(Gcap), cs_cap=int(cs_cap), want_point_leaf=False)

    R = np.array(R0, np.float64)
    p = np.array(p0, np.float64)
    info = {"timings": [], "block_planes": None, "top_planes": None,
            "overflow": False}

    for cyc in range(cycles):
        t = {}
        t0 = _time.perf_counter()
        Ra = R[idx[:, 0]]
        pa = p[idx[:, 0]]
        R_rel = np.einsum("bca,bwcd->bwad", Ra, R[idx])
        p_rel = np.einsum("bca,bwc->bwa", Ra, p[idx] - pa[:, None])
        Rrj, prj = f32(R_rel), f32(p_rel)

        dres = vdev.voxelize_core_batched(
            bb, mb, Rrj, prj,
            **core_kw(voxel, block_caps, Gcap_block, cs_cap_block))
        info["overflow"] |= bool(dres.overflow.any())
        t["block_assoc_s"] = _time.perf_counter() - t0

        t0 = _time.perf_counter()
        bres = lm.damping_iter_batched(Rrj, prj, dres.factors, solver)
        # re-anchor every block to its FIRST pose: the block BA has free
        # gauge (gauge_fix=False), and a tilted block frame would land
        # its super-scan tilted and poison the anchor association
        with fp32_matmul():
            R0b = bres.R[:, 0:1].transpose(-1, -2)           # (B, 1, 3, 3)
            Rr = R0b @ bres.R
            pr = (R0b @ (bres.p - bres.p[:, 0:1])[..., None])[..., 0]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t["block_solve_s"] = _time.perf_counter() - t0
        info["block_planes"] = [int(x) for x in
                                dres.num_planes[:4].cpu().numpy()]
        Rrn = Rr.double().cpu().numpy()
        prn = pr.double().cpu().numpy()
        # the per-block solutions before landing: overlapping blocks are
        # independent measurements of the shared scans' relative poses
        # (landing overwrites them, last block wins)
        info["block_rel"] = (idx.copy(), Rrn.copy(), prn.copy())

        if not top:
            # blocks only: keep the anchors, land the re-anchored blocks
            for b in range(B):
                for j, i in enumerate(idx[b]):
                    R[i] = _proj(Ra[b] @ Rrn[b, j])
                    p[i] = Ra[b] @ prn[b, j] + pa[b]
            t["cycle_s"] = sum(t.values())
            info["timings"].append({k: round(v, 3) for k, v in t.items()})
            continue

        t0 = _time.perf_counter()
        sp = (Rr[:, :, None, :, 0] * bb[..., 0, None]
              + Rr[:, :, None, :, 1] * bb[..., 1, None]
              + Rr[:, :, None, :, 2] * bb[..., 2, None]) + pr[:, :, None, :]
        tres = vdev._voxelize_core(
            sp.reshape(B, block * Nmax, 3), mb.reshape(B, -1), f32(Ra),
            f32(pa), **core_kw(top_voxel, top_caps, Gcap_top, cs_cap_top))
        info["overflow"] |= bool(tres.overflow)
        info["top_planes"] = int(tres.num_planes)
        t["top_assoc_s"] = _time.perf_counter() - t0

        t0 = _time.perf_counter()
        # the anchor problem on the 'xla' evaluator: small (B poses) and
        # multi-modal on weakly coupled scenes, where the JAX package's
        # packed f32 trajectory lands in the wrong optimum
        topres = lm.damping_iter(f32(Ra), f32(pa), tres.factors, top_solver,
                                 centered=True, backend="xla")
        Ran = topres.R.double().cpu().numpy()
        pan = topres.p.double().cpu().numpy()
        t["top_solve_s"] = _time.perf_counter() - t0

        for b in range(B):
            Ab = _proj(Ran[b])
            for j, i in enumerate(idx[b]):
                R[i] = _proj(Ab @ Rrn[b, j])
                p[i] = Ab @ prn[b, j] + pan[b]
        t["cycle_s"] = sum(t.values())
        info["timings"].append({k: round(v, 3) for k, v in t.items()})
        if verbose:
            print(f"cycle {cyc}: {info['timings'][-1]}", flush=True)

    return R, p, info


def _so3_log(Rm):
    return lie.so3_log(torch.as_tensor(Rm, dtype=torch.float64)).numpy()


def consensus_scan_edges(idx: np.ndarray, Rr, pr, *,
                         sigma_rot: float = 2e-3, sigma_tr: float = 2e-3,
                         weight_scale: float = 1.0,
                         init_R=None, init_p=None,
                         gate_rot: float = 0.05, gate_tr: float = 0.3,
                         prior_sigma_rot: float = 0.03,
                         prior_sigma_tr: float = 0.1,
                         stats: dict | None = None):
    """Consecutive-scan relative-pose edges from batched block solutions.

    idx: (B, block) global scan indices per block; Rr/pr: (B, block)
    refined block-relative poses (re-anchored to each block's first
    scan).  For every consecutive global pair (i, i+1) the relative pose
    T_i^-1 T_{i+1} is measured inside each overlapping block holding
    both; the edge takes the Lie-algebra consensus mean and the weight
    weight_scale / (sigma^2 + spread^2) from the cross-block spread.

    With init_R/init_p (the initial trajectory, an odometry-grade
    prior), a block measurement that disagrees with the init relative
    pose by more than gate_rot rad or gate_tr m (a block with
    locally degenerate geometry) is dropped; a pair with no measurement
    left falls back to the init relative pose at prior weight
    (prior_sigma_*).  stats, when given, receives n_gated_measurements
    and n_prior_pairs.

    Host float64.  Returns ops.pose_graph.RelPoseEdges over global scan
    indices (i, i+1), on the CPU in float64, or None."""
    idx = np.asarray(idx)
    Rr = np.asarray(Rr, np.float64)
    pr = np.asarray(pr, np.float64)
    B, blk = idx.shape
    W = int(idx.max()) + 1
    n_gated = 0
    meas: dict[int, list] = {}
    for b in range(B):
        for j in range(blk - 1):
            i = int(idx[b, j])
            if int(idx[b, j + 1]) != i + 1:
                continue
            Zr = Rr[b, j].T @ Rr[b, j + 1]
            Zp = Rr[b, j].T @ (pr[b, j + 1] - pr[b, j])
            if init_R is not None:
                Zr0 = init_R[i].T @ init_R[i + 1]
                Zp0 = init_R[i].T @ (init_p[i + 1] - init_p[i])
                dr = np.linalg.norm(_so3_log(Zr0.T @ Zr))
                dt = np.linalg.norm(Zp - Zp0)
                if dr > gate_rot or dt > gate_tr:
                    n_gated += 1
                    continue
            meas.setdefault(i, []).append((Zr, Zp))
    n_prior = 0
    if init_R is not None:
        for i in range(W - 1):
            if i not in meas:
                n_prior += 1
                meas[i] = [(init_R[i].T @ init_R[i + 1],
                            init_R[i].T @ (init_p[i + 1] - init_p[i]),
                            "prior")]
    if stats is not None:
        stats["n_gated_measurements"] = n_gated
        stats["n_prior_pairs"] = n_prior
    if not meas:
        return None
    li, Zr_l, Zp_l, wr_l, wt_l = [], [], [], [], []
    for i in sorted(meas):
        Ts = meas[i]
        prior = len(Ts[0]) == 3
        Rf, pf = Ts[0][0], Ts[0][1]
        if len(Ts) == 1:
            Rm, pm, sp_r, sp_t = Rf, pf, 0.0, 0.0
        else:
            ws = [_so3_log(Rf.T @ Rk) for Rk, _ in Ts]
            vs = [pk - pf for _, pk in Ts]
            wbar = np.mean(ws, axis=0)
            vbar = np.mean(vs, axis=0)
            sp_r = float(np.max(np.linalg.norm(
                np.asarray(ws) - wbar, axis=-1)))
            sp_t = float(np.max(np.linalg.norm(
                np.asarray(vs) - vbar, axis=-1)))
            Rm = Rf @ lie.so3_exp(torch.as_tensor(wbar)).numpy()
            pm = pf + vbar
        s_r = max(sigma_rot, prior_sigma_rot) if prior else sigma_rot
        s_t = max(sigma_tr, prior_sigma_tr) if prior else sigma_tr
        li.append(i)
        Zr_l.append(Rm)
        Zp_l.append(pm)
        wr_l.append(weight_scale / (s_r ** 2 + sp_r ** 2))
        wt_l.append(weight_scale / (s_t ** 2 + sp_t ** 2))
    li = np.asarray(li, np.int64)
    return PG.edges_from_numpy((li, li + 1, np.stack(Zr_l), np.stack(Zp_l),
                                wr_l, wt_l))


def run_batched_consensus(
    scans,
    R0: np.ndarray,
    p0: np.ndarray,
    *,
    block: int = 16,
    stride: int | None = None,
    cycles: int = 1,
    voxel: VoxelConfig = VoxelConfig(min_observers=2),
    solver: SolverConfig = SolverConfig(
        max_iters=12, u_init=0.01, min_planes_per_pose=0,
        gauge_fix=False),
    polish_solver: SolverConfig = SolverConfig(max_iters=25, u_init=0.01),
    polish_chunks: int = 1,
    sigma_rot: float = 2e-3,
    sigma_tr: float = 2e-3,
    edge_weight_scale: float = 1.0,
    block_caps=(1 << 9, 1 << 11, 1 << 13),
    Gcap_block: int = 256,
    cs_cap_block: int = 1 << 15,
    verbose: bool = False,
    device="cuda",
):
    """The device-batched hierarchy with the consensus machinery:

      1. overlapping blocks (stride block // 2 by default), association
         + window BA batched on the device (run_device_batched
         top=False): local geometry
      2. consecutive-scan consensus edges from the overlapping per-block
         solutions (consensus_scan_edges), gated against the init
      3. one chunked global banded solve (solver/large.damping_iter_large
         linear_solver='banded') over the plane factors associated at the
         INIT poses, from the init poses, plus the edges (float32)

    The blocks serve only as edge-measurement generators: the landed
    block composition is not used.  polish_chunks warm restarts of the
    polish run while a chunk uses all of polish_solver.max_iters.
    info holds the blocks' info, edges_s, n_edges, the gate stats, the
    edges (info["edges"], CPU float64), polish_assoc_s, polish_planes,
    polish_span, polish_solve_s, polish_iters and polish_residual.
    Returns (R, p, info), float64 numpy."""
    import time as _time

    device = torch.device(device)
    stride = stride if stride is not None else block // 2
    t0 = _time.perf_counter()
    _, _, info = run_device_batched(
        scans, R0, p0, block=block, stride=stride, cycles=cycles,
        voxel=voxel, solver=solver, block_caps=block_caps,
        Gcap_block=Gcap_block, cs_cap_block=cs_cap_block, top=False,
        verbose=verbose, device=device)
    info["blocks_s"] = round(_time.perf_counter() - t0, 2)

    # edges from the PER-BLOCK solutions, not the landed trajectory,
    # whose overwritten overlaps would repeat one measurement per block
    idx, R_rel, p_rel = info.pop("block_rel")
    t0 = _time.perf_counter()
    gate_stats: dict = {}
    edges = consensus_scan_edges(
        idx, R_rel, p_rel, sigma_rot=sigma_rot, sigma_tr=sigma_tr,
        weight_scale=edge_weight_scale,
        init_R=np.asarray(R0, np.float64),
        init_p=np.asarray(p0, np.float64), stats=gate_stats)
    info["edges_s"] = round(_time.perf_counter() - t0, 2)
    info["n_edges"] = 0 if edges is None else int(edges.i.shape[0])
    info.update(gate_stats)
    # the edges stay valid for a later re-associated refine
    info["edges"] = edges

    t0 = _time.perf_counter()
    vres = grid.voxelize(list(scans), R0, p0, voxel, dtype=np.float64)
    wf = FW.windowed_from_numpy(
        FW.from_dense(Fmod.recenter_bodies(vres.factors)), device=device,
        dtype=torch.float32)
    info["polish_assoc_s"] = round(_time.perf_counter() - t0, 2)
    info["polish_planes"] = int(vres.num_planes)
    info["polish_span"] = int(wf.span)

    if edges is not None:
        edges = PG.RelPoseEdges(
            i=edges.i.to(device), j=edges.j.to(device),
            **{k: getattr(edges, k).to(device=device, dtype=torch.float32)
               for k in ("Zr", "Zp", "w_rot", "w_tr")})
    t0 = _time.perf_counter()
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                    dtype=torch.float32, device=device)
    Rc, pc = f32(R0), f32(p0)
    tot_iters = 0
    res = None
    for _ in range(max(1, polish_chunks)):
        res = large.damping_iter_large(Rc, pc, wf, polish_solver,
                                       linear_solver="banded", edges=edges)
        tot_iters += int(res.iters)
        Rc, pc = res.R, res.p
        if int(res.iters) < polish_solver.max_iters:
            break
    Rf = Rc.double().cpu().numpy()
    pf = pc.double().cpu().numpy()
    info["polish_solve_s"] = round(_time.perf_counter() - t0, 2)
    info["polish_iters"] = tot_iters
    info["polish_residual"] = float(res.residual)
    return Rf, pf, info
