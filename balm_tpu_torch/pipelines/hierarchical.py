"""Hierarchical (HBA / Voxel-SLAM style) global bundle adjustment.

Counterpart: balm_tpu/pipelines/hierarchical.py up to :617 —
HierarchicalConfig (:40), _solve_window (:163), solve_blocks_batched
(:186), refeature_super_scan (:227), _edges_in_block (:244) and run
(:267).  The reference caps its window at W = 177 poses with one dense
(6W)^2 solve (bavoxel.hpp:1104-1157); this is the large-W design:

  1. BOTTOM: partition the trajectory into overlapping keyframe blocks;
     each block is a small BA (voxelize + damped Newton in the
     block-anchor frame)
  2. TOP: freeze the refined intra-block geometry, merge each block's
     scans into one "super-scan" in its anchor frame, and run BA over the
     anchor poses only, with overlap-consensus edges between consecutive
     anchors (ops/pose_graph.consensus_edge)
  3. COMPOSE: scan pose = refined anchor o refined intra-block relative
     pose; optional global sweeps, a cycle guard and a flat polish

Host driven: association, composition and the edges are float64 numpy
on the host; every solve is the port's float64 damping_iter (backend
'xla', ops/factors.py's evaluators) on `device` (default 'cuda'; 'cpu'
for the plain path), the global sweep past 512 scans
solver/large.damping_iter_large.  The bottom level solves its blocks one
after another, also under batched_bottom (solve_blocks_batched is a
loop; the JAX package vmaps its while-loop).  The anchor pose-graph
stage needs loop closure's pose_graph_optimize, which is not ported:
where it would run, run raises NotImplementedError.
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

_PGO = ("the anchor pose-graph stage needs pipelines/loopclose."
        "pose_graph_optimize, not ported yet (ROADMAP.md, A13a)")


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
    # anchor-level pose-graph stage for lifted loop edges whose
    # correction exceeds anchor_pgo_gate voxels (see the JAX package's
    # HierarchicalConfig); it raises NotImplementedError here (A13a)
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
        if scan_edges is not None:
            lifted = PG.lift_edges(scan_edges, owner, rel_R, rel_p)
            if lifted is not None:
                info["n_lifted_edges"] = int(lifted.i.shape[0])
                eff = _loop_drift(lifted, R, p, anchors)
                info["loop_drift_effective_m"] = eff
                if (cfg.anchor_pgo
                        and eff > cfg.anchor_pgo_gate * cfg.voxel.voxel_size):
                    raise NotImplementedError(_PGO)
                anchor_edges = PG.concat_edges(anchor_edges, lifted)

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
