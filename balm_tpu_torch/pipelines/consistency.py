"""Statistical-consistency (NEES) experiment — the reference's
`consistency` node (src/simulation/consistency.cpp), which checks the
gradient, the Hessian and the covariance propagation together.

Counterpart: balm_tpu/pipelines/consistency.py — ConsistencyConfig
(:37), load (:76), corrupt_and_rebuild (:87), variant_gates (:97),
prepare (:129), run_multi (:156) and run (:197).

Protocol (consistency.cpp:96-199, BAs_left.hpp:13-21):
  1. load 101 simulator poses + scans (datas/consistency)
  2. voxelize all scans (voxel 1 m, layer_limit 0, ratio 1/64, min_ps
     10, no min-observer gate, unit weights)
  3. marginalize the first scan into the fixed clusters (fix_size = 1),
     which anchors the gauge and makes H invertible
  4. corrupt the remaining points with iid N(0, pnoise^2) noise and
     rebuild the window clusters (OCTO_TREE_NODE::corrupt,
     BAs_left.hpp:886-907)
  5. solve (u0 = 0.01, <= 1000 iterations, |dres| < 1e-9, no gauge fix)
  6. Rcov = H^{-1} (sum L ccov L^T) H^{-T}; NEES = err^T Rcov^{-1} err
     with the left-invariant error against the noise-free trajectory;
     E[NEES] = 6 W (consistency.cpp:160-179)

Association, gates, marginalization and the noise draw are host numpy in
float64; the solve and the covariance run on `device` (default 'cuda';
'cpu' takes the kernels' plain versions).  backend='xla' is the f64
oracle (ops/factors.py's evaluators, ops/covariance.py);
backend='packed' is the production f32 path: body-recentered f32
factors through the packed evaluate (kernels B1 `csum` and B2 `rows` on
the card), the covariance's H from evaluate_packed at the converged
poses, the noise-propagation rhs on the f64 oracle path.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time

import numpy as np
import torch

from ..config import SolverConfig, VoxelConfig
from ..io import pcd, poses
from ..ops import clusters, covariance, factors as Fmod, lie
from ..ops import packed as packed_mod
from ..ops import packed_evaluate as pe
from ..solver import lm
from ..voxel import grid, marginalize


@dataclasses.dataclass
class ConsistencyConfig:
    # the reference's simulator dataset (datas/consistency)
    data_dir: str = "datas/consistency"
    num_scans: int = 101
    fix_size: int = 1
    pnoise: float = 0.02            # launch/consistency.launch pnoise
    seed: int = 0
    # the consistency build's extra plane gates (BAs_left.hpp:674) on the
    # NOISE-FREE clusters before corruption: max point deviation along
    # the normal, a lambda_2/lambda_1 cap and an absolute lambda_0 cap
    gate_max_dis: float = 0.001
    gate_l2_l1: float = 25.0
    gate_l0_abs: float = 1e-10
    use_variant_gates: bool = True
    voxel: VoxelConfig = VoxelConfig(
        voxel_size=1.0,
        layer_limit=0,
        eigen_ratio=(1.0 / 64,),
        min_points=10,
        min_observers=1,
    )
    # ulp_tol=0: the protocol's stops are abs_tol alone — 1e-9 in f64
    # and the f32 floor of 1e-6 on the packed path (_solve_packed).  The
    # JAX package keeps SolverConfig's default ulp_tol=128 here, whose
    # f32 floor (128 eps res, ~1.2e-5 at res 0.8) ends the damped f32
    # solve of a corridor-like scene after 2-4 of the f64 solve's 10-11
    # iterations, ~1 cm short of its optimum, and moves the NEES ratio
    # by ~0.1.  In f64 the floor (~2e-14) never binds.
    solver: SolverConfig = SolverConfig(
        max_iters=1000, u_init=0.01, rel_tol=0.0, abs_tol=1e-9,
        ulp_tol=0.0, min_planes_per_pose=1, gauge_fix=False,
    )
    # 'xla' = the f64 oracle path (reference protocol); 'packed' = the
    # production f32 path, hess_precision='high', with the covariance H
    # from the same evaluate at the converged estimate
    backend: str = "xla"
    # build the voxel map incrementally, scan by scan, as the reference
    # streams them (grid.StreamingVoxelizer); False = one-shot batch
    # association (the same final state)
    streaming: bool = False


def load(cfg: ConsistencyConfig):
    """(R, p, scans) of the dataset, re-anchored to p[0]
    (consistency.cpp:85-88)."""
    d = pathlib.Path(cfg.data_dir)
    R, p, _ = poses.read_pose_csv(d / "lidarPose.csv", cfg.num_scans)
    p = p - p[0]
    scans = [pcd.read_pcd_xyz(d / f"{m + 1}.pcd", np.float64)
             for m in range(cfg.num_scans)]
    return R, p, scans


def corrupt_and_rebuild(body, scan_id, point_leaf, keep_mask, G, W, rng,
                        pnoise):
    """Re-noise raw points and rebuild the per-(plane, scan) window
    moments (OCTO_TREE_NODE::corrupt, BAs_left.hpp:886-907)."""
    noisy = body + rng.normal(0.0, pnoise, size=body.shape)
    sel = keep_mask & (point_leaf >= 0)
    seg = point_leaf[sel] * W + scan_id[sel]
    C = grid._moment_bincount(noisy[sel], seg, G * W)
    return C.reshape(G, W, 4, 4)


def _pose_matrix(R, p):
    """(W, 3, 3), (W, 3) float64 numpy -> (W, 4, 4) numpy."""
    return lie.pose_matrix(torch.as_tensor(R), torch.as_tensor(p)).numpy()


def variant_gates(vres, scans, R, p, cfg: ConsistencyConfig):
    """The consistency build's extra plane gates (BAs_left.hpp:674) on
    the noise-free clusters, host numpy f64: a (G,) keep mask."""
    f = vres.factors
    G = f.C.shape[0]
    T = _pose_matrix(np.asarray(R), np.asarray(p))
    TC = np.einsum("wab,gwbc->gwac", T, np.asarray(f.C))
    Q = np.asarray(f.Cfix) + np.einsum("gwac,wdc->gad", TC, T)
    N = np.maximum(Q[:, 3, 3], 1.0)
    c = Q[:, :3, 3] / N[:, None]
    cov = Q[:, :3, :3] / N[:, None, None] - c[:, :, None] * c[:, None, :]
    lam, U = np.linalg.eigh(cov)
    keep = lam[:, 2] / np.maximum(lam[:, 1], 1e-300) < cfg.gate_l2_l1
    keep &= lam[:, 0] < cfg.gate_l0_abs

    # max point deviation along the normal, per leaf
    body = np.concatenate(scans)
    sid = vres.point_scan
    world = np.einsum("nab,nb->na", np.asarray(R)[sid], body) \
        + np.asarray(p)[sid]
    leaf = vres.point_leaf
    sel = leaf >= 0
    nrm = U[:, :, 0]
    dev = np.abs(np.einsum("na,na->n", world[sel] - c[leaf[sel]],
                           nrm[leaf[sel]]))
    max_dis = np.zeros(G)
    np.maximum.at(max_dis, leaf[sel], dev)
    keep &= max_dis < cfg.gate_max_dis
    return keep


def prepare(cfg: ConsistencyConfig, *, scans_override=None):
    """Seed-independent setup: load, voxelize, gate, marginalize.
    Returns (R, p, scans, vres, f_marginalized), host numpy."""
    if scans_override is not None:
        R, p, scans = scans_override
    else:
        R, p, scans = load(cfg)
    R = np.asarray(R, np.float64)
    p = np.asarray(p, np.float64)
    fix = cfg.fix_size
    if cfg.streaming:
        sv = grid.StreamingVoxelizer(len(scans), cfg.voxel)
        for m, s in enumerate(scans):       # consistency.cpp:127
            sv.insert(m, s, R[m], p[m])
        vres = sv.finalize(weighting="unit")
    else:
        vres = grid.voxelize(scans, R, p, cfg.voxel, dtype=np.float64,
                             weighting="unit")
    f_all = vres.factors
    if cfg.use_variant_gates:
        keep = variant_gates(vres, scans, R, p, cfg)
        f_all = f_all._replace(coe=np.where(keep, f_all.coe, 0.0))
    T_all = _pose_matrix(R, p)
    f = marginalize.marginalize(f_all, T_all[:fix], fix, weighting="unit")
    return R, p, scans, vres, f


def _check_device(device, who):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' "
                           "for the plain PyTorch path")
    return device


def run_multi(cfg: ConsistencyConfig = ConsistencyConfig(),
              seeds=tuple(range(10)), *, verbose: bool = False,
              scans_override=None, device="cuda"):
    """Monte-Carlo NEES protocol (consistency.cpp:181-197): the
    corrupt-solve-NEES experiment over seeds, with the mean ratio and a
    normal-approximation confidence interval.  E[NEES] = 6W; for one
    chi-square_{6W} sample Var = 2*6W, so the mean ratio over S seeds
    has sd = sqrt(2/(6W S)).

    The JAX package's keys, and `per_seed`: each run's iters, residual,
    pose errors beside the RMS errors its Rcov predicts (the root mean
    of the rotation / translation variances on its diagonal), host wall
    seconds and whether Rcov is finite with a positive diagonal."""
    device = _check_device(device, "consistency.run_multi")
    prepared = prepare(cfg, scans_override=scans_override)
    runs, per_seed = [], []
    for s in seeds:
        t0 = time.perf_counter()
        out = run(dataclasses.replace(cfg, seed=int(s)),
                  _prepared=prepared, verbose=verbose, device=device)
        dt = time.perf_counter() - t0
        runs.append(out)
        Rcov = out["Rcov"]
        var = np.diag(Rcov).reshape(-1, 6)
        per_seed.append({
            "seed": int(s), "iters": out["iters"],
            "residual": out["residual"], "ratio": out["ratio"],
            "err_rot_rms_deg": out["err_rot_rms_deg"],
            "err_trans_rms_m": out["err_trans_rms_m"],
            "pred_rot_rms_deg": float(
                np.sqrt(np.mean(var[:, :3])) * 57.2958),
            "pred_trans_rms_m": float(np.sqrt(np.mean(var[:, 3:]))),
            "seconds": dt,
            "rcov_ok": bool(np.all(np.isfinite(Rcov))
                            and np.all(np.diag(Rcov) > 0))})
    W = len(prepared[2]) - cfg.fix_size
    S = len(seeds)
    ratios = np.array([r["ratio"] for r in runs])
    # per-pose protocol (consistency.cpp:181-197): the mean per-pose NEES
    # over seeds is chi^2_6/6 around 1 with sd = sqrt(12/S)/6 per pose;
    # the 3-sigma check counts standardized per-component errors in +-3
    nees_pose = np.stack([r["nees_pose"] for r in runs])   # (S, W)
    std_err = np.stack([r["std_err"] for r in runs])       # (S, W, 6)
    pose_sd = float(np.sqrt(12.0 / S) / 6.0)
    return {
        "seeds": list(map(int, seeds)),
        "ratios": ratios.tolist(),
        "mean_ratio": float(ratios.mean()),
        "sd_ratio": float(ratios.std(ddof=1)) if S > 1 else 0.0,
        "sd_theory_of_mean": float(np.sqrt(2.0 / (6 * W * S))),
        "expected": 6 * W,
        "nees": [r["nees"] for r in runs],
        "num_planes": runs[0]["num_planes"],
        "nees_pose_mean_ratio": (nees_pose.mean(axis=0) / 6.0).tolist(),
        "nees_pose_band_3sigma": [1.0 - 3 * pose_sd, 1.0 + 3 * pose_sd],
        "frac_within_3sigma": float(np.mean(np.abs(std_err) <= 3.0)),
        "frac_within_2sigma": float(np.mean(np.abs(std_err) <= 2.0)),
        "per_seed": per_seed,
    }


def _solve_packed(R_gt, p_gt, f, cfg, device):
    """The production f32 path: recenter_bodies in f64 numpy, f32
    factors on the device, the packed solve, and H from evaluate_packed
    at the converged poses.  -> (LMResult, H (6W, 6W) float64 numpy)."""
    fr = Fmod.factors_from_numpy(Fmod.recenter_bodies(f), device=device,
                                 dtype=torch.float32)
    # f32 cannot resolve the f64 protocol's 1e-9 absolute residual
    # deltas: stop at the f32 floor (consistency.py:239-244), abs_tol
    # 1e-6 (with ConsistencyConfig's ulp_tol=0, the only f32 stop)
    scfg = dataclasses.replace(cfg.solver,
                               abs_tol=max(cfg.solver.abs_tol, 1e-6))
    T32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    res = lm.damping_iter(T32(R_gt), T32(p_gt), fr, scfg, centered=True,
                          backend="packed", hess_precision="high")
    _, _, H32 = pe.evaluate_packed(res.R, res.p,
                                   packed_mod.pack_factors(fr),
                                   hess_precision="high")
    return res, H32.to(torch.float64).cpu().numpy()


def run(cfg: ConsistencyConfig = ConsistencyConfig(), *,
        verbose: bool = False, scans_override=None, _prepared=None,
        device="cuda"):
    """One corrupt-solve-NEES experiment.  Returns a dict with nees,
    expected, ratio, the per-pose NEES and standardized errors, iters,
    residual, num_planes, the pose errors, Rcov and err.

    _prepared: the output of prepare(), which the multi-seed sweep
    reuses (association and marginalization do not depend on the seed).
    """
    device = _check_device(device, "consistency.run")
    if _prepared is not None:
        R, p, scans, vres, f = _prepared
    else:
        R, p, scans, vres, f = prepare(cfg, scans_override=scans_override)
    fix = cfg.fix_size
    W = len(scans) - fix
    G = vres.factors.C.shape[0]  # padded size

    # corrupt the raw window points and rebuild the window moments
    rng = np.random.default_rng(cfg.seed)
    body = np.concatenate(scans)
    scan_id = vres.point_scan
    C_noisy = corrupt_and_rebuild(body, scan_id - fix, vres.point_leaf,
                                  scan_id >= fix, G, W, rng, cfg.pnoise)
    f = f._replace(C=C_noisy)
    R_gt, p_gt = R[fix:], p[fix:]       # the noise-free window trajectory

    T64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    fj = Fmod.factors_from_numpy(f, device=device, dtype=torch.float64)
    ccov = clusters.stat_noise_cov(fj.C, cfg.pnoise)
    if cfg.backend == "packed":
        res, H = _solve_packed(R_gt, p_gt, f, cfg, device)
        Rw = res.R.to(torch.float64).cpu().numpy()
        pw = res.p.to(torch.float64).cpu().numpy()
        # the noise-propagation rhs is the experiment's noise model: it
        # stays on the f64 oracle path (raw uncentered moments in f32
        # would hit the cancellation recenter_bodies exists to avoid)
        T_est = lie.pose_matrix(T64(Rw), T64(pw))
        rhs = covariance.scatter_jacobian_rhs(T_est, fj, ccov)
        rhs = rhs.cpu().numpy()
        Rcov = np.linalg.solve(H, np.linalg.solve(H, rhs).T).T
    elif cfg.backend == "xla":
        res = lm.damping_iter(T64(R_gt), T64(p_gt), fj, cfg.solver)
        T_est = lie.pose_matrix(res.R, res.p)
        Rcov = covariance.pose_covariance(T_est, fj, ccov).cpu().numpy()
        Rw = res.R.cpu().numpy()
        pw = res.p.cpu().numpy()
    else:
        raise ValueError(f"unknown backend {cfg.backend!r}")

    # left-invariant error against the ground truth (consistency.cpp:
    # 168-175)
    Rr = np.einsum("wab,wcb->wac", R_gt, Rw)           # R_gt R_w^T
    errW = np.zeros((W, 6))
    errW[:, :3] = lie.so3_log(torch.as_tensor(Rr)).numpy()
    errW[:, 3:] = -np.einsum("wab,wb->wa", Rr, pw) + p_gt
    err = errW.reshape(6 * W)

    nees = float(err @ np.linalg.solve(Rcov, err))
    # per-pose NEES (consistency.cpp:181-189): err_i^T Rcov[ii]^{-1} err_i
    # against the 6x6 marginal block, E = 6 per pose
    blocks = Rcov.reshape(W, 6, W, 6)[np.arange(W), :, np.arange(W), :]
    nees_pose = np.einsum(
        "wi,wi->w", errW, np.linalg.solve(blocks, errW[..., None])[..., 0])
    # 3-sigma bound check (consistency.cpp:190-197): per-component
    # standardized errors |err| / sigma from the covariance diagonal
    sig = np.sqrt(np.maximum(np.diagonal(Rcov), 1e-300)).reshape(W, 6)
    out = {
        "nees": nees,
        "expected": 6 * W,
        "ratio": nees / (6 * W),
        "nees_pose": nees_pose,
        "std_err": errW / sig,
        "iters": int(res.iters),
        "residual": float(res.residual),
        "num_planes": vres.num_planes,
        "err_rot_rms_deg": float(
            np.sqrt(np.mean(errW[:, :3] ** 2)) * 57.2958),
        "err_trans_rms_m": float(np.sqrt(np.mean(errW[:, 3:] ** 2))),
        "Rcov": Rcov,
        "err": err,
    }
    if verbose:
        print(f"NEES {nees:.1f} (expected {6 * W}, ratio "
              f"{out['ratio']:.3f}) planes {vres.num_planes} iters "
              f"{out['iters']}")
    return out
