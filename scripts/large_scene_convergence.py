#!/usr/bin/env python3
"""How the large and the dense solve converge on chip_smoke.py's scene
above optimize_poses' large_threshold.

    python3 scripts/large_scene_convergence.py [--seed 11] [--scans 640]
        [--iters 10,50,200] [--solvers large,packed]

Builds chip_smoke.py's scene at --scans scans (phase 10e's: seed 11,
pose 0 exact, 2 deg / 0.1 m on the others), voxelizes once on the host
and recenters in f64.  Then for each --iters cap, f32 on the card:
'large' is optimize_poses' large path (from_dense, damping_iter_large,
banded), 'packed' the dense packed solve (damping_iter(centered=True,
backend='packed')) on the same association.  Printed per solve: the
iterations taken, the residual before and after, the rotation (rad) and
translation (m) RSME against the ground truth after gauge-fixing both,
and the wall seconds.  The card's name and power limit come first.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--scans", type=int, default=640)
    ap.add_argument("--iters", default="10,50,200")
    ap.add_argument("--solvers", default="large,packed")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from balm_tpu_torch.config import SolverConfig, VoxelConfig
    from balm_tpu_torch.ops import factors as Fmod
    from balm_tpu_torch.ops import factors_windowed as FW
    from balm_tpu_torch.solver import large, lm
    from balm_tpu_torch.voxel import grid

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    R_gt, p_gt, scans = cs.make_scene(args.scans, args.seed)
    R0, p0 = cs.perturb(R_gt, p_gt, args.seed)
    R0[0], p0[0] = R_gt[0], p_gt[0]
    vres = grid.voxelize(scans, R0, p0, VoxelConfig(voxel_size=cs.VOXEL))
    fr = Fmod.recenter_bodies(vres.factors).astype(np.float32)
    del vres, scans
    wf = FW.windowed_from_numpy(FW.from_dense(fr), device=dev)
    T = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    f = Fmod.factors_from_numpy(fr, device=dev) \
        if "packed" in args.solvers else None
    print(f"{args.scans} scans: {wf.num_planes} planes, span {wf.span}; "
          f"RSME at the start rot {cs.rsme(R0, p0, R_gt, p_gt)[0]:.6e} rad,"
          f" trans {cs.rsme(R0, p0, R_gt, p_gt)[1]:.6e} m", flush=True)
    for cap in (int(x) for x in args.iters.split(",")):
        cfg = SolverConfig(max_iters=cap, min_planes_per_pose=0)
        for name in args.solvers.split(","):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "large":
                res = large.damping_iter_large(T(R0), T(p0), wf, cfg)
            else:
                res = lm.damping_iter(T(R0), T(p0), f, cfg, centered=True,
                                      backend="packed")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rot, tra = cs.rsme(res.R.cpu().numpy(), res.p.cpu().numpy(),
                               R_gt, p_gt)
            print(f"{name} cap {cap}: {res.iters} iterations, residual "
                  f"{res.trace_res1[0]:.6f} -> {res.residual:.6f}, RSME rot "
                  f"{rot:.6e} rad, trans {tra:.6e} m, {wall:.3f} s on "
                  f"{card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
