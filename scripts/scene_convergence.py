#!/usr/bin/env python3
"""How the port's f32 packed solve converges on chip_smoke.py's scene,
with the device and the host association side by side.

    python3 scripts/scene_convergence.py [--seed 0] [--scans 256]
        [--iters 10,150] [--pose0 exact,perturbed] [--device cuda]

For each --pose0 the scene's perturbed poses are re-anchored to pose 0
as realworld.load does: 'exact' keeps pose 0 at the ground truth
(chip_smoke.py phase 9's file), 'perturbed' keeps its 2 deg / 0.1 m
error, which turns the world frame, and with it the voxel grid, against
the scene's patches.  Both associations run (voxel/device.py on the
device, grid.voxelize on the host, both recentered f32), and for each
--iters a damping_iter(backend='packed') from each; printed: the plane
counts, the residual before and after, and the rotation / translation
RSME against the re-anchored ground truth.  --device cpu runs the plain
versions (slow at 256 scans).  The card's name and power limit come
first when there is one.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scans", type=int, default=256)
    ap.add_argument("--iters", default="10,150")
    ap.add_argument("--pose0", default="exact,perturbed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from balm_tpu_torch.config import SolverConfig, VoxelConfig
    from balm_tpu_torch.ops import factors as Fmod
    from balm_tpu_torch.solver import lm
    from balm_tpu_torch.voxel import device as vdev
    from balm_tpu_torch.voxel import grid

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("FAIL: no CUDA device", flush=True)
            return 1
        print(f"card: {cs.card_line()}", flush=True)
    vcfg = VoxelConfig(voxel_size=cs.VOXEL)
    R_gt, p_gt, scans = cs.make_scene(args.scans, args.seed)
    R0, p0 = cs.perturb(R_gt, p_gt, args.seed)
    Rg, pg = cs.anchor(R_gt, p_gt)
    for pose0 in args.pose0.split(","):
        Rw, pw = R0.copy(), p0.copy()
        if pose0 == "exact":
            Rw[0], pw[0] = R_gt[0], p_gt[0]
        R, p = cs.anchor(Rw, pw)
        d = vdev.voxelize_device([s.astype(np.float32) for s in scans],
                                 R.astype(np.float32), p.astype(np.float32),
                                 vcfg, want_point_leaf=False, device=dev)
        n_d = int(d.num_planes)
        h = grid.voxelize(scans, R, p, vcfg)
        factors = {"device": vdev.trim_planes(d.factors, n_d),
                   "host": Fmod.factors_from_numpy(
                       Fmod.recenter_bodies(h.factors), device=dev)}
        print(f"pose0={pose0}: planes device {n_d}, host {h.num_planes}",
              flush=True)
        T = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
        for iters in (int(x) for x in args.iters.split(",")):
            for name, f in factors.items():
                res = lm.damping_iter(T(R), T(p), f,
                                      SolverConfig(max_iters=iters),
                                      centered=True, backend="packed")
                rs0 = cs.rsme(R, p, Rg, pg)
                rs1 = cs.rsme(res.R.cpu().numpy(), res.p.cpu().numpy(),
                              Rg, pg)
                print(f"  {name} association, max_iters {iters}: "
                      f"{res.iters} iters, residual "
                      f"{res.trace_res1[0]:.6f} -> {res.residual:.6f}; "
                      f"RSME rot {rs0[0]:.6e} -> {rs1[0]:.6e} rad, trans "
                      f"{rs0[1]:.6e} -> {rs1[1]:.6e} m", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
