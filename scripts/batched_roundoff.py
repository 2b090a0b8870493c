#!/usr/bin/env python3
"""How far roundoff-sized changes of the start move the f32
device-batched hierarchy.

    python3 scripts/batched_roundoff.py [--W 48] [--trials 4]
        [--scale 1e-7]

Runs hierarchical.run_device_batched (block 16, one cycle) on the first
--W scans of chip_smoke.py's W=400 corridor (scripts/hba_demo.
make_corridor(400, seed=1) from perturb_drift(seed=2)) on the CPU, once
from that start and once from each of --trials starts moved by
--scale (rad and m, normal draws per pose), and prints each run's block
and anchor plane counts and its largest pose difference from the first
run.  The f32 block solves carry such differences along the corridor's
weak modes, and the anchor association then admits other borderline
planes.  Host CPU only; it measures the problem's sensitivity, not a
device.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--W", type=int, default=48)
    ap.add_argument("--trials", type=int, default=4)
    ap.add_argument("--scale", type=float, default=1e-7)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from balm_tpu_torch.ops import lie
    from balm_tpu_torch.pipelines import hierarchical

    W = args.W
    R_gt, p_gt, scans = cs.make_hba_corridor(400, seed=1)
    R0, p0 = cs.perturb_drift(R_gt, p_gt, seed=2)
    R0, p0, scans = R0[:W], p0[:W], scans[:W]

    def run(R, p):
        return hierarchical.run_device_batched(scans, R, p, block=16,
                                               cycles=1, device="cpu")

    Rb, pb, ib = run(R0, p0)
    print(f"start: block planes {ib['block_planes']}, anchor planes "
          f"{ib['top_planes']}")
    for k in range(args.trials):
        rng = np.random.default_rng(100 + k)
        dR = lie.so3_exp(torch.as_tensor(
            rng.normal(0, args.scale, (W, 3)))).numpy()
        R1 = np.einsum("wab,wbc->wac", R0, dR)
        p1 = p0 + rng.normal(0, args.scale, (W, 3))
        Rk, pk, ik = run(R1, p1)
        print(f"start moved by {args.scale:g} (draw {k}): block planes "
              f"{ik['block_planes']}, anchor planes {ik['top_planes']}, "
              f"poses {float(np.max(np.abs(Rk - Rb))):.3e} (R) "
              f"{float(np.max(np.abs(pk - pb))):.3e} (p) from the first")
    return 0


if __name__ == "__main__":
    sys.exit(main())
