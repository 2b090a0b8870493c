#!/usr/bin/env python3
"""How far roundoff alone moves the corridor's first LM iterations.

    python3 scripts/corridor_roundoff.py [--W 2048] [--iters 4]
        [--threads 1,8]

Runs the first --iters iterations of damping_iter_large on the
corridor (pipelines/corridor.py, CorridorConfig's widths, W poses) on
the CPU, once per thread count in --threads: PyTorch's CPU reductions
then sum in another order, and nothing else changes.  Does so in float32
and float64 for the banded solve without and with chip_smoke.py's
odometry chain edges and for the PCG solve (CorridorConfig's cg_iters and
cg_tol), and prints each trace (res1, res2, accepted, CG iterations) and
the largest relative difference of res1 / res2 between the thread
counts.  Host CPU only; it
measures the problem's sensitivity to summation order, not a device.
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
    ap.add_argument("--W", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--threads", default="1,8")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from balm_tpu_torch.config import SolverConfig
    from balm_tpu_torch.ops import pose_graph as PG
    from balm_tpu_torch.pipelines import corridor
    from balm_tpu_torch.solver import large

    cfg = SolverConfig(max_iters=args.iters, rel_tol=1e-10,
                       min_planes_per_pose=0)
    for dtype in ("float32", "float64"):
        ccfg = corridor.CorridorConfig(W=args.W, dtype=dtype)
        R_gt, p_gt, wf = corridor.make_corridor(ccfg)
        R0, p0 = corridor.corrupt_poses(R_gt, p_gt, ccfg)
        for case in ("banded", "edges", "pcg"):
            kw = {}
            if case == "edges":
                kw["edges"] = PG.edges_from_numpy(cs.chain_edges(R0, p0),
                                                  dtype=R0.dtype)
            if case == "pcg":
                kw.update(linear_solver="pcg", cg_iters=ccfg.cg_iters,
                          cg_tol=ccfg.cg_tol)
            traces = []
            for nt in (int(t) for t in args.threads.split(",")):
                torch.set_num_threads(nt)
                r = large.damping_iter_large(R0, p0, wf, cfg, **kw)
                n = r.iters
                traces.append((r.trace_res1[:n].astype(np.float64),
                               r.trace_res2[:n].astype(np.float64),
                               r.trace_accept[:n]))
                print(f"W={args.W} {dtype} {case} threads={nt}:"
                      f" res1 {traces[-1][0].tolist()} res2 "
                      f"{traces[-1][1].tolist()} accept "
                      f"{traces[-1][2].tolist()} CG "
                      f"{r.trace_cg[:n].tolist()}", flush=True)
            a, b = traces[0], traces[-1]
            n = min(len(a[0]), len(b[0]))
            for k, name in ((0, "res1"), (1, "res2")):
                rel = np.abs(a[k][:n] - b[k][:n]) / np.abs(b[k][:n])
                print(f"  {name} max rel difference between thread counts "
                      f"{rel.max():.3e} (per iteration "
                      f"{[f'{x:.1e}' for x in rel]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
