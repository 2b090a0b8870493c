#!/usr/bin/env python3
"""Where a large-window solve of the PyTorch/CUDA port spends its time on
the GPU.

    python3 scripts/profile_large.py [--W 2048] [--solvers banded,pcg,edges]
        [--top 25]

Builds the corridor (pipelines/corridor.py, CorridorConfig's published
widths, W poses, f32) and its corrupted initialization.  For each solver
(damping_iter_large with linear_solver 'banded' or 'pcg'; 'edges' is the
banded solve with chip_smoke.py's odometry chain edges) it runs one
warm-up solve, then profiles a second one with torch.profiler (CPU + CUDA
activities) and prints the device-side operations by device time (the
first --top; 0 = all), the solve's wall ms, iterations, ms per LM
iteration, the summed device time, the device idle share (1 - device
time / wall time; one stream) and the peak device memory of an
unprofiled third solve above what was allocated before it.  The card's
name and power limit come first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from profile_torch_slice import _device_us  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--W", type=int, default=2048)
    ap.add_argument("--solvers", default="banded,pcg,edges")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    import chip_smoke as cs
    from balm_tpu_torch.config import SolverConfig
    from balm_tpu_torch.ops import pose_graph as PG
    from balm_tpu_torch.pipelines import corridor
    from balm_tpu_torch.solver import large

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    ccfg = corridor.CorridorConfig(W=args.W)
    R_gt, p_gt, wf = corridor.make_corridor(ccfg, device=dev)
    R0, p0 = corridor.corrupt_poses(R_gt, p_gt, ccfg)
    cfg = SolverConfig(max_iters=ccfg.max_iters, rel_tol=1e-10,
                       min_planes_per_pose=0)
    print(f"corridor W={args.W}: {wf.num_planes} planes, span {wf.span}",
          flush=True)
    for name in args.solvers.split(","):
        kw = dict(cg_iters=ccfg.cg_iters, cg_tol=ccfg.cg_tol)
        if name == "edges":
            kw["edges"] = PG.edges_from_numpy(
                cs.chain_edges(R0.cpu(), p0.cpu()), device=dev,
                dtype=torch.float32)
        else:
            kw["linear_solver"] = name
        large.damping_iter_large(R0, p0, wf, cfg, **kw)       # warm-up
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            res = large.damping_iter_large(R0, p0, wf, cfg, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        cuda = torch.autograd.DeviceType.CUDA
        rows = sorted(((_device_us(e), e.count, e.key)
                       for e in prof.key_averages()
                       if getattr(e, "device_type", None) == cuda
                       and _device_us(e) > 0), reverse=True)
        dev_ms = sum(r[0] for r in rows) / 1e3
        print(f"== {name}", flush=True)
        for us, n, key in rows[:args.top or None]:
            print(f"{us / 1e3:10.3f} ms {n:6d} x  {key[:120]}", flush=True)
        _, ms, peak = cs.timed_large(R0, p0, wf, cfg, **kw)
        print(f"{name}: iterations {res.iters}, residual "
              f"{res.trace_res1[0]:.6f} -> {res.residual:.6f}, solve wall "
              f"{wall_ms:.3f} ms under the profiler ({wall_ms / res.iters:.3f}"
              f" ms per iteration), device time {dev_ms:.3f} ms, device "
              f"idle share {1.0 - dev_ms / wall_ms:.3f}; unprofiled "
              f"{ms:.3f} ms per iteration, peak {peak / 2**20:.2f} MiB "
              f"above the resident factors, on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
