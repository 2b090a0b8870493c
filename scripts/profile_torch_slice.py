#!/usr/bin/env python3
"""Where an LM solve of the PyTorch/CUDA port spends its time on the GPU.

    python3 scripts/profile_torch_slice.py [--seed 0] [--scans 256]
        [--impls hybrid,xla,pallas,pallas2,pallas3,chunk2048,xla32,f64]
        [--top 0]

Builds chip_smoke.py's synthetic scene (256 scans, ~7.7 M points),
voxelizes and packs.  Then for each evaluate in --impls (a damping_iter
packed_impl, chunkN for chunk_planes=N, xla32 for the f32 centered
backend='xla' solve, f64 for the float64 backend='xla' solve of
optimize_poses(dtype='float64') on the raw moments) it runs one warm-up
`damping_iter` and profiles a second one with torch.profiler (CPU + CUDA
activities).  Per impl it prints the device-side operations by device
time (the first --top of them; 0 = all), then the solve's wall ms and
iterations, the summed device time and the device idle share (1 - device
time / wall time; one stream, so kernels do not overlap).  The card's
name and power limit come first.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_solve(impl, opts, R0t, p0t, f, num_planes, top):
    import torch

    from balm_tpu_torch.config import SolverConfig
    from balm_tpu_torch.solver import lm

    lm.damping_iter(R0t, p0t, f, SolverConfig(), **opts)    # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = lm.damping_iter(R0t, p0t, f, SolverConfig(), **opts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): the CPU ops that launch
    # them carry the same time again
    cuda = torch.autograd.DeviceType.CUDA
    rows = sorted(((_device_us(e), e.count, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == cuda
                   and _device_us(e) > 0), reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3
    print(f"== {impl} {opts}", flush=True)
    for us, n, key in rows[:top or None]:
        print(f"{us / 1e3:10.3f} ms {n:6d} x  {key[:120]}", flush=True)
    print(f"{impl}: planes {num_planes}, iterations {res.iters}, solve wall "
          f"{wall_ms:.3f} ms under the profiler, device time "
          f"{dev_ms:.3f} ms, device idle share "
          f"{1.0 - dev_ms / wall_ms:.3f}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scans", type=int, default=256)
    ap.add_argument("--impls", default="hybrid")
    ap.add_argument("--top", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    import chip_smoke as cs
    from balm_tpu_torch.config import VoxelConfig
    from balm_tpu_torch.ops import factors as Fmod
    from balm_tpu_torch.voxel import grid

    card = cs.card_line()
    dev = torch.device("cuda", 0)
    R_gt, p_gt, scans = cs.make_scene(args.scans, args.seed)
    R0, p0 = cs.perturb(R_gt, p_gt, args.seed)
    vres = grid.voxelize(scans, R0, p0, VoxelConfig(voxel_size=cs.VOXEL))
    f = Fmod.factors_from_numpy(Fmod.recenter_bodies(vres.factors),
                                device=dev)
    R0t = torch.tensor(R0, dtype=torch.float32, device=dev)
    p0t = torch.tensor(p0, dtype=torch.float32, device=dev)
    print(f"card: {card}", flush=True)
    packed = dict(centered=True, backend="packed")
    for impl in args.impls.split(","):
        if impl == "f64":
            f64 = torch.float64
            profile_solve(impl, dict(backend="xla"),
                          torch.tensor(R0, dtype=f64, device=dev),
                          torch.tensor(p0, dtype=f64, device=dev),
                          Fmod.factors_from_numpy(vres.factors, device=dev,
                                                  dtype=f64),
                          vres.num_planes, args.top)
            continue
        if impl == "xla32":
            opts = dict(centered=True, backend="xla")
        elif impl.startswith("chunk"):
            opts = dict(packed, chunk_planes=int(impl[5:]))
        else:
            opts = dict(packed, packed_impl=impl)
        profile_solve(impl, opts, R0t, p0t, f, vres.num_planes, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
