#!/usr/bin/env python3
"""Where the port's association on the GPU (voxel/device.py) spends its
time.

    python3 scripts/profile_assoc.py [--seed 0] [--scans 256] [--top 20]

Builds chip_smoke.py's synthetic scene (256 scans, ~7.7 M points) with
pose 0 exact, as chip_smoke.py's phase 9 writes it, pads the scans on the
card, runs one warm-up voxelize_device and profiles a second one with
torch.profiler (CPU + CUDA activities):
the device-side operations by device time (the first --top), the call's
wall ms (its capacity retry included), its attempts, the summed device
time and the device idle share (1 - device time / wall time).  Then the
host voxelizer (native engine) on the same scans, by wall clock.  The
card's name and power limit come first.  Needs one CUDA card.
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scans", type=int, default=256)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    import chip_smoke as cs
    from balm_tpu_torch.config import VoxelConfig
    from balm_tpu_torch.voxel import device as vdev
    from balm_tpu_torch.voxel import grid

    print(f"card: {cs.card_line()}", flush=True)
    dev = torch.device("cuda", 0)
    R_gt, p_gt, scans = cs.make_scene(args.scans, args.seed)
    R0, p0 = cs.perturb(R_gt, p_gt, args.seed)
    R0[0], p0[0] = R_gt[0], p_gt[0]
    vcfg = VoxelConfig(voxel_size=cs.VOXEL)
    body, mask = vdev.pad_scans([s.astype(np.float32) for s in scans])
    pad = (torch.tensor(body, device=dev), torch.tensor(mask, device=dev))
    R32, p32 = R0.astype(np.float32), p0.astype(np.float32)
    cuda = torch.autograd.DeviceType.CUDA
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    run = lambda: vdev.voxelize_device(pad, R32, p32, vcfg,
                                       want_point_leaf=False)
    run()                                                    # warm-up
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((_device_us(e), e.count, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == cuda
                   and _device_us(e) > 0), reverse=True)
    dev_ms = sum(r[0] for r in rows) / 1e3
    for us, n, key in rows[:args.top or None]:
        print(f"{us / 1e3:10.3f} ms {n:6d} x  {key[:110]}", flush=True)
    att = [(round(a["seconds"] * 1e3, 3), a["overflow"], a["Gcap"])
           for a in res.attempts]
    print(f"voxelize_device: N={body.shape[0] * body.shape[1]}, planes "
          f"{int(res.num_planes)}, attempts (ms, overflow, Gcap) {att}, "
          f"wall {wall_ms:.3f} ms under the profiler, device time "
          f"{dev_ms:.3f} ms, device idle share "
          f"{1.0 - dev_ms / wall_ms:.3f}", flush=True)
    t0 = time.perf_counter()
    h = grid.voxelize(scans, R0, p0, vcfg)
    print(f"host voxelize (native): {h.num_planes} planes, "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms wall", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
