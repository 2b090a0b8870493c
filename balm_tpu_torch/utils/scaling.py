"""Scaling-efficiency harness: LM iterations per second against shard count.

Counterpart: balm_tpu/utils/scaling.py (measure :24).  BASELINE.md's
target is >= 80% scaling efficiency at 4 hosts.  The harness runs the
same factor problem factor-sharded over meshes of 1, 2, ..., N shards
(parallel/sharded.py) and reports iterations per second and the
efficiency.  Shards on distinct cards measure scaling; virtual shards of
one card (a device repeated in `devices`) run one after another on it,
so they measure the sharding's overhead, not scaling; on the CPU the
numbers say nothing of a device.
"""

from __future__ import annotations

import time
from typing import List, Optional

import torch

from ..config import SolverConfig
from ..ops.factors import PlaneFactors
from ..parallel import sharded
from ..solver import lm


def measure(R, p, f: PlaneFactors, device_counts: Optional[List[int]] = None,
            solver_cfg: SolverConfig = SolverConfig(max_iters=10, u_init=0.01,
                                                    rel_tol=0.0,
                                                    min_planes_per_pose=1),
            *, centered: bool = False, repeats: int = 3, devices=None):
    """Returns a list of dicts {devices, iters_per_sec, efficiency,
    speedup_vs_base, residual}, one per count.

    devices: the pool the meshes take their first nd devices from (the
    visible cards by default; repeat a device for virtual shards);
    device_counts defaults to the powers of two up to the pool's size.
    Each count runs one untimed solve, then `repeats` timed ones (host
    clock, synchronized on the card), the best kept."""
    pool = sharded.make_mesh(devices=devices).devices
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(pool)]

    def solve(Rr, pr, fs):
        out = lm.damping_iter(Rr, pr, fs, solver_cfg, centered=centered)
        for d in set(fs.mesh.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return out

    results = []
    base_ips = None
    for nd in device_counts:
        mesh = sharded.make_mesh(nd, devices=pool)
        fs = sharded.shard_factors(f, mesh)
        Rr = sharded.replicate(R, mesh)
        pr = sharded.replicate(p, mesh)
        res = solve(Rr, pr, fs)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            res = solve(Rr, pr, fs)
            best = min(best, time.perf_counter() - t0)
        ips = max(int(res.iters), 1) / best
        if base_ips is None:
            base_ips = ips
        # efficiency relative to LINEAR scaling from the first measured
        # count: ips(base) * (nd / base_nd).  (The round-1 form divided
        # by nd as if the baseline were 1 device, reporting wrong numbers
        # whenever device_counts didn't start at 1.)
        results.append({
            "devices": nd,
            "iters_per_sec": ips,
            "efficiency": ips / (base_ips * nd / device_counts[0]),
            "speedup_vs_base": ips / base_ips,
            "residual": float(res.residual),
        })
    return results
