"""One-call user API: voxelize -> (recenter) -> LM solve -> gauge.

Counterpart: balm_tpu/api.py:30 (optimize_poses).

    import balm_tpu_torch
    R1, p1, info = balm_tpu_torch.optimize_poses(scans, R0, p0)

Steps (what benchmark_realworld.cpp:144-236 does around
BALM2::damping_iter):
  1. host voxelization with the native C++ engine (voxel/grid.py)
  2. float32: recenter_bodies in f64, then the cast to f32 on the device;
     float64: the raw moments
  3. solver/lm.damping_iter with
     * backend='packed' (the float32 default, the JAX package's
       accelerator choice): the hybrid packed evaluate, the `csum` and
       `rows` CUDA kernels on 'cuda', their plain PyTorch versions on
       'cpu'
     * backend='xla' (the float64 default): ops/factors.py's evaluators,
       uncentered in float64, centered on the recentered factors in
       float32

It runs on the GPU unless the caller passes device='cpu'.  The JAX
package's other paths (backend='large', loop closure) are not ported yet
and raise NotImplementedError.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import SolverConfig, VoxelConfig
from .ops import factors as Fmod
from .ops import packed_evaluate as pe
from .solver import lm
from .voxel import grid

_ROADMAP = "not ported yet (ROADMAP.md, queue A)"


def optimize_poses(
    scans,
    R,
    p,
    *,
    voxel: VoxelConfig = VoxelConfig(),
    solver: SolverConfig = SolverConfig(),
    backend: str = "auto",   # 'auto' | 'packed' (alias 'pallas') | 'xla'
    dtype: Optional[str] = None,    # None = 'float32'
    loop_closure: bool = False,
    loop_config=None,
    verbose: bool = False,
    device="cuda",
):
    """Bundle-adjust a pose window against self-consistent plane factors.

    scans: list of (Ni, 3) body-frame clouds; R (W,3,3), p (W,3) initial
    poses.  dtype 'float32' (default) or 'float64'; backend 'auto' takes
    'packed' in float32 and 'xla' in float64.  Returns (R, p, info) with
    R, p numpy arrays of `dtype` and info holding num_planes, status,
    iters, residual_initial, residual and the launch counts of the csum
    and rows CUDA kernels during this call.
    """
    W = len(scans)
    if loop_closure or loop_config is not None:
        raise NotImplementedError(f"loop_closure is {_ROADMAP}")
    if dtype is None:
        dtype = "float32"
    if dtype not in ("float32", "float64"):
        raise ValueError(f"unknown dtype {dtype!r}")
    if backend == "pallas":
        backend = "packed"
    if backend == "auto":
        backend = "packed" if dtype == "float32" else "xla"
    if backend == "large":
        raise NotImplementedError(f"backend={backend!r} is {_ROADMAP}")
    if backend not in ("packed", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    if W == 0:
        raise ValueError("optimize_poses needs at least one scan")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("optimize_poses: no CUDA device; pass "
                           "device='cpu' for the plain PyTorch path")

    R = np.asarray(R, np.float64)
    p = np.asarray(p, np.float64)
    vres = grid.voxelize(list(scans), R, p, voxel, dtype=np.float64)
    info = {"num_planes": vres.num_planes, "backend": backend,
            "evaluate": "hybrid" if backend == "packed" else "factors",
            "dtype": dtype, "device": str(device)}
    if vres.num_planes == 0:
        info["status"] = "no_planes"
        return R, p, info

    use_f32 = dtype == "float32"
    tdt = torch.float32 if use_f32 else torch.float64
    f = Fmod.recenter_bodies(vres.factors) if use_f32 else vres.factors
    ft = Fmod.factors_from_numpy(f, device=device, dtype=tdt)
    launches0 = (pe.csum_packed.launches, pe.rows_packed.launches)
    res = lm.damping_iter(
        torch.as_tensor(R, dtype=tdt, device=device),
        torch.as_tensor(p, dtype=tdt, device=device),
        ft, solver, centered=use_f32, backend=backend)
    res1_0 = float(res.trace_res1[0])
    info.update(
        status="degenerate" if res.degenerate else "ok",
        iters=int(res.iters), residual=float(res.residual),
        # trace_res1[0] is unwritten (NaN) when the loop never iterated
        residual_initial=res1_0 if np.isfinite(res1_0)
        else float(res.residual),
        launches={"csum": pe.csum_packed.launches - launches0[0],
                  "rows": pe.rows_packed.launches - launches0[1]})
    if verbose:
        print(lm.format_trace(res))
    return res.R.cpu().numpy(), res.p.cpu().numpy(), info
