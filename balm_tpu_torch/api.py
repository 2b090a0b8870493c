"""One-call user API: voxelize -> (recenter) -> LM solve -> gauge.

Counterpart: balm_tpu/api.py:30 (optimize_poses), with its loop
closure (:50-79) and its dtype and backend dispatch (:82-94), the card
in the TPU's place: dtype None takes float32 on the card and float64
elsewhere; 'auto' takes 'large' for W > large_threshold (600), else
'packed' in float32 on the card and 'xla' otherwise.

    import balm_tpu_torch
    R1, p1, info = balm_tpu_torch.optimize_poses(scans, R0, p0)

Steps (what benchmark_realworld.cpp:144-236 does around
BALM2::damping_iter):
  0. with loop_closure=True: pipelines/loopclose.close_loops — place
     recognition with its verification GN on the device, then the pose
     graph on the host in float64 — warps the start poses first
  1. host voxelization with the native C++ engine (voxel/grid.py)
  2. float32: recenter_bodies in f64, then the cast to f32 on the device;
     float64: the raw moments
  3. the solve:
     * backend='packed' (the default on the card up to large_threshold
       scans, the JAX package's accelerator choice): solver/lm.
       damping_iter with the packed evaluate (packed_impl 'auto':
       'hybrid' from 256 scans, 'xla' below), the `csum` and
       `rows` CUDA kernels on 'cuda', their plain PyTorch versions on
       'cpu'
     * backend='xla' (the default off the card up to large_threshold):
       damping_iter over ops/factors.py's evaluators, uncentered in
       float64, centered on the recentered factors in float32
     * backend='large' (the default above large_threshold scans):
       ops/factors_windowed.from_dense on the host (the dense factors
       never reach the card), then solver/large.damping_iter_large (the
       banded solve) over the span-compressed factors on the device

It runs on the GPU unless the caller passes device='cpu'.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .config import SolverConfig, VoxelConfig
from .ops import factors as Fmod
from .ops import factors_windowed as FW
from .ops import packed_evaluate as pe
from .solver import large, lm
from .voxel import grid

def optimize_poses(
    scans,
    R,
    p,
    *,
    voxel: VoxelConfig = VoxelConfig(),
    solver: SolverConfig = SolverConfig(),
    backend: str = "auto",   # 'auto' | 'packed' ('pallas') | 'xla' | 'large'
    dtype: Optional[str] = None,    # None: 'float32' on the card
    large_threshold: int = 600,
    loop_closure: bool = False,
    loop_config=None,        # pipelines.loopclose.LoopConfig when set
    verbose: bool = False,
    device="cuda",
):
    """Bundle-adjust a pose window against self-consistent plane factors.

    scans: list of (Ni, 3) body-frame clouds; R (W,3,3), p (W,3) initial
    poses.  dtype 'float32' or 'float64' (None: 'float32' on a CUDA
    device, 'float64' elsewhere); backend 'auto' takes 'large' for
    W > large_threshold, else 'packed' in float32 on a CUDA device and
    'xla' otherwise — the JAX package's rule with the card in the TPU's
    place.  Returns (R, p, info) with R, p numpy arrays of `dtype`
    and info holding num_planes, status, iters, residual_initial,
    residual and, for the dense backends, the launch counts of the csum
    and rows CUDA kernels during this call; for 'large' instead the span
    and the host seconds of the voxelization, from_dense and the solve.

    loop_closure=True prepends place recognition and pose-graph warping
    (pipelines/loopclose.close_loops) before the BA: needed once
    cumulative drift exceeds the voxel size, where plane association
    alone never forms the revisit constraints.  Detection's GN runs on
    `device`, the pose graph on the host in float64; info["loop_closure"]
    holds n_edges, n_verified and (when edges survived) pgo_iters.  When
    no loop survives verification the input poses pass through
    unchanged.  Without loop_closure a loop_config is ignored, as in the
    JAX package.
    """
    W = len(scans)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("optimize_poses: no CUDA device; pass "
                           "device='cpu' for the plain PyTorch path")
    loop_info = None
    if loop_closure and W > 0:
        from .pipelines import loopclose as LC

        lcfg = loop_config if loop_config is not None else LC.LoopConfig()
        R, p, lc_edges, lc_info = LC.close_loops(
            scans, np.asarray(R, np.float64), np.asarray(p, np.float64),
            lcfg, verbose=verbose, device=device)
        loop_info = {
            "n_edges": 0 if lc_edges is None else int(lc_edges.i.shape[0]),
            "n_verified": lc_info.get("n_verified", 0),
        }
        if "pgo" in lc_info:
            loop_info["pgo_iters"] = lc_info["pgo"].get("iters")
    # the JAX package's rule (balm_tpu/api.py:82-93) with the card in the
    # TPU's place: float32 and 'packed' on it, float64 and 'xla' elsewhere
    on_card = device.type == "cuda"
    if dtype is None:
        dtype = "float32" if on_card else "float64"
    if dtype not in ("float32", "float64"):
        raise ValueError(f"unknown dtype {dtype!r}")
    if backend == "pallas":
        backend = "packed"
    if backend == "auto":
        if W > large_threshold:
            backend = "large"
        else:
            backend = "packed" if on_card and dtype == "float32" else "xla"
    if backend not in ("packed", "xla", "large"):
        raise ValueError(f"unknown backend {backend!r}")
    if W == 0:
        raise ValueError("optimize_poses needs at least one scan")

    R = np.asarray(R, np.float64)
    p = np.asarray(p, np.float64)
    t0 = time.perf_counter()
    vres = grid.voxelize(list(scans), R, p, voxel, dtype=np.float64)
    t_vox = time.perf_counter() - t0
    info = {"num_planes": vres.num_planes, "backend": backend,
            "evaluate": {"packed": lm.auto_impl(len(scans)),
                         "xla": "factors", "large": "windowed"}[backend],
            "dtype": dtype, "device": str(device)}
    if loop_info is not None:
        info["loop_closure"] = loop_info
    if vres.num_planes == 0:
        info["status"] = "no_planes"
        return R, p, info

    use_f32 = dtype == "float32"
    tdt = torch.float32 if use_f32 else torch.float64
    f = Fmod.recenter_bodies(vres.factors) if use_f32 else vres.factors
    if backend == "large":
        return _large(R, p, f, solver, tdt, device, info, t_vox, verbose)
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


def _large(R, p, f, solver, tdt, device, info, t_vox, verbose):
    """The 'large' backend (balm_tpu/api.py:114-127): from_dense on the
    host, only the span-compressed factors to the device, then
    damping_iter_large."""
    t0 = time.perf_counter()
    if tdt == torch.float32:
        f = f.astype(np.float32)
    wf = FW.from_dense(f)
    wft = FW.windowed_from_numpy(wf, device=device, dtype=tdt)
    t_fd = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = large.damping_iter_large(
        torch.as_tensor(R, dtype=tdt, device=device),
        torch.as_tensor(p, dtype=tdt, device=device), wft, solver)
    R1, p1 = res.R.cpu().numpy(), res.p.cpu().numpy()
    res1_0 = float(res.trace_res1[0])
    info.update(
        status="ok", iters=int(res.iters), residual=float(res.residual),
        residual_initial=res1_0 if np.isfinite(res1_0)
        else float(res.residual),
        span=int(wf.span),
        seconds={"voxelize": t_vox, "from_dense": t_fd,
                 "solve": time.perf_counter() - t0})
    if verbose:
        print(lm.format_trace(res))
    return R1, p1, info
