"""Real-world benchmark — the reference's `benchmark_realworld` experiment.

Counterpart: balm_tpu/pipelines/realworld.py (RealworldConfig :37,
load :75, run :93); reference src/benchmark/benchmark_realworld.cpp:
144-236:
  1. load alidarPose.csv + full{i}.pcd scans (io/poses.py, io/pcd.py)
  2. re-anchor the trajectory to pose 0 (lines 163-168), host f64 numpy
  3. adaptive voxelization: on the card (voxel/device.py) when the solve
     is centered f32 on a CUDA device and nothing on the host needs the
     per-point association; the host voxelizer (voxel/grid.py) otherwise
  4. degeneracy gate: >= 3 planes per pose on average (lines 209-215)
  5. BALM2 damped-Newton refinement, max 10 iterations (line 218); on the
     card the recentered f32 solve is the packed path (kernels B1 `csum`
     and B2 `rows`)
  6. with `export_dir`: a second, timed solve, and the refined poses,
     the convergence curve and the coloured plane cloud written there

The interactive rviz gates (lines 174-176, 203-207) become the returned
summary dict.  `run` works on the card unless the caller passes
device='cpu'; the device association never falls back to the host
voxelizer (its capacity retry is the JAX package's, and is logged in
`assoc_attempts_s`).

With `mesh_devices` N > 1 (or an explicit `mesh=`) the solve is
factor-parallel (JAX :181-235): the factors are plane-sharded over the
mesh (parallel/sharded.py) and the LM runs the 'xla' evaluator per
shard, whatever `backend` says ('auto', 'packed', 'pallas' -> 'xla', as
JAX's mesh path).  On device='cuda' the mesh is the first N visible
cards, and fewer raise, as JAX's visible-devices check; on 'cpu' it is N
virtual CPU shards.  `mesh=` takes any mesh, e.g. virtual shards of one
card (sharded.make_mesh(devices=[torch.device('cuda')] * 4)), the
counterpart of JAX's process-global device list.
"""

from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import SolverConfig, VoxelConfig
from ..io import pcd, planecloud, poses
from ..ops import factors as Fmod
from ..parallel import sharded
from ..solver import lm
from ..utils import checkpoint
from ..voxel import device as vdev
from ..voxel import grid
from ..voxel import merge as merge_mod


@dataclasses.dataclass
class RealworldConfig:
    # the reference repository's dataset folder, relative to the working
    # directory
    data_dir: str = "datas/benchmark_realworld"
    max_scans: Optional[int] = None    # None = all 177
    voxel: VoxelConfig = VoxelConfig(
        voxel_size=1.0, eigen_ratio=(1.0 / 16, 1.0 / 16, 1.0 / 9))
    solver: SolverConfig = SolverConfig(max_iters=10, u_init=0.01)
    dtype: str = "float64"
    centered: bool = False     # enable for the f32 fast path
    downsample: float = 0.0    # optional voxel downsample of input scans
    # fuse coplanar leaves into single factors before the solve
    # (VOXEL_MERGE, bavoxel.hpp:484-624)
    merge_planes: bool = False
    # write the refined trajectory (reference CSV format), the
    # convergence curve and the plane cloud here
    export_dir: Optional[str] = None
    # solver backend: 'auto' takes the packed path for a centered f32
    # solve on a CUDA device, the XLA-formulated evaluator otherwise
    backend: str = "auto"
    # association backend: 'auto' (the device voxelizer for a centered
    # f32 solve on a CUDA device with no host consumers of the per-point
    # maps — merge, stages, export — and a key that fits; the host
    # engine otherwise), 'device', 'native' or 'numpy'
    assoc_backend: str = "auto"
    # factor-parallel execution over N devices (0 or 1: one device)
    mesh_devices: int = 0
    # coarse-to-fine stages (coarse_to_fine.default_stages() or a list of
    # VoxelConfig); None = single resolution at `voxel`
    stages: Optional[Sequence[VoxelConfig]] = None


def _visible_mesh(n, device):
    """n shards: the first n visible cards on device 'cuda' (fewer raise,
    JAX :186-191's check), n virtual shards of the CPU on 'cpu'."""
    if device.type != "cuda":
        return sharded.make_mesh(devices=[device] * n)
    count = torch.cuda.device_count()
    if count < n:
        raise ValueError(
            f"mesh_devices={n} but only {count} devices visible (pass "
            f"mesh=sharded.make_mesh(devices=[torch.device('cuda')] * {n}) "
            f"for virtual shards of one card, or device='cpu' for a "
            f"virtual CPU mesh)")
    return sharded.make_mesh(n)


def load(cfg: RealworldConfig):
    """Load poses + scans (host f64 numpy), re-anchored to pose 0."""
    d = pathlib.Path(cfg.data_dir)
    R, p, _ = poses.read_pose_csv(d / "alidarPose.csv", cfg.max_scans)
    scans = []
    for i in range(len(R)):
        pts = pcd.read_pcd_xyz(d / f"full{i}.pcd", np.float64)
        if cfg.downsample > 0:
            pts = grid.down_sample_voxel(pts, cfg.downsample)
        scans.append(pts)
    # gauge anchor (benchmark_realworld.cpp:163-168)
    R0, p0 = R[0].copy(), p[0].copy()
    p = (p - p0) @ R0
    R = np.einsum("ba,nbc->nac", R0, R)
    return R, p, scans


def run(cfg: RealworldConfig = RealworldConfig(), *, verbose: bool = False,
        device="cuda", mesh=None):
    """The experiment on `device`; returns its summary dict (status,
    planes, iterations, residuals, the LMResult, and the load,
    association and solve seconds; with a mesh also mesh_devices and
    planes_per_shard).  mesh: a parallel.sharded.Mesh for the
    factor-parallel solve (default: the one cfg.mesh_devices asks
    for)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("realworld.run: no CUDA device; pass "
                           "device='cpu' for the plain PyTorch path")
    if (mesh is not None and cfg.mesh_devices > 1
            and mesh.size != cfg.mesh_devices):
        raise ValueError(f"mesh_devices={cfg.mesh_devices} but the mesh "
                         f"has {mesh.size} shards")
    tdt = getattr(torch, cfg.dtype)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    R, p, scans = load(cfg)
    W = len(scans)
    t_load = time.perf_counter() - t0

    stage_history = None
    if cfg.stages is not None:
        # every stage but the last re-associates at the refined poses;
        # the final stage below is the single-resolution pipeline
        from . import coarse_to_fine as c2f

        R, p, stage_history = c2f.run(
            scans, R, p, list(cfg.stages), cfg.solver, dtype=cfg.dtype,
            centered=cfg.centered, verbose=verbose, device=device)

    assoc = cfg.assoc_backend
    needs_host_assoc = (cfg.merge_planes or cfg.export_dir is not None
                        or cfg.stages is not None
                        or not cfg.centered or tdt != torch.float32)
    # the device voxelizer packs the scan id into the sort key
    device_key_ok = (max(W - 1, 1).bit_length()
                     + 3 * cfg.voxel.layer_limit) <= 16
    if assoc == "auto":
        assoc = ("device" if (device.type == "cuda" and device_key_ok
                              and not needs_host_assoc) else "host")
    elif assoc == "device" and needs_host_assoc:
        raise ValueError(
            "assoc_backend='device' supports the plain centered-f32 solve "
            "path only (merge/stages/export consume host per-point maps)")

    merged_planes = None
    attempts = None
    if assoc == "device":
        t0 = time.perf_counter()
        dres = vdev.voxelize_device(
            [s.astype(np.float32) for s in scans], R.astype(np.float32),
            p.astype(np.float32), cfg.voxel, want_point_leaf=False,
            device=device)
        num_planes = int(dres.num_planes)
        # the padding rows are exactly zero: the solve sweeps only the
        # admitted planes
        f = vdev.trim_planes(dres.factors, num_planes)
        sync()
        t_assoc = time.perf_counter() - t0
        attempts = [a["seconds"] for a in dres.attempts]
        vres = None
    else:
        t0 = time.perf_counter()
        vres = grid.voxelize(
            scans, R, p, cfg.voxel, dtype=np.float64,
            backend=assoc if assoc in ("native", "numpy") else "auto")
        t_assoc = time.perf_counter() - t0
        f = vres.factors
        num_planes = vres.num_planes
        if cfg.merge_planes:
            f, merged_planes, _ = merge_mod.merge_coplanar(f, num_planes)
            num_planes = merged_planes
        if cfg.centered:
            f = Fmod.recenter_bodies(f)
        f = Fmod.factors_from_numpy(f, device=device, dtype=tdt)

    summary = {
        "num_scans": W,
        "num_points": int(sum(len(s) for s in scans)),
        "num_planes": num_planes,
        "merged_planes": merged_planes,
        "assoc_backend": assoc,
        "assoc_attempts_s": attempts,
        "t_load_s": t_load,
        "t_assoc_s": t_assoc,
        "stage_history": stage_history,
    }
    # degeneracy gate (benchmark_realworld.cpp:209-215)
    if num_planes < 3 * W:
        summary["status"] = "too_few_planes"
        return summary

    backend = cfg.backend
    f_solve = f
    if mesh is None and cfg.mesh_devices > 1:
        mesh = _visible_mesh(cfg.mesh_devices, device)
    if mesh is not None:
        f_solve = sharded.shard_factors(f, mesh)
        if backend in ("auto", "packed", "pallas"):
            backend = "xla"      # the mesh path runs the 'xla' evaluator
        summary.update(mesh_devices=mesh.size,
                       planes_per_shard=f_solve.num_planes // mesh.size)
    if backend == "auto":
        backend = ("packed" if (device.type == "cuda" and cfg.centered
                                and tdt == torch.float32) else "xla")
    Rt = torch.tensor(R, dtype=tdt, device=device)
    pt = torch.tensor(p, dtype=tdt, device=device)
    Rs, ps, devs = Rt, pt, {device}
    if mesh is not None:
        Rs, ps = sharded.replicate(Rt, mesh), sharded.replicate(pt, mesh)
        devs |= set(mesh.devices)
    sync_solve = lambda: [torch.cuda.synchronize(d) for d in devs
                          if d.type == "cuda"]
    sync_solve()
    t0 = time.perf_counter()
    res = lm.damping_iter(Rs, ps, f_solve, cfg.solver, centered=cfg.centered,
                          backend=backend)
    sync_solve()
    t_solve = time.perf_counter() - t0

    summary.update(
        status="degenerate" if res.degenerate else "ok",
        backend=backend,
        t_solve_s=t_solve,
        iters=int(res.iters),
        residual_final=float(res.residual),
        residual_initial=float(res.trace_res1[0]),
        result=res,
    )

    if cfg.export_dir is not None:
        # real per-iteration timestamps: a second, timed solve (on the
        # unsharded factors, as JAX's)
        res_t, t_iter = lm.damping_iter_timed(
            Rt, pt, f, cfg.solver, centered=cfg.centered, backend=backend)
        out = pathlib.Path(cfg.export_dir)
        out.mkdir(parents=True, exist_ok=True)
        checkpoint.write_pose_csv(out / "refined_poses.csv", res.R, res.p)
        # the Supplementary/data format: "cumulative_time(s) cost" per
        # accepted iteration (Supplementary/data/readme.txt)
        n = int(res_t.iters)
        accepted = res_t.trace_accept[:n] > 0.5
        costs = res_t.trace_res2[:n][accepted]
        tstamps = np.asarray(t_iter)[:n][accepted]
        with open(out / "convergence.txt", "w") as fh:
            fh.write(f"0.0 {float(res_t.trace_res1[0]):.6f}\n")
            for tk, cst in zip(tstamps, costs):
                fh.write(f"{tk:.4f} {cst:.6f}\n")
        # the coloured per-leaf plane cloud (bavoxel.hpp:825-871)
        planecloud.export_plane_cloud(
            scans, res.R.cpu().numpy(), res.p.cpu().numpy(),
            vres.point_scan, vres.point_leaf, out / "plane_cloud")
        summary["export_dir"] = str(out)
    if verbose:
        print(lm.format_trace(res))
        for k, v in summary.items():
            if k != "result":
                print(f"  {k}: {v}")
    return summary
