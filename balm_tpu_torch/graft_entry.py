"""Entry points: one evaluation, and a dry run of every multi-device path.

Counterpart: the repository's root __graft_entry__.py (entry, the
single-chip forward evaluation; dryrun_multichip, the mesh-sharded LM
step, the plane-sharded large-window solve and the pose-sharded one).

    python -m balm_tpu_torch.graft_entry [n] [--cpu]

runs entry() and dryrun_multichip(n) (n virtual CPU shards with --cpu,
else n shards over the visible cards, virtual shards of them when there
are fewer).
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def _make_problem(win_size=20, surf_size=64, pts_size=40, dtype="float32",
                  seed=0, device="cuda"):
    from .pipelines import virtual

    cfg = virtual.VirtualConfig(win_size=win_size, surf_size=surf_size,
                                pts_size=pts_size, seed=seed, dtype=dtype)
    R_gt, p_gt, body = virtual.generate(cfg)
    R0, p0 = virtual.perturb(R_gt, p_gt, cfg)
    dt = getattr(torch, dtype)
    f = virtual.build_factors(body, dt, device)
    T = lambda x: torch.tensor(x, dtype=dt, device=device)
    return T(R0), T(p0), f


def entry(device="cuda"):
    """(fn, example_args): one second-order BA evaluation — the forward
    pass (residual, gradient, Hessian over the pose window) on
    virtual.generate's (20 scans, 64 planes, 40 points) problem in f32."""
    from .ops import factors, lie

    R, p, f = _make_problem(device=device)

    def fn(R, p, f):
        T = lie.pose_matrix(R, p)
        return factors.evaluate(T, f)

    return fn, (R, p, f)


def _devices(n_devices, devices):
    """n shards: the given devices, or the first n visible cards, the
    cards repeated (virtual shards) when fewer are visible."""
    if devices is not None:
        return list(devices)[:n_devices]
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device; pass "
                           "devices=[torch.device('cpu')] * n")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n_devices)]


def _finite(what, res, ok=True):
    if not (ok and np.isfinite(res.residual)):
        raise RuntimeError(f"dryrun_multichip: {what} is not finite "
                           f"(residual {res.residual})")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The three multi-device paths over n shards, each with finite
    results: (1) the factor-sharded LM step (lm.damping_iter); (2) the
    plane-sharded damping_iter_large (its default banded solve) on
    CorridorConfig(W=16, pts=10, max_iters=2, cg_iters=20); (3) the pose-sharded LM on
    CorridorConfig(W=8n, pts=8, vis=1.6, pillar_spacing=2.0)."""
    from .config import SolverConfig
    from .parallel import pose_sharded, sharded
    from .pipelines import corridor
    from .solver import large, lm

    mesh = sharded.make_mesh(n_devices, devices=_devices(n_devices,
                                                         devices))
    home = mesh.home
    R, p, f = _make_problem(win_size=6, surf_size=4 * n_devices,
                            pts_size=20, device=home)
    res = lm.damping_iter(R, p, sharded.shard_factors(f, mesh),
                          SolverConfig(max_iters=1, u_init=0.1,
                                       min_planes_per_pose=1))
    _finite("the factor-sharded LM step", res, bool(torch.all(
        torch.isfinite(res.R))))

    # the large-window path: span-compressed factors sharded over the
    # plane axis (sorted by base -> trajectory segments); the JAX
    # package's call, whose default solve is the banded LU
    ccfg = corridor.CorridorConfig(W=16, pts=10, max_iters=2, cg_iters=20)
    R_gt, p_gt, wf = corridor.make_corridor(ccfg, device=home)
    R0, p0 = corridor.corrupt_poses(R_gt, p_gt, ccfg)
    res2 = large.damping_iter_large(
        R0, p0, sharded.shard_factors(wf, mesh),
        SolverConfig(max_iters=2, min_planes_per_pose=0), cg_iters=20,
        cg_tol=1e-6)
    _finite("the plane-sharded damping_iter_large", res2)

    # the pose-axis-partitioned path: pose blocks + owner-major factors
    # over the same shards, halo exchange and fold per evaluation
    pcfg = corridor.CorridorConfig(W=8 * n_devices, pts=8, vis=1.6,
                                   pillar_spacing=2.0)
    R_gt3, p_gt3, wf3 = corridor.make_corridor(pcfg)
    R3, p3 = corridor.corrupt_poses(R_gt3, p_gt3, pcfg)
    prob = pose_sharded.prepare(R3, p3, wf3, n_devices)
    res3 = pose_sharded.damping_iter_pose_sharded(
        prob, mesh, SolverConfig(max_iters=2, min_planes_per_pose=0),
        cg_iters=20, cg_tol=1e-6)
    _finite("the pose-sharded LM", res3)


if __name__ == "__main__":
    cpu = "--cpu" in sys.argv
    nums = [int(a) for a in sys.argv[1:] if a != "--cpu"]
    dev = "cpu" if cpu else "cuda"
    fn, args = entry(device=dev)
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out])
    n = nums[0] if nums else (8 if cpu else torch.cuda.device_count())
    dryrun_multichip(n, devices=[torch.device("cpu")] * n if cpu else None)
    print("dryrun_multichip ok")
