"""Multi-process validation of the distributed backend (parallel/mesh.py).

Counterpart: scripts/multihost_demo.py.  `run` launches `nproc` worker
processes, each holding `shards_per_proc` virtual shards of its device,
joined by torch.distributed (gloo on the CPU and when the processes share
one card, NCCL when each has a card of its own: mesh.init_distributed).
Every worker builds the same f64 factor problem (virtual.generate from a
fixed seed), shards it over the global mesh (its own shards only), runs
the factor-sharded LM solve (lm.damping_iter, backend 'xla') and the
explicit sharded evaluate (sharded.evaluate_shard_map), whose psum ends
in one all_reduce over the processes.  Rank 0 writes its result; this
process then solves the same problem on one device and compares: poses
and residual within 1e-9, the same iterations, H within 1e-7 and J within
1e-9 (the JAX script's bars).

    python -m balm_tpu_torch.parallel.multihost_demo [nproc] [shards] [--cpu]

prints the record as JSON and exits non-zero on a mismatch.
"""

from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CFG = dict(max_iters=8, u_init=0.01, min_planes_per_pose=1)


def _problem(win, surf, pts, device):
    """The deterministic f64 problem (R0, p0, f), identical in every
    process."""
    from ..pipelines import virtual

    cfg = virtual.VirtualConfig(win_size=win, surf_size=surf, pts_size=pts,
                                seed=3, dtype="float64")
    R_gt, p_gt, body = virtual.generate(cfg)
    R0, p0 = virtual.perturb(R_gt, p_gt, cfg)
    f = virtual.build_factors(body, torch.float64, device)
    T = lambda x: torch.tensor(x, dtype=torch.float64, device=device)
    return T(R0), T(p0), f


def worker(rank, nproc, shards, coord, win, surf, pts, device, out_path):
    from ..config import SolverConfig
    from ..ops import lie
    from ..solver import lm
    from . import mesh as mesh_mod
    from . import sharded

    backend = mesh_mod.init_distributed(coord, nproc, rank, device=device)
    dev = (mesh_mod.local_device() if torch.device(device).type == "cuda"
           else torch.device("cpu"))
    gmesh = mesh_mod.make_global_mesh([dev] * shards)
    assert gmesh.size == nproc * shards, gmesh
    R, p, f = _problem(win, surf, pts, dev)
    lo, hi = mesh_mod.local_factor_slice(f.num_planes)
    assert 0 <= lo <= hi <= f.num_planes

    fs = sharded.shard_factors(f, gmesh)
    out = lm.damping_iter(R, p, fs, SolverConfig(**CFG))
    res, J, H = sharded.evaluate_shard_map(lie.pose_matrix(R, p), fs)
    if rank == 0:
        meta = {"processes": gmesh.world, "global_shards": gmesh.size,
                "local_shards": len(gmesh.devices), "backend": backend,
                "device": str(dev), "iters": int(out.iters),
                "residual": float(out.residual),
                "res_shard_map": float(res)}
        np.savez(out_path, R=out.R.cpu().numpy(), p=out.p.cpu().numpy(),
                 J=J.cpu().numpy(), H=H.cpu().numpy(),
                 meta=json.dumps(meta))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(nproc=2, shards_per_proc=2, win=20, surf=40, pts=30, *,
        device="cuda", timeout=600.0):
    """Launch the workers, solve single-process, compare; returns the
    record (its "ok" is the verdict).  Kills every worker on a timeout or
    a failure of one."""
    from ..config import SolverConfig
    from ..ops import factors as Fmod
    from ..ops import lie
    from ..solver import lm

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("multihost_demo.run: no CUDA device; pass "
                           "device='cpu'")
    coord = f"127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out_npz = str(pathlib.Path(tmp) / "worker0.npz")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "balm_tpu_torch.parallel.multihost_demo",
             "--worker", str(i), str(nproc),
             str(shards_per_proc), coord, str(win), str(surf), str(pts),
             dev.type, out_npz],
            cwd=str(pathlib.Path(__file__).resolve().parents[2]),
            env={**os.environ, "OMP_NUM_THREADS": "1"})
            for i in range(nproc)]
        try:
            # one shared deadline: a worker that dies mid-init leaves its
            # peers blocked in a collective, so the whole set is killed
            deadline = time.monotonic() + timeout
            codes = [q.wait(timeout=max(1.0, deadline - time.monotonic()))
                     for q in procs]
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        if any(codes):
            raise RuntimeError(f"multihost_demo: worker exit codes {codes}")
        dist_out = np.load(out_npz)
        meta = json.loads(str(dist_out["meta"]))
        got = {k: dist_out[k] for k in ("R", "p", "J", "H")}
    t_workers = time.perf_counter() - t0

    R, p, f = _problem(win, surf, pts, dev)
    ref = lm.damping_iter(R, p, f, SolverConfig(**CFG))
    res0, J0, H0 = Fmod.evaluate(lie.pose_matrix(R, p), f)
    err = lambda a, b: float(np.max(np.abs(a - b.cpu().numpy())))
    rec = {
        **meta,
        "shards_per_process": shards_per_proc,
        "iters_single": int(ref.iters),
        "residual_single": float(ref.residual),
        "max_abs_dR": err(got["R"], ref.R), "max_abs_dp": err(got["p"],
                                                             ref.p),
        "abs_dresidual": abs(meta["residual"] - float(ref.residual)),
        "shard_map_max_abs_dH": err(got["H"], H0),
        "shard_map_max_abs_dJ": err(got["J"], J0),
        "shard_map_abs_dres": abs(meta["res_shard_map"] - float(res0)),
        "workers_s": t_workers,
    }
    rec["ok"] = bool(
        rec["max_abs_dR"] < 1e-9 and rec["max_abs_dp"] < 1e-9
        and rec["abs_dresidual"] < 1e-9 and rec["shard_map_max_abs_dH"] < 1e-7
        and rec["shard_map_max_abs_dJ"] < 1e-9
        and rec["shard_map_abs_dres"] < 1e-9
        and meta["iters"] == rec["iters_single"])
    return rec


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        (_, _, rk, npc, spp, crd, w, s, k, dv, op) = sys.argv
        worker(int(rk), int(npc), int(spp), crd, int(w), int(s), int(k), dv,
               op)
    else:
        args = [a for a in sys.argv[1:] if a != "--cpu"]
        rec = run(*(int(a) for a in args),
                  device="cpu" if "--cpu" in sys.argv else "cuda")
        print(json.dumps(rec, indent=2))
        sys.exit(0 if rec["ok"] else 1)
