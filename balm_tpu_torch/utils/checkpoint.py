"""Checkpoint and resume of long BA runs; the reference's pose CSV.

Counterpart: balm_tpu/utils/checkpoint.py (save :20, load :31,
pack_lm_state :43, unpack_lm_state :49, save_odometry :57,
load_odometry :83, write_pose_csv :96, read_pose_csv :113).  One .npz holds the trajectory, optionally the
factor batch, and any extra arrays, such as a solver state from
solver/lm.damping_iter_resumable.  The file format is the JAX
package's, so a checkpoint written by either package loads in the
other.  Tensors are copied to the host; `load` returns numpy arrays.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from ..io import poses
from ..ops.factors import PlaneFactors

_FIELDS = ("C", "Cfix", "coe", "centers", "body_centers")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path, R, p, factors: PlaneFactors = None, **extra):
    """Save the trajectory (+ an optional factor batch and extra arrays)."""
    data = {"R": _np(R), "p": _np(p)}
    if factors is not None:
        for name in _FIELDS:
            data[f"factors_{name}"] = _np(getattr(factors, name))
    for k, v in extra.items():
        data[k] = _np(v)
    np.savez_compressed(path, **data)


def load(path):
    """-> dict with R, p, an optional 'factors' (PlaneFactors of numpy
    arrays) and any extra arrays."""
    with np.load(path, allow_pickle=False) as z:
        out = {k: z[k] for k in z.files if not k.startswith("factors_")}
        if "factors_C" in z.files:
            out["factors"] = PlaneFactors(*[z[f"factors_{name}"]
                                            for name in _FIELDS])
    return out


def pack_lm_state(state: dict) -> dict:
    """A damping_iter_resumable state -> npz-safe `lm_`-prefixed arrays
    (pass as **extra to `save`)."""
    return {f"lm_{k}": _np(v) for k, v in state.items()}


def unpack_lm_state(data: dict) -> dict | None:
    """Inverse of pack_lm_state over a dict loaded by `load`; None when
    the checkpoint holds no solver state."""
    out = {k[3:]: np.asarray(v) for k, v in data.items()
           if k.startswith("lm_")}
    return out or None


def save_odometry(path, i_next: int, R, p, vmap_state: dict,
                  contribs: dict, info: dict):
    """Persist the whole streaming-odometry loop state after scan
    `i_next - 1` (pipelines/odometry.run): the trajectory so far, the
    incremental VoxelPlaneMap, and the per-scan map contributions still
    inside the BA window (needed for the contribution swaps).  Atomic:
    written to a temporary file and renamed, so a kill mid-write never
    leaves a truncated checkpoint.  The keys are the JAX package's."""
    path = pathlib.Path(path)
    data = {"odo_i_next": np.asarray(i_next),
            "R": _np(R), "p": _np(p),
            "odo_reg_points": np.asarray(info.get("reg_points", []),
                                         np.int64),
            "odo_ba_runs": np.asarray(info.get("ba_runs", 0))}
    for k, v in vmap_state.items():
        data[f"vmap_{k}"] = _np(v)
    data["contrib_idx"] = np.asarray(sorted(contribs), np.int64)
    for j, (keys, sums) in contribs.items():
        data[f"contrib_{j}_k"] = _np(keys)
        data[f"contrib_{j}_s"] = _np(sums)
    # keep the .npz suffix on the temp file (savez appends it otherwise)
    tmp = path.with_name(path.stem + ".tmp.npz")
    np.savez_compressed(tmp, **data)
    tmp.replace(path)


def load_odometry(path):
    """-> (i_next, R, p, vmap_state, contribs, info) saved by
    save_odometry (by either package)."""
    with np.load(path, allow_pickle=False) as z:
        vmap_state = {k[5:]: z[k] for k in z.files if k.startswith("vmap_")}
        contribs = {int(j): (z[f"contrib_{j}_k"], z[f"contrib_{j}_s"])
                    for j in z["contrib_idx"]}
        info = {"reg_points": list(z["odo_reg_points"]),
                "ba_runs": int(z["odo_ba_runs"])}
        return (int(z["odo_i_next"]), z["R"], z["p"], vmap_state, contribs,
                info)


def write_pose_csv(path, R, p, t=None):
    """Write the reference's 4-lines-per-pose CSV trajectory
    (datas/benchmark_realworld/alidarPose.csv; see io/poses.py)."""
    R = _np(R)
    p = _np(p)
    W = len(R)
    t = np.zeros(W) if t is None else _np(t)
    with open(path, "w") as fh:
        for i in range(W):
            M = np.eye(4)
            M[:3, :3] = R[i]
            M[:3, 3] = p[i]
            M[3, 3] = t[i]
            for row in M:
                fh.write(",".join(f"{x:.9f}" for x in row) + ",\n")


def read_pose_csv(path):
    """Read the reference's 4-lines-per-pose CSV trajectory -> (R (W, 3,
    3), p (W, 3), t (W,)) float64 arrays: io/poses.read_pose_csv."""
    return poses.read_pose_csv(path)
