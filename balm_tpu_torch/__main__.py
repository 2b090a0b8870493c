"""Command-line surface: ``python -m balm_tpu_torch <pipeline> [options]``.

Counterpart: balm_tpu/__main__.py — the same subcommands, flags and one
JSON summary line per command; the reference ships its user surface as
roslaunch executables (``rosrun balm2 benchmark_realworld`` etc., see
MIGRATION.md).  Every pipeline config field is reachable with
``--set path=value`` (dotted paths descend into nested dataclasses, e.g.
``--set voxel.voxel_size=2.0 --set solver.max_iters=20``), mirroring how
the reference exposes every knob as a ``<param>`` in the .launch files.

Subcommands:

  realworld    the 177-scan real-data benchmark (benchmark_realworld)
  virtual      the synthetic-window benchmark (benchmark_virtual)
  consistency  the Monte-Carlo NEES experiment (consistency.cpp)
  odometry     streaming front-end + sliding-window BA (balm_front_back)
  optimize     one-call BA on an alidarPose.csv + full%d.pcd directory
               (the ``balm_tpu_torch.optimize_poses`` API)

Every command runs on the CUDA card (and raises without one) unless
``--cpu`` is given, which passes device='cpu' to the pipeline: its plain
PyTorch path.  Each command prints one JSON summary line and exits 0 on
success.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import sys

import numpy as np


def _coerce(current, text: str):
    """Parse `text` against the type of the field's current value."""
    if text.lower() in ("none", "null"):
        return None
    if isinstance(current, bool):
        if text.lower() in ("1", "true", "yes", "on"):
            return True
        if text.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"not a bool: {text!r}")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(text)
    if isinstance(current, float):
        return float(text)
    if isinstance(current, tuple):
        return tuple(float(v) for v in text.split(","))
    if isinstance(current, str) or current is None:
        # Optional[...] fields default to None; fall back to literal
        # parsing so ints/floats/strings all work.
        try:
            return ast.literal_eval(text)
        except (ValueError, SyntaxError):
            return text
    raise ValueError(f"cannot set a field of type {type(current).__name__} "
                     f"from the command line")


def _apply_sets(cfg, sets):
    """Return a copy of dataclass `cfg` with dotted-path overrides applied.

    Never mutates in place: nested dataclass defaults are shared class
    attributes, so in-place writes would leak across instances.
    """
    for item in sets or ():
        if "=" not in item:
            raise SystemExit(f"--set expects path=value, got {item!r}")
        path, text = item.split("=", 1)
        cfg = _replace_path(cfg, path.strip().split("."), text.strip())
    return cfg


def _replace_path(cfg, parts, text):
    name = parts[0]
    if not hasattr(cfg, name):
        valid = ", ".join(f.name for f in dataclasses.fields(cfg))
        raise SystemExit(
            f"unknown field {name!r} on {type(cfg).__name__} (has: {valid})")
    cur = getattr(cfg, name)
    if len(parts) == 1:
        try:
            val = _coerce(cur, text)
        except ValueError as e:
            raise SystemExit(
                f"bad value for {name!r} "
                f"(expected {type(cur).__name__}): {e}") from None
    elif dataclasses.is_dataclass(cur):
        val = _replace_path(cur, parts[1:], text)
    else:
        raise SystemExit(f"{name!r} is not a nested config; cannot descend")
    return dataclasses.replace(cfg, **{name: val})


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        obj = obj.item()
    if isinstance(obj, float):
        # strict JSON has no NaN/Infinity tokens; degenerate solves can
        # report non-finite residuals
        return obj if np.isfinite(obj) else None
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    if hasattr(obj, "detach"):  # a torch tensor, on any device
        obj = obj.detach().cpu().numpy()
    if hasattr(obj, "shape"):  # numpy arrays
        arr = np.asarray(obj)
        if arr.ndim == 0:
            return _jsonable(arr.item())
        return (_jsonable(arr.tolist()) if arr.size <= 64
                else f"<array {tuple(arr.shape)}>")
    return str(obj)


def _emit(summary, out_path=None):
    if isinstance(summary, dict):
        # pipelines tuck the raw LMResult / pose arrays under these keys
        # for programmatic callers; the CLI line keeps scalars only
        summary = {k: v for k, v in summary.items()
                   if k not in ("result", "R", "p", "poses")}
    line = json.dumps(_jsonable(summary))
    print(line)
    if out_path:
        with open(out_path, "w") as fh:
            fh.write(line + "\n")


def _device(args):
    return "cpu" if args.cpu else "cuda"


def _cmd_realworld(args):
    from .pipelines import coarse_to_fine, realworld

    cfg = realworld.RealworldConfig()
    if args.data_dir:
        cfg = dataclasses.replace(cfg, data_dir=args.data_dir)
    if args.max_scans:
        cfg = dataclasses.replace(cfg, max_scans=args.max_scans)
    if args.export_dir:
        cfg = dataclasses.replace(cfg, export_dir=args.export_dir)
    if args.mesh:
        cfg = dataclasses.replace(cfg, mesh_devices=args.mesh)
    # --set first: stage VoxelConfigs derive from the post-override
    # cfg.voxel so "--set voxel.*" reaches the coarse stages too
    cfg = _apply_sets(cfg, args.set)
    if args.stages:
        sizes = [float(s) for s in args.stages.split(",")]
        if sizes == [4.0, 2.0, 1.0] and cfg.voxel == type(cfg.voxel)(
                voxel_size=1.0,
                eigen_ratio=(1.0 / 16, 1.0 / 16, 1.0 / 9)):
            # pristine default config: use the README recipe's staged
            # loosened ratios; any --set voxel.* override takes the
            # derived branch below instead
            stages = coarse_to_fine.default_stages()
        else:
            # derive each stage from cfg.voxel so non-size gates carry
            # over; the last stage IS cfg.voxel at its requested size
            stages = [dataclasses.replace(cfg.voxel, voxel_size=s)
                      for s in sizes]
        cfg = dataclasses.replace(cfg, stages=stages)
    _emit(realworld.run(cfg, verbose=args.verbose, device=_device(args)),
          args.json)


def _cmd_virtual(args):
    from .pipelines import virtual

    cfg = _apply_sets(virtual.VirtualConfig(), args.set)
    _emit(virtual.run(cfg, verbose=args.verbose, device=_device(args)),
          args.json)


def _cmd_consistency(args):
    from .pipelines import consistency

    cfg = _apply_sets(consistency.ConsistencyConfig(), args.set)
    if args.seeds > 1:
        out = consistency.run_multi(cfg, seeds=range(args.seeds),
                                    verbose=args.verbose,
                                    device=_device(args))
    else:
        out = consistency.run(cfg, verbose=args.verbose,
                              device=_device(args))
    _emit(out, args.json)


def _load_scan_dir(data_dir, max_scans):
    from .pipelines import realworld

    cfg = realworld.RealworldConfig(data_dir=data_dir, max_scans=max_scans)
    return realworld.load(cfg)


def _cmd_odometry(args):
    from .pipelines import odometry
    from .utils import metrics

    if args.checkpoint and args.checkpoint_every <= 0:
        print("note: --checkpoint given without --checkpoint-every; "
              "defaulting to --checkpoint-every 25", file=sys.stderr)
        args.checkpoint_every = 25
    R_ref, p_ref, scans = _load_scan_dir(args.data_dir, args.max_scans)
    cfg = _apply_sets(odometry.OdometryConfig(), args.set)
    R, p, info = odometry.run(
        scans, cfg, verbose=args.verbose,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume, device=_device(args))
    rot_rad, trans_m = metrics.pose_rsme(R, p, R_ref, p_ref)
    summary = {
        "scans": len(scans),
        "rsme_rot_deg_vs_input_traj": float(rot_rad) * 180.0 / np.pi,
        "rsme_trans_m_vs_input_traj": float(trans_m),
    }
    summary.update({k: v for k, v in info.items()
                    if isinstance(v, (int, float, str, bool))})
    if args.out_csv:
        from .utils import checkpoint as ck

        ck.write_pose_csv(args.out_csv, R, p)
        summary["trajectory_csv"] = args.out_csv
    _emit(summary, args.json)


def _cmd_optimize(args):
    from . import api
    from .utils import metrics

    R0, p0, scans = _load_scan_dir(args.data_dir, args.max_scans)
    R1, p1, info = api.optimize_poses(
        scans, R0, p0, loop_closure=args.loop_closure,
        verbose=args.verbose, device=_device(args))
    rot_rad, trans_m = metrics.pose_rsme(
        np.asarray(R1), np.asarray(p1), R0, p0)
    summary = {
        "scans": len(scans),
        "residual_initial": info.get("residual_initial"),
        "residual_final": info.get("residual"),
        "iters": info.get("iters"),
        "status": info.get("status"),
        "backend": info.get("backend"),
        "moved_rot_deg": float(rot_rad) * 180.0 / np.pi,
        "moved_trans_m": float(trans_m),
    }
    if "loop_closure" in info:
        summary["loop_closure"] = info["loop_closure"]
    if args.out_csv:
        from .utils import checkpoint as ck

        ck.write_pose_csv(args.out_csv, np.asarray(R1), np.asarray(p1))
        summary["trajectory_csv"] = args.out_csv
    _emit(summary, args.json)


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m balm_tpu_torch",
        description=__doc__.split("\n\n")[0],
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--set", action="append", metavar="PATH=VALUE",
                       help="override any config field (dotted paths OK)")
        p.add_argument("--json", metavar="FILE",
                       help="also write the summary JSON to FILE")
        p.add_argument("--cpu", action="store_true",
                       help="run on the CPU (the plain PyTorch path) "
                            "instead of the CUDA card")
        p.add_argument("-v", "--verbose", action="store_true")

    p = sub.add_parser("realworld", help="177-scan real-data benchmark")
    p.add_argument("--data-dir", help="alidarPose.csv + full%%d.pcd dir")
    p.add_argument("--max-scans", type=int)
    p.add_argument("--export-dir", help="trajectory + convergence curves")
    p.add_argument("--stages", metavar="V1,V2,...",
                   help="coarse-to-fine voxel sizes, e.g. 4,2,1")
    p.add_argument("--mesh", type=int, metavar="N",
                   help="shard the plane axis over the first N devices "
                        "(factor-parallel solve; with --cpu N virtual CPU "
                        "shards)")
    common(p)
    p.set_defaults(fn=_cmd_realworld)

    p = sub.add_parser("virtual", help="synthetic-window benchmark")
    common(p)
    p.set_defaults(fn=_cmd_virtual)

    p = sub.add_parser("consistency", help="Monte-Carlo NEES experiment")
    p.add_argument("--seeds", type=int, default=1,
                   help="run a multi-seed NEES sweep when > 1")
    common(p)
    p.set_defaults(fn=_cmd_consistency)

    p = sub.add_parser("odometry",
                       help="streaming front-end + sliding-window BA")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--max-scans", type=int)
    p.add_argument("--checkpoint", help="loop-state checkpoint path (.npz)")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--out-csv", help="write the trajectory (reference CSV)")
    common(p)
    p.set_defaults(fn=_cmd_odometry)

    p = sub.add_parser("optimize",
                       help="one-call BA (balm_tpu_torch.optimize_poses)")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--max-scans", type=int)
    p.add_argument("--loop-closure", action="store_true")
    p.add_argument("--out-csv", help="write the trajectory (reference CSV)")
    common(p)
    p.set_defaults(fn=_cmd_optimize)

    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
