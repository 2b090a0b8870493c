#!/usr/bin/env python3
"""Time the CUDA kernels built with and without nvcc's FMA contraction.

    python3 scripts/time_kernel_builds.py [--seed 0] [--iters 50]

Builds the kernels of csrc/ twice, with ops/_cuda.py's flags ('fma':
nvcc contracts products and sums into FMAs everywhere except where the
source rounds explicitly) and with -fmad=false added ('nofma': nothing
contracted), each into its own library under balm_tpu_torch/_build/.
On chip_smoke.py's 256-scan scene it times the `csum` and `rows` kernels
of each build (CUDA events, mean of --iters calls) in the order nofma,
fma, fma, nofma, and compares every output with the plain PyTorch
version (max abs error and that over max|plain|).
Prints one line per measurement, the card, and a JSON summary last.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def use_build(variant: str, built: set) -> float:
    """Point ops/_cuda.py at this variant's library (building it the first
    time); returns the build seconds (0 when already built)."""
    from balm_tpu_torch.ops import _cuda

    flags = [f for f in _cuda.FLAGS if f != "-fmad=false"]
    if variant == "nofma":
        flags.insert(flags.index("-fPIC") + 1, "-fmad=false")
    _cuda.FLAGS = flags
    stem = _cuda.BUILD_DIR / f"libbalm_kernels_{variant}"
    _cuda.LIB_PATH = stem.with_suffix(".so")
    _cuda._STAMP = stem.with_suffix(".sha256")
    _cuda._LOG = stem.with_suffix(".log")
    _cuda._lib = None
    seconds = _cuda.build(force=variant not in built)["seconds"]
    built.add(variant)
    _cuda.lib()
    return seconds


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    import chip_smoke as cs
    from balm_tpu_torch.config import VoxelConfig
    from balm_tpu_torch.ops import factors as Fmod
    from balm_tpu_torch.ops import packed as packed_mod
    from balm_tpu_torch.ops import packed_evaluate as pe
    from balm_tpu_torch.voxel import grid

    card = cs.card_line()
    dev = torch.device("cuda", 0)
    R_gt, p_gt, scans = cs.make_scene(cs.SCANS, args.seed)
    R0, p0 = cs.perturb(R_gt, p_gt, args.seed)
    vres = grid.voxelize(scans, R0, p0, VoxelConfig(voxel_size=cs.VOXEL))
    pk = packed_mod.pack_factors(Fmod.factors_from_numpy(
        Fmod.recenter_bodies(vres.factors), device=dev))
    pose = packed_mod.pad_poses(
        torch.tensor(R0, dtype=torch.float32, device=dev),
        torch.tensor(p0, dtype=torch.float32, device=dev), pk.wp)
    csum0 = pe.csum_packed_plain(pose, pk.mom, pk.cen, pk.cfix)
    _, aux = pe._aux_from_csum(csum0, pk, 1e-9)
    plain = {"csum": (csum0,),
             "rows": pe.rows_packed_plain(pose, pk.mom, pk.cen, aux)}
    names = {"csum": ("csum",), "rows": ("rows", "J", "D")}
    calls = {
        "csum": lambda: (pe.csum_packed(pose, pk.mom, pk.cen, pk.cfix),),
        "rows": lambda: pe.rows_packed(pose, pk.mom, pk.cen, aux)}
    print(f"card: {card}; Wp={pk.wp} Gp={pk.gp} planes {vres.num_planes}",
          flush=True)

    built: set = set()
    runs = []
    for variant in ("nofma", "fma", "fma", "nofma"):
        rec = {"variant": variant, "build_s": use_build(variant, built)}
        for k, fn in calls.items():
            outs = fn()
            torch.cuda.synchronize()
            for name, a, b in zip(names[k], outs, plain[k]):
                err = float((a - b).abs().max())
                rec[f"{name}_abs"] = err
                rec[f"{name}_rel"] = err / max(float(b.abs().max()), 1e-30)
            rec[f"{k}_ms"] = cs.time_ms(fn, iters=args.iters)
        runs.append(rec)
        print("  " + " ".join(f"{key}={val:.4e}" if isinstance(val, float)
                              else f"{key}={val}"
                              for key, val in rec.items()), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "wp": pk.wp, "gp": pk.gp,
                      "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
