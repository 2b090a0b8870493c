#!/usr/bin/env python3
"""B1 `csum`, B2 `rows` and B7 `moments` of this checkout against those
of another one, on the card.

    python3 scripts/compare_packed_kernels.py --old DIR [--seed 0]
        [--out FILE.json]

DIR holds another checkout of the repository (for example `git archive`
of the parent commit, unpacked into a git-ignored directory); its
`balm_tpu_torch/csrc/packed_kernels.cu` (with `rows_point.cuh`) and
`balm_tpu_torch/csrc/moments_kernels.cu` are built with nvcc into
DIR/_old_build/ and loaded with ctypes beside this checkout's library
(the same C interfaces).  On the shapes of chip_smoke.py, both versions
run on the same inputs:
  * B1 and B2: phase 3's 256-scan scene (Wp = 256, Gp = 11,520), its
    random W = 256, G = 11,520 moments and ragged W = 13, G = 300
    problem, and phase 12 (a)'s batches (B = 255, Wp = 16, Gp = 256;
    B = 3, W = 13, G = 300);
  * B7, in float32 and float64: the scene's moments.pack_inputs, the
    random W = 256, G = 11,520 moments (every warp live) and the ragged
    W = 13 and W = 300, G = 384 problems of phase 8 (a) (chip_smoke.
    moments_inputs).
The outputs are compared with torch.equal (max |difference| printed
where they differ), and each kernel's device time is taken in turns
old, new, new, old, each turn 5 CUDA-event runs of a graph of 20
launches after an L2 flush (chip_smoke.time_device_ms), the median of
each version's 10 runs printed beside the bound that chip_smoke.bounds
or chip_smoke.moments_bound counts for the inputs.  Prints one line per
kernel and shape and, with --out, writes the numbers there as JSON.
Needs one CUDA card and nvcc; imports neither jax nor balm_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build_old(old: pathlib.Path):
    """Compile DIR's packed_kernels.cu and moments_kernels.cu, each alone
    into a shared library; returns the two handles."""
    from balm_tpu_torch.ops import _cuda

    out = old / "_old_build"
    out.mkdir(exist_ok=True)
    vp, i64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    libs = {}
    procs = []
    for stem in ("packed_kernels", "moments_kernels"):
        src = old / "balm_tpu_torch" / "csrc" / f"{stem}.cu"
        so = out / f"libold_{stem}.so"
        cmd = [_cuda.nvcc_path(), *_cuda.FLAGS, "-shared", "-o", str(so),
               str(src)]
        procs.append((stem, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for stem, so, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the old {stem}.cu:\n{err}")
        libs[stem] = ctypes.CDLL(str(so))
    h = libs["packed_kernels"]
    h.balm_csum_packed_batched.argtypes = [vp] * 5 + [i64, i64, i64, cint,
                                                     vp]
    h.balm_rows_packed_batched.argtypes = [vp] * 8 + [i64, i64, i64, cint,
                                                     vp]
    h.balm_rows_block_planes.restype = cint
    hm = libs["moments_kernels"]
    for name in ("balm_moments_f32", "balm_moments_f64"):
        fn = getattr(hm, name)
        fn.argtypes = [vp] * 4 + [i64, i64, cint, vp]
        fn.restype = cint
    return h, hm


def old_launchers(h):
    """The other checkout's B1 and B2 as functions of the wrappers'
    arguments (a leading batch axis or none)."""
    import torch

    from balm_tpu_torch.ops import _cuda

    def shape(mom):
        return (mom.shape[0], *mom.shape[1:]) if mom.dim() == 4 \
            else (1, *mom.shape)

    def csum(pose, mom, cen, cfix):
        B, Wp, _, Gp = shape(mom)
        out = torch.empty((B, 10, Gp), device=mom.device)
        rc = h.balm_csum_packed_batched(
            pose.data_ptr(), mom.data_ptr(), cen.data_ptr(), cfix.data_ptr(),
            out.data_ptr(), B, Wp, Gp, mom.device.index,
            _cuda.stream_of(mom))
        if rc:
            raise RuntimeError(f"old csum launch failed: {rc}")
        return out if mom.dim() == 4 else out[0]

    def rows(pose, mom, cen, aux):
        B, Wp, _, Gp = shape(mom)
        nt = -(-Gp // h.balm_rows_block_planes())
        e = lambda *s: torch.empty(s, device=mom.device)
        r, part, J, D = e(B, 3, 6, Wp, Gp), e(B, Wp, nt, 42), e(B, Wp, 6), \
            e(B, Wp, 36)
        rc = h.balm_rows_packed_batched(
            pose.data_ptr(), mom.data_ptr(), cen.data_ptr(), aux.data_ptr(),
            r.data_ptr(), part.data_ptr(), J.data_ptr(), D.data_ptr(), B, Wp,
            Gp, mom.device.index, _cuda.stream_of(mom))
        if rc:
            raise RuntimeError(f"old rows launch failed: {rc}")
        return (r, J, D) if mom.dim() == 4 else (r[0], J[0], D[0])

    return csum, rows


def old_moments(hm):
    """The other checkout's B7 as a function of the wrapper's arguments."""
    import torch

    from balm_tpu_torch.ops import _cuda

    def moments(R9, CH, OFS):
        W, _, G = CH.shape
        out = torch.empty((10, G), dtype=CH.dtype, device=CH.device)
        fn = (hm.balm_moments_f32 if CH.dtype == torch.float32
              else hm.balm_moments_f64)
        rc = fn(R9.data_ptr(), CH.data_ptr(), OFS.data_ptr(),
                out.data_ptr(), W, G, CH.device.index, _cuda.stream_of(CH))
        if rc:
            raise RuntimeError(f"old moments launch failed: {rc}")
        return out

    return moments


def problems(seed, dev):
    """(name -> (pose, PackedFactors), name -> B7's (R9, CH, OFS)):
    chip_smoke.py's shapes."""
    import torch

    import chip_smoke as cs
    from balm_tpu_torch.config import VoxelConfig
    from balm_tpu_torch.ops import factors as Fmod
    from balm_tpu_torch.ops import lie
    from balm_tpu_torch.ops import packed as packed_mod
    from balm_tpu_torch.voxel import grid

    R_gt, p_gt, scans = cs.make_scene(cs.SCANS, seed)
    R0, p0 = cs.perturb(R_gt, p_gt, seed)
    vres = grid.voxelize(scans, R0, p0, VoxelConfig(voxel_size=cs.VOXEL))
    leaves = Fmod.recenter_bodies(vres.factors)
    pk = packed_mod.pack_factors(Fmod.factors_from_numpy(leaves, device=dev))
    T = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    out = {"slice": (packed_mod.pad_poses(T(R0), T(p0), pk.wp), pk),
           "random_W256_G11520": cs.ragged_problem(seed + 1, W=cs.SCANS,
                                                   G=11520, device=dev),
           "ragged_W13_G300": cs.ragged_problem(seed, device=dev)}
    for i, (tag, B, W, G) in enumerate(cs.BATCH_SHAPES):
        out[f"batched {tag}"] = cs.batched_problem(seed + 1000 * (i + 1), B,
                                                   W, G, dev)
    f32, f64 = (Fmod.factors_from_numpy(leaves, device=dev, dtype=dt)
                for dt in (torch.float32, torch.float64))
    T32, T64 = (lie.pose_matrix(torch.tensor(R0, dtype=dt, device=dev),
                                torch.tensor(p0, dtype=dt, device=dev))
                for dt in (torch.float32, torch.float64))
    return out, cs.moments_inputs(seed, f32, f64, T32, T64)


def compare(tag, name, old, new, a, bb, st, card):
    """One kernel, old against new on the inputs a: outputs and device
    times (interleaved), printed; returns the record."""
    import torch

    import chip_smoke as cs

    o, n = old(*a), new(*a)
    torch.cuda.synchronize()
    o, n = (o, n) if isinstance(o, tuple) else ((o,), (n,))
    equal = all(torch.equal(x, y) for x, y in zip(o, n))
    diff = max(float((x - y).abs().max()) for x, y in zip(o, n))
    runs = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        fn = old if who == "old" else new
        runs[who] += cs.time_device_ms(lambda: fn(*a))[1]
    ms = {k: float(np.median(v)) for k, v in runs.items()}
    share = {k: 100 * bb["bound_ms"] / v for k, v in ms.items()}
    print(f"[{tag}] {name}: old {ms['old']:.4f} ms, new "
          f"{ms['new']:.4f} ms (medians of 10 runs), bound "
          f"{bb['bound_ms']:.4f} ms ({share['new']:.1f}% new, "
          f"{share['old']:.1f}% old), "
          f"dense bound {bb['dense_bound_ms']:.4f} ms; outputs "
          f"{'torch.equal' if equal else f'differ by {diff:.3e}'}; "
          f"live {100 * st['live_share']:.2f}%, warp-live "
          f"{100 * st['warp_live_share']:.2f}%; on {card}", flush=True)
    return {"equal": equal, "max_abs_diff": diff,
            "old_ms": ms["old"], "new_ms": ms["new"],
            "old_runs_ms": runs["old"], "new_runs_ms": runs["new"],
            "bound_ms": bb["bound_ms"],
            "dense_bound_ms": bb["dense_bound_ms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=pathlib.Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from balm_tpu_torch.ops import _cuda, moments
    from balm_tpu_torch.ops import packed_evaluate as pe

    if not torch.cuda.is_available():
        print("no CUDA card", flush=True)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    _cuda.lib()
    h, hm = build_old(args.old.resolve())
    old_csum, old_rows = old_launchers(h)
    old_mom = old_moments(hm)
    res = {"card": card}
    packed, moment_inputs = problems(args.seed, dev)
    for tag, (pose, pk) in packed.items():
        batched = pk.mom.dim() == 4
        st = cs.live_stats(pk.mom)
        bnd = cs.bounds(pk.wp, pk.gp, st, B=pk.mom.shape[0] if batched
                        else 1)
        new_csum = pe.csum_packed_batched if batched else pe.csum_packed
        new_rows = pe.rows_packed_batched if batched else pe.rows_packed
        plain = (pe.csum_packed_batched_plain if batched
                 else pe.csum_packed_plain)(pose, pk.mom, pk.cen, pk.cfix)
        _, aux = pe._aux_from_csum(plain, pk, 1e-9)
        cargs = (pose, pk.mom, pk.cen, pk.cfix)
        hargs = (pose, pk.mom, pk.cen, aux)
        rec = {"live_share": st["live_share"],
               "warp_live_share": st["warp_live_share"]}
        for name, old, new, a in (("csum", old_csum, new_csum, cargs),
                                  ("rows", old_rows, new_rows, hargs)):
            rec[name] = compare(tag, name, old, new, a, bnd[name], st, card)
        res[tag] = rec
        del pose, pk, aux, plain
    del packed
    for tag, x in moment_inputs.items():
        st = cs.live_stats(x[1])
        W, _, G = x[1].shape
        bb = cs.moments_bound(W, G, x[1].element_size(), st["live"])
        res[f"moments {tag}"] = dict(
            compare(tag, "moments", old_mom, moments.accumulate_moments, x,
                    bb, st, card),
            live_share=st["live_share"],
            warp_live_share=st["warp_live_share"])
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps({"ok": True, "out": str(args.out)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
