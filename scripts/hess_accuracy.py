#!/usr/bin/env python3
"""How close each fp32 Hessian product of the port comes to an f64 one.

    python3 scripts/hess_accuracy.py [--seed 1] [--scans 256] [--planes 11520]

On chip_smoke.py's random packed problem (ragged_problem: PSD moments,
counts up to 40, some scans not observing) at the slice's size, it
builds the plain rank rows on the card, forms Htilde = sum_k M_k M_k^T
in float64 from them, and prints max|H - H64| / max|H64| for the plain
version (rows + fp32 torch.mm, and its bf16x3 form), the hybrid path
(B2 + fp32 torch.mm) and the fused kernels B6 `hess_v1` (the exact bf16
split), B4 `hess_v2` and B5 `hess_v3` each at split 'bf16x3' (their
default, the JAX kernel's product) and 'f32' (exact; B5 mirrored to the
full matrix and compared in its (w, j)-major order).  The bf16x3
products are also held against H64x3, the f64 sum of the bf16x3 split's
own three piece products (chip_smoke.f64_products), which leaves only
their fp32 accumulation error.  The card's name and power limit come first.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--scans", type=int, default=256)
    ap.add_argument("--planes", type=int, default=11520)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    import chip_smoke as cs
    from balm_tpu_torch.ops import packed_evaluate as pe

    print(f"card: {cs.card_line()}", flush=True)
    dev = torch.device("cuda", 0)
    pose, pk = cs.ragged_problem(args.seed, W=args.scans, G=args.planes,
                                 device=dev)
    csum = pe.csum_packed(pose, pk.mom, pk.cen, pk.cfix)
    _, aux = pe._aux_from_csum(csum, pk, 1e-9)
    hargs = (pose, pk.mom, pk.cen, aux)
    Wp = pk.wp
    H64, H64x3 = cs.f64_products(pe.rows_packed_plain(*hargs)[0])
    scale = float(H64.abs().max())
    wj = lambda H: H.view(6, Wp, 6, Wp).permute(1, 0, 3, 2).reshape(
        6 * Wp, 6 * Wp)
    x3 = dict(split="bf16x3")
    f32 = dict(split="f32")
    for name, fn, ref in (
            ("plain", pe.hess_packed_plain, H64),
            ("plain bf16x3", lambda *a: pe.hess_packed_plain(*a, **x3), H64),
            ("hybrid", pe.hess_packed_hybrid, H64),
            ("hess_v1", pe.hess_packed, H64),
            ("hess_v2 bf16x3", lambda *a: pe.hess_packed_v2(*a, **x3), H64),
            ("hess_v2 f32", lambda *a: pe.hess_packed_v2(*a, **f32), H64),
            ("hess_v3 bf16x3", lambda *a: pe.hess_packed_v3(*a, **x3),
             wj(H64)),
            ("hess_v3 f32", lambda *a: pe.hess_packed_v3(*a, **f32),
             wj(H64)),
            ("plain bf16x3 vs H64x3",
             lambda *a: pe.hess_packed_plain(*a, **x3), H64x3),
            ("hess_v2 bf16x3 vs H64x3",
             lambda *a: pe.hess_packed_v2(*a, **x3), H64x3),
            ("hess_v3 bf16x3 vs H64x3",
             lambda *a: pe.hess_packed_v3(*a, **x3), wj(H64x3))):
        H = fn(*hargs)[0]
        err = float((H.double() - ref).abs().max()) / scale
        print(f"{name}: max|H - ref| / max|H64| = {err:.3e} at Wp={Wp} "
              f"Gp={pk.gp}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
