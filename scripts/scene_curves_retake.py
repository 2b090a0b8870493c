"""Re-take BALM2's rows of the city method comparison with the JAX package
on the CPU, with every LM step's accept flag.

scripts/scene_curves.py city wrote artifacts/realworld_curves_city, whose
k.txt files keep each method's ACCEPTED iterates only.  This script runs
BALM2 as run_scene does (lm.damping_iter_timed, SolverConfig(max_iters=
100, rel_tol=1e-10, min_planes_per_pose=0, ulp_tol=8), centered) on the
same scene, in the rows

  4         float64, backend 'xla' (the record's row 4)
  5         float32, backend 'xla' (the record's row 5)
  5_packed  float32, the packed evaluator, which the record did not run
            (damping_iter_timed takes it by the name 'pallas': unlike
            damping_iter it does not map 'packed', which falls through
            to 'xla'; on a CPU its packed_impl is the XLA channel
            formulation, no Pallas kernel)

and writes, per row, every iteration's res1, res2 and accept flag, the
accepted costs and where they first leave the record's curve of the same
precision (relative 1e-6 in f64, 1e-4 in f32).  chip_smoke.py phase 14
(a) compares the card's curves and accept patterns with these.  It does
not write artifacts/.

Run: python3 scripts/scene_curves_retake.py [OUT.json]
     (default scripts/realworld_curves_city_balm2_retake.json; ~2 min
     on a CPU, under 2 GiB)
"""

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import scene_curves  # noqa: E402
from balm_tpu.config import SolverConfig  # noqa: E402
from balm_tpu.ops import factors as Fmod  # noqa: E402
from balm_tpu.solver import lm  # noqa: E402

TOL = {"4": 1e-6, "5": 1e-4, "5_packed": 1e-4}
ROWS = {"4": (jnp.float64, "xla"), "5": (jnp.float32, "xla"),
        "5_packed": (jnp.float32, "pallas")}


def main(out_path) -> int:
    R0, p0, scans, vcfg, (R_gt, p_gt) = scene_curves.scene_city(0)
    f_raw, _, G = scene_curves.build_factors(scans, R0, p0, vcfg)
    f_cen = Fmod.recenter_bodies(f_raw)
    record = ROOT / "scripts" / "realworld_curves_city_record.json"
    curves = json.loads(record.read_text())["curves"]
    scfg = SolverConfig(max_iters=100, rel_tol=1e-10,
                        min_planes_per_pose=0, ulp_tol=8.0)
    out = {"scene": "city", "W": len(scans), "planes": int(G),
           "solver": "lm.damping_iter_timed, centered, SolverConfig("
                     "max_iters=100, rel_tol=1e-10, min_planes_per_pose=0, "
                     "ulp_tol=8)",
           "host": "the JAX package on a CPU", "methods": {}}
    for key, (dt, backend) in ROWS.items():
        Rj, pj = jnp.asarray(R0, dt), jnp.asarray(p0, dt)
        fj = f_cen.astype(dt)
        t0 = time.perf_counter()
        res, _ = lm.damping_iter_timed(Rj, pj, fj, scfg, centered=True,
                                       backend=backend)
        wall = time.perf_counter() - t0
        n = int(res.iters)
        acc = np.asarray(res.trace_accept)[:n] > 0.5
        res2 = np.asarray(res.trace_res2, np.float64)[:n]
        costs = [float(c) for c in res2[acc]]
        ref = [c for _, c in curves[key[0]][1:]]
        rel = [abs(a - b) / abs(b) for a, b in zip(costs, ref)]
        first = next((k for k, r in enumerate(rel) if r > TOL[key]), None)
        out["methods"][key] = {
            "dtype": jnp.dtype(dt).name, "backend": backend, "iters": n,
            "accepted": int(acc.sum()), "seconds": wall,
            "trace_res1": [float(x) for x in
                           np.asarray(res.trace_res1, np.float64)[:n]],
            "trace_res2": [float(x) for x in res2],
            "trace_accept": [int(a) for a in acc],
            "accepted_costs": costs,
            "record_accepted": len(ref),
            "first_off_record": first,
            "max_rel_before": max(rel[:first] if first is not None
                                  else rel, default=0.0)}
        print(f"{key}: {n} iterations, {int(acc.sum())} accepted (the "
              f"record {len(ref)}), final {costs[-1]!r}, first accepted "
              f"iterate off the record: {first}, {wall:.1f} s", flush=True)
    pathlib.Path(out_path).write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps({k: {x: v[x] for x in ("iters", "accepted",
                                            "first_off_record")}
                      for k, v in out["methods"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else
                  ROOT / "scripts" / "realworld_curves_city_balm2_retake.json"))
