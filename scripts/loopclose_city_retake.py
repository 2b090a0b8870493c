"""Re-take the JAX package's W=1200 city loop-closure numbers on the CPU
from chip_smoke.py's copy of the scene (the gate of its phase 13 (c)).

chip_smoke.py copies scripts/hba_city_demo.make_city and
perturb_cumulative with the port's so3_exp in place of JAX's.  This
script builds the scene both ways, says whether they agree, then runs
balm_tpu's detect and close_loops (LoopConfig() defaults, float64 on
the CPU) on chip_smoke's copy and prints one JSON line: n_verified,
n_edges, the detect counters, the PGO's iterations and costs and the
RSME (deg, m) before and after the PGO, beside the record
artifacts/loopclose_city.json (which it does not write).

Run: python3 scripts/loopclose_city_retake.py  (~15 s on one CPU)
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

import chip_smoke  # noqa: E402
import hba_city_demo  # noqa: E402
from balm_tpu.ops import lie  # noqa: E402
from balm_tpu.pipelines import loopclose as LC  # noqa: E402
from balm_tpu.utils import metrics  # noqa: E402

W = 1200


def main() -> int:
    R_gt, p_gt, scans = chip_smoke.make_city(W, seed=1)
    R0, p0 = chip_smoke.perturb_cumulative(R_gt, p_gt, seed=2,
                                           rot_step_deg=0.05,
                                           trans_step=0.007)
    Rs, ps, ss = hba_city_demo.make_city(W, seed=1)
    Rs0, ps0 = hba_city_demo.perturb_cumulative(Rs, ps, seed=2)
    same = {
        "scene_bitwise": bool(np.array_equal(Rs, R_gt)
                              and np.array_equal(ps, p_gt)
                              and all(np.array_equal(a, b)
                                      for a, b in zip(ss, scans))),
        "start_max_diff": max(float(np.abs(Rs0 - R0).max()),
                              float(np.abs(ps0 - p0).max())),
    }
    Rg, pg = lie.gauge_fix(jnp.asarray(R_gt), jnp.asarray(p_gt))

    def rsme(R, p):
        r, t = metrics.pose_rsme(
            *lie.gauge_fix(jnp.asarray(R), jnp.asarray(p)), Rg, pg)
        return [float(r) * 57.3, float(t)]

    t0 = time.perf_counter()
    edges, info = LC.detect(scans, R0, p0, LC.LoopConfig())
    t_det = time.perf_counter() - t0
    t0 = time.perf_counter()
    Rp, pp, _, cinfo = LC.close_loops(scans, R0, p0, LC.LoopConfig(),
                                      edges=edges, detect_info=info)
    t_pgo = time.perf_counter() - t0
    out = {
        "W": W, "points": int(sum(len(s) for s in scans)), **same,
        "n_edges": 0 if edges is None else int(np.asarray(edges.i).size),
        **{k: info.get(k, 0) for k in ("n_queries", "n_scored", "n_verified",
                                       "n_drift_rejected",
                                       "n_pcm_rejected")},
        "pgo": cinfo.get("pgo"), "rsme_init_deg_m": rsme(R0, p0),
        "rsme_pgo_deg_m": rsme(Rp, pp), "detect_s": t_det, "pgo_s": t_pgo,
        "record": {k: v for k, v in json.load(open(
            ROOT / "artifacts" / "loopclose_city.json"))["detect"].items()
            if k != "edge_err_deg_m"},
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
