"""The port's hierarchy (pipelines/hierarchical.py) against the JAX
package's on its optional stages, on the CPU in float64, on
tests/test_hierarchical.py's make_long_scene (W=20) with its
perturb_drift start: the global sweep through the span-compressed solve
with coarse-to-fine top stages, scan-level chain edges (in-block and
lifted onto the anchor graph), and the recursive top level.

Tolerances: the same block and plane counts and edge counts; poses
within 1e-6 (the same f64 solves; sums round in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from balm_tpu.config import VoxelConfig as JVoxelConfig
from balm_tpu.ops import pose_graph as jPG
from balm_tpu.pipelines import hierarchical as jh
from balm_tpu_torch.ops import pose_graph as tPG
from balm_tpu_torch.pipelines import hierarchical as th

from test_hierarchical import make_long_scene, perturb_drift
from test_torch_hierarchical import to_torch_config


@pytest.fixture(scope="module")
def scene():
    R_gt, p_gt, scans = make_long_scene(W=20, seed=14)
    R0, p0 = perturb_drift(R_gt, p_gt, seed=15)
    return scans, R0, p0


def chain_edges(R, p, w=100.0):
    """Odometry edges (i, i+1) measured from the given poses, as numpy."""
    i = np.arange(len(R) - 1)
    j = i + 1
    Zr = np.einsum("nba,nbc->nac", R[i], R[j])
    Zp = np.einsum("nba,nb->na", R[i], p[j] - p[i])
    return i, j, Zr, Zp, np.full(len(i), w), np.full(len(i), w)


CASES = {
    "sweep_stages": dict(
        block=8, stride=6, cycles=1, polish=False, global_sweep=2,
        global_sweep_solver="large",
        top_stages=(JVoxelConfig(voxel_size=2.0, min_observers=2),
                    JVoxelConfig(min_observers=2))),
    "scan_edges": dict(block=8, stride=6, cycles=1),
    "recurse": dict(block=8, stride=6, cycles=1, recurse_at=2,
                    polish=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stage_matches_jax(scene, case):
    scans, R0, p0 = scene
    jcfg = jh.HierarchicalConfig(**CASES[case])
    je = te = None
    if case == "scan_edges":
        e = chain_edges(R0, p0)
        je = jPG.RelPoseEdges(*[jnp.asarray(x) for x in e])
        te = tPG.edges_from_numpy(e)
    Rj, pj, ij = jh.run(scans, R0, p0, jcfg, scan_edges=je)
    Rt, pt, it = th.run(scans, R0, p0, to_torch_config(jcfg), scan_edges=te,
                        device="cpu")
    assert it["blocks"] == ij["blocks"]
    for k in ("n_edges", "n_blocks", "top_planes", "global_sweeps",
              "n_lifted_edges", "polish_planes"):
        assert it.get(k) == ij.get(k), k
    if case == "recurse":
        assert it["recursed"]["blocks"] == ij["recursed"]["blocks"]
    if case == "scan_edges":
        assert it["n_lifted_edges"] > 0
        assert it["loop_drift_effective_m"] == pytest.approx(
            ij["loop_drift_effective_m"], rel=1e-9)
    assert np.max(np.abs(Rt - np.asarray(Rj))) <= 1e-6
    assert np.max(np.abs(pt - np.asarray(pj))) <= 1e-6
