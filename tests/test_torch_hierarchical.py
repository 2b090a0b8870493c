"""The PyTorch port's host hierarchy (pipelines/hierarchical.py) against
the JAX package's, on the CPU in float64, on tests/test_hierarchical.py's
make_long_scene with its perturb_drift start.  The global sweep, the
coarse-to-fine top stages, scan edges and the recursive top level are
in tests/test_torch_hierarchical_stages.py.

Tolerances:
  * run: the same info["blocks"] (start, size and plane count of every
    block solve), n_edges, top and polish plane counts; poses within
    1e-6 (every solve is the same f64 damped Newton; sums round in
    another order and the steps carry that on)
  * batched_bottom=True against the per-block loop: poses within 1e-8
    (tests/test_hierarchical.py::test_batched_bottom_matches_loop's bar)
  * refeature_super_scan: the same kept points, exactly
  * the anchor pose-graph branch: the same pose-graph iterations and
    accepted steps, the provisional and final poses within 1e-8 (both
    run the f64 graph solve and the f64 top solve on the same inputs)
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.config import VoxelConfig as JVoxelConfig
from balm_tpu.ops import pose_graph as jPG
from balm_tpu.pipelines import hierarchical as jh
from balm_tpu_torch.config import SolverConfig, VoxelConfig
from balm_tpu_torch.ops import pose_graph as tPG
from balm_tpu_torch.pipelines import hierarchical as th

from test_hierarchical import make_long_scene, perturb_drift


def to_torch_config(jcfg):
    """The port's HierarchicalConfig from the JAX package's, field by
    field (VoxelConfig and SolverConfig fields converted in kind)."""
    def conv(v):
        if isinstance(v, JVoxelConfig):
            return VoxelConfig(**vars(v))
        if isinstance(v, JSolverConfig):
            return SolverConfig(**vars(v))
        if isinstance(v, (list, tuple)):
            return type(v)(conv(x) for x in v)
        return v
    return th.HierarchicalConfig(**{
        f.name: conv(getattr(jcfg, f.name))
        for f in dataclasses.fields(jh.HierarchicalConfig)})


@pytest.fixture(scope="module")
def scene():
    R_gt, p_gt, scans = make_long_scene(W=20, seed=14)
    R0, p0 = perturb_drift(R_gt, p_gt, seed=15)
    return scans, R0, p0


def test_config_defaults_match_jax():
    assert to_torch_config(jh.HierarchicalConfig()) == th.HierarchicalConfig()


def test_run_matches_jax(scene):
    scans, R0, p0 = scene
    jcfg = jh.HierarchicalConfig(block=8, stride=6, cycles=2)
    Rj, pj, ij = jh.run(scans, R0, p0, jcfg)
    Rt, pt, it = th.run(scans, R0, p0, to_torch_config(jcfg), device="cpu")
    assert it["blocks"] == ij["blocks"]
    assert len(it["blocks"]) == 6
    for k in ("W", "n_edges", "n_blocks", "top_planes", "polish_planes"):
        assert it[k] == ij[k], k
    np.testing.assert_allclose(it["cycle_residuals"], ij["cycle_residuals"],
                               rtol=1e-8)
    assert np.max(np.abs(Rt - np.asarray(Rj))) <= 1e-6
    assert np.max(np.abs(pt - np.asarray(pj))) <= 1e-6


def test_batched_bottom_matches_loop(scene):
    scans, R0, p0 = scene
    top = JSolverConfig(max_iters=10, u_init=0.01, min_planes_per_pose=1)
    jcfg = jh.HierarchicalConfig(block=8, stride=6, polish=False, cycles=1,
                                 top_solver=top, use_overlap_edges=False)
    Rj, pj, _ = jh.run(scans, R0, p0, jcfg)
    base = to_torch_config(jcfg)
    R1, p1, i1 = th.run(scans, R0, p0, base, device="cpu")
    R2, p2, i2 = th.run(scans, R0, p0,
                        dataclasses.replace(base, batched_bottom=True),
                        device="cpu")
    assert i1["blocks"] == i2["blocks"]
    assert np.allclose(R1, R2, atol=1e-8) and np.allclose(p1, p2, atol=1e-8)
    assert np.max(np.abs(R2 - np.asarray(Rj))) <= 1e-6
    assert np.max(np.abs(p2 - np.asarray(pj))) <= 1e-6


def test_refeature_super_scan_matches_jax(scene):
    scans, R0, p0 = scene
    sp = np.concatenate([s @ R0[i].T + p0[i] for i, s in enumerate(scans[:6])])
    rng = np.random.default_rng(3)
    sp = np.concatenate([sp, rng.uniform(-6, 6, size=(400, 3))])   # clutter
    kept_j = jh.refeature_super_scan(sp, JVoxelConfig(min_observers=1))
    kept_t = th.refeature_super_scan(sp, VoxelConfig(min_observers=1))
    assert 0 < len(kept_t) < len(sp)
    assert np.array_equal(kept_t, np.asarray(kept_j))
    tiny = sp[:5]
    assert th.refeature_super_scan(tiny, VoxelConfig()) is tiny


def test_anchor_pgo_branch_matches_jax(scene):
    """A lifted loop edge whose correction exceeds anchor_pgo_gate voxels
    sends both packages through the anchor pose-graph stage
    (loopclose.pose_graph_optimize) before the top plane solve: the same
    pose-graph iterations, poses within 1e-8."""
    scans, R0, p0 = scene
    i, j = 0, len(scans) - 1
    Zr = R0[i].T @ R0[j]
    Zp = R0[i].T @ (p0[j] - p0[i]) + np.array([1.5, 0.0, 0.0])
    fields = ([i], [j], Zr[None], Zp[None], [100.0], [100.0])
    edges = tPG.edges_from_numpy(fields)
    jedges = jPG.RelPoseEdges(*[jnp.asarray(np.asarray(x)) for x in fields])
    cfg = th.HierarchicalConfig(block=8, stride=6, cycles=1, polish=False)
    Rt, pt, it = th.run(scans, R0, p0, cfg, scan_edges=edges, device="cpu")
    Rj, pj, ij = jh.run(scans, R0, p0,
                        jh.HierarchicalConfig(block=8, stride=6, cycles=1,
                                              polish=False),
                        scan_edges=jedges)
    assert "anchor_pgo" in it and it["anchor_pgo"]["iters"] > 0
    assert it["anchor_pgo"]["iters"] == ij["anchor_pgo"]["iters"]
    assert it["anchor_pgo"]["accepted"] == ij["anchor_pgo"]["accepted"]
    assert it["loop_drift_effective_m"] > 0.5 * cfg.voxel.voxel_size
    for a, b in zip(it["anchor_pgo_provisional"],
                    ij["anchor_pgo_provisional"]):
        assert np.max(np.abs(a - np.asarray(b))) <= 1e-8
    assert np.max(np.abs(Rt - np.asarray(Rj))) <= 1e-8
    assert np.max(np.abs(pt - np.asarray(pj))) <= 1e-8
    with pytest.raises(ValueError, match="stride"):
        th.run(scans, R0, p0, th.HierarchicalConfig(block=4, stride=6),
               device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            th.run(scans, R0, p0, cfg)


def test_slice8_imports_neither_jax_nor_balm_tpu():
    mods = ("ops.clusters", "ops.covariance", "voxel.marginalize",
            "voxel.grid", "pipelines.consistency", "pipelines.hierarchical")
    code = ("import sys; "
            + "; ".join(f"import balm_tpu_torch.{m}" for m in mods)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'balm_tpu')]; assert not bad, bad")
    repo = pathlib.Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=repo)
