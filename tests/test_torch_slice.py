"""The PyTorch port's slice — voxelize -> recenter -> packed f32 LM solve
— against the JAX package, on the CPU through the kernels' plain
versions.

Tolerances:
  * voxelizer moments: 1e-12 absolute (both packages' host code is f64
    numpy / the same C++ engine; only the summation order may differ)
  * optimize_poses: the same num_planes and iters; residual_initial
    within 1e-5 relative and the final residual within 1e-4 relative
    (f32 sums in other orders, and the JAX CPU path evaluates in
    (w, j)-major order while the port keeps (j, w)); poses within
    1e-4 rad and 1e-4 m
"""

import pathlib
import shutil
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import balm_tpu
import balm_tpu_torch
from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.config import VoxelConfig as JVoxelConfig
from balm_tpu.ops import factors as jF
from balm_tpu.solver import lm as jlm
from balm_tpu.voxel import grid as jgrid
from balm_tpu_torch.config import SolverConfig, VoxelConfig
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.ops import lie as tlie
from balm_tpu_torch.solver import lm as tlm
from balm_tpu_torch.utils import metrics as tmetrics
from balm_tpu_torch.voxel import grid as tgrid

from test_hierarchical import make_long_scene, perturb_drift
from test_voxelize import make_scene


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_voxelize_matches_jax(backend):
    R, p, scans = make_scene()
    jres = jgrid.voxelize(scans, R, p, JVoxelConfig(), pad_to=16,
                          backend=backend)
    tres = tgrid.voxelize(scans, R, p, VoxelConfig(), pad_to=16,
                          backend=backend)
    assert tres.num_planes == jres.num_planes >= 6
    for a, b in zip(tres.factors, jres.factors):
        assert a.shape == np.shape(b)
        assert np.max(np.abs(a - np.asarray(b)), initial=0.0) <= 1e-12
    assert np.array_equal(tres.point_leaf, jres.point_leaf)


def test_config_defaults_match_jax():
    assert SolverConfig() == SolverConfig(**vars(JSolverConfig()))
    assert VoxelConfig() == VoxelConfig(**vars(JVoxelConfig()))


def test_recenter_bodies_matches_jax():
    R, p, scans = make_scene(seed=3)
    f = tgrid.voxelize(scans, R, p, VoxelConfig(), pad_to=16).factors
    a = tF.recenter_bodies(f)
    b = jF.recenter_bodies(jF.PlaneFactors(*f))
    for x, y in zip(a, b):
        assert np.max(np.abs(x - np.asarray(y))) <= 1e-12


def _rsme(R1, p1, R_gt, p_gt):
    T = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    g = tlie.gauge_fix(T(R_gt), T(p_gt))
    return [float(x) for x in
            tmetrics.pose_rsme(*tlie.gauge_fix(T(R1), T(p1)), *g)]


def test_optimize_poses_matches_jax():
    R_gt, p_gt, scans = make_long_scene(W=12, seed=41)
    R0, p0 = perturb_drift(R_gt, p_gt, seed=42)
    Rj, pj, ij = balm_tpu.optimize_poses(scans, R0, p0, backend="packed",
                                         dtype="float32")
    Rt, pt, it = balm_tpu_torch.optimize_poses(scans, R0, p0,
                                               backend="packed",
                                               device="cpu")
    assert it["status"] == ij["status"] == "ok"
    assert it["num_planes"] == ij["num_planes"]
    assert it["iters"] == ij["iters"] > 0
    assert abs(it["residual_initial"] - ij["residual_initial"]) \
        < 1e-5 * ij["residual_initial"]
    assert abs(it["residual"] - ij["residual"]) < 1e-4 * ij["residual"]
    rot = tlie.so3_log(torch.as_tensor(
        np.einsum("nji,njk->nik", np.asarray(Rj, np.float64),
                  np.asarray(Rt, np.float64))))
    assert float(rot.norm(dim=-1).max()) < 1e-4
    assert np.max(np.abs(np.asarray(pt) - np.asarray(pj))) < 1e-4
    assert it["launches"] == {"csum": 0, "rows": 0}   # plain on the CPU
    # and it refines: translation error falls against the ground truth
    assert _rsme(Rt, pt, R_gt, p_gt)[1] < 0.3 * _rsme(R0, p0, R_gt, p_gt)[1]


def test_smoke_scene_matches_jax():
    """chip_smoke.py's scene at 32 scans (2 m voxels, 2 deg / 0.1 m pose
    noise): the port's CPU solve follows the JAX package's — same planes,
    iterations and accept/reject pattern — and refines the poses."""
    import chip_smoke

    R_gt, p_gt, scans = chip_smoke.make_scene(32, 0)
    R0, p0 = chip_smoke.perturb(R_gt, p_gt, 0)
    Rj, pj, ij = balm_tpu.optimize_poses(
        scans, R0, p0, voxel=JVoxelConfig(voxel_size=chip_smoke.VOXEL),
        backend="packed", dtype="float32")
    Rt, pt, it = balm_tpu_torch.optimize_poses(
        scans, R0, p0, voxel=VoxelConfig(voxel_size=chip_smoke.VOXEL),
        device="cpu")
    assert it["backend"] == "packed"          # what backend='auto' takes
    assert it["num_planes"] == ij["num_planes"]
    assert it["iters"] == ij["iters"] > 0
    assert abs(it["residual_initial"] - ij["residual_initial"]) \
        < 1e-5 * ij["residual_initial"]
    assert abs(it["residual"] - ij["residual"]) < 1e-4 * ij["residual"]
    assert np.max(np.abs(np.asarray(pt) - np.asarray(pj))) < 1e-4
    rs0, rs1 = _rsme(R0, p0, R_gt, p_gt), _rsme(Rt, pt, R_gt, p_gt)
    assert rs1[0] < 0.1 * rs0[0] and rs1[1] < 0.1 * rs0[1]


@pytest.mark.parametrize("linear_solver", ["cholesky_nofallback", "lu"])
def test_damping_iter_solvers_match_jax(linear_solver):
    R_gt, p_gt, scans = make_long_scene(W=10, seed=7)
    R0, p0 = perturb_drift(R_gt, p_gt, seed=8)
    f = tgrid.voxelize(scans, R0, p0, VoxelConfig()).factors
    fr = tF.recenter_bodies(f)
    cfg = SolverConfig(max_iters=6, min_planes_per_pose=1)
    jres = jlm.damping_iter(
        jnp.asarray(R0, jnp.float32), jnp.asarray(p0, jnp.float32),
        jF.PlaneFactors(*[jnp.asarray(x, jnp.float32) for x in fr]),
        JSolverConfig(max_iters=6, min_planes_per_pose=1), centered=True,
        backend="packed", linear_solver=linear_solver)
    tres = tlm.damping_iter(
        torch.tensor(R0, dtype=torch.float32),
        torch.tensor(p0, dtype=torch.float32),
        tF.factors_from_numpy(fr), cfg, centered=True, backend="packed",
        linear_solver=linear_solver)
    assert tres.iters == int(jres.iters) > 0
    n = tres.iters
    assert np.allclose(tres.trace_res1[:n], np.asarray(jres.trace_res1)[:n],
                       rtol=1e-4, atol=0)
    assert np.array_equal(tres.trace_accept[:n],
                          np.asarray(jres.trace_accept)[:n])
    assert abs(tres.residual - float(jres.residual)) \
        < 1e-4 * float(jres.residual)
    assert "accept" in tlm.format_trace(tres)


def test_optimize_poses_runs_on_cuda_or_raises():
    """No CPU fallback: the default device is the GPU."""
    R_gt, p_gt, scans = make_long_scene(W=4, n_planes=8, seed=3)
    if torch.cuda.is_available():
        pytest.skip("covered by chip_smoke.py on the GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        balm_tpu_torch.optimize_poses(scans, R_gt, p_gt)


def test_unported_paths_raise():
    R_gt, p_gt, scans = make_long_scene(W=4, n_planes=8, seed=3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        balm_tpu_torch.optimize_poses(scans, R_gt, p_gt, device="cpu",
                                      loop_closure=True)
    with pytest.raises(ValueError, match="at least one scan"):
        balm_tpu_torch.optimize_poses([], np.zeros((0, 3, 3)),
                                      np.zeros((0, 3)), device="cpu")
    f = tF.factors_from_numpy(tF.recenter_bodies(
        tgrid.voxelize(scans, R_gt, p_gt, VoxelConfig()).factors))
    R = torch.tensor(R_gt, dtype=torch.float32)
    p = torch.tensor(p_gt, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlm.damping_iter(R, p, f, hess_precision="bf16", centered=True,
                         backend="packed")
    # the large-window solve and edges are ported (solver/large.py,
    # ops/pose_graph.py); damping_iter refuses what JAX's cannot do
    with pytest.raises(ValueError, match="damping_iter_large"):
        tlm.damping_iter(R, p, f, backend="large")
    with pytest.raises(ValueError, match="left update"):
        tlm.damping_iter(R, p, f, edges=object(), update="right")
    with pytest.raises(ValueError, match="unknown packed_impl"):
        tlm.damping_iter(R, p, f, packed_impl="pallas4")


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when torch
    sees no CUDA device (or, copied alone, when the package is absent)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(src, alone)
    for script in (src, alone):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
