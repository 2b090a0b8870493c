"""The port's large-window path — pipelines/corridor.py, solver/large.py
(damping_iter_large, banded and pcg, with and without pose-graph edges)
and optimize_poses' large_threshold dispatch — against the JAX package
on the CPU, in float64.

Tolerances:
  * make_corridor / corrupt_poses: within 1e-12 (the same rng streams;
    so3_exp's roundoff only)
  * damping_iter_large, banded: the same iterations and accept pattern,
    trace res1 within 1e-6 relative (with chain edges too)
  * damping_iter_large, pcg: the final residual within 1e-6 relative
    where every CG solve ends by its tolerance (u_init = 1 keeps the
    damped system positive definite; truncated at non-positive
    curvature CG amplifies summation-order roundoff far beyond that)
  * corridor.run at W = 40: residual within 1e-6 relative
  * optimize_poses(large_threshold=4), float64: both packages take
    'large', poses within 1e-6
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import balm_tpu
import balm_tpu_torch
from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.config import VoxelConfig as JVoxelConfig
from balm_tpu.ops import pose_graph as JPG
from balm_tpu.pipelines import corridor as JC
from balm_tpu.solver import large as JL
from balm_tpu_torch.config import SolverConfig, VoxelConfig
from balm_tpu_torch.ops import pose_graph as TPG
from balm_tpu_torch.pipelines import corridor as TC
from balm_tpu_torch.solver import large as TL

from test_hierarchical import make_long_scene, perturb_drift

W = 40
ITERS = 8
CFG = dict(max_iters=ITERS, rel_tol=1e-10, min_planes_per_pose=0)


@pytest.fixture(scope="module")
def corridor():
    jc = JC.CorridorConfig(W=W, dtype="float64", max_iters=ITERS)
    tc = TC.CorridorConfig(W=W, dtype="float64", max_iters=ITERS)
    Rj, pj, wfj = JC.make_corridor(jc)
    Rt, pt, wft = TC.make_corridor(tc)
    R0j, p0j = JC.corrupt_poses(Rj, pj, jc)
    R0t, p0t = TC.corrupt_poses(Rt, pt, tc)
    return dict(jc=jc, tc=tc, j=(Rj, pj, wfj, R0j, p0j),
                t=(Rt, pt, wft, R0t, p0t))


def _close(a, b, tol):
    a = np.asarray(a, np.float64)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return np.max(np.abs(a - b)) <= tol * max(np.max(np.abs(a)), 1e-300)


def test_make_corridor_matches_jax(corridor):
    for a, b in zip(corridor["j"][:2] + tuple(corridor["j"][2])
                    + corridor["j"][3:],
                    corridor["t"][:2] + tuple(corridor["t"][2])
                    + corridor["t"][3:]):
        assert tuple(a.shape) == tuple(b.shape)
        assert _close(a, b, 1e-12)
    wf = corridor["t"][2]
    assert wf.base.dtype == torch.int64 and wf.span == corridor["j"][2].span


def _chain_edges(R0, p0, n):
    """Odometry chain edges i -> i+1 measured from the given poses (each
    exactly satisfied there)."""
    R0, p0 = np.asarray(R0), np.asarray(p0)
    i = np.arange(n - 1)
    j = i + 1
    Zr = np.einsum("eba,ebc->eac", R0[i], R0[j])
    Zp = np.einsum("eba,eb->ea", R0[i], p0[j] - p0[i])
    return (i, j, Zr, Zp, np.full(n - 1, 50.0), np.full(n - 1, 20.0))


def _jedges(fields):
    i, j, Zr, Zp, wr, wt = fields
    return JPG.RelPoseEdges(jnp.asarray(i, jnp.int32),
                            jnp.asarray(j, jnp.int32), jnp.asarray(Zr),
                            jnp.asarray(Zp), jnp.asarray(wr),
                            jnp.asarray(wt))


@pytest.mark.parametrize("with_edges", [False, True])
def test_damping_iter_large_banded_matches_jax(corridor, with_edges):
    Rj, pj, wfj, R0j, p0j = corridor["j"]
    Rt, pt, wft, R0t, p0t = corridor["t"]
    je = te = None
    if with_edges:
        fields = _chain_edges(R0j, p0j, W)
        je = _jedges(fields)
        te = TPG.edges_from_numpy(fields)
    # corridor.run's CG options: one JAX compile serves both tests
    kw = dict(cg_iters=100, cg_tol=1e-5)
    jr = JL.damping_iter_large(R0j, p0j, wfj, JSolverConfig(**CFG),
                               edges=je, **kw)
    tr = TL.damping_iter_large(R0t, p0t, wft, SolverConfig(**CFG),
                               edges=te, **kw)
    n = tr.iters
    assert n == int(jr.iters) > 2
    assert np.array_equal(tr.trace_accept[:n],
                          np.asarray(jr.trace_accept)[:n])
    a = np.asarray(jr.trace_res1)[:n]
    assert np.max(np.abs(tr.trace_res1[:n] - a) / np.abs(a)) < 1e-6
    assert not np.any(tr.trace_cg[:n])
    assert abs(tr.residual - float(jr.residual)) < 1e-6 * float(jr.residual)
    assert _close(jr.R, tr.R, 1e-6) and _close(jr.p, tr.p, 1e-6)


def test_damping_iter_large_pcg_matches_jax(corridor):
    Rj, pj, wfj, R0j, p0j = corridor["j"]
    Rt, pt, wft, R0t, p0t = corridor["t"]
    cfg = dict(CFG, u_init=1.0)
    jr = JL.damping_iter_large(R0j, p0j, wfj, JSolverConfig(**cfg),
                               linear_solver="pcg", cg_tol=1e-5)
    tr = TL.damping_iter_large(R0t, p0t, wft, SolverConfig(**cfg),
                               linear_solver="pcg", cg_tol=1e-5)
    n = tr.iters
    assert n == int(jr.iters) > 2
    # every CG solve ended by its tolerance (not by the iteration cap)
    assert np.all((tr.trace_cg[:n] > 0) & (tr.trace_cg[:n] < 100))
    assert np.array_equal(tr.trace_cg[:n], np.asarray(jr.trace_cg)[:n])
    assert abs(tr.residual - float(jr.residual)) < 1e-6 * float(jr.residual)


def test_damping_iter_large_checks_edges(corridor):
    Rt, pt, wft, R0t, p0t = corridor["t"]
    i, j, Zr, Zp, wr, wt = _chain_edges(R0t, p0t, 3)
    far = TPG.edges_from_numpy((i, j + wft.span, Zr, Zp, wr, wt))
    with pytest.raises(ValueError, match="span"):
        TL.damping_iter_large(R0t, p0t, wft, edges=far)
    back = TPG.edges_from_numpy((j, i, Zr, Zp, wr, wt))
    with pytest.raises(ValueError, match="i < j"):
        TL.damping_iter_large(R0t, p0t, wft, edges=back)
    with pytest.raises(ValueError, match="linear_solver"):
        TL.damping_iter_large(R0t, p0t, wft, linear_solver="lu")


def test_corridor_run_matches_jax(corridor):
    jo = JC.run(corridor["jc"])
    to = TC.run(corridor["tc"], device="cpu")
    assert (to["W"], to["planes"], to["span"], to["iters"]) == (
        jo["W"], jo["planes"], jo["span"], jo["iters"])
    assert abs(to["residual"] - jo["residual"]) < 1e-6 * jo["residual"]
    for k in ("rmse_rot_deg_init", "rmse_trans_m_init"):
        assert abs(to[k] - jo[k]) < 1e-9 * jo[k]
    assert to["cg_iters_per_lm"] == jo["cg_iters_per_lm"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.run(corridor["tc"])


def test_optimize_poses_large_threshold_matches_jax():
    R_gt, p_gt, scans = make_long_scene(W=8, n_planes=20, seed=43)
    R0, p0 = perturb_drift(R_gt, p_gt, seed=44)
    kw = dict(large_threshold=4, dtype="float64")
    Rj, pj, ij = balm_tpu.optimize_poses(
        scans, R0, p0, voxel=JVoxelConfig(),
        solver=JSolverConfig(max_iters=6, min_planes_per_pose=0), **kw)
    Rt, pt, it = balm_tpu_torch.optimize_poses(
        scans, R0, p0, voxel=VoxelConfig(),
        solver=SolverConfig(max_iters=6, min_planes_per_pose=0),
        device="cpu", **kw)
    assert ij["backend"] == it["backend"] == "large"
    assert it["status"] == ij["status"] == "ok"
    assert it["num_planes"] == ij["num_planes"]
    assert it["span"] == ij["span"] and it["iters"] == ij["iters"] > 0
    assert abs(it["residual"] - ij["residual"]) < 1e-6 * ij["residual"]
    assert np.max(np.abs(Rt - np.asarray(Rj))) < 1e-6
    assert np.max(np.abs(pt - np.asarray(pj))) < 1e-6
    assert set(it["seconds"]) == {"voxelize", "from_dense", "solve"}


def test_optimize_poses_dispatch():
    """'auto' as in JAX: 'large' above large_threshold scans, else
    'packed' in float32 on the card (JAX: on its accelerator) and 'xla'
    otherwise — so 'xla' at either dtype on the CPU, as JAX off the TPU
    (tests/test_torch_slice.py::test_optimize_poses_cpu_defaults_match_jax)."""
    R_gt, p_gt, scans = make_long_scene(W=5, n_planes=12, seed=45)
    one = SolverConfig(max_iters=1, min_planes_per_pose=0)
    for dtype, thr, want in (("float32", 600, "xla"),
                             ("float64", 600, "xla"),
                             ("float32", 4, "large"),
                             ("float64", 5, "xla")):
        _, _, info = balm_tpu_torch.optimize_poses(
            scans, R_gt, p_gt, solver=one, dtype=dtype,
            large_threshold=thr, device="cpu")
        assert info["backend"] == want, (dtype, thr)


def test_slice7_imports_neither_jax_nor_balm_tpu():
    mods = ("ops.factors_windowed", "ops.pose_graph", "solver.banded",
            "solver.large", "solver.lm", "pipelines.corridor", "api")
    code = ("import sys; "
            + "; ".join(f"import balm_tpu_torch.{m}" for m in mods)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'balm_tpu')]; assert not bad, bad")
    repo = pathlib.Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=repo)
