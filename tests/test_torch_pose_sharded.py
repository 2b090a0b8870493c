"""The port's pose-axis-partitioned LM (balm_tpu_torch/parallel/
pose_sharded.py) and its plane-sharded damping_iter_large (solver/
large.py over parallel/sharded.shard_factors) on virtual CPU shards,
against the JAX package's replicated large-window solve, in f64.

As tests/test_pose_sharded.py explains, the full damping loop is
comparable only where the solve is determinate: the corridor has dense
x-facing pillar tiles (pillar_spacing=2 < 2 * vis), so no pose has a
cost-flat sliding mode, and CG runs to convergence (tol 1e-12, cap 2000).

Tolerances (tests/test_pose_sharded.py:45-58, tests/
test_factors_windowed.py:152-163):
  * the full loop at W = 78 (ragged blocks of 10 over 8 shards): poses
    within 1e-9, residual 1e-9 relative, the same accept pattern, trace
    res1 within 1e-8 relative
  * the engine at W = 80 on an ill-posed corridor (pillar_spacing=6):
    res within 1e-10, J 1e-10, diag(H), the block-Jacobi blocks and H v
    within 1e-9
  * one shard: poses within 1e-9 of the unsharded solve
  * the plane-sharded damping_iter_large, banded and pcg: as the full
    loop above
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.pipelines import corridor as JC
from balm_tpu.solver import large as JL
from balm_tpu_torch.config import SolverConfig
from balm_tpu_torch.ops import factors_windowed as TFW
from balm_tpu_torch.parallel import pose_sharded as PS
from balm_tpu_torch.parallel import sharded
from balm_tpu_torch.pipelines import corridor as TC
from balm_tpu_torch.solver import large as TL

CPU = torch.device("cpu")
N = 8
CG = dict(cg_iters=2000, cg_tol=1e-12)


def _problem(W, seed=1, vis=1.6, pillar_spacing=2.0):
    kw = dict(W=W, pts=8, vis=vis, pillar_spacing=pillar_spacing,
              dtype="float64", seed=seed)
    jc, tc = JC.CorridorConfig(**kw), TC.CorridorConfig(**kw)
    Rj, pj, wfj = JC.make_corridor(jc)
    Rt, pt, wft = TC.make_corridor(tc)
    return JC.corrupt_poses(Rj, pj, jc) + (wfj,), \
        TC.corrupt_poses(Rt, pt, tc) + (wft,)


@pytest.fixture(scope="module")
def w78():
    """The W = 78 problem and JAX's replicated pcg solve of it."""
    (R0j, p0j, wfj), t = _problem(78)
    ref = JL.damping_iter_large(R0j, p0j, wfj, JSolverConfig(max_iters=8),
                                linear_solver="pcg", **CG)
    return t, ref


def _same_solve(res, ref):
    np.testing.assert_allclose(res.R.numpy(), np.asarray(ref.R), atol=1e-9)
    np.testing.assert_allclose(res.p.numpy(), np.asarray(ref.p), atol=1e-9)
    np.testing.assert_allclose(float(res.residual), float(ref.residual),
                               rtol=1e-9)
    np.testing.assert_array_equal(res.trace_accept,
                                  np.asarray(ref.trace_accept))
    np.testing.assert_allclose(res.trace_res1, np.asarray(ref.trace_res1),
                               rtol=1e-8)


def test_pose_sharded_matches_jax_replicated(w78):
    (R0, p0, wf), ref = w78
    prob = PS.prepare(R0, p0, wf, N)
    assert prob.Wb == 10 and prob.Wb >= wf.span
    res = PS.damping_iter_pose_sharded(
        prob, PS.make_pose_mesh(devices=[CPU] * N),
        SolverConfig(max_iters=8), **CG)
    assert res.R.shape == (78, 3, 3) and res.iters == int(ref.iters)
    _same_solve(res, ref)


def test_engine_matches_jax_windowed_ops():
    """evaluate / matvec / precond of the pose-sharded engine against
    JAX's single-device large.windowed_ops at the corrupted start."""
    (R0j, p0j, wfj), (R0, p0, wf) = _problem(80, pillar_spacing=6.0)
    W = 80
    ops_ref = JL.windowed_ops(wfj, W)
    res_r, J_r, dH_r, parts_r = ops_ref.evaluate(R0j, p0j)
    A_r = ops_ref.precond(parts_r, 0.01, dH_r)
    v = np.random.default_rng(0).normal(size=(W * 6,))
    mv_r = ops_ref.matvec(parts_r, dH_r, 0.01, jnp.asarray(v))

    prob = PS.prepare(R0, p0, wf, N)
    mesh = PS.make_pose_mesh(devices=[CPU] * N)
    Gd = prob.wf.num_planes // N
    wfs = [TFW.windowed_from_numpy([np.asarray(x)[d * Gd:(d + 1) * Gd]
                                    for x in prob.wf], dtype=torch.float64)
           for d in range(N)]
    ops = PS._pose_sharded_ops(wfs, mesh, prob.Wb)
    res, J, dH, state = ops.evaluate(torch.tensor(prob.R),
                                     torch.tensor(prob.p))
    A = ops.precond(state, 0.01, dH)
    vpad = torch.zeros((N * prob.Wb, 6), dtype=torch.float64)
    vpad[:W] = torch.tensor(v).view(W, 6)
    mv = ops.matvec(state, dH, 0.01, vpad.reshape(-1)).view(-1, 6)

    assert abs(float(res) - float(res_r)) < 1e-10
    np.testing.assert_allclose(J.view(-1, 6)[:W].numpy(),
                               np.asarray(J_r).reshape(W, 6), atol=1e-10)
    np.testing.assert_allclose(dH.view(-1, 6)[:W].numpy(),
                               np.asarray(dH_r).reshape(W, 6), atol=1e-9)
    np.testing.assert_allclose(A[:W].numpy(), np.asarray(A_r), atol=1e-9)
    np.testing.assert_allclose(mv[:W].numpy(),
                               np.asarray(mv_r).reshape(W, 6), atol=1e-9)


def test_single_shard():
    _, (R0, p0, wf) = _problem(40)
    cfg = SolverConfig(max_iters=3)
    ref = TL.damping_iter_large(R0, p0, wf, cfg, cg_iters=500,
                                cg_tol=1e-12, linear_solver="pcg")
    res = PS.damping_iter_pose_sharded(
        PS.prepare(R0, p0, wf, 1), PS.make_pose_mesh(devices=[CPU]), cfg,
        cg_iters=500, cg_tol=1e-12)
    np.testing.assert_allclose(res.p.numpy(), ref.p.numpy(), atol=1e-9)
    np.testing.assert_allclose(res.R.numpy(), ref.R.numpy(), atol=1e-9)


def test_span_exceeding_block_raises():
    _, (R0, p0, wf) = _problem(40, vis=4.0)   # long spans
    with pytest.raises(ValueError, match="exceeds pose block"):
        PS.prepare(R0, p0, wf, 8)
    with pytest.raises(ValueError, match="must be 2 shards of one process"):
        PS.damping_iter_pose_sharded(PS.prepare(R0, p0, wf, 2),
                                     PS.make_pose_mesh(devices=[CPU] * 8))


@pytest.mark.parametrize("linear_solver", ["banded", "pcg"])
def test_plane_sharded_large_matches_jax(w78, linear_solver):
    """damping_iter_large on WindowedFactors plane-sharded over 8 shards
    (sorted by base) against JAX's unsharded solve of the same
    problem."""
    (R0, p0, wf), ref_pcg = w78
    if linear_solver == "pcg":
        ref = ref_pcg
    else:
        (R0j, p0j, wfj), _ = _problem(78)
        ref = JL.damping_iter_large(R0j, p0j, wfj,
                                    JSolverConfig(max_iters=8))
    mesh = sharded.make_mesh(devices=[CPU] * N)
    wfs = sharded.shard_factors(wf, mesh)
    assert wfs.num_planes % N == 0 and wfs.span == wf.span
    base = torch.cat([s.base[s.coe > 0] for s in wfs.shards])
    assert torch.all(base[1:] >= base[:-1])      # trajectory segments
    res = TL.damping_iter_large(R0, p0, wfs, SolverConfig(max_iters=8),
                                linear_solver=linear_solver, **CG)
    assert res.iters == int(ref.iters)
    _same_solve(res, ref)
