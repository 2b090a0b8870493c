"""The port's batched packed LM (solver/lm.damping_iter_batched, with the
batched B1/B2 launches' plain versions and evaluate_packed_batched on
the CPU) against a loop of its per-block damping_iter and against the
JAX package's jax.vmap of damping_iter (balm_tpu/pipelines/
hierarchical.py:711-713), on the factors that JAX's vmapped
_voxelize_core gives for tests/test_hierarchical.make_long_scene
(W = 24) cut into B = 3 blocks of 8 scans, in float32 as the hierarchy
runs them.

Tolerances:
  * against per-block damping_iter(centered=True, backend='packed',
    packed_impl='xla') in f32: poses within 1e-6, the same per-lane
    iterations and accept pattern (the same per-block arithmetic).  The
    per-block loop takes impl 'xla', the evaluate that the batched path
    and the JAX package's vmapped solve at 8 poses run (its 'auto' is
    'xla' below 256 poses, balm_tpu/solver/lm.py:117-124): the port's
    'auto' is 'hybrid', whose (j, w)-major Cholesky rounds in another
    order, and on block 2 here that f32 noise near convergence moves
    the stop test (8 iterations against 3)
  * against JAX's vmap in f32: poses within 1e-4, final residuals within
    1e-4 relative (XLA's CPU products and its FMA contractions against
    PyTorch's, carried through up to 8 f32 LM steps)
  * a block with no planes keeps its input poses exactly
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.config import VoxelConfig
from balm_tpu.solver import lm as jlm
from balm_tpu.voxel import device as jdev
from balm_tpu_torch.config import SolverConfig
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.ops import packed as tpk
from balm_tpu_torch.ops import packed_evaluate as tpe
from balm_tpu_torch.solver import lm as tlm
from balm_tpu_torch.voxel import device as tdev

from test_hierarchical import make_long_scene, perturb_drift

SOLVER = dict(max_iters=8, u_init=0.01, min_planes_per_pose=0,
              gauge_fix=False)


def batched_factors_from_jax(jf, dtype=torch.float32):
    """JAX's vmapped DeviceVoxelizeResult.factors (leaves with a leading
    B axis) -> the port's batched PlaneFactors of `dtype` tensors."""
    return tF.PlaneFactors(*[torch.tensor(np.asarray(x), dtype=dtype)
                             for x in jf])


@pytest.fixture(scope="module")
def problem():
    """(R (B, 8, 3, 3), p, JAX's batched factors), f32 numpy / JAX."""
    R_gt, p_gt, scans = make_long_scene(W=24, n_planes=30, pts_per=100,
                                        seed=6)
    R0, p0 = perturb_drift(R_gt, p_gt, seed=7)
    idx = np.stack([np.arange(s, s + 8) for s in (0, 8, 16)])
    body, mask = tdev.pad_scans(
        [s.astype(np.float32) for s in scans], np.float32)
    Ra, pa = R0[idx[:, 0]], p0[idx[:, 0]]
    R_rel = np.einsum("bca,bwcd->bwad", Ra, R0[idx]).astype(np.float32)
    p_rel = np.einsum("bca,bwc->bwa", Ra,
                      p0[idx] - pa[:, None]).astype(np.float32)
    v = VoxelConfig(min_observers=2)
    kw = dict(voxel_size=float(v.voxel_size),
              layer_limit=int(v.layer_limit),
              eigen_ratio=tuple(float(r) for r in v.eigen_ratio),
              min_points=int(v.min_points), min_observers=2,
              unit_coe=False, cell_caps=(1 << 8, 1 << 10, 1 << 12),
              Gcap=512, cs_cap=1 << 13, want_point_leaf=False)
    dres = jax.vmap(lambda b, m, R, p: jdev._voxelize_core(b, m, R, p, **kw))(
        jnp.asarray(body[idx]), jnp.asarray(mask[idx]), jnp.asarray(R_rel),
        jnp.asarray(p_rel))
    assert int(np.asarray(dres.num_planes).min()) > 0
    return R_rel, p_rel, dres.factors


@pytest.fixture(scope="module")
def batched(problem):
    R, p, jf = problem
    return tlm.damping_iter_batched(torch.as_tensor(R), torch.as_tensor(p),
                                    batched_factors_from_jax(jf),
                                    SolverConfig(**SOLVER))


def test_batched_equals_per_block_loop(problem, batched):
    R, p, jf = problem
    f = batched_factors_from_jax(jf)
    assert batched.R.shape == (3, 8, 3, 3) and batched.iters.shape == (3,)
    for b in range(3):
        one = tlm.damping_iter(torch.as_tensor(R[b]), torch.as_tensor(p[b]),
                               tF.PlaneFactors(*[x[b] for x in f]),
                               SolverConfig(**SOLVER), centered=True,
                               backend="packed", packed_impl="xla")
        assert one.iters == int(batched.iters[b]) > 0
        n = one.iters
        assert np.array_equal(one.trace_accept[:n],
                              batched.trace_accept[b, :n])
        assert float((one.R - batched.R[b]).abs().max()) <= 1e-6
        assert float((one.p - batched.p[b]).abs().max()) <= 1e-6
        assert batched.residual[b] < batched.trace_res1[b, 0]


def test_batched_matches_jax_vmap(problem, batched):
    R, p, jf = problem
    solve = jax.jit(jax.vmap(lambda R_, p_, f_: jlm.damping_iter(
        R_, p_, f_, JSolverConfig(**SOLVER), centered=True,
        backend="packed")))
    jres = solve(jnp.asarray(R), jnp.asarray(p), jf)
    assert np.max(np.abs(batched.R.numpy() - np.asarray(jres.R))) <= 1e-4
    assert np.max(np.abs(batched.p.numpy() - np.asarray(jres.p))) <= 1e-4
    np.testing.assert_allclose(batched.residual, np.asarray(jres.residual),
                               rtol=1e-4)


def test_empty_block_keeps_its_poses(problem):
    R, p, jf = problem
    f = batched_factors_from_jax(jf)
    f = tF.PlaneFactors(*[torch.stack([x[0], torch.zeros_like(x[1])])
                          for x in f])
    Rt, pt = torch.as_tensor(R[:2]), torch.as_tensor(p[:2])
    out = tlm.damping_iter_batched(Rt, pt, f, SolverConfig(**SOLVER))
    assert torch.equal(out.R[1], Rt[1]) and torch.equal(out.p[1], pt[1])
    assert not out.trace_accept[1][np.isfinite(out.trace_accept[1])].any()
    # the other lane runs as it does alone
    alone = tlm.damping_iter_batched(
        Rt[:1], pt[:1], tF.PlaneFactors(*[x[:1] for x in f]),
        SolverConfig(**SOLVER))
    assert torch.equal(out.R[0], alone.R[0])
    assert int(out.iters[0]) == int(alone.iters[0])


def test_batched_evaluate_matches_per_block(problem):
    """evaluate_packed_batched against evaluate_packed(impl='xla') per
    block, and its launch counts on the CPU: none (plain versions)."""
    R, p, jf = problem
    f = batched_factors_from_jax(jf)
    pk = tpk.pack_factors_batched(f)
    assert pk.mom.shape == (3, 8, 10, 512)
    n0 = (tpe.csum_packed_batched.launches, tpe.rows_packed_batched.launches)
    res, J, H = tpe.evaluate_packed_batched(torch.as_tensor(R),
                                            torch.as_tensor(p), pk)
    r2 = tpe.residual_only_packed_batched(torch.as_tensor(R),
                                          torch.as_tensor(p), pk)
    assert n0 == (tpe.csum_packed_batched.launches,
                  tpe.rows_packed_batched.launches)
    for b in range(3):
        pkb = tpk.pack_factors(tF.PlaneFactors(*[x[b] for x in f]))
        rb, Jb, Hb = tpe.evaluate_packed(torch.as_tensor(R[b]),
                                         torch.as_tensor(p[b]), pkb,
                                         impl="xla")
        assert float(abs(rb - res[b])) <= 1e-6 * float(abs(rb))
        assert float(abs(rb - r2[b])) <= 1e-6 * float(abs(rb))
        assert float((Jb - J[b]).abs().max()) <= 1e-6 * float(Jb.abs().max())
        assert float((Hb - H[b]).abs().max()) <= 1e-6 * float(Hb.abs().max())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpe.evaluate_packed_batched(torch.as_tensor(R), torch.as_tensor(p),
                                    pk, hess_precision="bf16")


def test_c10_auto_impl_follows_jax(problem):
    """packed_impl='auto' takes 'xla' below 256 poses and 'hybrid' from
    256, as the JAX package does (C10): on block 2 the port's default
    solve then stops where JAX's does (3 iterations; 'hybrid' ran 8)."""
    assert tlm.auto_impl(255) == "xla" and tlm.auto_impl(256) == "hybrid"
    R, p, jf = problem
    jfb = type(jf)(*[x[2] for x in jf])
    jres = jlm.damping_iter(jnp.asarray(R[2]), jnp.asarray(p[2]), jfb,
                            JSolverConfig(**SOLVER), centered=True,
                            backend="packed")
    out = tlm.damping_iter(torch.as_tensor(R[2]), torch.as_tensor(p[2]),
                           batched_factors_from_jax(jfb),
                           SolverConfig(**SOLVER), centered=True,
                           backend="packed")
    assert out.iters == int(jres.iters)
    assert float(np.max(np.abs(out.R.numpy() - np.asarray(jres.R)))) <= 1e-4
