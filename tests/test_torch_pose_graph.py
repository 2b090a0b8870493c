"""The port's pose-graph edges (ops/pose_graph.py) and damping_iter's
`edges=` against the JAX package, on the CPU.

Tolerances, relative to each quantity's max:
  * evaluate_relpose_blocks (res, g, h), with an exactly satisfied edge
    (no NaN) and with Huber thresholds, evaluate_relpose,
    evaluate_relpose_dense, relpose_cost: 1e-9 in float64; in float32
    the satisfied edge's derivatives stay finite, within 1e-4
  * lift_edges / consensus_edge (host numpy): 1e-12
  * damping_iter(edges=) on the 'xla' backend (float64): the same
    iterations and accept pattern, trace res1 within 1e-6
  * damping_iter(edges=) on the packed f32 path: trace res1 and the
    residual within 1e-4 (ROADMAP.md's bar against the f32 evaluator)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.ops import factors as jF
from balm_tpu.ops import lie as jlie
from balm_tpu.ops import pose_graph as JPG
from balm_tpu.solver import lm as jlm
from balm_tpu_torch.config import SolverConfig, VoxelConfig
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.ops import pose_graph as TPG
from balm_tpu_torch.solver import lm as tlm
from balm_tpu_torch.voxel import grid as tgrid

from test_hierarchical import make_long_scene, perturb_drift
from test_torch_xla_solve import _perturbed

TOL = 1e-9
# the JAX side jitted: eager, its vmap of jax.hessian takes ~20 s
J_BLOCKS = jax.jit(JPG.evaluate_relpose_blocks)
J_SCATTER = jax.jit(JPG.evaluate_relpose)
J_DENSE = jax.jit(JPG.evaluate_relpose_dense)


def _edges(W=6, seed=0):
    """Poses and edges; edge 0 is exactly satisfied at the poses."""
    rng = np.random.default_rng(seed)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(W, 3)) * 0.3)))
    p = rng.normal(size=(W, 3))
    i = np.array([0, 1, 2, 3, 0])
    j = np.array([1, 2, 3, 4, 5])
    Zr = np.einsum("eba,ebc->eac", R[i], R[j])
    Zp = np.einsum("eba,eb->ea", R[i], p[j] - p[i])
    noise = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(4, 3))
                                                * 0.05)))
    Zr[1:] = Zr[1:] @ noise
    Zp[1:] += rng.normal(size=(4, 3)) * 0.05
    fields = (i, j, Zr, Zp, np.arange(1.0, 6.0), np.arange(5.0, 0.0, -1.0))
    return R, p, fields


def _jedges(fields):
    i, j, Zr, Zp, wr, wt = fields
    return JPG.RelPoseEdges(jnp.asarray(i, jnp.int32),
                            jnp.asarray(j, jnp.int32), jnp.asarray(Zr),
                            jnp.asarray(Zp), jnp.asarray(wr),
                            jnp.asarray(wt))


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = b.detach().numpy().astype(np.float64) \
        if isinstance(b, torch.Tensor) else np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300))


@pytest.mark.parametrize("huber", [False, True])
def test_evaluate_relpose_blocks_matches_jax(huber):
    R, p, fields = _edges()
    je, te = _jedges(fields), TPG.edges_from_numpy(fields)
    jd = jnp.full(5, 0.01) if huber else None
    td = torch.full((5,), 0.01, dtype=torch.float64) if huber else None
    a = J_BLOCKS(jnp.asarray(R), jnp.asarray(p), je, jd)
    b = TPG.evaluate_relpose_blocks(torch.tensor(R), torch.tensor(p), te,
                                    td)
    for x, y in zip(a, b):
        assert torch.isfinite(y).all()
        assert _rel(x, y) < TOL
    # the satisfied edge has zero cost and gradient, a finite Hessian
    assert float(torch.abs(b[1][0]).max()) < 1e-12
    assert _rel(JPG.relpose_cost(jnp.asarray(R), jnp.asarray(p), je, jd),
                TPG.relpose_cost(torch.tensor(R), torch.tensor(p), te,
                                 td)) < TOL


def test_evaluate_relpose_blocks_f32_satisfied_edge_finite():
    R, p, fields = _edges(seed=1)
    je = _jedges(fields)
    te = TPG.edges_from_numpy(fields, dtype=torch.float32)
    a = J_BLOCKS(jnp.asarray(R), jnp.asarray(p), je)
    b = TPG.evaluate_relpose_blocks(torch.tensor(R, dtype=torch.float32),
                                    torch.tensor(p, dtype=torch.float32), te)
    for x, y in zip(a, b):
        assert y.dtype == torch.float32 and torch.isfinite(y).all()
        assert _rel(x, y) < 1e-4


def test_evaluate_relpose_dense_and_scatter_match_jax():
    R, p, fields = _edges(seed=2)
    je, te = _jedges(fields), TPG.edges_from_numpy(fields)
    Rt, pt = torch.tensor(R), torch.tensor(p)
    a = J_SCATTER(jnp.asarray(R), jnp.asarray(p), je)
    b = TPG.evaluate_relpose(Rt, pt, te)
    c = TPG.evaluate_relpose_dense(Rt, pt, te)
    d = J_DENSE(jnp.asarray(R), jnp.asarray(p), je)
    for x, y, z, w in zip(a, b, c, d):
        assert _rel(x, y) < TOL and _rel(x, z) < TOL and _rel(w, z) < TOL
    empty = TPG.evaluate_relpose(Rt, pt, TPG.RelPoseEdges.empty())
    assert empty[2].shape == (36, 36) and not torch.any(empty[2])


def test_concat_lift_and_consensus_match_jax():
    R, p, fields = _edges(seed=3)
    je, te = _jedges(fields), TPG.edges_from_numpy(fields)
    assert TPG.concat_edges(None, te) is te
    cat = TPG.concat_edges(te, te)
    jcat = JPG.concat_edges(je, je)
    for x, y in zip(jcat, cat):
        assert np.array_equal(np.asarray(x), y.numpy())
    owner = np.array([0, 0, 1, 1, 2, 2])
    rng = np.random.default_rng(4)
    rel_R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(6, 3))
                                                * 0.2)))
    rel_p = rng.normal(size=(6, 3))
    a = JPG.lift_edges(je, owner, rel_R, rel_p)
    b = TPG.lift_edges(te, owner, rel_R, rel_p)
    assert b.i.shape[0] == a.i.shape[0] == 3
    for x, y in zip(a, b):
        assert _rel(x, y) < 1e-12
    assert TPG.lift_edges(te, np.zeros(6, int), rel_R, rel_p) is None
    args = (list(rel_R[:3]), list(rel_p[:3]), list(rel_R[3:]),
            list(rel_p[3:]))
    for x, y in zip(JPG.consensus_edge(*args), TPG.consensus_edge(*args)):
        assert _rel(x, y) < 1e-12


def _chain(R0, p0):
    R0, p0 = np.asarray(R0), np.asarray(p0)
    W = len(R0)
    i = np.arange(W - 1)
    j = i + 1
    return (i, j, np.einsum("eba,ebc->eac", R0[i], R0[j]),
            np.einsum("eba,eb->ea", R0[i], p0[j] - p0[i]) + 0.01,
            np.full(W - 1, 30.0), np.full(W - 1, 10.0))


def test_damping_iter_xla_edges_matches_jax():
    R0, p0, f = _perturbed(False)
    fields = _chain(R0, p0)
    cfg = dict(max_iters=10, min_planes_per_pose=0)
    jres = jlm.damping_iter(R0, p0, f, JSolverConfig(**cfg),
                            edges=_jedges(fields))
    te = TPG.edges_from_numpy(fields)
    ft = tF.factors_from_numpy([np.asarray(x) for x in f],
                               dtype=torch.float64)
    T = lambda x: torch.tensor(np.asarray(x))
    tres = tlm.damping_iter(T(R0), T(p0), ft, SolverConfig(**cfg), edges=te)
    n = tres.iters
    assert n == int(jres.iters) > 2
    assert np.array_equal(tres.trace_accept[:n],
                          np.asarray(jres.trace_accept)[:n])
    a = np.asarray(jres.trace_res1)[:n]
    assert np.max(np.abs(tres.trace_res1[:n] - a) / np.abs(a)) < 1e-6
    # the resumable chunks and the timed loop take the same transition
    res1, st = tlm.damping_iter_resumable(T(R0), T(p0), ft,
                                          SolverConfig(**cfg), chunk_iters=3,
                                          edges=te)
    while not st["done"] and st["it"] < cfg["max_iters"]:
        res1, st = tlm.damping_iter_resumable(T(R0), T(p0), ft,
                                              SolverConfig(**cfg), state=st,
                                              chunk_iters=3, edges=te)
    assert np.array_equal(res1.trace_res1, tres.trace_res1, equal_nan=True)
    rt, times = tlm.damping_iter_timed(T(R0), T(p0), ft, SolverConfig(**cfg),
                                       edges=te)
    assert np.array_equal(rt.trace_res1, tres.trace_res1, equal_nan=True)
    assert len(times) == rt.iters


def test_damping_iter_packed_edges_matches_jax():
    R_gt, p_gt, scans = make_long_scene(W=10, seed=7)
    R0, p0 = perturb_drift(R_gt, p_gt, seed=8)
    fr = tF.recenter_bodies(tgrid.voxelize(scans, R0, p0,
                                           VoxelConfig()).factors)
    fields = _chain(R0, p0)
    cfg = dict(max_iters=6, min_planes_per_pose=1)
    jres = jlm.damping_iter(
        jnp.asarray(R0, jnp.float32), jnp.asarray(p0, jnp.float32),
        jF.PlaneFactors(*[jnp.asarray(x, jnp.float32) for x in fr]),
        JSolverConfig(**cfg), centered=True, backend="packed",
        edges=JPG.RelPoseEdges(*[jnp.asarray(x, jnp.float32)
                                 if k > 1 else jnp.asarray(x, jnp.int32)
                                 for k, x in enumerate(fields)]))
    tres = tlm.damping_iter(
        torch.tensor(R0, dtype=torch.float32),
        torch.tensor(p0, dtype=torch.float32), tF.factors_from_numpy(fr),
        SolverConfig(**cfg), centered=True, backend="packed",
        edges=TPG.edges_from_numpy(fields, dtype=torch.float32))
    n = tres.iters
    assert n == int(jres.iters) > 0
    assert np.array_equal(tres.trace_accept[:n],
                          np.asarray(jres.trace_accept)[:n])
    assert np.allclose(tres.trace_res1[:n], np.asarray(jres.trace_res1)[:n],
                       rtol=1e-4, atol=0)
    assert abs(tres.residual - float(jres.residual)) \
        < 1e-4 * float(jres.residual)
