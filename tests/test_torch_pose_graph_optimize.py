"""The port's pose-graph stage (pipelines/loopclose.py: chain_edges,
_sparse_newton_step, pose_graph_optimize) against the JAX package's, in
float64 on the CPU, on tests/test_loopclose.py::
test_pose_graph_sparse_matches_dense's noisy circle.

Tolerances:
  * chain_edges: every field within 1e-12 (the same f64 einsums)
  * pose_graph_optimize against JAX, per solver: the same `iters` and
    `accepted`, final_cost within 1e-10 relative, poses within 1e-9
    (the same host-stepped f64 LM; autodiff derivatives and the LU/splu
    solves round in another order)
  * the port's sparse solver against its dense one: the same bars (the
    JAX test's, tests/test_loopclose.py:474-480)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.ops import lie as jlie
from balm_tpu.ops import pose_graph as jPG
from balm_tpu.pipelines import loopclose as jLC
from balm_tpu_torch.ops import pose_graph as tPG
from balm_tpu_torch.pipelines import loopclose as tLC

W = 40


@pytest.fixture(scope="module")
def circle():
    """The JAX test's inputs: (R0, p0, R_gt, p_gt, loop fields, delta)."""
    rng = np.random.default_rng(3)
    th = np.linspace(0, 2 * np.pi, W, endpoint=False)
    p_gt = np.stack([10 * np.cos(th), 10 * np.sin(th), 0 * th], -1)
    R_gt = np.stack([np.asarray(jlie.so3_exp(jnp.asarray([0, 0, t])))
                     for t in th])
    R0 = np.stack([
        np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.02, 3))))
        @ R_gt[k] for k in range(W)])
    p0 = p_gt + rng.normal(0, 0.05, (W, 3))
    li = np.asarray([0, 5, 12], np.int32)
    lj = np.asarray([W // 2, W // 2 + 5, W - 3], np.int32)
    Zr = np.einsum("eba,ebc->eac", R_gt[li], R_gt[lj])
    Zp = np.einsum("eba,eb->ea", R_gt[li],
                   p_gt[lj] - p_gt[li]) + rng.normal(0, 0.01, (3, 3))
    loops = (li, lj, Zr, Zp, np.full(3, 100.0), np.full(3, 100.0))
    delta = np.concatenate([np.full(W - 1, 1e30), np.full(3, 0.5)])
    return R0, p0, R_gt, p_gt, loops, delta


@pytest.fixture(scope="module")
def solves(circle):
    """Both packages' solves, sparse and dense: {(pkg, solver): out}."""
    R0, p0, R_gt, p_gt, loops, delta = circle
    jedges = jPG.concat_edges(
        jLC.chain_edges(R_gt, p_gt, 0.01, 0.02),
        jPG.RelPoseEdges(*[jnp.asarray(x) for x in loops]))
    tedges = tPG.concat_edges(tLC.chain_edges(R_gt, p_gt, 0.01, 0.02),
                              tPG.edges_from_numpy(loops))
    out = {}
    for solver in ("sparse", "dense"):
        out["jax", solver] = jLC.pose_graph_optimize(
            R0, p0, jedges, delta=jnp.asarray(delta), solver=solver)
        out["torch", solver] = tLC.pose_graph_optimize(
            R0, p0, tedges, delta=delta, solver=solver)
    return out


def _same_solve(a, b):
    Ra, pa, ia = a
    Rb, pb, ib = b
    assert ia["iters"] == ib["iters"]
    assert ia["accepted"] == ib["accepted"]
    np.testing.assert_allclose(ia["final_cost"], ib["final_cost"],
                               rtol=1e-10)
    assert np.max(np.abs(Ra - np.asarray(Rb))) <= 1e-9
    assert np.max(np.abs(pa - np.asarray(pb))) <= 1e-9


def test_chain_edges_matches_jax(circle):
    R0, p0 = circle[:2]
    je = jLC.chain_edges(R0, p0, 0.01, 0.02)
    te = tLC.chain_edges(R0, p0, 0.01, 0.02)
    for name in te._fields:
        a = getattr(te, name).numpy()
        b = np.asarray(getattr(je, name))
        assert a.shape == b.shape, name
        assert np.max(np.abs(a - b), initial=0.0) <= 1e-12, name
    assert te.Zr.dtype == torch.float64 and te.i.dtype == torch.int64


@pytest.mark.parametrize("solver", ["sparse", "dense"])
def test_pose_graph_optimize_matches_jax(solves, solver):
    out = solves["torch", solver]
    assert out[2]["accepted"] > 0
    assert out[2]["final_cost"] < out[2]["initial_cost"]
    _same_solve(out, solves["jax", solver])


def test_pose_graph_sparse_matches_dense(solves, circle):
    _same_solve(solves["torch", "sparse"], solves["torch", "dense"])
    # the gauge: pose 0 keeps its input value
    R0, p0 = circle[:2]
    Rs, ps, _ = solves["torch", "sparse"]
    assert np.max(np.abs(Rs[0] - R0[0])) <= 1e-12
    assert np.max(np.abs(ps[0] - p0[0])) <= 1e-12
    with pytest.raises(ValueError, match="solver"):
        tLC.pose_graph_optimize(R0, p0, tLC.chain_edges(R0, p0, 1.0, 1.0),
                                solver="lu")
