"""The PyTorch port's NEES building blocks — the rest of ops/clusters,
voxel/marginalize, ops/covariance and voxel/grid.StreamingVoxelizer —
against the JAX package on the same numpy inputs, on the CPU in float64.

Problems: tests/test_covariance.make_nees_problem (a marginalized anchor
scan, gauge-constrained), tests/test_factors.make_problem (the problems
of tests/test_marginalize.py) and tests/test_voxelize.make_scene.

Tolerances:
  * transform, cov, recenter, stat_noise_cov: 1e-12 of max|ref| (the
    same closed forms; products round in another order)
  * marginalize: 1e-12 absolute (the same host numpy einsum)
  * scatter_jacobian_rhs and pose_covariance: 1e-9 of max|ref| (per-plane
    eigenvectors from the same closed-form eigh3, then sums over planes
    and a dense solve in another order)
  * StreamingVoxelizer against the port's batch voxelize (numpy and
    native engines) and against the JAX package's StreamingVoxelizer:
    the same planes, layers and leaf centers, factors within 1e-12
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.config import VoxelConfig as JVoxelConfig
from balm_tpu.ops import clusters as jcl
from balm_tpu.ops import covariance as jcov
from balm_tpu.ops import factors as jF
from balm_tpu.ops import lie as jlie
from balm_tpu.voxel import grid as jgrid
from balm_tpu.voxel import marginalize as jmarg
from balm_tpu_torch.config import VoxelConfig
from balm_tpu_torch.ops import clusters as tcl
from balm_tpu_torch.ops import covariance as tcov
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.voxel import grid as tgrid
from balm_tpu_torch.voxel import marginalize as tmarg

from test_covariance import make_nees_problem
from test_factors import make_problem
from test_voxelize import make_scene

T64 = lambda a: torch.tensor(np.asarray(a, np.float64))


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              1e-300)


def _tf(f):
    return tF.factors_from_numpy([np.asarray(x) for x in f],
                                 dtype=torch.float64)


@pytest.fixture(scope="module")
def nees():
    """The NEES problem at its converged-ish poses (the generating ones:
    the identities under test do not need a stationary point)."""
    Rg, pg, f = make_nees_problem(4)
    T = jlie.pose_matrix(Rg, pg)
    ccov = jcl.stat_noise_cov(f.C, 0.02)
    return T, f, ccov


def test_cluster_ops_match_jax():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(6, 40, 3)) * 2.0 + 5.0
    C = np.stack([np.asarray(jcl.from_points(jnp.asarray(x))) for x in pts])
    Tm = np.asarray(jlie.pose_matrix(
        jlie.so3_exp(jnp.asarray(rng.normal(size=(6, 3)))),
        jnp.asarray(rng.normal(size=(6, 3)))))
    c = rng.normal(size=(6, 3))
    for name, got, ref in (
            ("transform", tcl.transform(T64(C), T64(Tm)),
             jcl.transform(jnp.asarray(C), jnp.asarray(Tm))),
            ("transform numpy", tcl.transform(C, Tm),
             jcl.transform(jnp.asarray(C), jnp.asarray(Tm))),
            ("cov", tcl.cov(T64(C)), jcl.cov(jnp.asarray(C))),
            ("recenter", tcl.recenter(T64(C), T64(c)),
             jcl.recenter(jnp.asarray(C), jnp.asarray(c))),
            ("stat_noise_cov", tcl.stat_noise_cov(T64(C), 0.03),
             jcl.stat_noise_cov(jnp.asarray(C), 0.03))):
        assert _rel(got, ref) <= 1e-12, name
    assert np.array_equal(tcl._stack_E().numpy(), np.asarray(jcl._stack_E()))
    assert np.array_equal(tcov._stat_basis().numpy(),
                          np.asarray(jcov._stat_basis(jnp.float64)))


@pytest.mark.parametrize("case", ["absorb", "fix_cap", "unit"])
def test_marginalize_matches_jax(case):
    R, p, f, _ = make_problem(G=4, W=5, seed=71, with_fix=case != "absorb")
    T = np.asarray(jlie.pose_matrix(R, p))
    kw = {}
    if case == "fix_cap":
        big = np.asarray(f.Cfix).copy()
        big[0, 3, 3] = 100.0
        f = f._replace(Cfix=jnp.asarray(big))
    if case == "unit":
        kw = dict(weighting="unit")
    mg = 1 if case == "fix_cap" else 2
    ref = jmarg.marginalize(f, T[:mg], mg, **kw)
    got = tmarg.marginalize(jF.PlaneFactors(*[np.asarray(x) for x in f]),
                            T[:mg], mg, **kw)
    for a, b in zip(got, ref):
        assert isinstance(a, np.ndarray)
        assert a.shape == np.shape(b)
        assert np.max(np.abs(a - np.asarray(b)), initial=0.0) <= 1e-12
    with pytest.raises(ValueError):
        tmarg.marginalize(got, T[:1], 5)


def test_scatter_jacobian_rhs_matches_jax(nees):
    T, f, ccov = nees
    ref = jax.jit(jcov.scatter_jacobian_rhs)(T, f, ccov)
    got = tcov.scatter_jacobian_rhs(T64(T), _tf(f), T64(ccov))
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-9


def test_pose_covariance_matches_jax(nees):
    T, f, ccov = nees
    ref = jax.jit(jcov.pose_covariance)(T, f, ccov)
    got = tcov.pose_covariance(T64(T), _tf(f), T64(ccov))
    assert _rel(got, ref) <= 1e-9
    assert np.all(np.diag(got.numpy()) > 0)


def _sorted_leaves(res):
    """(centers, layers, C, coe) of the valid planes in lexicographic
    center order: the streaming and batch leaves come in other orders."""
    G = res.num_planes
    o = np.lexsort(np.round(res.leaf_center, 6).T)
    return (res.leaf_center[o], np.asarray(res.leaf_layer)[o],
            np.asarray(res.factors.C[:G])[o],
            np.asarray(res.factors.coe[:G])[o])


@pytest.mark.parametrize("layer_limit", [0, 2])
def test_streaming_voxelizer_matches_batch_and_jax(layer_limit):
    R, p, scans = make_scene(seed=23, W=5, n_planes=10, pts_per=300)
    kw = dict(voxel_size=1.0, min_observers=2, layer_limit=layer_limit)
    sv = tgrid.StreamingVoxelizer(len(scans), VoxelConfig(**kw))
    jsv = jgrid.StreamingVoxelizer(len(scans), JVoxelConfig(**kw))
    for i, s in enumerate(scans):
        sv.insert(i, s, R[i], p[i])
        jsv.insert(i, s, R[i], p[i])
    stream = sv.finalize(pad_to=16, weighting="unit")
    jstream = jsv.finalize(pad_to=16, weighting="unit")
    assert sv.n_inserted == len(scans)

    # against the JAX package's StreamingVoxelizer: the same leaves in
    # the same order
    assert stream.num_planes == jstream.num_planes >= 6
    for a, b in zip(stream.factors, jstream.factors):
        assert np.max(np.abs(a - np.asarray(b)), initial=0.0) <= 1e-12
    assert np.array_equal(stream.point_leaf, jstream.point_leaf)
    assert np.array_equal(stream.leaf_layer, jstream.leaf_layer)

    # against the port's batch voxelize, both engines
    for backend in ("numpy", "native"):
        batch = tgrid.voxelize(scans, R, p, VoxelConfig(**kw), pad_to=16,
                               weighting="unit", backend=backend)
        assert stream.num_planes == batch.num_planes
        s_c, s_l, s_C, s_coe = _sorted_leaves(stream)
        b_c, b_l, b_C, b_coe = _sorted_leaves(batch)
        assert np.max(np.abs(s_c - b_c)) <= 1e-12, backend
        assert np.array_equal(s_l, b_l), backend
        assert np.max(np.abs(s_C - b_C)) <= 1e-12, backend
        assert np.array_equal(s_coe, b_coe), backend
