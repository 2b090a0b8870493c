"""The PyTorch port's XLA-formulated evaluators (ops/factors.py), the rest
of its lie, smallmat and clusters ops, and kernel B7's glue and plain
version (ops/moments.py), against the JAX package on the same numpy
inputs (tests/test_factors.make_problem), on the CPU.

Tolerances:
  * lie, smallmat, from_points, estimate_centers: 1e-12 (the same closed
    forms; products and sums may round in another order)
  * evaluate / evaluate_right in f64: res 1e-10 relative, J and H 1e-8 of
    max|.| (the bars of tests/test_factors.py)
  * B7's plain version against the Pallas kernel in interpret mode: Csum
    atol 1e-9, the residual through it rtol 1e-10
    (tests/test_pallas_moments.py:31, :44)
  * evaluate in f32 (centered): res 1e-5 relative, J and H 1e-4 of max
    (the bars of tests/test_pallas_evaluate.py:40-58 for two f32 paths)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.ops import clusters as jcl
from balm_tpu.ops import factors as jF
from balm_tpu.ops import lie as jlie
from balm_tpu.ops import pallas_moments as jpm
from balm_tpu.ops import smallmat as jsm
from balm_tpu.parallel.sharded import pad_planes
from balm_tpu_torch.ops import clusters as tcl
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.ops import lie as tlie
from balm_tpu_torch.ops import moments as tmom
from balm_tpu_torch.ops import smallmat as tsm

from test_factors import make_problem


def _err(a, b):
    """max|a - b| (a a tensor, b a JAX or numpy array)."""
    a = a.detach().numpy().astype(np.float64)
    return float(np.max(np.abs(a - np.asarray(b, np.float64)), initial=0.0))


def _rel(a, b):
    """max|a - b| / max|b|."""
    scale = float(np.max(np.abs(np.asarray(b, np.float64)), initial=0.0))
    return _err(a, b) / max(scale, 1e-300)


def _tf(f, dtype=torch.float64):
    return tF.factors_from_numpy([np.asarray(x) for x in f], dtype=dtype)


def _problem(centered, seed=3, sparse_obs=False, with_fix=False, G=6, W=5):
    """(T jax, T torch, f jax): raw moments, or recentered bodies with
    the generating plane centers as conditioning centers."""
    R, p, f, centers = make_problem(G=G, W=W, seed=seed,
                                    sparse_obs=sparse_obs, with_fix=with_fix)
    if centered:
        f = jF.recenter_bodies(f._replace(centers=centers))
    T = jlie.pose_matrix(R, p)
    return T, torch.tensor(np.asarray(T)), f


def test_lie_rest_matches_jax():
    rng = np.random.default_rng(11)
    w = rng.normal(size=(16, 3))
    w[0] = 0.0
    w[1] = [1e-6, -2e-6, 0.5e-6]               # the small branch
    for name in ("so3_jr", "so3_jr_inv"):
        got = getattr(tlie, name)(torch.tensor(w))
        assert _err(got, getattr(jlie, name)(jnp.asarray(w))) < 1e-12
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=(16, 3)))))
    p = rng.normal(size=(16, 3))
    dx = rng.normal(size=(16, 6)) * 0.1
    for a, b in zip(tlie.se3_right_update(torch.tensor(R), torch.tensor(p),
                                          torch.tensor(dx)),
                    jlie.se3_right_update(jnp.asarray(R), jnp.asarray(p),
                                          jnp.asarray(dx))):
        assert _err(a, b) < 1e-12
    v6 = rng.normal(size=(4, 5, 6))
    c = rng.normal(size=(4, 1, 3)) * 3
    M = rng.normal(size=(4, 5, 6, 6))
    assert _err(tlie.adjoint_translation_vec(torch.tensor(v6),
                                             torch.tensor(c)),
                jlie.adjoint_translation_vec(v6, c)) < 1e-12
    assert _err(tlie.centering_hessian_correction(torch.tensor(v6[..., 3:]),
                                                  torch.tensor(c)),
                jlie.centering_hessian_correction(v6[..., 3:], c)) < 1e-12
    assert _err(tlie.adjoint_translation_mat(torch.tensor(M),
                                             torch.tensor(c)),
                jlie.adjoint_translation_mat(M, c)) < 1e-12


def test_smallmat_matches_jax():
    rng = np.random.default_rng(12)
    A = rng.normal(size=(3, 1, 6, 4))
    B = rng.normal(size=(3, 5, 4, 4))
    Bt = rng.normal(size=(1, 5, 3, 4))
    v = rng.normal(size=(3, 5, 4))
    S = rng.normal(size=(3, 5, 4, 4))
    pairs = (
        (tsm.matmul(torch.tensor(A), torch.tensor(B)), jsm.matmul(A, B)),
        (tsm.matmul(torch.tensor(A), torch.tensor(Bt), transpose_b=True),
         jsm.matmul(A, Bt, transpose_b=True)),
        (tsm.matvec(torch.tensor(A), torch.tensor(v)), jsm.matvec(A, v)),
        (tsm.congruence(torch.tensor(A), torch.tensor(S)),
         jsm.congruence(A, S)),
        (tsm.congruence(torch.tensor(B), torch.tensor(S),
                        transpose_first=True),
         jsm.congruence(B, S, transpose_first=True)),
    )
    for got, ref in pairs:
        assert got.shape == ref.shape
        assert _err(got, ref) < 1e-12


def test_from_points_matches_jax():
    rng = np.random.default_rng(13)
    pts = rng.normal(size=(60, 3)) * 4
    seg = rng.integers(0, 7, size=60)
    assert _err(tcl.homogenize(torch.tensor(pts)), jcl.homogenize(pts)) == 0
    assert _err(tcl.from_points(torch.tensor(pts)),
                jcl.from_points(jnp.asarray(pts))) < 1e-12
    got = tcl.from_points(torch.tensor(pts), torch.tensor(seg), 8)
    ref = jcl.from_points(jnp.asarray(pts), jnp.asarray(seg, jnp.int32), 8)
    assert got.shape == (8, 4, 4)
    assert _err(got, ref) < 1e-12


def test_estimate_centers_matches_jax():
    T, Tt, f = _problem(False, seed=14, sparse_obs=True, with_fix=True)
    got = tF.estimate_centers(Tt, _tf(f))
    assert _err(got, jF.estimate_centers(T, f)) < 1e-12
    f2 = _tf(f)
    assert f2.num_planes == 6 and f2.window == 5


@pytest.mark.parametrize("l_set", [(0,), (0, 1)], ids=["planes", "lines"])
@pytest.mark.parametrize("centered", [False, True],
                         ids=["raw", "centered"])
@pytest.mark.parametrize("sparse_obs,with_fix", [(False, False),
                                                 (True, True)],
                         ids=["dense", "sparse_fix"])
def test_evaluate_f64_matches_jax(sparse_obs, with_fix, centered, l_set):
    T, Tt, f = _problem(centered, seed=21, sparse_obs=sparse_obs,
                        with_fix=with_fix)
    res, J, H = tF.evaluate(Tt, _tf(f), centered=centered, l_set=l_set)
    rj, Jj, Hj = jF.evaluate(T, f, centered=centered, l_set=l_set)
    assert H.shape == (30, 30) and J.shape == (30,)
    assert _rel(res[None], np.asarray(rj)[None]) < 1e-10
    assert _rel(J, Jj) < 1e-8
    assert _rel(H, Hj) < 1e-8
    r0 = tF.residual_only(Tt, _tf(f), centered=centered, l_set=l_set)
    assert _rel(r0[None], np.asarray(rj)[None]) < 1e-10


@pytest.mark.parametrize("centered", [False, True],
                         ids=["raw", "centered"])
def test_evaluate_lapack_eigh_matches_jax(centered):
    """torch.linalg.eigh in place of eigh3: against JAX's LAPACK path and
    against the port's own eigh3 path (eigenvector signs may differ; every
    quantity uses each u_k twice or in an outer product)."""
    T, Tt, f = _problem(centered, seed=22, sparse_obs=True)
    got = tF.evaluate(Tt, _tf(f), centered=centered, use_lapack_eigh=True)
    ref = jF.evaluate(T, f, centered=centered, use_lapack_eigh=True)
    own = tF.evaluate(Tt, _tf(f), centered=centered)
    for a, b, c, tol in zip(got, ref, own, (1e-10, 1e-8, 1e-8)):
        b = np.asarray(b)
        assert _rel(a.reshape(-1), b.reshape(-1)) < tol
        assert _rel(a.reshape(-1), c.numpy().reshape(-1)) < tol
    r0 = tF.residual_only(Tt, _tf(f), centered=centered, use_lapack_eigh=True)
    assert _rel(r0[None], np.asarray(ref[0])[None]) < 1e-10


@pytest.mark.parametrize("sparse_obs,with_fix", [(False, False),
                                                 (True, True)],
                         ids=["dense", "sparse_fix"])
def test_evaluate_right_matches_jax(sparse_obs, with_fix):
    T, Tt, f = _problem(False, seed=23, sparse_obs=sparse_obs,
                        with_fix=with_fix)
    res, J, H = tF.evaluate_right(Tt, _tf(f))
    rj, Jj, Hj = jF.evaluate_right(T, f)
    assert _rel(res[None], np.asarray(rj)[None]) < 1e-10
    assert _rel(J, Jj) < 1e-8
    assert _rel(H, Hj) < 1e-8


@pytest.mark.parametrize("l_set", [(0,), (0, 1), (1,)],
                         ids=["l0", "l01", "l1"])
def test_residual_only_matches_jax(l_set):
    for centered in (False, True):
        T, Tt, f = _problem(centered, seed=24, with_fix=True)
        got = tF.residual_only(Tt, _tf(f), centered=centered, l_set=l_set)
        ref = jF.residual_only(T, f, centered=centered, l_set=l_set)
        assert _rel(got[None], np.asarray(ref)[None]) < 1e-10


def _padded(seed, **kw):
    """test_pallas_moments.py's problem: recentered, conditioning centers,
    the plane axis padded to 128."""
    R, p, f, centers = make_problem(seed=seed, **kw)
    f = pad_planes(jF.recenter_bodies(f._replace(centers=centers)), 128)
    T = jlie.pose_matrix(R, p)
    return T, torch.tensor(np.asarray(T)), f


def test_moments_plain_matches_pallas():
    T, Tt, f = _padded(61, G=7, W=5, sparse_obs=True, with_fix=True)
    packed = tmom.pack_inputs(Tt, _tf(f))
    for a, b in zip(packed, jpm.pack_inputs(T, f)):
        assert a.shape == b.shape and a.is_contiguous()
        assert _err(a, b) < 1e-12
    got = tmom.accumulate_moments(*packed)         # CPU: the plain version
    ref = jpm.accumulate_moments(*[jnp.asarray(x.numpy()) for x in packed],
                                 interpret=True)
    assert _err(got, ref) < 1e-9
    Csum = tmom.residual_moments(Tt, _tf(f))
    assert _err(Csum, jpm.residual_moments(T, f, interpret=True)) < 1e-9
    # and the centered moment path without the fixed moment
    _, _, TCT, *_ = tF._plane_moment(Tt, _tf(f), centered=True)
    assert _err(Csum, TCT.sum(1).numpy()) < 1e-9


def test_residual_through_moments_matches_pallas():
    T, Tt, f = _padded(62, G=6, W=4, with_fix=True)
    got = tF.residual_only(Tt, _tf(f), centered=True, use_pallas=True)
    ref = jF.residual_only(T, f, centered=True, use_pallas=True,
                           pallas_interpret=True)
    assert np.allclose(float(got), float(ref), rtol=1e-10)
    plain = tF.residual_only(Tt, _tf(f), centered=True)
    assert np.allclose(float(got), float(plain), rtol=1e-10)
    # without centering, use_pallas falls through to the moment path
    raw = tF.residual_only(Tt, _tf(f), use_pallas=True)
    assert float(raw) == float(tF.residual_only(Tt, _tf(f)))


def test_moments_wrapper_refuses_bad_inputs():
    R9, CH, OFS = torch.zeros(4, 9), torch.zeros(4, 10, 100), \
        torch.zeros(4, 3, 100)
    with pytest.raises(ValueError, match="multiple of 128"):
        tmom.accumulate_moments(R9, CH, OFS)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        tmom.accumulate_moments(R9, CH.to("meta"), OFS)
    with pytest.raises(ValueError, match=r"\(W, 10, G\)"):
        tmom.accumulate_moments(R9, torch.zeros(4, 9, 128), OFS)


def test_evaluate_f32_centered_matches_jax():
    T, Tt, f = _problem(True, seed=25, sparse_obs=True, with_fix=True)
    f32 = f.astype(jnp.float32)
    res, J, H = tF.evaluate(Tt.float(), _tf(f32, torch.float32),
                            centered=True)
    rj, Jj, Hj = jF.evaluate(T.astype(jnp.float32), f32, centered=True)
    assert res.dtype == torch.float32
    assert _rel(res[None], np.asarray(rj)[None]) < 1e-5
    assert _rel(J, Jj) < 1e-4
    assert _rel(H, Hj) < 1e-4
