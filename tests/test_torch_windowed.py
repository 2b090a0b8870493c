"""The port's span-compressed factors (ops/factors_windowed.py) and banded
solve (solver/banded.py) against the JAX package, on the CPU.

Inputs: tests/test_factors.make_problem with sparse observations and a
fixed moment, body-recentered as tests/test_factors_windowed.py does, in
float64 unless stated.  Tolerances, relative to each quantity's max:
  * from_dense / to_dense: equal
  * evaluate_windowed (res, J, rows, D), hvp, hess_diag, block_jacobi,
    band_hessian, residual_only_windowed: 1e-9
  * solve_banded for B in {S, S+3, 2S}: 1e-6 (the bar of
    test_banded_direct_solve_matches_dense_solve); a singular pivot
    block gives ok=False and x = 0 in both packages
  * float32 centered evaluate: 1e-4 (ROADMAP.md's bar against the f32
    evaluator)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.ops import factors as jF
from balm_tpu.ops import factors_windowed as JFW
from balm_tpu.solver import banded as jbanded
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.ops import factors_windowed as TFW
from balm_tpu_torch.solver import banded as tbanded

from test_factors import make_problem

TOL = 1e-9
# the JAX evaluators jitted: eager, their op-by-op dispatch takes ~10 s
J_EVAL = jax.jit(JFW.evaluate_windowed)
J_RES = jax.jit(JFW.residual_only_windowed)


def _problem(seed=21, G=10, W=8, dtype=np.float64):
    R, p, f, centers = make_problem(G=G, W=W, seed=seed, sparse_obs=True,
                                    with_fix=True)
    f = jF.recenter_bodies(f._replace(centers=centers))
    jwf = JFW.from_dense(jF.PlaneFactors(
        *[jnp.asarray(np.asarray(x), dtype) for x in f]))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    twf = TFW.windowed_from_numpy([np.asarray(x) for x in jwf], dtype=tdt)
    T = lambda x: torch.tensor(np.asarray(x), dtype=tdt)
    return (jnp.asarray(R, dtype), jnp.asarray(p, dtype), jwf, T(R), T(p),
            twf, f)


@pytest.fixture(scope="module")
def parts():
    jR, jp, jwf, tR, tp, twf, _ = _problem()
    return (J_EVAL(jR, jp, jwf),
            TFW.evaluate_windowed(tR, tp, twf), jR.shape[0])


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = b.detach().cpu().numpy().astype(np.float64) \
        if isinstance(b, torch.Tensor) else np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300))


def test_from_dense_and_to_dense_equal_jax():
    *_, f = _problem()
    W = f.C.shape[1]
    nf = tF.PlaneFactors(*[np.asarray(x) for x in f])
    for span in (None, 3):        # a cap keeps the first observers
        jwf = JFW.from_dense(f, span=span)
        twf = TFW.from_dense(nf, span=span)
        assert twf.span == jwf.span and twf.num_planes == jwf.num_planes
        for a, b in zip(jwf, twf):
            assert np.array_equal(np.asarray(a), b)
        for a, b in zip(JFW.to_dense(jwf, W), TFW.to_dense(twf, W)):
            assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("key", ["res", "J", "rows", "D"])
def test_evaluate_windowed_matches_jax(parts, key):
    jp, tp, _ = parts
    assert _rel(getattr(jp, key), getattr(tp, key)) < TOL


def test_hvp_diag_block_jacobi_band_match_jax(parts):
    jp, tp, W = parts
    v = np.random.default_rng(0).normal(size=(W, 6))
    assert _rel(JFW.hvp(jp, jnp.asarray(v), W),
                TFW.hvp(tp, torch.tensor(v), W)) < TOL
    assert _rel(JFW.hess_diag(jp, W), TFW.hess_diag(tp, W)) < TOL
    for damp in (0.0, 0.3):
        assert _rel(JFW.block_jacobi(jp, W, damp),
                    TFW.block_jacobi(tp, W, damp)) < TOL
    Dd = np.abs(v)
    assert _rel(JFW.block_jacobi(jp, W, 0.3, jnp.asarray(Dd)),
                TFW.block_jacobi(tp, W, 0.3, torch.tensor(Dd))) < TOL
    assert _rel(JFW.band_hessian(jp, W), TFW.band_hessian(tp, W)) < TOL


def test_residual_only_windowed_matches_jax():
    jR, jp, jwf, tR, tp, twf, _ = _problem(seed=22)
    a = float(J_RES(jR, jp, jwf))
    b = float(TFW.residual_only_windowed(tR, tp, twf))
    assert abs(a - b) < TOL * abs(a)


def test_evaluate_windowed_same_bits_twice():
    """The pose sums are sorted segment sums: no float scatter."""
    _, _, _, tR, tp, twf, _ = _problem(seed=23)
    a = TFW.evaluate_windowed(tR, tp, twf)
    b = TFW.evaluate_windowed(tR, tp, twf)
    W = tR.shape[0]
    for x, y in ((a.J, b.J), (a.D, b.D),
                 (TFW.band_hessian(a, W), TFW.band_hessian(b, W))):
        assert torch.equal(x, y)


def test_evaluate_windowed_f32_centered_matches_jax():
    jR, jp, jwf, tR, tp, twf, _ = _problem(seed=24, dtype=np.float32)
    a = J_EVAL(jR, jp, jwf)
    b = TFW.evaluate_windowed(tR, tp, twf)
    assert b.J.dtype == torch.float32
    for key in ("res", "J", "rows", "D"):
        assert _rel(getattr(a, key), getattr(b, key)) < 1e-4, key


def _band_system(seed=25):
    jR, jp, jwf, tR, tp, twf, _ = _problem(seed=seed)
    W = jR.shape[0]
    Hb = np.array(JFW.band_hessian(J_EVAL(jR, jp, jwf), W))
    Hb[:, 0] += 50.0 * np.eye(6)
    b = np.random.default_rng(seed).normal(size=6 * W)
    return Hb, b, jwf.span


def test_solve_banded_matches_jax():
    Hb, b, S = _band_system()
    for B in (S, S + 3, 2 * S):
        xj, okj = jbanded.solve_banded(jnp.asarray(Hb), jnp.asarray(b), B)
        xt, okt = tbanded.solve_banded(torch.tensor(Hb), torch.tensor(b), B)
        assert bool(okj) and bool(okt)
        assert _rel(xj, xt) < 1e-6, B


def test_solve_banded_singular_block():
    """A pose with no coupling and a zero diagonal block: the pivot block
    is singular, so both packages report ok=False with x = 0."""
    Hb, b, S = _band_system(seed=26)
    Hb[2] = 0.0
    Hb[1, 1] = 0.0
    Hb[0, 2] = 0.0
    xj, okj = jbanded.solve_banded(jnp.asarray(Hb), jnp.asarray(b), S)
    xt, okt = tbanded.solve_banded(torch.tensor(Hb), torch.tensor(b), S)
    assert not bool(okj) and not bool(okt)
    assert not np.any(np.asarray(xj)) and not torch.any(xt)
