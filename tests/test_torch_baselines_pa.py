"""The port's plane-parameter baselines — the cluster-form PA
alternation and the reference-faithful PA and BAREG
(balm_tpu_torch/baselines/pa.py, pa_whitened.py and bareg.py) — against
the JAX package's, on the CPU in float64.

Problem: tests/test_baselines.setup's virtual scene (win 4, surf 8,
pts 15).  Each JAX solver runs once per module (a module fixture): the
JAX package builds a fresh jit of jax.hessian on every call.

Tolerances:
  * pa.refit_planes: 1e-10 of max|.|, the (n, d) pair compared up to
    its sign (eigh3's eigenvector sign is not part of the result)
  * pa_whitened.init_planes and bareg.cluster_stats / refit: 1e-10 of
    max|.| (the same closed forms; the port's eigh is ops/eigh3's closed
    form, JAX's LAPACK's, both accurate to rounding on these matrices).
    init_planes fixes its sign by d > 0 and is compared as is; BAREG's
    eigenvectors (the refit normal, the cluster axes) are compared up to
    sign, each column on its own (its costs are squares)
  * the solvers after 3-5 iterations: the same iteration count, poses
    and costs within 1e-9 (relative for the cost; the same f64 steps,
    each dense or batched solve rounding in its own order)
  * a singular LM system (one scan with no points): torch.linalg.solve
    would raise; the port's solve_ex gives a NaN step and both packages
    reject it, leaving the poses unchanged
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.baselines import bareg as jbr
from balm_tpu.baselines import pa as jpa
from balm_tpu.baselines import pa_whitened as jpw
from balm_tpu.ops import lie as jlie
from balm_tpu_torch.baselines import bareg as tbr
from balm_tpu_torch.baselines import pa as tpa
from balm_tpu_torch.baselines import pa_whitened as tpw
from balm_tpu_torch.ops import eigh3 as teigh3
from balm_tpu_torch.ops import lie as tlie

from test_torch_baselines import _rel, _same_solve, _t, problem, unobserved

TOL_REFIT = 1e-10

RUNS = {
    "pa_whitened.solve": (jpw.solve, tpw.solve, dict(max_iters=4)),
    "pa_whitened.solve_schur": (jpw.solve_schur, tpw.solve_schur,
                                dict(max_iters=4)),
    "bareg.solve": (jbr.solve, tbr.solve, dict(outer_iters=1,
                                               inner_iters=4)),
    "bareg.solve_gn": (jbr.solve_gn, tbr.solve_gn, dict(outer_iters=2,
                                                        inner_iters=2)),
}
SINGULAR = {
    "pa_whitened.solve_schur": dict(max_iters=3),
    "bareg.solve_gn": dict(outer_iters=1, inner_iters=3),
}


@pytest.fixture(scope="module")
def pr():
    return problem(seed=1)


@pytest.fixture(scope="module")
def jax_runs(pr):
    """Each JAX solver once on `pr`, and on its singular variant."""
    sg = unobserved(pr)
    out = {name: jfn(pr["R0"], pr["p0"], pr["jf"], **kw)
           for name, (jfn, _, kw) in RUNS.items()}
    out["pa"] = jpa.alternate(pr["R0"], pr["p0"], pr["jf"], outer_iters=2,
                              gn_iters=2)
    for name, kw in SINGULAR.items():
        out[name + "/singular"] = RUNS[name][0](sg["R0"], sg["p0"], sg["jf"],
                                                **kw)
    return out


def test_pa_refit_planes_matches_jax(pr):
    T = tlie.pose_matrix(_t(pr["R0"]), _t(pr["p0"]))
    n, d = tpa.refit_planes(T, pr["tf"])
    nj, dj = jpa.refit_planes(jlie.pose_matrix(jnp.asarray(pr["R0"]),
                                               jnp.asarray(pr["p0"])),
                              pr["jf"])
    nd = torch.cat([n, d[:, None]], -1).numpy()
    ndj = np.concatenate([np.asarray(nj), np.asarray(dj)[:, None]], -1)
    sign = np.sign(np.sum(nd * ndj, axis=-1, keepdims=True))
    assert _rel(nd * sign, ndj) < TOL_REFIT


def test_pa_alternate_matches_jax(pr, jax_runs):
    out = tpa.alternate(pr["R0"], pr["p0"], pr["tf"], outer_iters=2,
                        gn_iters=2)
    _same_solve(jax_runs["pa"], out)


def _up_to_sign(a, b, axis):
    """a with each vector along `axis` flipped to b's sign."""
    a = np.asarray(a)
    b = np.asarray(b)
    return a * np.sign(np.sum(a * b, axis=axis, keepdims=True))


def test_pa_whitened_init_planes_matches_jax(pr):
    T = tlie.pose_matrix(_t(pr["R0"]), _t(pr["p0"]))
    pis = tpw.init_planes(T, pr["tf"])
    pis_j = jpw.init_planes(jlie.pose_matrix(jnp.asarray(pr["R0"]),
                                             jnp.asarray(pr["p0"])), pr["jf"])
    assert _rel(pis, pis_j) < TOL_REFIT


def test_bareg_cluster_stats_matches_jax(pr):
    got = tbr.cluster_stats(pr["tf"])
    ref = jbr.cluster_stats(pr["jf"])
    for name, a, b in zip(("mu", "sw_t", "sw_r", "axes", "N"), got, ref):
        a = a.numpy()
        if name == "axes":
            a = _up_to_sign(a, b, axis=-2)
        assert _rel(a, b) < TOL_REFIT, name


def test_bareg_refit_matches_jax(pr):
    n, mu = tbr.refit(_t(pr["R0"]), _t(pr["p0"]), pr["tf"])
    nj, muj = jbr.refit(jnp.asarray(pr["R0"]), jnp.asarray(pr["p0"]),
                        pr["jf"])
    assert _rel(_up_to_sign(n.numpy(), nj, axis=-1), nj) < TOL_REFIT
    assert _rel(mu, muj) < TOL_REFIT


@pytest.mark.parametrize("name", list(RUNS))
def test_solver_matches_jax(pr, jax_runs, name):
    _, tfn, kw = RUNS[name]
    trace = []
    out = tfn(pr["R0"], pr["p0"], pr["tf"], trace=trace, **kw)
    _same_solve(jax_runs[name], out)
    assert len(trace) > 0


@pytest.mark.parametrize("name", list(SINGULAR))
def test_singular_step_rejected_in_both(pr, jax_runs, name):
    sg = unobserved(pr)
    out = RUNS[name][1](sg["R0"], sg["p0"], sg["tf"], **SINGULAR[name])
    ref = jax_runs[name + "/singular"]
    _same_solve(ref, out)
    # every step rejected: the poses are the start's, re-anchored
    R_start, p_start = tlie.gauge_fix(_t(sg["R0"]), _t(sg["p0"]))
    assert _rel(out[0], R_start) < 1e-12 and _rel(out[1], p_start) < 1e-12
    assert np.all(np.isfinite(np.asarray(ref[0])))


def test_eigh3_matches_lapack_on_cluster_covariances(pr):
    """bareg and pa_whitened take ops/eigh3's closed form on the tensors'
    device where the JAX package calls LAPACK (jnp.linalg.eigh): on the
    (plane, scan) covariances of the problem with one scan unobserved
    (zero matrices) the eigenvalues, the smallest eigenvector up to sign
    and the axes' weighted projector sum_k lam_k e_k e_k^T over the two
    largest (what BAREG's rotation factors read) agree within 1e-10."""
    sg = unobserved(pr)
    C = np.asarray(sg["jf"].C)
    N = np.maximum(C[..., 3, 3], 1.0)
    mu = C[..., :3, 3] / N[..., None]
    cov = C[..., :3, :3] / N[..., None, None] - mu[..., :, None] * mu[
        ..., None, :]
    lam, U = (x.numpy() for x in teigh3.eigh3(_t(cov)))
    lam_j, U_j = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(cov)))
    assert np.all(cov[:, 2] == 0.0)
    assert _rel(lam, lam_j) < TOL_REFIT
    assert _rel(_up_to_sign(U[..., 0], U_j[..., 0], axis=-1),
                U_j[..., 0]) < TOL_REFIT

    def proj(l, V):
        return np.einsum("...k,...ak,...bk->...ab", l[..., 1:], V[..., 1:],
                         V[..., 1:])

    assert _rel(proj(lam, U), proj(lam_j, U_j)) < TOL_REFIT
