"""The PyTorch port's small ops (lie, eigh3) against the JAX package's,
and the port's import boundary (no jax, no balm_tpu).

Tolerances: f64 1e-12 (same closed forms, same operation order); f32
eigenvalues 1e-5 of max|.| (transcendentals from two libraries).
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from balm_tpu.ops import eigh3 as jeig
from balm_tpu.ops import lie as jlie
from balm_tpu_torch.ops import eigh3 as teig
from balm_tpu_torch.ops import lie as tlie

from test_torch_kernels import _relmax


def test_eigh3_matches_jax():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(64, 3, 3))
    A = A @ np.swapaxes(A, -1, -2)
    A[0] = np.diag([1.0, 1.0, 2.0])            # repeated eigenvalue
    A[1] = 0.0                                 # all-zero
    A[2] = np.diag([3e-4, 1.0, 1.0 + 1e-7])    # thin plane, near-repeat
    for dt in (np.float64, np.float32):
        lam_j, U_j = jeig.eigh3(jnp.asarray(A, dt))
        lam_t, U_t = teig.eigh3(torch.tensor(A.astype(dt)))
        tol = 1e-12 if dt == np.float64 else 1e-5
        assert _relmax(lam_t, lam_j) < tol
        assert _relmax(teig.eigvals3(torch.tensor(A.astype(dt))),
                       jeig.eigvals3(jnp.asarray(A, dt))) < tol
        # eigenvectors are sign-free: compare the projectors u u^T
        Pj = np.einsum("gik,gjk->gkij", U_j, U_j)
        Pt = np.einsum("gik,gjk->gkij", U_t.numpy(), U_t.numpy())
        assert np.max(np.abs(Pj[3:] - Pt[3:])) < 100 * tol


def test_lie_matches_jax():
    rng = np.random.default_rng(6)
    w = rng.normal(size=(32, 3))
    w[0] = 0.0
    w[1] = [np.pi - 1e-4, 0.0, 0.0]            # the near-pi branch
    w[2] = [1e-6, -2e-6, 0.5e-6]               # the small branch
    R_j = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    R_t = tlie.so3_exp(torch.tensor(w))
    assert np.max(np.abs(R_t.numpy() - R_j)) < 1e-12
    assert np.max(np.abs(tlie.so3_log(R_t).numpy()
                         - np.asarray(jlie.so3_log(jnp.asarray(R_j))))) < 1e-9
    assert np.max(np.abs(tlie.vee(tlie.hat(torch.tensor(w))).numpy() - w)) == 0
    p = rng.normal(size=(32, 3))
    dx = rng.normal(size=(32, 6)) * 0.1
    for a, b in zip(tlie.se3_left_update(R_t, torch.tensor(p), torch.tensor(dx)),
                    jlie.se3_left_update(jnp.asarray(R_j), jnp.asarray(p),
                                         jnp.asarray(dx))):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) < 1e-12
    for a, b in zip(tlie.gauge_fix(R_t, torch.tensor(p)),
                    jlie.gauge_fix(jnp.asarray(R_j), jnp.asarray(p))):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) < 1e-12
    T_t = tlie.pose_matrix(torch.tensor(R_j), torch.tensor(p))
    assert np.max(np.abs(T_t.numpy() - np.asarray(
        jlie.pose_matrix(jnp.asarray(R_j), jnp.asarray(p))))) == 0


def test_port_imports_neither_jax_nor_balm_tpu():
    code = ("import sys, balm_tpu_torch, balm_tpu_torch.api, chip_smoke, "
            "balm_tpu_torch.ops.moments, balm_tpu_torch.ops.smallmat, "
            "balm_tpu_torch.pipelines.virtual; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'balm_tpu' or "
            "m.startswith('balm_tpu.')]; "
            "assert not bad, bad")
    repo = pathlib.Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=repo)
