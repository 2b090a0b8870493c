"""Block-Jacobi preconditioned CG: what damping_iter(linear_solver='pcg')
needs of the JAX package's large-window solver.

Counterpart: balm_tpu/solver/large.py — _chol6 (:89), _inv6 (:94),
_precond_apply (:108) and _pcg (:114).  The rest of that module (the
matrix-free large-window LM over windowed factors) is ROADMAP.md queue
A, item 11.

JAX runs the CG loop as one while_loop on the device.  Here the host
drives it without a read per iteration: each iteration is guarded (a
finished carry passes through unchanged by torch.where), and the host
reads the carry's `active` flag once every _CHECK_EVERY iterations.
The iterates are JAX's; a finished solve costs at most _CHECK_EVERY - 1
guarded no-op iterations.
"""

from __future__ import annotations

import torch

_CHECK_EVERY = 16


def _chol6(A):
    """Batched 6x6 Cholesky factors; NaN where a block is not positive
    definite (jnp.linalg.cholesky's result there)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[:, None, None], L, torch.nan)


def _inv6(A):
    """Batched symmetrized 6x6 inverse of the block-Jacobi
    preconditioner; NaN where a block is singular.  M^-1 only steers CG,
    so the inverse's roundoff is harmless; symmetrizing keeps it a
    valid CG preconditioner."""
    Minv, info = torch.linalg.inv_ex(A)
    Minv = torch.where((info == 0)[:, None, None], Minv, torch.nan)
    return 0.5 * (Minv + Minv.transpose(-1, -2))


def _precond_apply(Minv, r):
    """z = M^-1 r by the cached block inverses; r flat (6W,)."""
    W = Minv.shape[0]
    return (Minv @ r.view(W, 6, 1)).reshape(-1)


def _pcg(matvec, b, Minv, max_iters, tol):
    """Preconditioned CG for A x = b -> (x, iterations (a 0-d tensor)).

    Minv: (W, 6, 6) block-Jacobi inverse blocks (see _inv6).  Truncated
    at non-positive curvature, keeping the partial step (LM then rejects
    and raises u), as in JAX.
    """
    x = torch.zeros_like(b)
    r = b
    z = _precond_apply(Minv, r)
    p = z
    rz = torch.dot(r, z)
    bnorm = torch.sqrt(torch.dot(b, b))
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    ok = torch.ones((), dtype=torch.bool, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    n = 0
    while n < max_iters:
        active = ok & (k < max_iters) & (torch.sqrt(torch.dot(r, r)) > tol * bnorm)
        if n % _CHECK_EVERY == 0 and not bool(active):
            break
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        posdef = pAp > 0
        alpha = torch.where(posdef, rz / torch.where(posdef, pAp, one), 0.0)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = _precond_apply(Minv, r_n)
        rz_n = torch.dot(r_n, z)
        beta = rz_n / torch.where(rz == 0, one, rz)
        p_n = z + beta * p
        x = torch.where(active, x_n, x)
        r = torch.where(active, r_n, r)
        p = torch.where(active, p_n, p)
        rz = torch.where(active, rz_n, rz)
        k = torch.where(active, k + 1, k)
        ok = torch.where(active, posdef, ok)
        n += 1
    return x, k
