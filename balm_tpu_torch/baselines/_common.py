"""What the baselines share: dense solves with the JAX package's outcome
on a singular system, and their LM accept rule.

`jnp.linalg.solve` and `jnp.linalg.inv` return non-finite values where
the LU factorization meets an exact zero pivot; the LM loops then reject
the step (its trial cost is not finite), and pa.alternate, which has no
accept test, carries the non-finite poses on.  torch.linalg.solve and
torch.linalg.inv raise instead, so the baselines solve through the `_ex`
forms and set a failed system's whole result to NaN: the outcome is
JAX's.
"""

from __future__ import annotations

import math

import torch


def _nan_where_failed(x, info, ntrail):
    bad = (info != 0).reshape(info.shape + (1,) * ntrail)
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def solve(A, b):
    """A x = b for (..., n, n) A and (..., n) or (..., n, k) b (torch's
    broadcasting rules); NaN where A is singular."""
    x, info = torch.linalg.solve_ex(A, b)
    return _nan_where_failed(x, info, x.dim() - info.dim())


def inv(A):
    """Inverse of (..., n, n) A; NaN where A is singular."""
    x, info = torch.linalg.inv_ex(A)
    return _nan_where_failed(x, info, 2)


def lm_rule(c0, c1, u, v, ftol):
    """The baselines' LM accept rule (balm_tpu/baselines/pa_whitened.py:
    105-119 and :237-252, bareg.py:130-144 and :227-242): a trial cost c1
    is taken when finite and below c0, the damping u shrinks by 3 (floor
    1e-12), and the loop stops on a relative decrease below ftol; a
    rejection multiplies u by v, doubles v, and stops once u passes
    1e12.  Returns (accepted, u, v, stop)."""
    if math.isfinite(c1) and c1 < c0:
        rel = abs(c0 - c1) / max(c0, 1e-30)
        return True, max(u / 3.0, 1e-12), 2.0, rel < ftol
    return False, u * v, v * 2.0, u * v > 1e12
