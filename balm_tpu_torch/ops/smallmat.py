"""Batched products of tiny matrices (3x3, 4x4, 6x4) over (plane, scan).

Counterpart: balm_tpu/ops/smallmat.py (matmul :16, matvec :41,
congruence :53).  On the TPU these are unrolled into elementwise
multiply-adds to keep 4-wide contractions off the MXU; on the card they
are batched torch.matmul over the last two dims, with the batch dims
broadcast.  A float32 product here must run in full fp32: the
evaluators that call these hold ops/precision.fp32_matmul around them.
"""

from __future__ import annotations

import torch


def matmul(A, B, *, transpose_b: bool = False):
    """(..., m, k) @ (..., k, n) (or B^T), batch dims broadcast."""
    return A @ (B.transpose(-1, -2) if transpose_b else B)


def matvec(A, v):
    """(..., m, k) @ (..., k) -> (..., m), batch dims broadcast."""
    return (A @ v[..., None])[..., 0]


def congruence(A, B, *, transpose_first: bool = False):
    """A B A^T (or A^T B A)."""
    if transpose_first:
        At = A.transpose(-1, -2)
        return matmul(matmul(At, B), At, transpose_b=True)
    return matmul(matmul(A, B), A, transpose_b=True)
