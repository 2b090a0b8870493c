"""Full-fp32 matrix products on the card, whatever the caller set.

Counterpart: the JAX package's `jax.default_matmul_precision("float32")`
scopes (balm_tpu/solver/lm.py:155-159, balm_tpu/ops/factors.py:336,
:374).  A float32 product on the card may run in TF32 (a 10-bit
mantissa) when the caller switched TF32 on; on moment math that is the
same silent corruption as one bf16 pass on the TPU's MXU, so every
float32 product of the port (the LM loop, the evaluators, the Hessian
products) runs inside `fp32_matmul()`.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_matmul():
    """Full-fp32 cuBLAS matrix products (TF32 off), restored after.

    Sets `torch.backends.cuda.matmul.fp32_precision` to 'ieee' where that
    attribute exists.  Once a caller has used it, reading the legacy
    `allow_tf32` raises ("mix of the legacy and new APIs"), so the
    legacy flag is read only on a torch that lacks the new one.
    """
    m = torch.backends.cuda.matmul
    if hasattr(m, "fp32_precision"):
        prev = m.fp32_precision
        m.fp32_precision = "ieee"
        try:
            yield
        finally:
            m.fp32_precision = prev
    else:
        prev = m.allow_tf32
        m.allow_tf32 = False
        try:
            yield
        finally:
            m.allow_tf32 = prev
