"""The PyTorch port's packed evaluate (ops/packed_evaluate.py, around
the `csum` and `rows` kernels) against the JAX package's, on the CPU
through the kernels' plain versions.

Tolerance: 1e-4 relative on the residual, J and H, the bars of
tests/test_pallas_evaluate.py:40-58 (f32 sums in other orders).
"""

import numpy as np
import pytest
import torch

from balm_tpu.ops import pallas_evaluate as jpe
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.ops import packed as tpk
from balm_tpu_torch.ops import packed_evaluate as tpe

from test_torch_kernels import CASES, _jax_inputs, _relmax, _t


def _port_packed(f32):
    return tpk.pack_factors(
        tF.factors_from_numpy([np.asarray(x) for x in f32]))


@pytest.mark.parametrize("case", CASES)
def test_evaluate_packed_jw_matches_jax(case):
    R32, p32, f32, packed, _ = _jax_inputs(case)
    res0, J0, H0 = jpe.evaluate_packed_jw(R32, p32, packed, interpret=True)
    res1, J1, H1 = tpe.evaluate_packed_jw(_t(R32), _t(p32), _port_packed(f32))
    assert abs(float(res1) - float(res0)) < 1e-4 * abs(float(res0))
    assert _relmax(J1, J0) < 1e-4
    assert _relmax(H1, H0) < 1e-4


@pytest.mark.parametrize("case", CASES)
def test_residual_only_packed_matches_jax(case):
    R32, p32, f32, packed, _ = _jax_inputs(case)
    r0 = jpe.residual_only_packed(R32, p32, packed, interpret=True)
    r1 = tpe.residual_only_packed(_t(R32), _t(p32), _port_packed(f32))
    assert abs(float(r1) - float(r0)) < 1e-4 * abs(float(r0))


def test_pack_padding_contributes_zero():
    """CUDA-tile padding (Gp % 128, Wp % 8) leaves every output of the
    evaluate unchanged against a pack at the JAX package's 512/8."""
    R32, p32, f32, _, _ = _jax_inputs(CASES[1])
    f = tF.factors_from_numpy([np.asarray(x) for x in f32])
    a = tpe.evaluate_packed_jw(_t(R32), _t(p32), tpk.pack_factors(f))
    b = tpe.evaluate_packed_jw(_t(R32), _t(p32),
                               tpk.pack_factors(f, gpad=512, wpad=16))
    for x, y in zip(a, b):
        assert torch.allclose(x, y, rtol=1e-6, atol=0)
