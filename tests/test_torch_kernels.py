"""The PyTorch port's two kernel modules' plain versions against the JAX
package: B1 `csum` (Pallas `_csum_kernel`) and B2 `rows` (Pallas
`_rows_only_kernel`).

Same inputs (made with numpy from a seed, through the JAX tests' own
problem builders) go through the JAX function — its Pallas kernel in
interpret mode and its XLA formulation — and through the port's wrapper,
which on CPU tensors runs the kernel's plain PyTorch version.  The CUDA
kernels themselves are held against these plain versions on the GPU by
chip_smoke.py.

Tolerances (f32 throughout; the two sides sum in different orders):
  * csum moments: 1e-5 of max|.| per case
  * rank rows: 1e-5 of max|.|
  * J and D: 1e-4 relative, the bars of tests/test_pallas_evaluate.py:40-58
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.ops import lie as jlie
from balm_tpu.ops import pallas_evaluate as jpe
from balm_tpu_torch.ops import packed_evaluate as tpe

from test_pallas_evaluate import _packed_problem

CASES = [
    dict(seed=11, sparse_obs=False, with_fix=False),
    dict(seed=12, sparse_obs=True, with_fix=True),
    dict(seed=14, sparse_obs=True, with_fix=True,
         far_shift=jnp.asarray([300.0, -200.0, 120.0])),
    dict(seed=15, G=70, W=13, sparse_obs=True, with_fix=False),
]


def _t(x):
    return torch.tensor(np.asarray(x))


def _relmax(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12)


def _jax_inputs(case):
    """JAX-packed f32 problem at perturbed (trial) poses, and its pose
    channels."""
    R32, p32, f32, packed, _, _, _ = _packed_problem(**case)
    dx = jnp.asarray(np.random.default_rng(case["seed"]).normal(
        size=(R32.shape[0], 6)) * 0.01, jnp.float32)
    R32, p32 = jlie.se3_left_update(R32, p32, dx)
    pose = jpe.pad_poses(R32, p32, packed.wp).astype(jnp.float32)
    return R32, p32, f32, packed, pose


@pytest.mark.parametrize("case", CASES)
def test_csum_plain_matches_jax(case):
    _, _, _, packed, pose = _jax_inputs(case)
    ref_pallas = jpe.csum_packed(pose, packed.mom, packed.cen, packed.cfix,
                                 interpret=True)
    ref_xla = jpe.csum_packed_xla(pose, packed.mom, packed.cen, packed.cfix)
    out = tpe.csum_packed(_t(pose), _t(packed.mom), _t(packed.cen),
                          _t(packed.cfix))
    assert out.shape == (10, packed.gp) and out.dtype == torch.float32
    assert _relmax(out, ref_pallas) < 1e-5
    assert _relmax(out, ref_xla) < 1e-5


@pytest.mark.parametrize("case", CASES)
def test_rows_plain_matches_jax(case):
    _, _, _, packed, pose = _jax_inputs(case)
    csum = jpe.csum_packed_xla(pose, packed.mom, packed.cen, packed.cfix)
    _, aux = jpe._aux_from_csum(csum, packed, 1e-9)
    r0, r1, r2, Jp, Dp = jpe.rows_packed_pallas(
        pose, packed.mom, packed.cen, aux, interpret=True)
    rows_x, jv_x, D_x = jpe._rows_channels_xla(
        pose, packed.mom, packed.cen, aux)
    rows, J, D = tpe.rows_packed(_t(pose), _t(packed.mom), _t(packed.cen),
                                 _t(aux))
    Wp, Gp = packed.wp, packed.gp
    assert rows.shape == (3, 6, Wp, Gp)
    assert J.shape == (Wp, 6) and D.shape == (Wp, 36)
    for k, rk in enumerate((r0, r1, r2)):
        assert _relmax(rows[k], rk) < 1e-5
        ref_k = np.stack([np.asarray(rows_x[j][k]) for j in range(6)])
        assert _relmax(rows[k], ref_k) < 1e-5
    assert _relmax(J, np.asarray(Jp)[:, :6]) < 1e-4
    assert _relmax(D, np.asarray(Dp)[:, :36]) < 1e-4
    J_x = np.stack([np.asarray(jv_x[j]).sum(1) for j in range(6)], 1)
    D_x = np.stack([np.asarray(D_x[a][b]).sum(1)
                    for a in range(6) for b in range(6)], 1)
    assert _relmax(J, J_x) < 1e-4
    assert _relmax(D, D_x) < 1e-4


def test_wrappers_take_plain_only_on_cpu():
    pose = torch.zeros(8, 12)
    mom = torch.zeros(8, 10, 128)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        tpe.csum_packed(pose.to("meta"), mom.to("meta"),
                        torch.zeros(3, 128, device="meta"),
                        torch.zeros(10, 128, device="meta"))
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        tpe.rows_packed(pose, mom.to("meta"), torch.zeros(3, 128),
                        torch.zeros(17, 128))
    # hess_precision='bf16' runs (tests/test_torch_slice.py holds it
    # against JAX); a setting the JAX package does not have raises
    with pytest.raises(ValueError, match="unknown hess_precision"):
        tpe.hess_packed_hybrid(pose, mom, torch.zeros(3, 128),
                               torch.zeros(17, 128), hess_precision="bf8")
