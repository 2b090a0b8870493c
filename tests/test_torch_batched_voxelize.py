"""The port's batched association (voxel/device.voxelize_core_batched)
against B separate calls of its single-problem core and against the JAX
package's jax.vmap of _voxelize_core (the device-batched hierarchy's
bottom level, balm_tpu/pipelines/hierarchical.py:696-706), on
tests/test_hierarchical.make_long_scene (W = 24, 30 planes, 100 points
per plane) cut into B = 3 blocks of 8 scans in block-anchor frames, in
float64 on the CPU.

Tolerances:
  * batched against B single-problem calls at the same caps: the same
    num_planes, overflow and leaf layers, factors within 1e-6 of max|.|
    plane for plane (the same arithmetic on pooled tables; the segment
    sums add the same rows in the same order)
  * against JAX's vmap: the same num_planes and leaf layers, factors
    within 1e-5 relative to max|.| of each leaf (f64 both; sums round in
    another order)
  * a Gcap that one block alone exceeds: the same per-block overflow
    flags as JAX's, mixed (set on some blocks, not on all)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.config import VoxelConfig
from balm_tpu.voxel import device as jdev
from balm_tpu_torch.voxel import device as tdev

from test_hierarchical import make_long_scene, perturb_drift

CAPS = (1 << 8, 1 << 10, 1 << 12)


def core_kw(Gcap, want_point_leaf=False):
    v = VoxelConfig(min_observers=2)
    return dict(voxel_size=float(v.voxel_size),
                layer_limit=int(v.layer_limit),
                eigen_ratio=tuple(float(r) for r in v.eigen_ratio),
                min_points=int(v.min_points), min_observers=2,
                unit_coe=False, cell_caps=CAPS, Gcap=Gcap, cs_cap=1 << 13,
                want_point_leaf=want_point_leaf)


@pytest.fixture(scope="module")
def blocks():
    """(body (B, 8, Nmax, 3), mask, R_rel (B, 8, 3, 3), p_rel) numpy f64:
    each block's scans at the perturbed poses relative to its first."""
    R_gt, p_gt, scans = make_long_scene(W=24, n_planes=30, pts_per=100,
                                        seed=6)
    R0, p0 = perturb_drift(R_gt, p_gt, seed=7)
    idx = np.stack([np.arange(s, s + 8) for s in (0, 8, 16)])
    body, mask = tdev.pad_scans(scans, np.float64)
    Ra, pa = R0[idx[:, 0]], p0[idx[:, 0]]
    R_rel = np.einsum("bca,bwcd->bwad", Ra, R0[idx])
    p_rel = np.einsum("bca,bwc->bwa", Ra, p0[idx] - pa[:, None])
    return body[idx], mask[idx], R_rel, p_rel


def _jax_vmap(blocks, Gcap):
    kw = core_kw(Gcap)
    return jax.vmap(lambda b, m, R, p: jdev._voxelize_core(b, m, R, p, **kw))(
        *[jnp.asarray(a) for a in blocks])


def _port(blocks, Gcap, **kw):
    return tdev.voxelize_core_batched(
        *[torch.as_tensor(a) for a in blocks], **core_kw(Gcap, **kw))


def test_batched_equals_single_calls(blocks):
    out = _port(blocks, 512, want_point_leaf=True)
    assert out.factors.C.shape[:3] == (3, 512, 8)
    assert not out.overflow.any()
    assert int(out.num_planes.min()) > 0
    for b in range(3):
        one = tdev._voxelize_core(*[torch.as_tensor(a[b]) for a in blocks],
                                  **core_kw(512, want_point_leaf=True))
        assert int(one.num_planes) == int(out.num_planes[b])
        assert bool(one.overflow) == bool(out.overflow[b])
        assert torch.equal(one.leaf_layer, out.leaf_layer[b])
        assert torch.equal(one.point_leaf, out.point_leaf[b])
        for a, c in zip(one.factors, out.factors):
            scale = max(float(a.abs().max()), 1e-30)
            assert float((a - c[b]).abs().max()) <= 1e-6 * scale


def test_batched_matches_jax_vmap(blocks):
    jr = _jax_vmap(blocks, 512)
    out = _port(blocks, 512)
    assert out.num_planes.tolist() == np.asarray(jr.num_planes).tolist()
    assert out.overflow.tolist() == np.asarray(jr.overflow).tolist()
    n = int(out.num_planes.max())
    assert np.array_equal(out.leaf_layer.numpy()[:, :n],
                          np.asarray(jr.leaf_layer)[:, :n])
    for name, a, c in zip(out.factors._fields, out.factors, jr.factors):
        a, c = a.numpy(), np.asarray(c)
        scale = np.abs(c).reshape(3, c.shape[1], -1).max(-1)   # per leaf
        scale = np.maximum(scale, 1e-30).reshape(
            scale.shape + (1,) * (c.ndim - 2))
        assert np.max(np.abs(a - c) / scale) <= 1e-5, name


def test_block_overflow_matches_jax(blocks):
    """Gcap = 48 leaves: blocks 1 and 2 alone exceed it, block 0 does
    not, though the pooled tables hold 3 x 48 rows."""
    jr = _jax_vmap(blocks, 48)
    out = _port(blocks, 48)
    flags = out.overflow.tolist()
    assert flags == np.asarray(jr.overflow).tolist()
    assert any(flags) and not all(flags)
    assert out.num_planes.tolist() == np.asarray(jr.num_planes).tolist()
