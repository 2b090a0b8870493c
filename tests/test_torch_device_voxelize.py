"""The port's association on the device (balm_tpu_torch/voxel/device.py)
and its segmented sums (ops/segments.py) against the JAX package, on the
CPU.

The JAX side runs in f64 under the test conftest's x64, the port with
dtype=torch.float64 and device='cpu'.  Tolerances:
  * ops/segments: 1e-12 absolute on O(1) data (both sum in f64, in other
    orders)
  * voxelize_device: the same plane count and leaf order, leaf_layer,
    coe and point_leaf equal; leaf_decision, C, centers and
    body_centers within 1e-9 (the JAX package's own bar against the host
    voxelizer, tests/test_device_voxelize.py)
Every JAX call is padded to one (W, Nmax) = (3, 2048) shape with
Gcap=128, so its _voxelize_core compiles once per (min_observers,
weighting) pair.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.config import VoxelConfig as JVoxelConfig
from balm_tpu.ops import segments as jseg
from balm_tpu.voxel import device as jdev
from balm_tpu_torch.config import VoxelConfig
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.ops import lie as tlie
from balm_tpu_torch.ops import packed as tpacked
from balm_tpu_torch.ops import packed_evaluate as tpe
from balm_tpu_torch.ops import segments as tseg
from balm_tpu_torch.voxel import device as tdev
from balm_tpu_torch.voxel import grid as tgrid

from test_voxelize import make_scene

TOL = 1e-9
W, NMAX, GCAP = 3, 2048, 128
F64 = dict(dtype=torch.float64, device="cpu")


def _padded(scans):
    return tdev.pad_scans(scans, np.float64, multiple=NMAX)


def _both(scans, R, p, *, min_observers=2, weighting="point_count", **kw):
    """(JAX result, port result) on the same pre-padded input."""
    body, mask = _padded(scans)
    assert body.shape[:2] == (W, NMAX)
    a = jdev.voxelize_device(
        (jnp.asarray(body), jnp.asarray(mask)), R, p,
        JVoxelConfig(voxel_size=1.0, min_observers=min_observers),
        Gcap=GCAP, weighting=weighting)
    b = tdev.voxelize_device(
        (body, mask), R, p,
        VoxelConfig(voxel_size=1.0, min_observers=min_observers),
        weighting=weighting, **{"Gcap": GCAP, **F64, **kw})
    return a, b


def _same(a, b, n=None):
    """The port's result equals JAX's over its first n planes (all of
    Gcap when n is None)."""
    na = int(a.num_planes)
    assert int(b.num_planes) == na > 0
    assert not bool(a.overflow) and not bool(b.overflow)
    n = len(a.leaf_layer) if n is None else n
    fa, fb = a.factors, b.factors
    np.testing.assert_array_equal(np.asarray(a.leaf_layer)[:n],
                                  b.leaf_layer.numpy()[:n])
    np.testing.assert_array_equal(np.asarray(fa.coe)[:n], fb.coe.numpy()[:n])
    for name in ("C", "centers", "body_centers", "Cfix"):
        np.testing.assert_allclose(np.asarray(getattr(fa, name))[:n],
                                   getattr(fb, name).numpy()[:n], rtol=0,
                                   atol=TOL, err_msg=name)
    np.testing.assert_allclose(np.asarray(a.leaf_decision)[:n],
                               b.leaf_decision.numpy()[:n], rtol=0, atol=TOL)
    return na


@pytest.mark.parametrize("S", [40, 3])
def test_segments_match_jax(S):
    rng = np.random.default_rng(0)
    N, C = 3000, 10
    seg = np.sort(rng.integers(-3, S + 4, size=N)).astype(np.int32)
    seg[1000:1700] = seg[1000]          # one long run
    seg = np.sort(seg)
    data = rng.normal(size=(N, C))
    a = jseg.sorted_segment_sum(jnp.asarray(data), jnp.asarray(seg),
                                num_segments=S, block=64)
    b = tseg.sorted_segment_sum(torch.tensor(data), torch.tensor(seg),
                                num_segments=S)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-12)
    ja = jseg.segment_bounds(jnp.asarray(seg), S)
    tb = tseg.segment_bounds(torch.tensor(seg), S)
    for x, y in zip(ja, tb):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    fa = jseg.segment_first(jnp.asarray(data), jnp.asarray(seg),
                            num_segments=S)
    fb = tseg.segment_first(torch.tensor(data), torch.tensor(seg),
                            num_segments=S)
    np.testing.assert_array_equal(np.asarray(fa), fb.numpy())


def test_flat_scene_matches_jax():
    R, p, scans = make_scene(seed=11, W=W, n_planes=8, pts_per=250)
    a, b = _both(scans, R, p)
    n = _same(a, b)
    assert len(b.attempts) == 1 and not b.attempts[0]["overflow"]
    np.testing.assert_array_equal(np.asarray(a.point_leaf),
                                  b.point_leaf.numpy())
    # padding rows exactly zero (the tested framework invariant)
    for x in b.factors:
        assert torch.all(x[n:] == 0)
    # and against the port's host voxelizer, recentered, by leaf centre
    h = tgrid.voxelize(scans, R, p, VoxelConfig(voxel_size=1.0),
                       backend="numpy")
    assert h.num_planes == n
    oa = np.lexsort(np.round(h.leaf_center, 6).T)
    ob = np.lexsort(np.round(b.factors.centers[:n].numpy(), 6).T)
    np.testing.assert_allclose(tF.recenter_bodies(h.factors).C[:n][oa],
                               b.factors.C[:n].numpy()[ob], atol=TOL)


def test_subdivision_and_observer_gate_match_jax():
    """Octant subdivision (two sub-voxel planes in one root) and the
    min_observers admission (tests/test_device_voxelize.py:73)."""
    rng = np.random.default_rng(4)
    R = np.tile(np.eye(3), (W, 1, 1))
    p = np.zeros((W, 3))
    scans = []
    for _ in range(W):
        uvA = rng.uniform(0.02, 0.48, size=(300, 2))
        A = np.stack([uvA[:, 0], uvA[:, 1], np.full(300, 0.25)], -1)
        uvB = rng.uniform(0.52, 0.98, size=(300, 2))
        B = np.stack([np.full(300, 0.75), uvB[:, 0], uvB[:, 1]], -1)
        scans.append(np.concatenate([A, B])
                     + rng.normal(0, 0.001, size=(600, 3)))
    # a plane seen by ONE scan only: admitted iff min_observers == 1
    solo = np.stack([rng.uniform(8.05, 8.95, 120),
                     rng.uniform(0.05, 0.95, 120),
                     np.full(120, 0.5) + rng.normal(0, 0.002, 120)], -1)
    scans[0] = np.concatenate([scans[0], solo])
    n2 = _same(*_both(scans, R, p, min_observers=2))
    n1 = _same(*_both(scans, R, p, min_observers=1))
    assert n2 >= 2 and n1 == n2 + 1


def test_prepadded_unit_weighting_matches_jax():
    R, p, scans = make_scene(seed=3, W=W, n_planes=5, pts_per=150)
    a, b = _both(scans, R, p, weighting="unit")
    n = _same(a, b)
    assert torch.all(b.factors.coe[:n] == 1.0)
    assert torch.all(b.factors.coe[n:] == 0.0)


def test_overflow_retry_matches_jax():
    """Undersized capacities set the overflow flag; the retry with every
    capacity 4x gives JAX's correctly sized result, leaf for leaf."""
    R, p, scans = make_scene(seed=11, W=W, n_planes=8, pts_per=250)
    a, _ = _both(scans, R, p)
    tiny = tdev.voxelize_device(
        _padded(scans), R, p, VoxelConfig(voxel_size=1.0),
        cell_caps=(8, 16, 32), Gcap=8, cs_cap=1 << 10, pair_cap=16,
        max_retries=3, **F64)
    assert [a["overflow"] for a in tiny.attempts] == [True] * (
        len(tiny.attempts) - 1) + [False]
    assert tiny.attempts[1]["Gcap"] == 4 * tiny.attempts[0]["Gcap"] == 32
    assert len(tiny.attempts) > 1
    _same(a, tiny, n=int(a.num_planes))
    # out of retries: the last result keeps its overflow flag
    short = tdev.voxelize_device(
        _padded(scans), R, p, VoxelConfig(voxel_size=1.0),
        cell_caps=(8, 16, 32), Gcap=8, cs_cap=1 << 10, pair_cap=16,
        max_retries=0, **F64)
    assert bool(short.overflow) and len(short.attempts) == 1


def test_too_many_scans_raises():
    """W beyond the packed-key budget fails loudly, in both packages."""
    body = np.zeros((2048, 8, 3))
    mask = np.ones((2048, 8), bool)
    R = np.tile(np.eye(3), (2048, 1, 1))
    p = np.zeros((2048, 3))
    kw = dict(voxel_size=1.0, layer_limit=2, eigen_ratio=(1 / 16,),
              min_points=5, min_observers=1, unit_coe=False,
              cell_caps=(64, 128, 256), Gcap=64, cs_cap=1 << 10)
    with pytest.raises(ValueError, match="key bits"):
        jdev._voxelize_core(jnp.asarray(body), jnp.asarray(mask),
                            jnp.asarray(R), jnp.asarray(p), **kw)
    with pytest.raises(ValueError, match="key bits"):
        tdev._voxelize_core(*[torch.tensor(x) for x in (body, mask, R, p)],
                            **kw)


def test_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    R, p, scans = make_scene(seed=3, W=2, n_planes=2, pts_per=20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.voxelize_device(scans, R, p)


def test_trimmed_padding_changes_no_residual():
    """realworld.run drops the zero padding rows before the solve: the
    same residual, gradient and Hessian with and without them, on the
    packed f32 path (its plain versions here) and the f64 evaluator."""
    R, p, scans = make_scene(seed=7, W=W, n_planes=8, pts_per=220)
    res = tdev.voxelize_device(scans, R, p, VoxelConfig(voxel_size=1.0),
                               Gcap=256, device="cpu")
    n = int(res.num_planes)
    assert 0 < n < 256
    full, cut = res.factors, tdev.trim_planes(res.factors, n)
    Rt = torch.tensor(R, dtype=torch.float32)
    pt = torch.tensor(p, dtype=torch.float32)
    ev = [tpe.evaluate_packed_jw(Rt, pt, tpacked.pack_factors(f))
          for f in (full, cut)]
    assert tpacked.pack_factors(full).gp > tpacked.pack_factors(cut).gp
    for x, y in zip(*ev):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6 * float(
            y.abs().max()))
    T = tlie.pose_matrix(torch.tensor(R), torch.tensor(p))
    r = [tF.residual_only(T, f.astype(torch.float64), centered=True)
         for f in (full, cut)]
    assert abs(float(r[0]) - float(r[1])) <= 1e-12 * abs(float(r[1]))
