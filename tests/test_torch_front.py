"""The port's feature extractors (features/loam.py, features/livox.py)
and the LOAM front end (pipelines/loam_front.py) against the JAX
package's, on the JAX tests' inputs.

Tolerances:
  * the extractors (host numpy, copied): bitwise
  * loam_front.run on tests/test_loam_front.make_room_sweeps(W=8) and
    one register_features call: the same surf/edge counts, poses within
    1e-10 (the same float64 GN, sums rounded in another order)
"""

import numpy as np
import pytest
import torch

from balm_tpu.features import livox as jlivox
from balm_tpu.features import loam as jloam
from balm_tpu.pipelines import loam_front as jLF
from balm_tpu_torch.features import livox as tlivox
from balm_tpu_torch.features import loam as tloam
from balm_tpu_torch.pipelines import loam_front as tLF
from balm_tpu_torch.pipelines import odometry as tO
from tests.test_features import make_corner_lines
from tests.test_loam_front import make_room_sweeps

TOL_POSE = 1e-10


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_loam_features_exact():
    lines = make_corner_lines()
    for line in lines[:3]:
        np.testing.assert_array_equal(tloam.curvature(line, 5),
                                      jloam.curvature(line, 5))
    _same(tloam.extract(lines), jloam.extract(lines))
    blind = tloam.LoamConfig(blind=2.5, surf_stride=1)
    _same(tloam.extract(lines, blind),
          jloam.extract(lines, jloam.LoamConfig(blind=2.5, surf_stride=1)))
    assert len(tloam.extract(lines)[1]) > 0


def _wall_line(start, end, n):
    t = np.linspace(0.0, 1.0, n)[:, None]
    return start[None, :] * (1 - t) + end[None, :] * t


def _scanline(kind):
    """tests/test_livox.py's scanlines."""
    if kind == "wall":
        ang = np.linspace(-0.4, 0.4, 300)
        d = 5.0 / np.cos(ang)
        return np.stack([d * np.cos(ang), d * np.sin(ang),
                         np.zeros_like(ang)], axis=-1)
    if kind == "corner":
        a = _wall_line(np.array([4.0, -2.0, 0.0]),
                       np.array([4.0, 2.0, 0.0]), 200)
        b = _wall_line(np.array([4.0, 2.0, 0.0]),
                       np.array([0.5, 2.0, 0.0]), 200)
        return np.concatenate([a, b[1:]])
    if kind == "jump":
        ang1 = np.linspace(-0.3, 0.0, 150)
        near = np.stack([3.0 * np.cos(ang1), 3.0 * np.sin(ang1),
                         np.zeros_like(ang1)], -1)
        ang2 = np.linspace(0.002, 0.3, 150)
        far = np.stack([9.0 * np.cos(ang2), 9.0 * np.sin(ang2),
                        np.zeros_like(ang2)], -1)
        return np.concatenate([near, far])
    ang = np.linspace(-0.4, 0.4, 200)
    return np.stack([0.3 * np.cos(ang), 0.3 * np.sin(ang),
                     np.zeros_like(ang)], -1)


@pytest.mark.parametrize("kind", ["wall", "corner", "jump", "blind"])
@pytest.mark.parametrize("lidar", ["horizon", "velo16"])
def test_livox_scanline_exact(kind, lidar):
    pts = _scanline(kind)
    _same(tlivox.extract_scanline(pts, tlivox.LivoxConfig(lidar_type=lidar)),
          jlivox.extract_scanline(pts, jlivox.LivoxConfig(lidar_type=lidar)))


def test_livox_rings_and_extract_exact():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(2000, 3)) * np.array([5, 5, 1.0])
    _same(tlivox.split_rings_velodyne(pts), jlivox.split_rings_velodyne(pts))
    wall = _scanline("corner")
    _same(tlivox.extract(wall), jlivox.extract(wall))
    cfg_t = tlivox.LivoxConfig(lidar_type="velo16")
    cfg_j = jlivox.LivoxConfig(lidar_type="velo16")
    _same(tlivox.extract(pts, cfg_t, n_scans=16),
          jlivox.extract(pts, cfg_j, n_scans=16))


@pytest.fixture(scope="module")
def room():
    return make_room_sweeps(W=8)


def test_loam_front_run_matches_jax(room):
    R_gt, p_gt, sweeps = room
    Rj, pj, ij = jLF.run(sweeps)
    Rt, pt, it = tLF.run(sweeps, device="cpu")
    assert it == ij
    assert np.median(it["edge_used"]) >= 3
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=TOL_POSE)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL_POSE)


def test_register_features_matches_jax(room):
    """One joint surf + edge registration of sweep 1 against sweep 0's
    maps, from the identity."""
    R_gt, p_gt, sweeps = room
    out = []
    for LF, O in ((jLF, None), (tLF, tO)):
        cfg = LF.LoamFrontConfig()
        f0 = LF.loam.extract(list(sweeps[0]), cfg.loam)
        f1 = LF.loam.extract(list(sweeps[1]), cfg.loam)
        mod = LF.odo
        smap = mod.VoxelPlaneMap(cfg.surf_voxel, cfg.plane_ratio,
                                 cfg.min_points)
        cmap = mod.VoxelPlaneMap(cfg.corner_voxel, 0.0, 4,
                                 line_ratio=cfg.line_ratio)
        smap.insert(f0[0])
        cmap.insert(f0[1])
        kw = {} if O is None else {"device": "cpu"}
        out.append(LF.register_features(f1[0], f1[1], smap, cmap, cfg,
                                        np.eye(3), np.zeros(3), **kw))
    (Rj, pj, nsj, nej), (Rt, pt, nst, net) = out
    assert (nst, net) == (nsj, nej) and nst > 200 and net > 0
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=TOL_POSE)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL_POSE)


def test_loam_front_needs_the_card_by_default(room):
    if torch.cuda.is_available():
        pytest.skip("the card is present: chip_smoke.py phase 13e")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tLF.run(room[2][:2])
