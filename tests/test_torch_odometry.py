"""The port's streaming odometry (pipelines/odometry.py, the odometry
checkpoint pair of utils/checkpoint.py) against the JAX package's, in
float64 on the CPU.

Tolerances:
  * VoxelPlaneMap (host numpy, copied): bitwise — keys, moments, the
    plane and line tables, lookups and state_dict
  * the fused GNs and _apply_step: poses within 1e-10 (the same f64
    normal equations; the 6x6 solves and sums round in another order);
    on an all-masked, a NaN and a singular system the step is skipped on
    both packages with no exception (torch.linalg.solve would raise)
  * register_scan: n_used equal, poses within 1e-10
  * odometry.run on make_long_scene(W=16, seed=21): the same reg_points
    and ba_runs, poses within 1e-8 (window BAs through two LM
    implementations); the port resuming a JAX-written checkpoint lands
    on the JAX package's uninterrupted run within the same 1e-8, and the
    port's own stop/resume is bitwise
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.ops import lie as jlie
from balm_tpu.pipelines import odometry as jO
from balm_tpu.utils import checkpoint as jckpt
from balm_tpu_torch.pipelines import odometry as tO
from balm_tpu_torch.utils import checkpoint as tckpt
from tests.test_hierarchical import make_long_scene

TOL_GN = 1e-10
TOL_RUN = 1e-8


def _pole_scene(seed=8):
    """tests/test_odometry.py::test_point_to_line_registration's floor
    and two vertical poles."""
    rng = np.random.default_rng(seed)
    floor = np.stack([rng.uniform(0, 3, 400), rng.uniform(0, 3, 400),
                      rng.normal(0, 0.004, 400)], -1)
    pole1 = np.stack([np.full(360, 0.5) + rng.normal(0, 0.004, 360),
                      np.full(360, 0.5) + rng.normal(0, 0.004, 360),
                      rng.uniform(0.1, 2.9, 360)], -1)
    pole2 = np.stack([np.full(360, 2.5) + rng.normal(0, 0.004, 360),
                      np.full(360, 1.5) + rng.normal(0, 0.004, 360),
                      rng.uniform(0.1, 2.9, 360)], -1)
    return np.concatenate([floor, pole1, pole2])


def _maps(scan, cfg_j, cfg_t):
    mj = jO.VoxelPlaneMap(cfg_j.voxel_size, cfg_j.plane_ratio,
                          cfg_j.min_plane_points, line_ratio=cfg_j.line_ratio)
    mt = tO.VoxelPlaneMap(cfg_t.voxel_size, cfg_t.plane_ratio,
                          cfg_t.min_plane_points, line_ratio=cfg_t.line_ratio)
    return mj, mt


def _perturbed_body(scan):
    dR = np.asarray(jlie.so3_exp(jnp.asarray([0.01, -0.02, 0.03])))
    dp = np.array([0.05, -0.04, 0.03])
    return (scan - dp) @ dR


def test_voxel_plane_map_matches_jax():
    cfg_j, cfg_t = jO.OdometryConfig(), tO.OdometryConfig()
    scan = _pole_scene()
    mj, mt = _maps(scan, cfg_j, cfg_t)
    cj, ct = mj.insert(scan), mt.insert(scan)
    assert all(np.array_equal(a, b) for a, b in zip(cj, ct))
    shifted = scan + np.array([0.3, -0.2, 0.1])
    cj2, ct2 = mj.insert(shifted), mt.insert(shifted)
    mj.remove(cj)
    mt.remove(ct)
    for a, b in zip(mj.plane_table() + mj.line_table(),
                    mt.plane_table() + mt.line_table()):
        assert np.array_equal(a, b)
    assert len(mt.plane_table()[0]) >= 4 and len(mt.line_table()[0]) >= 1
    q = _perturbed_body(shifted) + np.array([0.0, 0.0, 0.4])
    assert np.array_equal(mj.lookup(q), mt.lookup(q))
    assert np.array_equal(mj.lookup(q, neighbors=True),
                          mt.lookup(q, neighbors=True))
    assert np.array_equal(mj.lookup_lines(q), mt.lookup_lines(q))
    sj, st = mj.state_dict(), mt.state_dict()
    assert sj.keys() == st.keys()
    assert all(np.array_equal(sj[k], st[k]) for k in sj)
    back = tO.VoxelPlaneMap.from_state(sj)
    assert all(np.array_equal(a, b) for a, b in
               zip(back.plane_table(), mj.plane_table()))
    assert np.array_equal(tO._pack_keys(np.array([[-3, 7, 1 << 22]])),
                          jO._pack_keys(np.array([[-3, 7, 1 << 22]])))
    assert [tO._bucket_pow2(n, 1024) for n in (1, 1024, 1025, 5000)] == \
        [jO._bucket_pow2(n, 1024) for n in (1, 1024, 1025, 5000)]
    M = np.random.default_rng(1).normal(size=(3, 3))
    np.testing.assert_array_equal(tO._project_so3(M), jO._project_so3(M))


@pytest.fixture(scope="module")
def correspondences():
    """Plane and line correspondences of the pole scene at a perturbed
    pose, bucket-padded as register_scan pads them."""
    cfg = jO.OdometryConfig()
    scan = _pole_scene()
    mj, _ = _maps(scan, cfg, tO.OdometryConfig())
    mj.insert(scan)
    body = _perturbed_body(scan)
    _, cents, norms = mj.plane_table()
    _, lcents, ldirs = mj.line_table()
    rows = mj.lookup(body)
    sel = rows >= 0
    n = int(sel.sum())
    m = jO._bucket_pow2(n, 1024)
    P = np.zeros((m, 3)); P[:n] = body[sel]
    Nn = np.zeros((m, 3)); Nn[:n] = norms[rows[sel]]
    Cc = np.zeros((m, 3)); Cc[:n] = cents[rows[sel]]
    mask = np.zeros(m); mask[:n] = 1.0
    lrows = mj.lookup_lines(body)
    lsel = lrows >= 0
    nl = int(lsel.sum())
    ml = jO._bucket_pow2(nl, 256)
    Pl = np.zeros((ml, 3)); Pl[:nl] = body[lsel]
    Dl = np.tile([0.0, 0.0, 1.0], (ml, 1)); Dl[:nl] = ldirs[lrows[lsel]]
    Cl = np.zeros((ml, 3)); Cl[:nl] = lcents[lrows[lsel]]
    lmask = np.zeros(ml); lmask[:nl] = 1.0
    assert n > 200 and nl > 50, (n, nl)
    return P, Nn, Cc, mask, Pl, Dl, Cl, lmask


def _case(corr, case):
    P, Nn, Cc, mask, Pl, Dl, Cl, lmask = [x.copy() for x in corr]
    if case == "all_masked":
        mask[:] = 0.0
        lmask[:] = 0.0
    elif case == "nan":
        P[3] = np.nan
        Pl[2] = np.nan
    return P, Nn, Cc, mask, Pl, Dl, Cl, lmask


@pytest.mark.parametrize("kind", ["plane", "mixed"])
@pytest.mark.parametrize("case", ["normal", "all_masked", "nan"])
def test_gn_fused_matches_jax(correspondences, kind, case):
    P, Nn, Cc, mask, Pl, Dl, Cl, lmask = _case(correspondences, case)
    R0, p0 = np.eye(3), np.zeros(3)
    T = lambda x: torch.as_tensor(x)
    J = jnp.asarray
    if kind == "plane":
        Rj, pj, cj = jO._gn_plane_fused(J(R0), J(p0), J(P), J(Nn), J(Cc),
                                        J(mask), 0.1, iters=6)
        Rt, pt, ct = tO._gn_plane_fused(T(R0), T(p0), T(P), T(Nn), T(Cc),
                                        T(mask), 0.1, iters=6)
    else:
        Rj, pj, cj = jO._gn_mixed_fused(
            J(R0), J(p0), J(P), J(Nn), J(Cc), J(mask), J(Pl), J(Dl), J(Cl),
            J(lmask), 0.1, iters=6)
        Rt, pt, ct = tO._gn_mixed_fused(
            T(R0), T(p0), T(P), T(Nn), T(Cc), T(mask), T(Pl), T(Dl), T(Cl),
            T(lmask), 0.1, iters=6)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0,
                               atol=TOL_GN)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0,
                               atol=TOL_GN)
    if case == "normal":
        np.testing.assert_allclose(float(ct), float(cj), rtol=1e-9)
        assert np.abs(pt.numpy()).max() > 1e-3       # it moved
    else:
        # every step skipped: the start pose comes back exactly
        np.testing.assert_array_equal(Rt.numpy(), R0)
        np.testing.assert_array_equal(pt.numpy(), p0)


@pytest.mark.parametrize("H_kind", ["singular", "nan"])
def test_apply_step_skips_bad_systems(H_kind):
    """H + 1e-6 I exactly singular (torch.linalg.solve raises there,
    jnp.linalg.solve returns non-finite values), or holding a NaN: both
    packages skip the step."""
    H = -1e-6 * np.eye(6) if H_kind == "singular" else np.eye(6)
    if H_kind == "nan":
        H[1, 1] = np.nan
    g = np.arange(1.0, 7.0) * 1e-3
    R0 = np.array(jlie.so3_exp(jnp.asarray([0.1, 0.2, 0.3])))
    p0 = np.array([1.0, 2.0, 3.0])
    Rj, pj = jO._apply_step(jnp.asarray(R0), jnp.asarray(p0),
                            jnp.asarray(H), jnp.asarray(g))
    Rt, pt = tO._apply_step(torch.as_tensor(R0), torch.as_tensor(p0),
                            torch.as_tensor(H), torch.as_tensor(g))
    for a, b in ((Rt, Rj), (pt, pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-15)
    np.testing.assert_allclose(Rt.numpy(), R0, rtol=0, atol=1e-15)
    np.testing.assert_array_equal(pt.numpy(), p0)


@pytest.mark.parametrize("use_lines", [True, False])
def test_register_scan_matches_jax(use_lines):
    kw = dict(downsample=0.0, reg_iters=10, reg_reassociate=3,
              use_lines=use_lines)
    cfg_j, cfg_t = jO.OdometryConfig(**kw), tO.OdometryConfig(**kw)
    scan = _pole_scene()
    mj, mt = _maps(scan, cfg_j, cfg_t)
    mj.insert(scan)
    mt.insert(scan)
    body = _perturbed_body(scan)
    Rj, pj, nj = jO.register_scan(body, np.eye(3), np.zeros(3), mj, cfg_j)
    Rt, pt, nt = tO.register_scan(body, np.eye(3), np.zeros(3), mt, cfg_t,
                                  device="cpu")
    assert nt == nj and nt > 100
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=TOL_GN)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL_GN)


@pytest.fixture(scope="module")
def long_scene(tmp_path_factory):
    """make_long_scene(W=16, seed=21), JAX's uninterrupted run and a
    JAX-written checkpoint after scan 9."""
    R_gt, p_gt, scans = make_long_scene(W=16, n_planes=40, pts_per=150,
                                        seed=21)
    jax_run = jO.run(scans)
    path = tmp_path_factory.mktemp("odo") / "jax.npz"
    _, _, info = jO.run(scans, checkpoint_path=path, checkpoint_every=4,
                        stop_after_scan=9)
    assert info["stopped_at"] == 9
    return scans, jax_run, path


def test_odometry_run_matches_jax(long_scene):
    scans, (Rj, pj, ij), _ = long_scene
    Rt, pt, it = tO.run(scans, device="cpu")
    assert it["reg_points"] == ij["reg_points"]
    assert it["ba_runs"] == ij["ba_runs"] >= 2
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=TOL_RUN)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL_RUN)


def test_port_resumes_jax_checkpoint(long_scene, tmp_path):
    scans, (Rj, pj, ij), jpath = long_scene
    path = tmp_path / "odo.npz"
    path.write_bytes(jpath.read_bytes())
    Rt, pt, it = tO.run(scans, checkpoint_path=path, checkpoint_every=4,
                        resume=True, device="cpu")
    assert it["resumed_at"] == 10
    assert it["reg_points"] == ij["reg_points"]
    assert it["ba_runs"] == ij["ba_runs"]
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=TOL_RUN)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL_RUN)


def test_checkpoint_resume_bitwise(long_scene, tmp_path):
    """The port's own stop/resume reproduces its uninterrupted run to the
    bit (tests/test_odometry.py::test_checkpoint_resume's contract), and
    its checkpoint loads in the JAX package."""
    scans = long_scene[0]
    Ra, pa, ia = tO.run(scans, device="cpu")
    path = tmp_path / "odo.npz"
    _, _, i1 = tO.run(scans, checkpoint_path=path, checkpoint_every=4,
                      stop_after_scan=9, device="cpu")
    assert i1["stopped_at"] == 9
    loaded_t, loaded_j = tckpt.load_odometry(path), jckpt.load_odometry(path)
    assert loaded_t[0] == loaded_j[0] == 10
    np.testing.assert_array_equal(loaded_t[1], loaded_j[1])
    assert sorted(loaded_t[4]) == sorted(loaded_j[4])
    Rb, pb, ib = tO.run(scans, checkpoint_path=path, checkpoint_every=4,
                        resume=True, device="cpu")
    assert ib["resumed_at"] == 10
    np.testing.assert_array_equal(Rb, Ra)
    np.testing.assert_array_equal(pb, pa)
    assert ib["reg_points"] == ia["reg_points"]
    assert ib["ba_runs"] == ia["ba_runs"]


def test_async_ba_tracks_trajectory():
    """The detached window BA tracks about as well as the synchronous
    one (the bars of tests/test_odometry.py::test_async_ba_tracks_
    trajectory)."""
    from balm_tpu_torch.utils import metrics

    R_gt, p_gt, scans = make_long_scene(W=20, n_planes=40, pts_per=150,
                                        seed=21)
    outs = {}
    for mode in (False, True):
        R, p, info = tO.run(scans, tO.OdometryConfig(async_ba=mode),
                            device="cpu")
        rot, tra = metrics.pose_rsme(
            torch.as_tensor(R), torch.as_tensor(p), torch.as_tensor(R_gt),
            torch.as_tensor(p_gt))
        outs[mode] = (float(rot) * 57.3, float(tra), info["ba_runs"])
    assert outs[True][2] >= 2
    assert outs[True][0] < 2.0 * max(outs[False][0], 0.05), outs
    assert outs[True][1] < 2.0 * max(outs[False][1], 0.005), outs


def test_run_needs_the_card_by_default():
    R_gt, p_gt, scans = make_long_scene(W=3, n_planes=8, seed=3)
    if torch.cuda.is_available():
        pytest.skip("the card is present: chip_smoke.py phase 13d")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tO.run(scans)
