"""The port's loop closure (pipelines/loopclose.py: descriptors,
retrieval, verification, PCM, detect, close_loops) and
optimize_poses(loop_closure=True) against the JAX package's, in float64
on the CPU, on tests/test_loopclose.py's square_revisit scene (W=72,
101,850 points, cumulative drift from seed 3).

Tolerances:
  * scan_context, descriptors, ring_keys and shift_to_yaw (host numpy,
    copied): bitwise
  * sc_distance: the shifts equal, the distances within 1e-6 (float32
    descriptors; XLA sums the rings and sectors in another order than
    numpy, a few ulp at 1.0)
  * _pcm_filter: the same kept set and drop count
  * detect: the same edge list (i, j), info counts equal, Zr/Zp within
    1e-10, the weights within 1e-12 relative (the same f64 GN; the
    inlier counts and lever arms are host numpy)
  * close_loops: the same PGO iterations, final cost within 1e-10
    relative, poses within 1e-9
  * optimize_poses(loop_closure=True): the same info["loop_closure"],
    plane count and iterations, poses within 1e-9
"""

import numpy as np
import pytest
import torch

import balm_tpu
import balm_tpu_torch
from balm_tpu.config import SolverConfig as jSolver
from balm_tpu.config import VoxelConfig as jVoxel
from balm_tpu.pipelines import loopclose as jLC
from balm_tpu_torch.config import SolverConfig as tSolver
from balm_tpu_torch.config import VoxelConfig as tVoxel
from balm_tpu_torch.pipelines import loopclose as tLC
from tests.test_hierarchical import make_long_scene
from tests.test_loopclose import _perturb_cumulative, make_loop_scene

TOL_SC = 1e-6
TOL_EDGE = 1e-10
TOL_POSE = 1e-9
LOOP = dict(max_dist=5.0, query_every=2)


@pytest.fixture(scope="module")
def square_revisit():
    R_gt, p_gt, scans = make_loop_scene()
    R0, p0 = _perturb_cumulative(R_gt, p_gt, seed=3)
    return R_gt, p_gt, scans, R0, p0


@pytest.fixture(scope="module")
def jax_detect(square_revisit):
    _, _, scans, R0, p0 = square_revisit
    return jLC.detect(scans, R0, p0, jLC.LoopConfig(**LOOP))


@pytest.fixture(scope="module")
def torch_detect(square_revisit):
    _, _, scans, R0, p0 = square_revisit
    return tLC.detect(scans, R0, p0, tLC.LoopConfig(**LOOP), device="cpu")


def test_descriptors_exact(square_revisit):
    scans = square_revisit[2]
    dj, rj = jLC.descriptors(scans, jLC.LoopConfig())
    dt, rt = tLC.descriptors(scans, tLC.LoopConfig())
    assert rj == rt
    assert dt.dtype == np.float32
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(tLC.ring_keys(dt), jLC.ring_keys(dj))
    np.testing.assert_array_equal(
        tLC.scan_context(scans[5], 8, 30, 3.0, -0.4, 0.4),
        jLC.scan_context(scans[5], 8, 30, 3.0, -0.4, 0.4))
    np.testing.assert_array_equal(tLC._yaw_mat(0.3), jLC._yaw_mat(0.3))


def test_sc_distance_and_shift_to_yaw(square_revisit):
    scans = square_revisit[2]
    d, _ = tLC.descriptors(scans, tLC.LoopConfig())
    W = len(d)
    ii = np.repeat(np.arange(W), W)
    jj = np.tile(np.arange(W), W)
    dj, sj = jLC.sc_distance(d[ii], d[jj], 12)
    dt, st = tLC.sc_distance(d[ii], d[jj], 12)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=TOL_SC)
    assert dt.dtype == np.float32 and st.dtype == np.int64
    assert (dt > 0.3).any() and (dt < 0.3).any()    # both sides of sc_accept
    for shift in range(0, 60, 7):
        assert tLC.shift_to_yaw(shift, 60) == jLC.shift_to_yaw(shift, 60)


@pytest.mark.parametrize("require_support", [True, False])
def test_pcm_filter_matches_jax(square_revisit, require_support):
    """Edges measured at the ground truth, two of them corrupted into
    aliases (a lattice slide and a rotation), judged through the drifted
    estimate."""
    R_gt, p_gt, _, R0, p0 = square_revisit
    rng = np.random.default_rng(5)
    cand = []
    for a, b in ((4, 54), (6, 56), (8, 62), (9, 66), (10, 64), (10, 68),
                 (30, 71)):
        Zr = R_gt[a].T @ R_gt[b]
        Zp = R_gt[a].T @ (p_gt[b] - p_gt[a]) + rng.normal(0, 0.01, 3)
        cand.append({"a": a, "b": b, "Zr": Zr, "Zp": Zp,
                     "meta": {"med_res": float(rng.uniform(0.01, 0.05)),
                              "n_inlier": int(rng.integers(100, 400))}})
    cand[2]["Zp"] = cand[2]["Zp"] + np.array([1.0, 0.0, 0.0])
    cand[4]["Zr"] = tLC._yaw_mat(0.2) @ cand[4]["Zr"]
    out = []
    for LC in (jLC, tLC):
        cfg = LC.LoopConfig(require_support=require_support)
        out.append(LC._pcm_filter(cand, R0, p0, cfg))
    assert out[0] == out[1]
    assert out[1][1] >= 2


def test_detect_matches_jax(jax_detect, torch_detect):
    ej, ij = jax_detect
    et, it = torch_detect
    assert ej is not None and et is not None
    np.testing.assert_array_equal(et.i.numpy(), np.asarray(ej.i))
    np.testing.assert_array_equal(et.j.numpy(), np.asarray(ej.j))
    assert et.Zr.dtype == torch.float64 and et.Zr.device.type == "cpu"
    for k in ("Zr", "Zp"):
        np.testing.assert_allclose(getattr(et, k).numpy(),
                                   np.asarray(getattr(ej, k)), rtol=0,
                                   atol=TOL_EDGE)
    for k in ("w_rot", "w_tr"):
        np.testing.assert_allclose(getattr(et, k).numpy(),
                                   np.asarray(getattr(ej, k)), rtol=1e-12)
    for k in ("n_queries", "n_scored", "n_verified", "n_pcm_rejected",
              "n_drift_rejected", "r_max"):
        assert it.get(k) == ij.get(k), k
    assert [(m["query"], m["cand"], m["n_inlier"]) for m in it["pairs"]] \
        == [(m["query"], m["cand"], m["n_inlier"]) for m in ij["pairs"]]
    assert it["n_verified"] >= 3


def test_close_loops_matches_jax(square_revisit, jax_detect, torch_detect):
    """The pose-graph stage from the same detections (passed in, so
    detection is not repeated)."""
    _, _, scans, R0, p0 = square_revisit
    Rj, pj, _, ij = jLC.close_loops(scans, R0, p0, jLC.LoopConfig(**LOOP),
                                    edges=jax_detect[0],
                                    detect_info=jax_detect[1])
    Rt, pt, et, it = tLC.close_loops(scans, R0, p0, tLC.LoopConfig(**LOOP),
                                     edges=torch_detect[0],
                                     detect_info=torch_detect[1],
                                     device="cpu")
    assert et is torch_detect[0]
    assert it["pgo"]["iters"] == ij["pgo"]["iters"]
    assert it["pgo"]["accepted"] == ij["pgo"]["accepted"]
    np.testing.assert_allclose(it["pgo"]["final_cost"],
                               ij["pgo"]["final_cost"], rtol=1e-10)
    assert it["pgo"]["final_cost"] < 0.1 * it["pgo"]["initial_cost"]
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=TOL_POSE)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL_POSE)


def test_optimize_poses_loop_closure_matches_jax(square_revisit):
    """tests/test_api.py::test_optimize_poses_loop_closure's call on both
    packages (detect -> PGO -> the f64 'xla' BA)."""
    _, _, scans, R0, p0 = square_revisit
    Rj, pj, ij = balm_tpu.optimize_poses(
        scans, R0, p0, loop_closure=True,
        loop_config=jLC.LoopConfig(**LOOP),
        voxel=jVoxel(voxel_size=1.0),
        solver=jSolver(max_iters=30, u_init=0.01, min_planes_per_pose=1))
    Rt, pt, it = balm_tpu_torch.optimize_poses(
        scans, R0, p0, loop_closure=True,
        loop_config=tLC.LoopConfig(**LOOP),
        voxel=tVoxel(voxel_size=1.0),
        solver=tSolver(max_iters=30, u_init=0.01, min_planes_per_pose=1),
        device="cpu")
    assert it["loop_closure"] == ij["loop_closure"]
    assert it["loop_closure"]["n_edges"] > 0
    assert (it["num_planes"], it["iters"], it["status"]) == \
        (ij["num_planes"], ij["iters"], ij["status"])
    np.testing.assert_allclose(it["residual"], ij["residual"], rtol=1e-9)
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=TOL_POSE)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL_POSE)


def test_loop_closure_without_loops_passes_poses_through():
    """No revisit: n_edges 0 and the BA of the unchanged start poses —
    bitwise the call without loop closure; a loop_config without
    loop_closure is ignored, as in the JAX package."""
    R_gt, p_gt, scans = make_long_scene(W=6, n_planes=12, seed=3)
    kw = dict(solver=tSolver(max_iters=3, min_planes_per_pose=1),
              device="cpu")
    R1, p1, i1 = balm_tpu_torch.optimize_poses(scans, R_gt, p_gt,
                                               loop_closure=True, **kw)
    R2, p2, i2 = balm_tpu_torch.optimize_poses(
        scans, R_gt, p_gt, loop_config=tLC.LoopConfig(), **kw)
    assert i1["loop_closure"] == {"n_edges": 0, "n_verified": 0}
    assert "loop_closure" not in i2
    np.testing.assert_array_equal(R1, R2)
    np.testing.assert_array_equal(p1, p2)


def test_detect_needs_the_card_by_default(square_revisit):
    if torch.cuda.is_available():
        pytest.skip("the card is present: chip_smoke.py phase 13")
    _, _, scans, R0, p0 = square_revisit
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tLC.detect(scans, R0, p0, tLC.LoopConfig(**LOOP))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tLC.close_loops(scans, R0, p0, tLC.LoopConfig(**LOOP))
