"""The port's realworld pipeline and its I/O against the JAX package, on
the CPU, on a synthetic scene written as the reference dataset is laid
out: binary full{i}.pcd scans and an alidarPose.csv (the realworld-177
dataset is not in the repository).

Tolerances:
  * I/O, down-sampling, plane colours, write_pose_csv: equal (bytes for
    the CSV)
  * realworld.run in f64 with host association: the same planes and
    iterations, residuals within 1e-9 relative, refined poses within 1e-9
  * in f32 centered: residuals within 1e-4 relative (two f32 evaluators
    sum in other orders; tests/test_pallas_evaluate.py's bar)
  * the port's device association against its host association, f32
    centered: planes within max(2, 0.1%), residual_initial within 1e-3
    and residual_final within 5e-3 relative (tests/
    test_realworld_pipeline.py:27-37)
  * coarse_to_fine.run in f64: per stage the same planes and iterations,
    residuals within 1e-9 relative
  * realworld.run(mesh_devices=8) on 8 virtual CPU shards against JAX's
    on its 8 virtual devices: the same planes and iterations,
    residual_final within 1e-6 relative (tests/test_sharding.py:232)
"""

import pathlib

import numpy as np
import pytest
import torch

from balm_tpu.io import pcd as jpcd
from balm_tpu.io import planecloud as jcloud
from balm_tpu.io import poses as jposes
from balm_tpu.pipelines import coarse_to_fine as jc2f
from balm_tpu.pipelines import realworld as jrw
from balm_tpu.voxel import grid as jgrid
from balm_tpu_torch.io import pcd as tpcd
from balm_tpu_torch.io import planecloud as tcloud
from balm_tpu_torch.io import poses as tposes
from balm_tpu_torch.pipelines import coarse_to_fine as tc2f
from balm_tpu_torch.pipelines import realworld as trw
from balm_tpu_torch.voxel import grid as tgrid

from test_hierarchical import make_long_scene, perturb_drift

W = 12


def write_pcd(path, pts, mode="binary", intensity=None):
    """A PCD v0.7 file of float32 x y z (+ a uint8 intensity field)."""
    n = len(pts)
    extra = intensity is not None
    hdr = ("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
           f"FIELDS x y z{' intensity' if extra else ''}\n"
           f"SIZE 4 4 4{' 1' if extra else ''}\n"
           f"TYPE F F F{' U' if extra else ''}\n"
           f"COUNT 1 1 1{' 1' if extra else ''}\n"
           f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
           f"DATA {mode}\n")
    dt = [("x", "f4"), ("y", "f4"), ("z", "f4")] + (
        [("intensity", "u1")] if extra else [])
    rec = np.zeros(n, dt)
    for k, name in enumerate("xyz"):
        rec[name] = pts[:, k]
    if extra:
        rec["intensity"] = intensity
    with open(path, "wb") as fh:
        fh.write(hdr.encode())
        if mode == "binary":
            fh.write(rec.tobytes())
        else:
            for r in rec:
                fh.write((" ".join(repr(float(v)) if i < 3 else str(int(v))
                                   for i, v in enumerate(r)) + "\n").encode())


def write_pose_rows(path, R, p, t):
    with open(path, "w") as fh:
        for i in range(len(R)):
            M = np.eye(4)
            M[:3, :3], M[:3, 3], M[3, 3] = R[i], p[i], t[i]
            for row in M:
                fh.write(",".join(f"{x:.9f}" for x in row) + ",\n")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(data_dir, ground-truth R, p): W scans through 60 patches, poses
    perturbed by drift, written as the reference dataset."""
    d = tmp_path_factory.mktemp("realworld")
    R, p, scans = make_long_scene(W=W, n_planes=60, pts_per=100, seed=5)
    R0, p0 = perturb_drift(R, p, seed=6)
    for i, s in enumerate(scans):
        write_pcd(d / f"full{i}.pcd", s)
    write_pose_rows(d / "alidarPose.csv", R0, p0, 0.1 * np.arange(W))
    return d, R, p


@pytest.fixture(scope="module")
def f64_export(scene, tmp_path_factory):
    """The default (f64, host association) run of each package, both
    with export_dir."""
    d = scene[0]
    out = {}
    for name, rw, kw in (("jax", jrw, {}), ("port", trw,
                                            {"device": "cpu"})):
        ex = tmp_path_factory.mktemp(f"export_{name}")
        out[name] = (rw.run(rw.RealworldConfig(data_dir=str(d),
                                               export_dir=str(ex)), **kw),
                     ex)
    return out


@pytest.mark.parametrize("mode", ["binary", "ascii"])
def test_pcd_and_pose_io_match_jax(mode, tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(50, 3)) * 10
    pts[7] = np.nan                       # dropped by read_pcd_xyz
    inten = rng.integers(0, 255, 50).astype(np.uint8)
    write_pcd(tmp_path / "a.pcd", pts, mode, intensity=inten)
    a = jpcd.read_pcd(tmp_path / "a.pcd")
    b = tpcd.read_pcd(tmp_path / "a.pcd")
    assert list(a) == list(b) == ["x", "y", "z", "intensity"]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for dt in (np.float64, np.float32):
        xa = jpcd.read_pcd_xyz(tmp_path / "a.pcd", dt)
        xb = tpcd.read_pcd_xyz(tmp_path / "a.pcd", dt)
        np.testing.assert_array_equal(xa, xb)
        assert xb.shape == (49, 3) and xb.dtype == dt
    R = np.stack([np.eye(3)] * 4)
    write_pose_rows(tmp_path / "p.csv", R, rng.normal(size=(4, 3)),
                    np.arange(4.0))
    for m in (None, 2):
        for x, y in zip(jposes.read_pose_csv(tmp_path / "p.csv", m),
                        tposes.read_pose_csv(tmp_path / "p.csv", m)):
            np.testing.assert_array_equal(x, y)
    (tmp_path / "bad.csv").write_text("1,2,3,4,\n")
    with pytest.raises(ValueError, match="multiple of 4"):
        tposes.read_pose_csv(tmp_path / "bad.csv")


def test_down_sample_and_colors_match_jax():
    pts = np.random.default_rng(2).uniform(-3, 3, size=(4000, 3))
    for v in (0.0, 0.5, 1.0):
        np.testing.assert_array_equal(jgrid.down_sample_voxel(pts, v),
                                      tgrid.down_sample_voxel(pts, v))
    np.testing.assert_array_equal(jgrid.down_sample_stride(pts, 7),
                                  tgrid.down_sample_stride(pts, 7))
    np.testing.assert_array_equal(jcloud.leaf_colors(37, 3),
                                  tcloud.leaf_colors(37, 3))


def test_realworld_f64_matches_jax(scene, f64_export):
    (oj, _), (ot, _) = f64_export["jax"], f64_export["port"]
    assert ot["status"] == oj["status"] == "ok"
    assert ot["assoc_backend"] == "host"
    for k in ("num_scans", "num_points", "num_planes", "iters"):
        assert ot[k] == oj[k], k
    assert ot["num_planes"] >= 3 * W and ot["iters"] > 1
    for k in ("residual_initial", "residual_final"):
        assert abs(ot[k] - oj[k]) <= 1e-9 * abs(oj[k]), k
    assert ot["residual_final"] < 0.1 * ot["residual_initial"]
    np.testing.assert_allclose(ot["result"].p.numpy(),
                               np.asarray(oj["result"].p), atol=1e-9)


def test_realworld_export_matches_jax(f64_export):
    (_, ej), (ot, et) = f64_export["jax"], f64_export["port"]
    assert ot["export_dir"] == str(et)
    for x, y in zip(jposes.read_pose_csv(ej / "refined_poses.csv"),
                    tposes.read_pose_csv(et / "refined_poses.csv")):
        np.testing.assert_allclose(x, y, atol=1e-9, rtol=0)
    # convergence.txt: strictly increasing real timestamps, falling cost
    rows = np.loadtxt(et / "convergence.txt", ndmin=2)
    rows_j = np.loadtxt(ej / "convergence.txt", ndmin=2)
    assert rows.shape == rows_j.shape and len(rows) >= 2
    assert np.all(np.diff(rows[:, 0]) > 0)
    assert np.all(np.diff(rows[:, 1]) < 0)
    np.testing.assert_allclose(rows[:, 1], rows_j[:, 1], rtol=1e-9)
    ply = (et / "plane_cloud.ply").read_text().splitlines()
    ply_j = (ej / "plane_cloud.ply").read_text().splitlines()
    assert ply[0] == "ply" and ply[:10] == ply_j[:10]
    nvert = int([l for l in ply if l.startswith("element vertex")][0]
                .split()[-1])
    zt, zj = np.load(et / "plane_cloud.npz"), np.load(ej / "plane_cloud.npz")
    assert zt["world"].shape[0] == nvert > 1000
    np.testing.assert_array_equal(zt["leaf"], zj["leaf"])
    np.testing.assert_allclose(zt["world"], zj["world"], atol=1e-5)


def test_realworld_f32_centered_matches_jax(scene):
    d = str(scene[0])
    oj = jrw.run(jrw.RealworldConfig(data_dir=d, dtype="float32",
                                     centered=True))
    ot = trw.run(trw.RealworldConfig(data_dir=d, dtype="float32",
                                     centered=True), device="cpu")
    # on the CPU 'auto' keeps the host association and the xla backend
    assert ot["assoc_backend"] == "host" and ot["backend"] == "xla"
    assert ot["num_planes"] == oj["num_planes"]
    for k in ("residual_initial", "residual_final"):
        assert abs(ot[k] - oj[k]) <= 1e-4 * abs(oj[k]), k


def test_realworld_device_assoc_matches_host(scene):
    d = str(scene[0])
    cfg = dict(data_dir=d, dtype="float32", centered=True)
    dev = trw.run(trw.RealworldConfig(assoc_backend="device", **cfg),
                  device="cpu")
    host = trw.run(trw.RealworldConfig(assoc_backend="native", **cfg),
                   device="cpu")
    assert dev["assoc_backend"] == "device" and host["assoc_backend"] == \
        "native"
    assert len(dev["assoc_attempts_s"]) == 1
    n = host["num_planes"]
    assert abs(dev["num_planes"] - n) <= max(2, 1e-3 * n)
    assert abs(dev["residual_initial"] - host["residual_initial"]) \
        <= 1e-3 * host["residual_initial"]
    assert abs(dev["residual_final"] - host["residual_final"]) \
        <= 5e-3 * host["residual_final"]
    assert dev["residual_final"] < dev["residual_initial"]


def test_realworld_merge_matches_jax(scene):
    d = str(scene[0])
    oj = jrw.run(jrw.RealworldConfig(data_dir=d, merge_planes=True))
    ot = trw.run(trw.RealworldConfig(data_dir=d, merge_planes=True),
                 device="cpu")
    assert ot["status"] == "ok"
    assert 0 < ot["merged_planes"] == oj["merged_planes"] \
        <= ot["num_planes"]
    assert abs(ot["residual_final"] - oj["residual_final"]) \
        <= 1e-9 * oj["residual_final"]
    assert ot["residual_final"] < ot["residual_initial"]


def test_coarse_to_fine_matches_jax():
    R, p, scans = make_long_scene(W=6, n_planes=40, pts_per=80, seed=9)
    R0, p0 = perturb_drift(R, p, seed=10)
    Rj, pj, hj = jc2f.run(scans, R0, p0)
    Rt, pt, ht = tc2f.run(scans, R0, p0, device="cpu")
    assert len(ht) == len(hj) == len(tc2f.default_stages())
    for a, b in zip(ht, hj):
        for k in ("num_planes", "iters", "voxel_size"):
            assert a[k] == b[k], k
        for k in ("residual_initial", "residual_final"):
            assert abs(a[k] - b[k]) <= 1e-9 * abs(b[k]), k
    np.testing.assert_allclose(pt, np.asarray(pj), atol=1e-9)
    assert Rt.dtype == np.float64


def test_realworld_stages_and_options(scene):
    """The stages prologue runs; what the port refuses, it refuses as the
    JAX package does; mesh_devices=8 runs the factor-parallel solve on 8
    virtual CPU shards, as JAX's on its 8 virtual devices."""
    d = str(scene[0])
    out = trw.run(trw.RealworldConfig(
        data_dir=d, max_scans=6, stages=tc2f.default_stages()[1:]),
        device="cpu")
    assert len(out["stage_history"]) == 2 and out["num_scans"] == 6
    assert out["residual_final"] < out["residual_initial"]
    with pytest.raises(ValueError, match="centered-f32"):
        trw.run(trw.RealworldConfig(data_dir=d, assoc_backend="device",
                                    merge_planes=True, dtype="float32",
                                    centered=True), device="cpu")
    got = trw.run(trw.RealworldConfig(data_dir=d, mesh_devices=8),
                  device="cpu")
    ref = jrw.run(jrw.RealworldConfig(data_dir=d, mesh_devices=8))
    for k in ("status", "num_planes", "iters", "mesh_devices",
              "planes_per_shard"):
        assert got[k] == ref[k], k
    assert got["backend"] == "xla" and got["mesh_devices"] == 8
    assert abs(got["residual_final"] - ref["residual_final"]) \
        <= 1e-6 * abs(ref["residual_final"])
    # down-sampled to one centroid per 4 m cell: no plane survives
    few = trw.run(trw.RealworldConfig(data_dir=d, max_scans=2,
                                      downsample=4.0), device="cpu")
    assert few["status"] == "too_few_planes" and few["num_planes"] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trw.run(trw.RealworldConfig(data_dir=d))


def test_slice6_imports_neither_jax_nor_balm_tpu():
    import subprocess
    import sys

    mods = ("io.pcd", "io.poses", "io.planecloud", "utils.checkpoint",
            "ops.segments", "voxel.device", "voxel.merge", "solver.large",
            "solver.lm", "pipelines.coarse_to_fine", "pipelines.realworld")
    code = ("import sys; "
            + "; ".join(f"import balm_tpu_torch.{m}" for m in mods)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'balm_tpu')]; assert not bad, bad")
    repo = pathlib.Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=repo)
