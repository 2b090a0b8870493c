"""The PyTorch port's NEES experiment (pipelines/consistency.py) against
the JAX package's, on the CPU, through `scans_override` on a small
noise-free scene (chip_smoke.make_scene at sigma 0: exact planes, as the
variant gates need; corrupt_and_rebuild adds the noise), 10 scans, 1 m
voxels, the first scan marginalized.

The port's ConsistencyConfig sets ulp_tol=0 in its solver (the
protocol's stops are abs_tol alone; the JAX package inherits
SolverConfig's ulp_tol=128, whose f32 floor ends the packed solve early
on corridor-like scenes); the JAX side runs with the same solver config
(to_jax_config), and the packed comparison also with the JAX package's
own default on both sides.

Tolerances:
  * backend 'xla' (f64 oracle): the same num_planes and iters, NEES
    within 1e-6 relative, Rcov within 1e-8 of max|ref| (the same f64
    algebra; sums, eigh3 and the dense solves round in another order)
  * backend 'packed' (the port's plain f32 path against JAX's packed
    path on the CPU): the NEES ratios within 0.05 of each other (the
    JAX package's f32-vs-f64 bar, tests/test_consistency_pipeline.py:74)
    and the converged poses within 1e-4 of the trajectory's scale, read
    through the left-invariant errors `err` (err differs by exactly the
    pose difference, rotated)
  * run_multi: the JAX package's keys, shapes and per-seed NEES (1e-6
    relative); streaming=True against the batch association: the same
    num_planes and NEES within 1e-12 relative (the same leaves, in
    another order)
"""

import dataclasses

import numpy as np
import pytest
import torch

from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.config import VoxelConfig as JVoxelConfig
from balm_tpu.pipelines import consistency as jc
from balm_tpu_torch.config import SolverConfig, VoxelConfig
from balm_tpu_torch.pipelines import consistency as tc

import chip_smoke

W = 10
SEEDS = (3, 4)


def to_jax_config(cfg):
    """The JAX package's ConsistencyConfig from the port's, field by
    field (VoxelConfig and SolverConfig converted in kind)."""
    def conv(v):
        if isinstance(v, VoxelConfig):
            return JVoxelConfig(**vars(v))
        if isinstance(v, SolverConfig):
            return JSolverConfig(**vars(v))
        return v
    return jc.ConsistencyConfig(**{
        f.name: conv(getattr(cfg, f.name))
        for f in dataclasses.fields(tc.ConsistencyConfig)})


def test_config_defaults_match_jax():
    """The same defaults but the solver's ulp_tol (0 in the port) and
    data_dir (relative to the working directory, as the port's
    RealworldConfig's)."""
    ours = tc.ConsistencyConfig()
    theirs = to_jax_config(ours)
    ref = jc.ConsistencyConfig()
    assert theirs.solver == dataclasses.replace(ref.solver, ulp_tol=0.0)
    assert dataclasses.replace(theirs, solver=ref.solver,
                               data_dir=ref.data_dir) == ref


@pytest.fixture(scope="module")
def scene():
    R, p, scans = chip_smoke.make_scene(
        W, 3, pts_per_scan=3000, voxel=1.0, step=1.0, vis=3.5, ny=4, nz=3,
        sigma=0.0)
    return R, p, scans


def _cfg(**kw):
    return tc.ConsistencyConfig(num_scans=W, **kw)


@pytest.fixture(scope="module")
def jax_runs(scene):
    xla = jc.run(to_jax_config(_cfg(seed=SEEDS[0])), scans_override=scene)
    multi = jc.run_multi(to_jax_config(_cfg()), seeds=SEEDS,
                         scans_override=scene)
    return xla, multi


def test_xla_matches_jax(scene, jax_runs):
    ref = jax_runs[0]
    out = tc.run(_cfg(seed=SEEDS[0]), scans_override=scene, device="cpu")
    assert out["num_planes"] == ref["num_planes"] >= 100
    assert out["iters"] == ref["iters"] > 0
    assert out["expected"] == ref["expected"] == 6 * (W - 1)
    assert abs(out["nees"] - ref["nees"]) <= 1e-6 * abs(ref["nees"])
    scale = np.max(np.abs(ref["Rcov"]))
    assert np.max(np.abs(out["Rcov"] - ref["Rcov"])) <= 1e-8 * scale
    assert np.all(np.diag(out["Rcov"]) > 0)
    assert out["err_trans_rms_m"] < 0.02 and out["err_rot_rms_deg"] < 0.1


@pytest.mark.parametrize("ulp_tol", [0.0, 128.0])
def test_packed_matches_jax(scene, jax_runs, ulp_tol):
    cfg = _cfg(seed=SEEDS[0], backend="packed")
    cfg = dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, ulp_tol=ulp_tol))
    ref = jc.run(to_jax_config(cfg), scans_override=scene)
    out = tc.run(cfg, scans_override=scene, device="cpu")
    assert out["iters"] == ref["iters"]
    assert out["num_planes"] == ref["num_planes"]
    assert abs(out["ratio"] - ref["ratio"]) < 0.05
    assert abs(out["ratio"] - jax_runs[0]["ratio"]) < 0.05
    scale = max(1.0, float(np.max(np.abs(scene[1]))))
    assert np.max(np.abs(out["err"] - ref["err"])) <= 1e-4 * scale
    assert np.all(np.isfinite(out["Rcov"]))


def test_run_multi_matches_jax(scene, jax_runs):
    ref = jax_runs[1]
    out = tc.run_multi(_cfg(), seeds=SEEDS, scans_override=scene,
                       device="cpu")
    assert set(ref) <= set(out)
    for k in ref:
        assert np.shape(out[k]) == np.shape(ref[k]), k
    assert out["seeds"] == list(SEEDS)
    assert out["expected"] == ref["expected"]
    assert out["num_planes"] == ref["num_planes"]
    np.testing.assert_allclose(out["nees"], ref["nees"], rtol=1e-6)
    np.testing.assert_allclose(out["nees_pose_mean_ratio"],
                               ref["nees_pose_mean_ratio"], rtol=1e-6)
    assert out["frac_within_3sigma"] == ref["frac_within_3sigma"]
    assert [r["seed"] for r in out["per_seed"]] == list(SEEDS)
    assert all(r["rcov_ok"] and r["iters"] > 0 and r["pred_trans_rms_m"] > 0
               and r["pred_rot_rms_deg"] > 0 for r in out["per_seed"])
    # the seed-0-of-the-sweep run is test_xla_matches_jax's
    assert out["nees"][0] == pytest.approx(jax_runs[0]["nees"], rel=1e-6)


def test_streaming_matches_batch(scene):
    cfg = _cfg(seed=SEEDS[0])
    batch = tc.run(cfg, scans_override=scene, device="cpu")
    stream = tc.run(dataclasses.replace(cfg, streaming=True),
                    scans_override=scene, device="cpu")
    assert stream["num_planes"] == batch["num_planes"]
    assert abs(stream["nees"] - batch["nees"]) <= 1e-12 * batch["nees"]


def test_run_needs_a_card_or_cpu(scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.run(_cfg(), scans_override=scene)
    with pytest.raises(ValueError, match="unknown backend"):
        tc.run(_cfg(backend="pallas"), scans_override=scene, device="cpu")
