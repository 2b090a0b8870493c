"""The PyTorch port's slice — voxelize -> recenter -> packed f32 LM solve
— against the JAX package, on the CPU through the kernels' plain
versions.

Tolerances:
  * voxelizer moments: 1e-12 absolute (both packages' host code is f64
    numpy / the same C++ engine; only the summation order may differ)
  * optimize_poses: the same num_planes and iters; residual_initial
    within 1e-5 relative and the final residual within 1e-4 relative
    (f32 sums in other orders, and the JAX CPU path evaluates in
    (w, j)-major order while the port keeps (j, w)); poses within
    1e-4 rad and 1e-4 m
"""

import pathlib
import shutil
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import balm_tpu
import balm_tpu_torch
from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.config import VoxelConfig as JVoxelConfig
from balm_tpu.ops import factors as jF
from balm_tpu.solver import lm as jlm
from balm_tpu.voxel import grid as jgrid
from balm_tpu_torch.config import SolverConfig, VoxelConfig
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.ops import lie as tlie
from balm_tpu_torch.solver import lm as tlm
from balm_tpu_torch.utils import metrics as tmetrics
from balm_tpu_torch.voxel import grid as tgrid

from test_hierarchical import make_long_scene, perturb_drift
from test_voxelize import make_scene


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_voxelize_matches_jax(backend):
    R, p, scans = make_scene()
    jres = jgrid.voxelize(scans, R, p, JVoxelConfig(), pad_to=16,
                          backend=backend)
    tres = tgrid.voxelize(scans, R, p, VoxelConfig(), pad_to=16,
                          backend=backend)
    assert tres.num_planes == jres.num_planes >= 6
    for a, b in zip(tres.factors, jres.factors):
        assert a.shape == np.shape(b)
        assert np.max(np.abs(a - np.asarray(b)), initial=0.0) <= 1e-12
    assert np.array_equal(tres.point_leaf, jres.point_leaf)


def test_config_defaults_match_jax():
    assert SolverConfig() == SolverConfig(**vars(JSolverConfig()))
    assert VoxelConfig() == VoxelConfig(**vars(JVoxelConfig()))


def test_recenter_bodies_matches_jax():
    R, p, scans = make_scene(seed=3)
    f = tgrid.voxelize(scans, R, p, VoxelConfig(), pad_to=16).factors
    a = tF.recenter_bodies(f)
    b = jF.recenter_bodies(jF.PlaneFactors(*f))
    for x, y in zip(a, b):
        assert np.max(np.abs(x - np.asarray(y))) <= 1e-12


def _rsme(R1, p1, R_gt, p_gt):
    T = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    g = tlie.gauge_fix(T(R_gt), T(p_gt))
    return [float(x) for x in
            tmetrics.pose_rsme(*tlie.gauge_fix(T(R1), T(p1)), *g)]


def test_optimize_poses_matches_jax():
    R_gt, p_gt, scans = make_long_scene(W=12, seed=41)
    R0, p0 = perturb_drift(R_gt, p_gt, seed=42)
    Rj, pj, ij = balm_tpu.optimize_poses(scans, R0, p0, backend="packed",
                                         dtype="float32")
    Rt, pt, it = balm_tpu_torch.optimize_poses(scans, R0, p0,
                                               backend="packed",
                                               dtype="float32",
                                               device="cpu")
    assert it["status"] == ij["status"] == "ok"
    assert it["num_planes"] == ij["num_planes"]
    assert it["iters"] == ij["iters"] > 0
    assert abs(it["residual_initial"] - ij["residual_initial"]) \
        < 1e-5 * ij["residual_initial"]
    assert abs(it["residual"] - ij["residual"]) < 1e-4 * ij["residual"]
    rot = tlie.so3_log(torch.as_tensor(
        np.einsum("nji,njk->nik", np.asarray(Rj, np.float64),
                  np.asarray(Rt, np.float64))))
    assert float(rot.norm(dim=-1).max()) < 1e-4
    assert np.max(np.abs(np.asarray(pt) - np.asarray(pj))) < 1e-4
    assert it["launches"] == {"csum": 0, "rows": 0}   # plain on the CPU
    # and it refines: translation error falls against the ground truth
    assert _rsme(Rt, pt, R_gt, p_gt)[1] < 0.3 * _rsme(R0, p0, R_gt, p_gt)[1]


def test_smoke_scene_matches_jax():
    """chip_smoke.py's scene at 32 scans (2 m voxels, 2 deg / 0.1 m pose
    noise): the port's CPU solve follows the JAX package's — same planes,
    iterations and accept/reject pattern — and refines the poses."""
    import chip_smoke

    R_gt, p_gt, scans = chip_smoke.make_scene(32, 0)
    R0, p0 = chip_smoke.perturb(R_gt, p_gt, 0)
    Rj, pj, ij = balm_tpu.optimize_poses(
        scans, R0, p0, voxel=JVoxelConfig(voxel_size=chip_smoke.VOXEL),
        backend="packed", dtype="float32")
    # the card's defaults (float32, 'packed'), asked for explicitly: off
    # the card dtype=None takes float64 and 'xla', as JAX off the TPU
    Rt, pt, it = balm_tpu_torch.optimize_poses(
        scans, R0, p0, voxel=VoxelConfig(voxel_size=chip_smoke.VOXEL),
        dtype="float32", backend="packed", device="cpu")
    assert it["backend"] == "packed" and it["dtype"] == "float32"
    assert it["num_planes"] == ij["num_planes"]
    assert it["iters"] == ij["iters"] > 0
    assert abs(it["residual_initial"] - ij["residual_initial"]) \
        < 1e-5 * ij["residual_initial"]
    assert abs(it["residual"] - ij["residual"]) < 1e-4 * ij["residual"]
    assert np.max(np.abs(np.asarray(pt) - np.asarray(pj))) < 1e-4
    rs0, rs1 = _rsme(R0, p0, R_gt, p_gt), _rsme(Rt, pt, R_gt, p_gt)
    assert rs1[0] < 0.1 * rs0[0] and rs1[1] < 0.1 * rs0[1]


@pytest.mark.parametrize("linear_solver", ["cholesky_nofallback", "lu"])
def test_damping_iter_solvers_match_jax(linear_solver):
    R_gt, p_gt, scans = make_long_scene(W=10, seed=7)
    R0, p0 = perturb_drift(R_gt, p_gt, seed=8)
    f = tgrid.voxelize(scans, R0, p0, VoxelConfig()).factors
    fr = tF.recenter_bodies(f)
    cfg = SolverConfig(max_iters=6, min_planes_per_pose=1)
    jres = jlm.damping_iter(
        jnp.asarray(R0, jnp.float32), jnp.asarray(p0, jnp.float32),
        jF.PlaneFactors(*[jnp.asarray(x, jnp.float32) for x in fr]),
        JSolverConfig(max_iters=6, min_planes_per_pose=1), centered=True,
        backend="packed", linear_solver=linear_solver)
    tres = tlm.damping_iter(
        torch.tensor(R0, dtype=torch.float32),
        torch.tensor(p0, dtype=torch.float32),
        tF.factors_from_numpy(fr), cfg, centered=True, backend="packed",
        linear_solver=linear_solver)
    assert tres.iters == int(jres.iters) > 0
    n = tres.iters
    assert np.allclose(tres.trace_res1[:n], np.asarray(jres.trace_res1)[:n],
                       rtol=1e-4, atol=0)
    assert np.array_equal(tres.trace_accept[:n],
                          np.asarray(jres.trace_accept)[:n])
    assert abs(tres.residual - float(jres.residual)) \
        < 1e-4 * float(jres.residual)
    assert "accept" in tlm.format_trace(tres)


def test_optimize_poses_runs_on_cuda_or_raises():
    """No CPU fallback: the default device is the GPU."""
    R_gt, p_gt, scans = make_long_scene(W=4, n_planes=8, seed=3)
    if torch.cuda.is_available():
        pytest.skip("covered by chip_smoke.py on the GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        balm_tpu_torch.optimize_poses(scans, R_gt, p_gt)


def test_unported_paths_raise():
    R_gt, p_gt, scans = make_long_scene(W=4, n_planes=8, seed=3)
    # loop closure is ported (pipelines/loopclose.py): four scans hold
    # no revisit, so it reports no edge
    _, _, info = balm_tpu_torch.optimize_poses(scans, R_gt, p_gt,
                                               device="cpu",
                                               loop_closure=True)
    assert info["loop_closure"]["n_edges"] == 0
    with pytest.raises(ValueError, match="at least one scan"):
        balm_tpu_torch.optimize_poses([], np.zeros((0, 3, 3)),
                                      np.zeros((0, 3)), device="cpu")
    f = tF.factors_from_numpy(tF.recenter_bodies(
        tgrid.voxelize(scans, R_gt, p_gt, VoxelConfig()).factors))
    R = torch.tensor(R_gt, dtype=torch.float32)
    p = torch.tensor(p_gt, dtype=torch.float32)
    # hess_precision='bf16' runs now (test_hess_precision_bf16_*)
    with pytest.raises(ValueError, match="unknown hess_precision"):
        tlm.damping_iter(R, p, f, hess_precision="fp8", centered=True,
                         backend="packed")
    # the large-window solve and edges are ported (solver/large.py,
    # ops/pose_graph.py); damping_iter refuses what JAX's cannot do
    with pytest.raises(ValueError, match="damping_iter_large"):
        tlm.damping_iter(R, p, f, backend="large")
    with pytest.raises(ValueError, match="left update"):
        tlm.damping_iter(R, p, f, edges=object(), update="right")
    with pytest.raises(ValueError, match="unknown packed_impl"):
        tlm.damping_iter(R, p, f, packed_impl="pallas4")


@pytest.mark.parametrize("dtype", [None, "float32", "float64"])
def test_optimize_poses_cpu_defaults_match_jax(dtype):
    """The dtype and backend rule off the card is the JAX package's off
    the TPU: dtype None takes float64 (x64 on), 'auto' takes 'xla' at
    either dtype; the card takes the TPU's float32 and 'packed'."""
    R_gt, p_gt, scans = make_long_scene(W=5, n_planes=12, seed=45)
    one = dict(max_iters=1, min_planes_per_pose=0)
    _, _, ij = balm_tpu.optimize_poses(scans, R_gt, p_gt, dtype=dtype,
                                       solver=JSolverConfig(**one))
    _, _, it = balm_tpu_torch.optimize_poses(scans, R_gt, p_gt, dtype=dtype,
                                             solver=SolverConfig(**one),
                                             device="cpu")
    assert (it["dtype"], it["backend"]) == (ij["dtype"], ij["backend"])
    assert it["backend"] == "xla"
    assert it["dtype"] == (dtype or "float64")


def _bf16_problem():
    """A packed problem at trial poses, JAX's and the port's inputs."""
    from test_torch_kernels import CASES, _jax_inputs

    return _jax_inputs(CASES[3])


def test_hess_precision_bf16_matches_jax():
    """hess_precision='bf16' on the xla/hybrid/chunked product: one bf16
    pass with fp32 accumulation (the TPU's Precision.DEFAULT).  JAX on
    the CPU computes DEFAULT in full f32, so the reference is JAX's rank
    rows rounded to bf16 and multiplied in f64: within 1e-5 of max|H|."""
    from balm_tpu.ops import pallas_evaluate as jpe
    from balm_tpu_torch.ops import packed_evaluate as tpe

    R32, p32, f32, packed, pose = _bf16_problem()
    csum = jpe.csum_packed_xla(pose, packed.mom, packed.cen, packed.cfix)
    _, aux = jpe._aux_from_csum(csum, packed, 1e-9)
    rows, _, _ = jpe._rows_channels_xla(pose, packed.mom, packed.cen, aux)
    Wp, Gp = packed.wp, packed.gp
    M = np.stack([np.stack([np.asarray(rows[j][k]) for j in range(6)])
                  for k in range(3)])                       # (3, 6, Wp, Gp)
    Mb = np.asarray(jnp.asarray(M).astype(jnp.bfloat16).astype(jnp.float64))
    Mb = Mb.reshape(3, 6 * Wp, Gp)
    H_ref = sum(Mb[k] @ Mb[k].T for k in range(3))          # (j, w)-major
    H_exact = sum(M.reshape(3, 6 * Wp, Gp)[k].astype(np.float64)
                  @ M.reshape(3, 6 * Wp, Gp)[k].T.astype(np.float64)
                  for k in range(3))
    T = lambda x: torch.tensor(np.asarray(x))
    args = (T(pose), T(packed.mom), T(packed.cen), T(aux))
    Hh, Jh, Dh = tpe.hess_packed_hybrid(*args, hess_precision="bf16")
    scale = np.max(np.abs(H_ref))
    assert np.max(np.abs(Hh.numpy() - H_ref)) <= 1e-5 * scale
    # one bf16 pass is not the exact product: ~1e-3 off it
    assert np.max(np.abs(Hh.numpy() - H_exact)) > 1e-4 * scale
    # the (w, j)-major xla form is the same product, permuted
    Hx, Jx, Dx = tpe.hess_packed_xla(*args, hess_precision="bf16")
    perm = Hh.view(6, Wp, 6, Wp).permute(1, 0, 3, 2).reshape(6 * Wp, -1)
    assert torch.equal(Hx, perm)
    # J and D stay exact f32
    _, J0, D0 = tpe.hess_packed_hybrid(*args)
    assert torch.equal(Jh, J0) and torch.equal(Dh, D0)


def test_hess_precision_bf16_every_impl():
    """'bf16' runs for every impl as JAX maps it: pallas2 and pallas3 take
    split 'bf16x3' (their 'high' results), pallas stays exact (its
    default), xla, hybrid and the chunked evaluate take the one-pass
    product; each is the evaluate at 'bf16' within 1e-3 of the exact one
    (the one pass's error), and damping_iter runs with it."""
    from balm_tpu_torch.ops import packed as tpk
    from balm_tpu_torch.ops import packed_evaluate as tpe

    R32, p32, f32, _, _ = _bf16_problem()
    f = tF.factors_from_numpy([np.asarray(x) for x in f32])
    pk = tpk.pack_factors(f)
    R, p = torch.tensor(np.asarray(R32)), torch.tensor(np.asarray(p32))
    exact = tpe.evaluate_packed(R, p, pk, impl="xla")
    H0 = exact[2]
    for impl, same_as in (("pallas2", "high"), ("pallas3", "high"),
                          ("pallas", None)):
        got = tpe.evaluate_packed(R, p, pk, impl=impl, hess_precision="bf16")
        ref = tpe.evaluate_packed(R, p, pk, impl=impl,
                                  hess_precision=same_as)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), impl
    one = {}
    for impl in ("xla", "hybrid"):
        one[impl] = tpe.evaluate_packed(R, p, pk, impl=impl,
                                        hess_precision="bf16")
    pk64 = tpk.pad_planes(pk, 64)
    one["chunked"] = tpe.evaluate_packed_chunked(
        R, p, pk64, n_chunks=pk64.gp // 64, hess_precision="bf16")
    scale = float(H0.abs().max())
    for name, (res, J, H) in one.items():
        assert abs(float(res - exact[0])) <= 1e-6 * abs(float(exact[0])), \
            name
        assert float((J - exact[1]).abs().max()) <= 1e-6 * float(
            exact[1].abs().max()), name
        err = float((H - H0).abs().max())
        assert 1e-5 * scale < err <= 1e-2 * scale, (name, err / scale)
    assert torch.allclose(one["xla"][2], one["hybrid"][2], rtol=0,
                          atol=1e-6 * scale)
    cfg = SolverConfig(max_iters=3, min_planes_per_pose=0)
    for kw in (dict(packed_impl="hybrid"), dict(packed_impl="xla"),
               dict(packed_impl="pallas2"), dict(chunk_planes=64)):
        res = tlm.damping_iter(R, p, f, cfg, centered=True, backend="packed",
                               hess_precision="bf16", **kw)
        assert res.iters > 0 and np.isfinite(res.residual), kw


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when torch
    sees no CUDA device (or, copied alone, when the package is absent)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    src = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(src, alone)
    for script in (src, alone):
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=script.parent)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
