"""The port's factor-sharded paths (balm_tpu_torch/parallel/sharded.py,
the sharded-factor dispatch of solver/lm.py, utils/scaling.py and
graft_entry.py) on 8 virtual CPU shards, against the JAX package on its
8 virtual CPU devices (tests/conftest.py) and unsharded, on
tests/test_factors.make_problem inputs in f64.

Tolerances (the JAX package's own, tests/test_sharding.py):
  * evaluate_shard_map: J and H 1e-10 of max|.|; res 1e-12 relative
    against the port's unsharded evaluate (JAX's bar, whose allclose
    also admits 1e-8 absolute) and 1e-10 against JAX's evaluates (the
    cross-package bar of tests/test_torch_factors.py: the two packages'
    f64 sums round apart by ~4e-12 on this 0.057 cost)
  * damping_iter on sharded factors: the same iterations, poses within
    1e-9 (also damping_iter_timed and damping_iter_resumable)
  * scaling.measure([1, 8]): the residual within 1e-9 relative
  * graft_entry.entry() in f32 against JAX's entry(): the same inputs,
    res 1e-5 relative, J and H 1e-4 of max|.| (two f32 evaluators,
    tests/test_pallas_evaluate.py:40-58)
"""

import __graft_entry__ as jge
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.ops import factors as jF
from balm_tpu.ops import lie as jlie
from balm_tpu.parallel import sharded as jsh
from balm_tpu.solver import lm as jlm
from balm_tpu.utils import scaling as jscaling
from balm_tpu_torch import graft_entry
from balm_tpu_torch.config import SolverConfig
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.ops import lie as tlie
from balm_tpu_torch.parallel import sharded
from balm_tpu_torch.solver import lm
from balm_tpu_torch.utils import scaling

from test_factors import make_problem

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def mesh8():
    return sharded.make_mesh(devices=CPU8)


@pytest.fixture(scope="module")
def jmesh8():
    assert len(jax.devices()) >= 8
    return jsh.make_mesh(8)


def _port(R, p, f):
    return (torch.tensor(np.asarray(R)), torch.tensor(np.asarray(p)),
            tF.factors_from_numpy([np.asarray(x) for x in f],
                                  dtype=torch.float64))


def _rel(a, b):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_make_mesh_and_shard_factors(mesh8):
    assert mesh8.size == 8 and mesh8.world == 1
    assert mesh8.home == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            sharded.make_mesh()
    with pytest.raises(ValueError, match="9 devices"):
        sharded.make_mesh(9, devices=CPU8)
    _, _, f, _ = make_problem(G=13, W=3, K=15, seed=11)
    ft = _port(0, 0, f)[2]
    fs = sharded.shard_factors(ft, mesh8)
    assert fs.num_planes == 16 and len(fs.shards) == 8
    assert all(s.num_planes == 2 for s in fs.shards)
    # the shards tile the padded batch; JAX's pad_planes pads the same
    jpad = jsh.pad_planes(f, 8)
    for k, name in enumerate(ft._fields):
        got = torch.cat([getattr(s, name) for s in fs.shards])
        np.testing.assert_array_equal(got.numpy(), np.asarray(jpad[k]))
    np.testing.assert_array_equal(fs.planes_per_pose().numpy(),
                                  np.asarray(f.planes_per_pose()))


def test_sharded_evaluate_matches_jax(mesh8, jmesh8):
    R, p, f, _ = make_problem(G=13, W=3, K=15, seed=11)
    T = jlie.pose_matrix(R, p)
    res0, J0, H0 = jF.evaluate(T, f)
    res_j, J_j, H_j = jsh.evaluate_shard_map(
        jsh.replicate(T, jmesh8), jsh.shard_factors(f, jmesh8), jmesh8)

    Rt, pt, ft = _port(R, p, f)
    fs = sharded.shard_factors(ft, mesh8)
    Tt = sharded.replicate(tlie.pose_matrix(Rt, pt), mesh8)
    res1, J1, H1 = sharded.evaluate_shard_map(Tt, fs)
    res_t, J_t, H_t = tF.evaluate(Tt, ft)
    for ref, res_tol in (((res_t, J_t, H_t), 1e-12),
                         ((res0, J0, H0), 1e-10), ((res_j, J_j, H_j), 1e-10)):
        assert abs(float(res1) - float(ref[0])) <= res_tol * abs(
            float(ref[0]))
        assert _rel(J1, ref[1]) < 1e-10
        assert _rel(H1, ref[2]) < 1e-10


def test_sharded_lm_matches_jax(mesh8, jmesh8):
    R, p, f, _ = make_problem(G=16, W=3, K=15, seed=12)
    jcfg = JSolverConfig(max_iters=2, u_init=0.1, min_planes_per_pose=1)
    ref = jlm.damping_iter(R, p, f, jcfg)
    with jmesh8:
        ref_sh = jlm.damping_iter(jsh.replicate(R, jmesh8),
                                  jsh.replicate(p, jmesh8),
                                  jsh.shard_factors(f, jmesh8), jcfg)

    cfg = SolverConfig(max_iters=2, u_init=0.1, min_planes_per_pose=1)
    Rt, pt, ft = _port(R, p, f)
    fs = sharded.shard_factors(ft, mesh8)
    got = lm.damping_iter(Rt, pt, fs, cfg)
    one = lm.damping_iter(Rt, pt, ft, cfg)
    timed, times = lm.damping_iter_timed(Rt, pt, fs, cfg)
    resum, state = lm.damping_iter_resumable(Rt, pt, fs, cfg, chunk_iters=1)
    resum, _ = lm.damping_iter_resumable(Rt, pt, fs, cfg, state=state)
    assert len(times) == got.iters
    for r in (ref, ref_sh):
        assert got.iters == int(r.iters)
        np.testing.assert_allclose(got.R.numpy(), np.asarray(r.R), atol=1e-9)
        np.testing.assert_allclose(got.p.numpy(), np.asarray(r.p), atol=1e-9)
    for r in (one, timed, resum):
        assert r.iters == got.iters and not r.degenerate
        np.testing.assert_allclose(r.R.numpy(), got.R.numpy(), atol=1e-9)
        np.testing.assert_allclose(r.p.numpy(), got.p.numpy(), atol=1e-9)
    # the mesh path runs 'xla' (balm_tpu/pipelines/realworld.py:194-195)
    with pytest.raises(ValueError, match="backend='xla'"):
        lm.damping_iter(Rt.float(), pt.float(),
                        sharded.shard_factors(ft.astype(torch.float32),
                                              mesh8), cfg, centered=True,
                        backend="packed")


def test_scaling_measure_matches_jax(jmesh8):
    R, p, f, _ = make_problem(G=16, W=3, K=15, seed=14)
    jout = jscaling.measure(
        R, p, f, device_counts=[1, 8], repeats=1,
        solver_cfg=JSolverConfig(max_iters=2, u_init=0.1, rel_tol=0.0,
                                 min_planes_per_pose=1))
    Rt, pt, ft = _port(R, p, f)
    out = scaling.measure(
        Rt, pt, ft, device_counts=[1, 8], repeats=1, devices=CPU8,
        solver_cfg=SolverConfig(max_iters=2, u_init=0.1, rel_tol=0.0,
                                min_planes_per_pose=1))
    assert [o["devices"] for o in out] == [1, 8]
    assert out[0]["efficiency"] == 1.0
    for o, j in zip(out, jout):
        assert set(o) == set(j)
        assert abs(o["residual"] - j["residual"]) < 1e-9 * abs(j["residual"])
        assert o["iters_per_sec"] > 0


def test_entry_matches_jax():
    jfn, jargs = jge.entry()
    jres, jJ, jH = jax.jit(jfn)(*jargs)
    fn, args = graft_entry.entry(device="cpu")
    Rj, pj, fj = jargs
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(Rj))
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(pj))
    for a, b in zip(args[2], fj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6 * float(jnp.max(jnp.abs(b))))
    res, J, H = fn(*args)
    assert res.dtype == torch.float32 and H.shape == (120, 120)
    assert all(bool(torch.all(torch.isfinite(o))) for o in (res, J, H))
    assert abs(float(res) - float(jres)) < 1e-5 * abs(float(jres))
    assert _rel(J, jJ) < 1e-4
    assert _rel(H, jH) < 1e-4


def test_dryrun_multichip():
    graft_entry.dryrun_multichip(8, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graft_entry.dryrun_multichip(2)
