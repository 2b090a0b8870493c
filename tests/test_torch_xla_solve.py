"""The PyTorch port's f64/XLA solve path — damping_iter(backend='xla'),
optimize_poses(dtype='float64') and pipelines/virtual — against the JAX
package on the same numpy inputs, on the CPU; and the fixes of ROADMAP
queue C (the TF32 context, damping_iter's signature).

Tolerances:
  * float64: the same iterations and accept/reject pattern, trace res1 and
    res2 within 1e-9 relative; virtual.run's RSME within 1e-9
  * float32 (centered): the same accept pattern, trace within 1e-3
    relative (the bar of the packed path's solve tests); virtual.run's
    RSME within 1e-4.  Two f32 evaluators differ in their last bits (sums
    in other orders), and where a solve stops on the f32 ULP floor
    depends on those bits, so in f32 the iteration counts are compared
    over solves that run to max_iters (rel_tol=0) or over the first
    SOLVE_STEPS steps of virtual.run
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import balm_tpu
import balm_tpu_torch
from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.ops import factors as jF
from balm_tpu.ops import lie as jlie
from balm_tpu.pipelines import virtual as jvirtual
from balm_tpu.solver import lm as jlm
from balm_tpu_torch.config import SolverConfig
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.pipelines import virtual as tvirtual
from balm_tpu_torch.solver import lm as tlm
from balm_tpu_torch.utils import metrics as tmetrics

from test_factors import make_problem
from test_hierarchical import make_long_scene, perturb_drift

SOLVE_STEPS = 3


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _perturbed(centered, seed=31, dtype=jnp.float64):
    """make_problem's poses moved off their optimum by a left step."""
    R, p, f, centers = make_problem(G=6, W=5, seed=seed, sparse_obs=True,
                                    with_fix=True)
    if centered:
        f = jF.recenter_bodies(f._replace(centers=centers))
    dx = jnp.asarray(np.random.default_rng(seed).normal(size=(5, 6)) * 0.03)
    R0, p0 = jlie.se3_left_update(R, p, dx)
    f = f.astype(dtype)
    return R0.astype(dtype), p0.astype(dtype), f


def _same_trace(tres, jres, n, tol):
    assert np.array_equal(tres.trace_accept[:n],
                          np.asarray(jres.trace_accept)[:n])
    for key in ("trace_res1", "trace_res2"):
        a = getattr(tres, key)[:n].astype(np.float64)
        b = np.asarray(getattr(jres, key))[:n].astype(np.float64)
        assert np.max(np.abs(a - b) / np.abs(b)) < tol, key


@pytest.mark.parametrize("update", ["left", "right"])
def test_damping_iter_xla_f64_matches_jax(update):
    R0, p0, f = _perturbed(False)
    cfg = dict(max_iters=12, min_planes_per_pose=0)
    jres = jlm.damping_iter(R0, p0, f, JSolverConfig(**cfg), update=update)
    tres = tlm.damping_iter(_t(R0), _t(p0), tF.factors_from_numpy(
        [np.asarray(x) for x in f], dtype=torch.float64),
        SolverConfig(**cfg), update=update)
    assert tres.trace_res1.dtype == np.float64
    assert tres.iters == int(jres.iters) > 2
    _same_trace(tres, jres, tres.iters, 1e-9)
    assert abs(tres.residual - float(jres.residual)) \
        < 1e-9 * float(jres.residual)
    assert np.max(np.abs(tres.p.numpy() - np.asarray(jres.p))) < 1e-9


def test_damping_iter_xla_f32_centered_matches_jax():
    R0, p0, f = _perturbed(True, dtype=jnp.float32)
    cfg = dict(max_iters=4, rel_tol=0.0, min_planes_per_pose=0)
    jres = jlm.damping_iter(R0, p0, f, JSolverConfig(**cfg), centered=True)
    tres = tlm.damping_iter(
        _t(R0, torch.float32), _t(p0, torch.float32),
        tF.factors_from_numpy([np.asarray(x) for x in f]),
        SolverConfig(**cfg), centered=True, backend="xla")
    assert tres.trace_res1.dtype == np.float32
    assert tres.iters == int(jres.iters) > 0
    _same_trace(tres, jres, tres.iters, 1e-3)


def test_optimize_poses_f64_matches_jax():
    R_gt, p_gt, scans = make_long_scene(W=8, seed=43)
    R0, p0 = perturb_drift(R_gt, p_gt, seed=44)
    Rj, pj, ij = balm_tpu.optimize_poses(scans, R0, p0, dtype="float64",
                                         backend="xla")
    Rt, pt, it = balm_tpu_torch.optimize_poses(scans, R0, p0,
                                               dtype="float64", device="cpu")
    assert it["backend"] == "xla"              # what backend='auto' takes
    assert it["status"] == ij["status"] == "ok"
    assert it["num_planes"] == ij["num_planes"]
    assert it["iters"] == ij["iters"] > 0
    for key in ("residual_initial", "residual"):
        assert abs(it[key] - ij[key]) < 1e-9 * ij[key]
    assert Rt.dtype == np.float64
    assert np.max(np.abs(pt - np.asarray(pj))) < 1e-9
    assert it["launches"] == {"csum": 0, "rows": 0}
    # float32 through the XLA evaluator: recentered factors, centered
    R3, p3, i3 = balm_tpu_torch.optimize_poses(scans, R0, p0, backend="xla",
                                               dtype="float32", device="cpu")
    assert i3["status"] == "ok" and R3.dtype == np.float32
    assert abs(i3["residual_initial"] - ij["residual_initial"]) \
        < 1e-3 * ij["residual_initial"]
    assert i3["residual"] < i3["residual_initial"]


@pytest.mark.parametrize("dtype,centered,tol",
                         [("float64", False, 1e-9), ("float32", True, 1e-4)],
                         ids=["f64", "f32_centered"])
def test_virtual_run_matches_jax(dtype, centered, tol):
    kw = dict(win_size=8, surf_size=8, dtype=dtype)
    jout = jvirtual.run(jvirtual.VirtualConfig(**kw), centered=centered)
    tout = tvirtual.run(tvirtual.VirtualConfig(**kw), centered=centered,
                        device="cpu")
    R_gt, p_gt, body = tvirtual.generate(tvirtual.VirtualConfig(**kw))
    jR_gt, jp_gt, jbody = jvirtual.generate(jvirtual.VirtualConfig(**kw))
    assert np.max(np.abs(body - jbody)) < 1e-12
    for key in ("rsme_rot_deg_initial", "rsme_trans_m_initial"):
        assert abs(tout[key] - jout[key]) < 1e-12
    for key in ("rsme_rot_deg", "rsme_trans_m"):
        assert abs(tout[key] - jout[key]) < tol, key
    # and the solve refines the poses
    assert tout["rsme_rot_deg"] < 0.2 * tout["rsme_rot_deg_initial"]
    assert tout["rsme_trans_m"] < 0.2 * tout["rsme_trans_m_initial"]
    n = tout["iters"] if dtype == "float64" else SOLVE_STEPS
    if dtype == "float64":
        assert tout["iters"] == jout["iters"]
    _same_trace(tout["result"], jout["result"], n, 1e-9 if dtype ==
                "float64" else 1e-3)
    assert float(tmetrics.ate_rmse(tout["result"].p.double(), p_gt)) \
        == pytest.approx(tout["rsme_trans_m"], rel=1e-12)


def test_virtual_run_runs_on_cuda_or_raises():
    """No CPU fallback: the default device is the GPU."""
    if torch.cuda.is_available():
        pytest.skip("covered by chip_smoke.py on the GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvirtual.run(tvirtual.VirtualConfig(win_size=4, surf_size=4))


def test_damping_iter_signature_matches_jax():
    """ROADMAP C3: the same parameters, kinds and defaults as JAX's."""
    a = inspect.signature(tlm.damping_iter).parameters
    b = inspect.signature(jlm.damping_iter).parameters
    assert list(a) == list(b)
    for name, pa in a.items():
        pb = b[name]
        assert pa.kind == pb.kind, name
        if name == "cfg":
            assert vars(pa.default) == vars(pb.default)
        else:
            assert pa.default == pb.default, name


def test_solve_under_callers_tf32_setting():
    """ROADMAP C1/C2: with the caller's fp32_precision='tf32' the solve
    neither raises nor changes, and the caller's setting is restored."""
    m = torch.backends.cuda.matmul
    R0, p0, f = _perturbed(True, dtype=jnp.float32)
    args = (_t(R0, torch.float32), _t(p0, torch.float32),
            tF.factors_from_numpy([np.asarray(x) for x in f]),
            SolverConfig(max_iters=3, min_planes_per_pose=0))
    ref = [tlm.damping_iter(*args, centered=True, backend=b)
           for b in ("packed", "xla")]
    prev = m.fp32_precision
    try:
        m.fp32_precision = "tf32"
        got = [tlm.damping_iter(*args, centered=True, backend=b)
               for b in ("packed", "xla")]
        assert m.fp32_precision == "tf32"
    finally:
        m.fp32_precision = prev
    assert m.fp32_precision == prev
    for g, r in zip(got, ref):
        assert g.iters == r.iters > 0
        assert np.array_equal(g.trace_res1, r.trace_res1, equal_nan=True)
