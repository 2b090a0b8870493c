"""The port's comparison baselines BALM1 and EF
(balm_tpu_torch/baselines/{balm1,ef}.py) against the JAX package's, on
the CPU in float64; pa, pa_whitened and bareg are in
tests/test_torch_baselines_pa.py.

Problems: tests/test_baselines.setup's virtual scenes (win 4, surf 8,
pts 15).  Each JAX solver runs once per module (a module fixture): the
JAX package builds a fresh jit of jax.hessian on every call.

Tolerances:
  * balm1.residual against the port's cluster residual_only and against
    JAX's: 1e-10 relative (one cost, two evaluation paths and two
    packages; sums over points in another order)
  * balm1.evaluate: res, J and H within 1e-9 of max|JAX's| (autodiff
    twice through the same closed-form eigvals3, its clamp -> arccos and
    Newton polish, on both sides; the products round in another order)
  * the solvers after 3-5 iterations: the same iteration count, poses
    and costs within 1e-9 (relative for the cost; the same f64 steps,
    each dense solve rounding in its own order)
  * a singular LM system (one scan with no points): torch.linalg.solve
    would raise; the port's solve_ex gives a NaN step and both packages
    reject every step, leaving the poses unchanged
  * BALM1 on chip_smoke.py's 32-plane city cut: as the solvers
  * chip_smoke.py's copy of the city record: equal to artifacts/
    realworld_curves_city; the BALM2 re-take's accepted costs equal its
    accepted trial costs
"""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.baselines import balm1 as jb1
from balm_tpu.baselines import ef as jef
from balm_tpu_torch.baselines import balm1 as tb1
from balm_tpu_torch.baselines import ef as tef
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.ops import lie as tlie

from test_baselines import setup as jax_setup

TOL_RES = 1e-10
TOL_EVAL = 1e-9
TOL_SOLVE = 1e-9


def _t(a):
    return torch.tensor(np.asarray(a, np.float64))


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              1e-300)


def problem(seed, win=4, surf=8, pts=15):
    """tests/test_baselines.setup, with the port's inputs beside JAX's."""
    R_gt, p_gt, R0, p0, body, f, pf = jax_setup(seed=seed, win=win,
                                                surf=surf, pts=pts)
    tf_ = tF.factors_from_numpy([np.asarray(x) for x in f],
                                dtype=torch.float64)
    tpf = tb1.point_planes_from_numpy([np.asarray(x) for x in pf],
                                      dtype=torch.float64)
    return dict(R0=np.asarray(R0), p0=np.asarray(p0), jf=f, jpf=pf, tf=tf_,
                tpf=tpf)


def unobserved(pr, w=2):
    """The same problem with scan w's points removed: its rows of every
    LM system are zero, the damped system singular."""
    jpf = pr["jpf"]
    mask = np.asarray(jpf.mask).copy()
    mask[:, w] = 0.0
    C = np.asarray(pr["jf"].C).copy()
    C[:, w] = 0.0
    jf = pr["jf"]._replace(C=jnp.asarray(C))
    out = dict(pr, jpf=jpf._replace(mask=jnp.asarray(mask)), jf=jf,
               tf=tF.factors_from_numpy([np.asarray(x) for x in jf],
                                        dtype=torch.float64))
    out["tpf"] = tb1.point_planes_from_numpy(
        [np.asarray(x) for x in out["jpf"]], dtype=torch.float64)
    return out


def _same_solve(jout, tout):
    Rj, pj, cj, itj = jout
    Rt, pt, ct, itt = tout
    assert itt == itj
    assert _rel(Rt, Rj) < TOL_SOLVE
    assert _rel(pt, pj) < TOL_SOLVE
    assert abs(ct - cj) <= TOL_SOLVE * abs(cj)


@pytest.fixture(scope="module")
def pr():
    return problem(seed=1)


@pytest.fixture(scope="module")
def jax_runs(pr):
    """Each JAX solver once on `pr` (3-5 iterations each)."""
    R0, p0 = jnp.asarray(pr["R0"]), jnp.asarray(pr["p0"])
    out = {"balm1": jb1.damping_iter(R0, p0, pr["jpf"], max_iters=4)}
    for mode in (False, True):
        out[f"ef_{mode}"] = jef.descend(R0, p0, pr["jf"], max_iters=4,
                                        grad_only=mode)
    return out


def test_point_planes_from_numpy_roundtrip(pr):
    tpf = pr["tpf"]
    for a, b in zip(tpf, pr["jpf"]):
        assert a.dtype == torch.float64
        assert np.array_equal(a.numpy(), np.asarray(b))
    f32 = tb1.point_planes_from_numpy([x.numpy() for x in tpf])
    assert all(x.dtype == torch.float32 for x in f32)
    assert np.array_equal(f32.points.numpy(),
                          np.asarray(pr["jpf"].points, np.float32))


def test_balm1_residual_matches_cluster_and_jax(pr):
    R0, p0 = _t(pr["R0"]), _t(pr["p0"])
    r_pts = float(tb1.residual(R0, p0, pr["tpf"]))
    r_cluster = float(tF.residual_only(tlie.pose_matrix(R0, p0), pr["tf"]))
    r_jax = float(jb1.residual(jnp.asarray(pr["R0"]), jnp.asarray(pr["p0"]),
                               pr["jpf"]))
    assert abs(r_pts - r_cluster) <= TOL_RES * abs(r_cluster)
    assert abs(r_pts - r_jax) <= TOL_RES * abs(r_jax)


@pytest.mark.parametrize("one_batch", [False, True])
def test_balm1_evaluate_matches_jax(pr, one_batch, monkeypatch):
    """The 24 Hessian tangents of win 4 in batches of tb1.HESS_CHUNK,
    and in one batch."""
    assert 6 * 4 > tb1.HESS_CHUNK
    if one_batch:
        monkeypatch.setattr(tb1, "HESS_CHUNK", 6 * 4)
    res, J, H = tb1.evaluate(_t(pr["R0"]), _t(pr["p0"]), pr["tpf"])
    rj, Jj, Hj = jb1.evaluate(jnp.asarray(pr["R0"]), jnp.asarray(pr["p0"]),
                              pr["jpf"])
    assert abs(float(res) - float(rj)) <= TOL_EVAL * abs(float(rj))
    assert _rel(J, Jj) < TOL_EVAL
    assert _rel(H, Hj) < TOL_EVAL
    assert np.all(np.isfinite(H.numpy()))


def test_balm1_damping_iter_matches_jax(pr, jax_runs):
    trace = []
    out = tb1.damping_iter(_t(pr["R0"]), _t(pr["p0"]), pr["tpf"],
                           max_iters=4, trace=trace)
    _same_solve(jax_runs["balm1"], out)
    assert 0 < len(trace) <= 4 and trace[-1][1].shape == (4, 3, 3)


@pytest.mark.parametrize("grad_only", [False, True])
def test_ef_descend_matches_jax(pr, jax_runs, grad_only):
    trace = []
    out = tef.descend(_t(pr["R0"]), _t(pr["p0"]), pr["tf"], max_iters=4,
                      grad_only=grad_only, trace=trace)
    _same_solve(jax_runs[f"ef_{grad_only}"], out)
    assert len(trace) == out[3]


def test_ef_grad_only_matches_analytic_gradient(pr):
    R0, p0 = _t(pr["R0"]), _t(pr["p0"])
    res, g = tef._grad_only(R0, p0, pr["tf"])
    res_a, J, _ = tF.evaluate(tlie.pose_matrix(R0, p0), pr["tf"])
    assert abs(float(res) - float(res_a)) <= TOL_RES * abs(float(res_a))
    assert _rel(g, J) < 1e-9


def test_balm1_singular_step_rejected_in_both(pr):
    sg = unobserved(pr)
    R0, p0 = sg["R0"], sg["p0"]
    Rj, pj, rj, itj = jb1.damping_iter(jnp.asarray(R0), jnp.asarray(p0),
                                       sg["jpf"], max_iters=3)
    Rt, pt, rt, itt = tb1.damping_iter(_t(R0), _t(p0), sg["tpf"],
                                       max_iters=3)
    assert itj == itt == 3
    for a, b in ((Rj, R0), (pj, p0), (Rt, R0), (pt, p0)):
        assert np.array_equal(np.asarray(a), b)
    assert abs(rt - rj) <= TOL_RES * abs(rj)


def test_balm1_city_cut_matches_jax():
    """BALM1 on chip_smoke.py phase 14 (b)'s 32-plane cut of the city
    (24 scans, 16 points per cluster; its first damped system has
    condition number ~7.8e7): the same steps as the JAX package's, poses
    and cost within TOL_SOLVE."""
    import chip_smoke as cs
    from balm_tpu_torch.config import VoxelConfig

    R0, p0, scans, _, _ = cs.scene_city_curves()
    W = cs.CUT_W
    leaves = cs.balm1_subset(scans[:W], R0[:W], p0[:W],
                             VoxelConfig(voxel_size=1.0, min_observers=2),
                             W, cs.CUT_BALM1_G[0], cs.CUT_K)[3]
    assert cs.CUT_BALM1_G[0] == 32
    jpf = jb1.PointPlanes(*[jnp.asarray(x) for x in leaves])
    ref = jb1.damping_iter(jnp.asarray(R0[:W]), jnp.asarray(p0[:W]), jpf,
                           max_iters=3)
    tpf = tb1.point_planes_from_numpy(leaves, dtype=torch.float64)
    _same_solve(ref, tb1.damping_iter(_t(R0[:W]), _t(p0[:W]), tpf,
                                      max_iters=3))


def test_city_record_copy_matches_artifacts():
    """chip_smoke.py holds the card's method comparison to this copy of
    the record (artifacts/ stays out of the chip's copy of the repo)."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    rec = json.loads((repo / "scripts" / "realworld_curves_city_record.json")
                     .read_text())
    d = repo / "artifacts" / "realworld_curves_city"
    assert rec["summary"] == json.loads((d / "summary.json").read_text())
    for k in range(6):
        rows = np.loadtxt(d / f"{k}.txt", ndmin=2)
        assert np.array_equal(np.asarray(rec["curves"][str(k)]), rows)


def test_city_balm2_retake_is_consistent():
    """The JAX re-take of BALM2's rows (scripts/scene_curves_retake.py),
    which chip_smoke.py reads: each row's precision and evaluator, its
    accepted costs are its accepted steps' trial costs, and where they
    leave the record's row of the same precision is where it says."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    rec = json.loads((repo / "scripts" / "realworld_curves_city_record.json")
                     .read_text())["curves"]
    retake = json.loads((repo / "scripts" /
                         "realworld_curves_city_balm2_retake.json")
                        .read_text())["methods"]
    rows = (("4", 1e-6, "float64", "xla"), ("5", 1e-4, "float32", "xla"),
            ("5_packed", 1e-4, "float32", "pallas"))
    for key, tol, dtype, backend in rows:
        m = retake[key]
        assert (m["dtype"], m["backend"]) == (dtype, backend)
        acc = np.asarray(m["trace_accept"], bool)
        assert len(acc) == m["iters"] and acc.sum() == m["accepted"]
        assert np.array_equal(np.asarray(m["trace_res2"])[acc],
                              m["accepted_costs"])
        ref = np.asarray([c for _, c in rec[key[0]][1:]])
        n = min(len(ref), len(acc.nonzero()[0]))
        rel = np.abs(np.asarray(m["accepted_costs"][:n]) - ref[:n]) / ref[:n]
        k = m["first_off_record"]
        assert np.all(rel[:k] <= tol) and rel[k] > tol
