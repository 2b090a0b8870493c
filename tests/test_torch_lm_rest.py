"""The rest of the port's LM loop — linear_solver='pcg',
damping_iter_timed and damping_iter_resumable with utils/checkpoint —
against the JAX package, on tests/test_factors.make_problem in f64
(backend 'xla'), on the CPU.

Tolerances:
  * pcg where CG meets its tolerance on every solve: the same iterations
    and accept pattern, trace res1/res2 within 1e-9 relative
  * pcg truncated at non-positive curvature (an indefinite damped system
    far from the optimum, u_init = 0.01): the truncated iterate
    amplifies summation-order roundoff (~1e-10 in the step, ~1e-6 in
    the trial cost of a rejected step), so there the same iterations and
    accept pattern with the trace within 1e-5 relative
  * damping_iter_timed against the port's damping_iter, chained resumable
    chunks against the one-shot solve: bit for bit
  * a state resumed across the packages: finishing at the other
    package's one-shot result within 1e-9
"""

import numpy as np
import pytest
import torch

from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.solver import lm as jlm
from balm_tpu.utils import checkpoint as jckpt
from balm_tpu_torch.config import SolverConfig
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.solver import lm as tlm
from balm_tpu_torch.utils import checkpoint as tckpt

from test_torch_xla_solve import _perturbed, _t

MAX_ITERS = 12


def _problem(seed=31, centered=False):
    R0, p0, f = _perturbed(centered, seed=seed)
    ft = tF.factors_from_numpy([np.asarray(x) for x in f],
                               dtype=torch.float64)
    return R0, p0, f, ft


def _cfg(**kw):
    kw = dict(max_iters=MAX_ITERS, min_planes_per_pose=0, **kw)
    return JSolverConfig(**kw), SolverConfig(**kw)


def _close(tres, jres, tol):
    n = tres.iters
    assert n == int(jres.iters) > 2
    assert np.array_equal(tres.trace_accept[:n],
                          np.asarray(jres.trace_accept)[:n])
    for key in ("trace_res1", "trace_res2"):
        a = getattr(tres, key)[:n]
        b = np.asarray(getattr(jres, key))[:n]
        assert np.max(np.abs(a - b) / np.abs(b)) < tol, key
    assert abs(tres.residual - float(jres.residual)) \
        < tol * float(jres.residual)


def _bitwise(a, b):
    assert a.iters == b.iters and a.residual == b.residual
    for key in ("trace_res1", "trace_res2", "trace_u", "trace_accept"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    assert torch.equal(a.R, b.R) and torch.equal(a.p, b.p)


@pytest.mark.parametrize("u_init,tol", [(0.1, 1e-9), (0.01, 1e-5)])
def test_pcg_matches_jax(u_init, tol):
    R0, p0, f, ft = _problem()
    jc, tc = _cfg(u_init=u_init)
    jres = jlm.damping_iter(R0, p0, f, jc, linear_solver="pcg")
    tres = tlm.damping_iter(_t(R0), _t(p0), ft, tc, linear_solver="pcg")
    _close(tres, jres, tol)
    # pcg_iters / pcg_tol reach the solve: one CG iteration per step
    j1 = jlm.damping_iter(R0, p0, f, jc, linear_solver="pcg", pcg_iters=1)
    t1 = tlm.damping_iter(_t(R0), _t(p0), ft, tc, linear_solver="pcg",
                          pcg_iters=1)
    _close(t1, j1, 1e-9)
    assert abs(t1.residual - tres.residual) > 1e-6 * tres.residual


def test_pcg_packed_layout_matches_cholesky():
    """Under pcg the hybrid evaluate gives (w, j)-major H (its block-
    Jacobi blocks are pose blocks): the f32 packed pcg solve lands with
    the Cholesky one."""
    R0, p0, f, _ = _problem(centered=True)
    ft = tF.factors_from_numpy([np.asarray(x) for x in f])
    R = torch.tensor(np.asarray(R0), dtype=torch.float32)
    p = torch.tensor(np.asarray(p0), dtype=torch.float32)
    kw = dict(centered=True, backend="packed")
    _, tc = _cfg(u_init=0.1)
    a = tlm.damping_iter(R, p, ft, tc, linear_solver="pcg", **kw)
    b = tlm.damping_iter(R, p, ft, tc, **kw)
    assert a.iters > 2 and abs(a.residual - b.residual) < 1e-3 * b.residual


@pytest.mark.parametrize("backend", ["xla", "packed"])
def test_timed_equals_damping_iter(backend):
    R0, p0, f, ft = _problem(centered=backend == "packed")
    _, tc = _cfg()
    kw = {}
    if backend == "packed":
        ft = ft.astype(torch.float32)
        kw = dict(centered=True, backend="packed")
    dt = torch.float32 if backend == "packed" else torch.float64
    R, p = _t(R0, dt), _t(p0, dt)
    ref = tlm.damping_iter(R, p, ft, tc, **kw)
    res, times = tlm.damping_iter_timed(R, p, ft, tc, **kw)
    _bitwise(res, ref)
    assert len(times) == res.iters > 2
    assert np.all(np.diff(times) > 0) and times[0] > 0


def test_timed_matches_jax():
    R0, p0, f, ft = _problem()
    jc, tc = _cfg()
    jres, jt = jlm.damping_iter_timed(R0, p0, f, jc)
    tres, tt = tlm.damping_iter_timed(_t(R0), _t(p0), ft, tc)
    _close(tres, jres, 1e-9)
    assert len(tt) == len(jt) == tres.iters


@pytest.mark.parametrize("chunk", [1, 3, 5])
def test_resumable_chunks_equal_one_shot(chunk, tmp_path):
    """Chained chunks, each through a checkpoint file, equal one
    damping_iter bit for bit; a finished carry passes through."""
    R0, p0, _, ft = _problem()
    _, tc = _cfg()
    R, p = _t(R0), _t(p0)
    ref = tlm.damping_iter(R, p, ft, tc)
    state, calls = None, 0
    while state is None or (int(state["it"]) < ref.iters
                            and not bool(state["done"])):
        res, state = tlm.damping_iter_resumable(
            R, p, ft, tc, state=state, chunk_iters=chunk)
        path = tmp_path / f"ck{calls}.npz"
        tckpt.save(path, res.R, res.p, ft, **tckpt.pack_lm_state(state))
        state = tckpt.unpack_lm_state(tckpt.load(path))
        calls += 1
    assert calls == -(-ref.iters // chunk)
    _bitwise(res, ref)
    again, _ = tlm.damping_iter_resumable(R, p, ft, tc, state=state,
                                          chunk_iters=chunk)
    _bitwise(again, ref)
    one, _ = tlm.damping_iter_resumable(R, p, ft, tc)
    _bitwise(one, ref)


def test_resumable_state_crosses_packages(tmp_path):
    """The state has JAX's _Carry fields, shapes and dtypes; a JAX state
    resumed here, and a port state resumed by JAX, each finish at the
    other package's one-shot result within 1e-9.  The states pass
    through the other package's checkpoint files."""
    R0, p0, f, ft = _problem()
    jc, tc = _cfg()
    jone = jlm.damping_iter(R0, p0, f, jc)
    tone = tlm.damping_iter(_t(R0), _t(p0), ft, tc)

    _, jstate = jlm.damping_iter_resumable(R0, p0, f, jc, chunk_iters=3)
    _, tstate = tlm.damping_iter_resumable(_t(R0), _t(p0), ft, tc,
                                           chunk_iters=3)
    assert set(jstate) == set(tstate)
    for k, v in jstate.items():
        assert (v.dtype, v.shape) == (tstate[k].dtype, tstate[k].shape), k

    jckpt.save(tmp_path / "j.npz", jstate["R"], jstate["p"],
               **jckpt.pack_lm_state(jstate))
    tckpt.save(tmp_path / "t.npz", tstate["R"], tstate["p"],
               **tckpt.pack_lm_state(tstate))
    from_j = tckpt.unpack_lm_state(tckpt.load(tmp_path / "j.npz"))
    from_t = jckpt.unpack_lm_state(jckpt.load(tmp_path / "t.npz"))

    t_fin, _ = tlm.damping_iter_resumable(_t(R0), _t(p0), ft, tc,
                                          state=from_j)
    j_fin, _ = jlm.damping_iter_resumable(R0, p0, f, jc, state=from_t)
    _close(t_fin, jone, 1e-9)
    _close(tone, j_fin, 1e-9)
    np.testing.assert_allclose(t_fin.p.numpy(), np.asarray(jone.p),
                               atol=1e-9)


def test_checkpoint_and_pose_csv_match_jax(tmp_path):
    """Factor batches saved by either package load in the other; both
    write_pose_csv functions write the same bytes."""
    R0, p0, f, ft = _problem()
    jckpt.save(tmp_path / "j.npz", R0, p0, f, note=np.arange(3))
    tckpt.save(tmp_path / "t.npz", _t(R0), _t(p0), ft, note=np.arange(3))
    for a, b in ((tckpt.load(tmp_path / "j.npz"),
                  jckpt.load(tmp_path / "t.npz")),):
        np.testing.assert_array_equal(a["R"], b["R"])
        np.testing.assert_array_equal(a["note"], b["note"])
        for x, y in zip(a["factors"], b["factors"]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    t = np.linspace(0.0, 1.0, len(R0))
    jckpt.write_pose_csv(tmp_path / "j.csv", np.asarray(R0), np.asarray(p0),
                         t)
    tckpt.write_pose_csv(tmp_path / "t.csv", _t(R0), _t(p0), t)
    assert (tmp_path / "j.csv").read_bytes() == \
        (tmp_path / "t.csv").read_bytes()
    for x, y in zip(jckpt.read_pose_csv(tmp_path / "t.csv"),
                    tckpt.read_pose_csv(tmp_path / "j.csv")):
        np.testing.assert_array_equal(x, y)
    assert tckpt.unpack_lm_state({"R": 1}) is None


def test_read_pose_csv_round_trip(tmp_path):
    """A17: utils.checkpoint.read_pose_csv is the port's own function (as
    the JAX package's is); a trajectory written by the port's
    write_pose_csv reads back through both packages' readers to the same
    arrays, within the file's 9 decimals."""
    assert tckpt.read_pose_csv.__module__ == tckpt.__name__
    R0, p0, _, _ = _problem()
    R0, p0 = np.asarray(R0, np.float64), np.asarray(p0, np.float64)
    t = np.linspace(0.0, 2.0, len(R0))
    tckpt.write_pose_csv(tmp_path / "t.csv", _t(R0), _t(p0), t)
    got_t = tckpt.read_pose_csv(tmp_path / "t.csv")
    got_j = jckpt.read_pose_csv(tmp_path / "t.csv")
    for x, y, ref in zip(got_t, got_j, (R0, p0, t)):
        np.testing.assert_array_equal(x, np.asarray(y))
        np.testing.assert_allclose(x, ref, rtol=0, atol=1e-9)
