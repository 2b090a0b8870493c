"""The port's device-batched hierarchy (pipelines/hierarchical.py:
run_device_batched and consensus_scan_edges; run_batched_consensus is in
tests/test_torch_batched_consensus.py) against the JAX package's, on the
CPU (the batched kernels' plain versions), on the setups of
tests/test_hierarchical.py (make_long_scene W = 24, 30 planes, 100
points per plane, perturb_drift start).

Tolerances:
  * consensus_scan_edges (host float64 both): every field within 1e-10,
    the same gate stats
  * run_device_batched, block = 8: the same block and top plane counts
    after one cycle; after the JAX test's two cycles the poses within
    1e-3 of JAX's, and JAX's own bars (no overflow, rotation and
    translation RSME at most 0.2 of the start's).  The f32 world
    transform of the association rounds differently under XLA on the
    CPU, which contracts its multiply-adds into FMAs (up to 9.5e-7 m,
    9,674 coordinates of block 1 at the second cycle's poses): there
    one borderline leaf of block 1 falls on the other side of its
    planarity gate (70 planes in JAX, 71 here), so the plane counts are
    held after the first cycle, where both associate the same inputs
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from balm_tpu.pipelines import hierarchical as jh
from balm_tpu_torch.ops import lie
from balm_tpu_torch.pipelines import hierarchical as th
from balm_tpu_torch.utils import metrics

from test_hierarchical import make_long_scene, perturb_drift

CAPS = dict(block_caps=(1 << 8, 1 << 10, 1 << 12), Gcap_block=512,
            cs_cap_block=1 << 13)
TOP = dict(top_caps=(1 << 8, 1 << 10, 1 << 12), Gcap_top=512,
           cs_cap_top=1 << 14)


@pytest.fixture(scope="module")
def scene():
    R_gt, p_gt, scans = make_long_scene(W=24, n_planes=30, pts_per=100,
                                        seed=6)
    R0, p0 = perturb_drift(R_gt, p_gt, seed=7)
    return R_gt, p_gt, scans, R0, p0


def _rsme(R, p, R_gt, p_gt):
    T = torch.as_tensor
    Rg, pg = lie.gauge_fix(T(R_gt), T(p_gt))
    r, t = metrics.pose_rsme(*lie.gauge_fix(T(R), T(p)), Rg, pg)
    return float(r), float(t)


def test_consensus_scan_edges_matches_jax():
    """tests/test_hierarchical.py::test_consensus_edges_gate_degenerate_
    blocks's inputs: block 2 slid by 2 m is gated, its pairs fall back
    to the init prior."""
    rng = np.random.default_rng(0)
    W, blk = 12, 4
    R_init = np.stack([np.eye(3)] * W)
    p_init = np.cumsum(rng.normal(0, 0.01, (W, 3)), axis=0)
    idx = np.stack([np.arange(s, s + blk) for s in (0, 2, 4, 6, 8)])
    Rr = np.stack([R_init[i] for i in idx])
    pr = np.stack([p_init[i] - p_init[i[0]] for i in idx])
    pr[2, 2:] += np.array([2.0, 0.0, 0.0])
    # a small rotation spread so the consensus mean is not trivial
    Rr = np.einsum("bwij,bwjk->bwik", Rr, np.stack([
        lie.so3_exp(torch.as_tensor(rng.normal(0, 1e-3, (blk, 3)))).numpy()
        for _ in range(len(idx))]))
    kw = dict(weight_scale=1e-3, init_R=R_init, init_p=p_init)
    st, sj = {}, {}
    et = th.consensus_scan_edges(idx, Rr, pr, stats=st, **kw)
    ej = jh.consensus_scan_edges(idx, Rr, pr, stats=sj, **kw)
    assert st == sj and st["n_gated_measurements"] >= 1
    assert int(et.i.shape[0]) == W - 1
    for name in et._fields:
        a = getattr(et, name).numpy()
        b = np.asarray(getattr(ej, name))
        assert a.shape == b.shape, name
        assert np.max(np.abs(a - b)) <= 1e-10, name
    assert th.consensus_scan_edges(idx[:, :1], Rr[:, :1], pr[:, :1]) is None


@pytest.fixture(scope="module")
def device_batched(scene):
    """Both packages' run_device_batched at one and two cycles."""
    _, _, scans, R0, p0 = scene
    out = {}
    for cycles in (1, 2):
        kw = dict(block=8, cycles=cycles, **CAPS, **TOP)
        out["torch", cycles] = th.run_device_batched(scans, R0, p0,
                                                     device="cpu", **kw)
        out["jax", cycles] = jh.run_device_batched(scans, R0, p0, **kw)
    return out


def test_run_device_batched_matches_jax(scene, device_batched):
    R_gt, p_gt, _, R0, p0 = scene
    _, _, it1 = device_batched["torch", 1]
    _, _, ij1 = device_batched["jax", 1]
    assert it1["block_planes"] == ij1["block_planes"]
    assert it1["top_planes"] == ij1["top_planes"] > 0
    assert [sorted(t) for t in it1["timings"]] == \
        [sorted(t) for t in ij1["timings"]]
    Rt, pt, it = device_batched["torch", 2]
    Rj, pj, ij = device_batched["jax", 2]
    assert not it["overflow"] and not ij["overflow"]
    assert len(it["timings"]) == 2
    assert np.max(np.abs(Rt - np.asarray(Rj))) <= 1e-3
    assert np.max(np.abs(pt - np.asarray(pj))) <= 1e-3
    r0, t0 = _rsme(R0, p0, R_gt, p_gt)
    r1, t1 = _rsme(Rt, pt, R_gt, p_gt)
    assert r1 < 0.2 * r0 and t1 < 0.2 * t0, (r1, r0, t1, t0)


def test_slice9_imports_neither_jax_nor_balm_tpu():
    mods = ("pipelines.loopclose", "pipelines.hierarchical", "voxel.device",
            "solver.lm", "ops.packed", "ops.packed_evaluate")
    code = ("import sys; "
            + "; ".join(f"import balm_tpu_torch.{m}" for m in mods)
            + "; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'balm_tpu')]; assert not bad, bad")
    repo = pathlib.Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=repo)
