"""The port's sharded packed evaluate (balm_tpu_torch/parallel/
sharded_pallas.py) on 8 virtual CPU shards, where every kernel wrapper
runs its plain version, against the port's unsharded evaluate_packed of
the same impl and against the JAX package's unsharded
evaluate_packed(impl='xla') (its XLA formulation: no Pallas kernel, no
interpret mode).

The problem: virtual.generate's scene at 300 planes and 6 scans, f64
recentered, then f32; packed at GPAD = 128 over 8 shards the plane axis
is 1024 lanes, 128 per shard, so shards 0-1 are full, shard 2 holds 44
planes and shards 3-7 padding only.

Tolerances: res, J and H within 1e-4 relative to their max|.| (the bar
of tests/test_sharded_pallas.py and tests/test_pallas_evaluate.py:40-58:
f32 sums in other orders); a padding-only shard gives exact zeros; the
same bits twice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from balm_tpu.ops import factors as jF
from balm_tpu.ops import packed as jpk
from balm_tpu.ops import pallas_evaluate as jpe
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.ops import lie as tlie
from balm_tpu_torch.ops import packed as tpk
from balm_tpu_torch.ops import packed_evaluate as tpe
from balm_tpu_torch.parallel import sharded
from balm_tpu_torch.parallel import sharded_pallas as sp
from balm_tpu_torch.pipelines import virtual

TOL = 1e-4


@pytest.fixture(scope="module")
def problem():
    cfg = virtual.VirtualConfig(win_size=6, surf_size=300, pts_size=10,
                                seed=5)
    R_gt, p_gt, body = virtual.generate(cfg)
    R0, p0 = virtual.perturb(R_gt, p_gt, cfg)
    f = virtual.build_factors(body, torch.float64)
    T = tlie.pose_matrix(torch.tensor(R0), torch.tensor(p0))
    f = tF.recenter_bodies(f._replace(centers=tF.estimate_centers(T, f)))
    leaves = [x.numpy().astype(np.float32) for x in f]
    R32, p32 = R0.astype(np.float32), p0.astype(np.float32)
    jref = jpe.evaluate_packed(
        jnp.asarray(R32), jnp.asarray(p32),
        jpk.pack_factors(jF.PlaneFactors(*map(jnp.asarray, leaves))),
        impl="xla")
    pk = tpk.pack_factors(tF.factors_from_numpy(leaves))
    mesh = sharded.make_mesh(devices=[torch.device("cpu")] * 8)
    return dict(R=torch.tensor(R32), p=torch.tensor(p32), pk=pk,
                spk=sp.shard_packed(pk, mesh), jref=jref)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_shard_packed_layout(problem):
    spk, pk = problem["spk"], problem["pk"]
    assert spk.gp == 1024 and len(spk.shards) == 8
    for s in spk.shards:
        assert s.gp == 128 and s.wp == pk.wp
        assert all(t.is_contiguous() for t in s)
    # the lane slices tile the padded pack
    full = tpk.pad_planes(pk, 8 * tpk.GPAD)
    for k in range(4):
        np.testing.assert_array_equal(
            torch.cat([s[k] for s in spk.shards], dim=-1).numpy(),
            full[k].numpy())
    n_planes = [int((s.coe > 0).sum()) for s in spk.shards]
    assert n_planes == [128, 128, 44, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("impl", ["xla", "hybrid", "pallas", "pallas2",
                                  "pallas3"])
def test_evaluate_packed_sharded_matches(problem, impl):
    R, p, pk, spk = problem["R"], problem["p"], problem["pk"], problem["spk"]
    got = sp.evaluate_packed_sharded(R, p, spk, impl=impl)
    one = tpe.evaluate_packed(R, p, pk, impl=impl)
    for ref in (one, problem["jref"]):
        for a, b in zip(got, ref):
            assert _rel(a, b) < TOL, impl
    again = sp.evaluate_packed_sharded(R, p, spk, impl=impl)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_padding_only_shard_is_zero(problem):
    pad = problem["spk"].shards[-1]
    res, J, H = tpe.evaluate_packed(problem["R"], problem["p"], pad)
    assert float(res) == 0.0
    assert not torch.any(J) and not torch.any(H)


def test_residual_only_packed_sharded(problem):
    R, p = problem["R"], problem["p"]
    r = sp.residual_only_packed_sharded(R, p, problem["spk"])
    r1 = tpe.residual_only_packed(R, p, problem["pk"])
    for ref in (r1, problem["jref"][0]):
        assert abs(float(r) - float(ref)) < TOL * abs(float(ref))
