"""The packed layout's invariant that the CUDA kernels B1 `csum` and B2
`rows` rely on (balm_tpu_torch/ops/packed.py): P == 0 wherever n == 0,
so an empty (scan, plane) entry adds exactly zero to every output and
the kernels skip its other channels.

On factors of a small chip_smoke.make_scene (24 scans, 2 m voxels, most
entries empty), for the three packings that feed the kernels —
pack_factors, pack_factors_batched and parallel/sharded_pallas.
shard_packed's lane slices:
  * P is exactly 0 wherever n == 0;
  * mom, cen, coe and cfix equal the JAX package's pack_factors (its
    jax.vmap for the batched form, its lane slices for the shards; its
    extra padding lanes, all zero, cut off) within 1e-6 of max|.| (the
    same f32 leaves; the fold of the first moment into b rounds in
    another order);
  * pack_factors zeroes P at empty entries also when the factors carry
    junk there.
The plain versions of B1 and B2 (what the kernels are held against on
the card) give the same outputs, torch.equal, when the b channels of the
empty entries are overwritten with large finite values.

The same for kernel B7 `moments` (balm_tpu_torch/ops/moments.py), which
relies on P == 0 and v == 0 wherever N == 0: on tests/test_factors.
make_problem's recentered factors with unobserved entries,
moments.pack_inputs keeps the invariant, leaves the inputs as they were
and matches the JAX package's pallas_moments.pack_inputs; junk P and v at
empty entries come out zeroed; and accumulate_moments_plain gives the
same bits on such factors, and with large finite t' at the empty
entries, as on the clean ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from balm_tpu.ops import factors as jF
from balm_tpu.ops import lie as jlie
from balm_tpu.ops import packed as jpk
from balm_tpu.ops import pallas_moments as jpm
from balm_tpu.parallel.sharded import pad_planes
from balm_tpu_torch.config import VoxelConfig
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.ops import lie as tlie
from balm_tpu_torch.ops import moments as tmom
from balm_tpu_torch.ops import packed as tpk
from balm_tpu_torch.ops import packed_evaluate as tpe
from balm_tpu_torch.parallel import sharded
from balm_tpu_torch.parallel import sharded_pallas as sp
from balm_tpu_torch.voxel import grid
from test_factors import make_problem

TOL = 1e-6
SHARDS = 4


@pytest.fixture(scope="module")
def scene():
    R_gt, p_gt, scans = chip_smoke.make_scene(24, 3, pts_per_scan=3000)
    R0, p0 = chip_smoke.perturb(R_gt, p_gt, 3)
    vres = grid.voxelize(scans, R0, p0,
                         VoxelConfig(voxel_size=chip_smoke.VOXEL))
    leaves = [np.asarray(x, np.float32)
              for x in tF.recenter_bodies(vres.factors)]
    return R0.astype(np.float32), p0.astype(np.float32), leaves


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _cut(b, shape):
    """JAX's packed tensor b cut to the port's shape: the JAX package
    pads the plane axis to its TPU tile (512 lanes), the port to 128;
    the lanes cut off are padding, all zero."""
    b = np.asarray(b)
    assert b.ndim == len(shape) and all(x >= y for x, y in
                                        zip(b.shape, shape))
    keep = tuple(slice(0, y) for y in shape)
    rest = b.copy()
    rest[keep] = 0
    assert not rest.any()
    return b[keep]


def _check_invariant(mom):
    n = mom[..., 9:10, :]
    empty = (n == 0).expand_as(mom[..., :6, :])
    assert bool((mom[..., :6, :][empty] == 0).all())
    return int((n != 0).sum()), n.numel()


def _packs(leaves, how):
    """(port packs, JAX packs): lists of PackedFactors of numpy-able
    tensors, one per problem or shard."""
    jf = jF.PlaneFactors(*map(jnp.asarray, leaves))
    if how == "single":
        return ([tpk.pack_factors(tF.factors_from_numpy(leaves))],
                [jpk.pack_factors(jf)])
    if how == "batched":
        # the scene and its planes in reverse order, stacked
        rev = [x[::-1].copy() if x.ndim and x.shape[0] == leaves[0].shape[0]
               else x for x in leaves]
        both = [np.stack([a, b]) for a, b in zip(leaves, rev)]
        pk = tpk.pack_factors_batched(tF.factors_from_numpy(both))
        jb = jax.vmap(jpk.pack_factors)(
            jF.PlaneFactors(*map(jnp.asarray, both)))
        return ([tpk.PackedFactors(*[t[b] for t in pk]) for b in range(2)],
                [jpk.PackedFactors(*[t[b] for t in jb]) for b in range(2)])
    pk = tpk.pack_factors(tF.factors_from_numpy(leaves))
    mesh = sharded.make_mesh(devices=[torch.device("cpu")] * SHARDS)
    spk = sp.shard_packed(pk, mesh)
    jp = jpk.pack_factors(jf)
    ext = spk.gp - jp.mom.shape[-1]
    per = spk.gp // SHARDS
    jpad = [np.pad(np.asarray(t), [(0, 0)] * (t.ndim - 1) + [(0, ext)])
            for t in jp]
    return (list(spk.shards),
            [[t[..., k * per:(k + 1) * per] for t in jpad]
             for k in range(SHARDS)])


@pytest.mark.parametrize("how", ["single", "batched", "sharded"])
def test_packings_keep_the_invariant_and_match_jax(scene, how):
    _, _, leaves = scene
    ours, theirs = _packs(leaves, how)
    live = total = 0
    for pk, jp in zip(ours, theirs):
        n_live, n_all = _check_invariant(pk.mom)
        live, total = live + n_live, total + n_all
        for name, a, b in zip(("mom", "cen", "coe", "cfix"), pk, jp):
            assert _rel(a.numpy(), _cut(b, a.shape)) <= TOL, name
    # a scene: some entries live, most empty
    assert 0 < live < 0.5 * total


def test_pack_factors_zeroes_P_of_empty_entries(scene):
    _, _, leaves = scene
    f = tF.factors_from_numpy(leaves)
    empty = f.C[..., 3, 3] == 0
    junk = torch.randn(f.C.shape, generator=torch.Generator().manual_seed(0),
                       dtype=f.C.dtype)
    C = f.C.clone()
    C[..., :3, :3] = torch.where(empty[..., None, None],
                                 junk[..., :3, :3], C[..., :3, :3])
    dirty = tpk.pack_factors(f._replace(C=C))
    _check_invariant(dirty.mom)
    for a, b in zip(dirty, tpk.pack_factors(f)):
        assert torch.equal(a, b)


def test_empty_entries_contribute_exactly_zero(scene):
    """csum_packed_plain and rows_packed_plain (single and batched) with
    large finite b at the empty entries: the same outputs, torch.equal."""
    R0, p0, leaves = scene
    pk = tpk.pack_factors(tF.factors_from_numpy(leaves))
    T = tlie.pose_matrix(torch.tensor(R0), torch.tensor(p0))
    pose = tpk.pad_poses(T[:, :3, :3], T[:, :3, 3], pk.wp)
    mom = pk.mom.clone()
    empty = mom[:, 9] == 0
    big = torch.tensor([3.0e6, -7.5e5, 1.25e6])
    for k in range(3):
        mom[:, 6 + k] = torch.where(empty, big[k], mom[:, 6 + k])
    dirty = pk._replace(mom=mom)
    csum = tpe.csum_packed(pose, pk.mom, pk.cen, pk.cfix)
    assert torch.equal(csum, tpe.csum_packed(pose, dirty.mom, dirty.cen,
                                             dirty.cfix))
    _, aux = tpe._aux_from_csum(csum, pk, 1e-9)
    for a, b in zip(tpe.rows_packed(pose, pk.mom, pk.cen, aux),
                    tpe.rows_packed(pose, dirty.mom, dirty.cen, aux)):
        assert torch.equal(a, b)
    stack = lambda x, y: torch.stack([x, y]).contiguous()
    bat = [stack(pose, pose), stack(pk.mom, dirty.mom),
           stack(pk.cen, pk.cen)]
    cb = tpe.csum_packed_batched(*bat, stack(pk.cfix, pk.cfix))
    assert torch.equal(cb[0], cb[1]) and torch.equal(cb[0], csum)
    rb = tpe.rows_packed_batched(*bat, stack(aux, aux))
    for x in rb:
        assert torch.equal(x[0], x[1])


@pytest.fixture(scope="module")
def moment_problem():
    """test_torch_factors' B7 problem: recentered bodies with unobserved
    (scan, plane) entries, conditioning centers, a fixed moment, the plane
    axis padded to 128 (padding planes empty too)."""
    R, p, f, centers = make_problem(G=7, W=5, seed=61, sparse_obs=True,
                                    with_fix=True)
    f = pad_planes(jF.recenter_bodies(f._replace(centers=centers)), 128)
    T = jlie.pose_matrix(R, p)
    ft = tF.factors_from_numpy([np.asarray(x) for x in f],
                               dtype=torch.float64)
    return T, torch.tensor(np.asarray(T)), f, ft


def _check_moment_invariant(CH):
    empty = (CH[:, 9:10] == 0).expand_as(CH[:, :9])
    assert bool((CH[:, :9][empty] == 0).all())
    return int((CH[:, 9] != 0).sum()), CH[:, 9].numel()


def test_moments_pack_inputs_keeps_the_invariant_and_matches_jax(
        moment_problem):
    T, Tt, f, ft = moment_problem
    packed = tmom.pack_inputs(Tt, ft)
    live, total = _check_moment_invariant(packed[1])
    assert 0 < live < total
    # unchanged: the channels as gathered before the invariant was applied
    raw = torch.stack([ft.C[..., i, j] for i, j in tmom._CH], -1)
    assert torch.equal(packed[1], raw.permute(1, 2, 0))
    for a, b in zip(packed, jpm.pack_inputs(T, f)):
        assert a.shape == b.shape and a.is_contiguous()
        assert _rel(a.numpy(), b) <= 1e-12


def _junk_at_empty(ft):
    """ft with large random P and v at every entry with N == 0."""
    empty = ft.C[..., 3, 3] == 0
    junk = 1e3 * torch.randn(ft.C.shape, dtype=ft.C.dtype,
                             generator=torch.Generator().manual_seed(1))
    junk = junk + junk.transpose(-1, -2)
    junk[..., 3, 3] = 0
    return ft._replace(C=torch.where(empty[..., None, None], junk, ft.C))


def test_moments_pack_inputs_zeroes_junk_at_empty_entries(moment_problem):
    _, Tt, _, ft = moment_problem
    dirty = _junk_at_empty(ft)
    assert not torch.equal(dirty.C, ft.C)
    got, ref = tmom.pack_inputs(Tt, dirty), tmom.pack_inputs(Tt, ft)
    _check_moment_invariant(got[1])
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_moments_plain_ignores_empty_entries(moment_problem):
    """accumulate_moments_plain, what B7 is held against on the card: the
    same bits on the packed junk factors, and with large finite t' at the
    empty entries, as on the clean inputs."""
    _, Tt, _, ft = moment_problem
    R9, CH, OFS = tmom.pack_inputs(Tt, ft)
    ref = tmom.accumulate_moments_plain(R9, CH, OFS)
    assert torch.equal(
        tmom.accumulate_moments_plain(*tmom.pack_inputs(Tt,
                                                        _junk_at_empty(ft))),
        ref)
    empty = (CH[:, 9:10] == 0).expand_as(OFS)
    big = torch.tensor([3.0e6, -7.5e5, 1.25e6],
                       dtype=OFS.dtype)[None, :, None].expand_as(OFS)
    far = torch.where(empty, big, OFS)
    assert not torch.equal(far, OFS)
    assert torch.equal(tmom.accumulate_moments_plain(R9, CH, far), ref)
    # and in float32, as on the card's f32 path
    x32 = [t.float() for t in (R9, CH, OFS)]
    assert torch.equal(tmom.accumulate_moments_plain(x32[0], x32[1],
                                                     far.float()),
                       tmom.accumulate_moments_plain(*x32))
