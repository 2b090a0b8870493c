"""The PyTorch port's fused-Hessian packed evaluate against the JAX
package, on the CPU through the kernels' plain versions: B6
`hess_packed` (Pallas `_hess_kernel`), B4 `hess_packed_v2`
(`_hess_kernel_v2`), B5 `hess_packed_v3` (`_hess_kernel_v3`),
evaluate_packed with every impl, the chunked evaluate, and damping_iter
with every packed_impl and with chunk_planes.

The JAX side runs its Pallas kernels with interpret=True, as its own
tests do.  The CUDA kernels are held against these plain versions on the
GPU by chip_smoke.py.

Tolerances (f32 throughout; the two sides sum in different orders):
  * Htilde: 1e-5 of max|.| (the bar of tests/test_pallas_evaluate.py:
    158-159) against split='f32', and for B4 and B5 against the default
    bf16x3 split too, which both sides compute as three products of the
    same bf16 pieces
  * J and D: 1e-4 of max|.|
  * evaluate_packed: res 1e-5 relative, J and H 1e-4 of max|.| (the bars
    of tests/test_pallas_evaluate.py:124-178)
  * chunked against unchunked: res 1e-5 relative, J and H 1e-4 of max
    (:244-276)
  * damping_iter: the same iterations and accept pattern, residual
    within 1e-3 relative, p within 1e-3
"""

import jax.numpy as jnp
import numpy as np
from jax import lax
import pytest
import torch

from balm_tpu.config import SolverConfig as JSolverConfig
from balm_tpu.ops import lie as jlie
from balm_tpu.ops import pallas_evaluate as jpe
from balm_tpu.solver import lm as jlm
from balm_tpu_torch.config import SolverConfig
from balm_tpu_torch.ops import factors as tF
from balm_tpu_torch.ops import packed as tpk
from balm_tpu_torch.ops import packed_evaluate as tpe
from balm_tpu_torch.solver import lm as tlm

from test_pallas_evaluate import _packed_problem
from test_torch_kernels import _jax_inputs, _relmax, _t

# W = 20 scans (Wp = 24): several pose blocks at bw 8 and 16
MULTI = dict(seed=31, G=12, W=20, sparse_obs=True, with_fix=True)


_MULTI_INPUTS = {}


def _multi_inputs():
    """_jax_inputs(MULTI), built once per module: the JAX side of every
    test on MULTI."""
    if "jax" not in _MULTI_INPUTS:
        _MULTI_INPUTS["jax"] = _jax_inputs(MULTI)
    return _MULTI_INPUTS["jax"]


def _hess_inputs(case):
    """(JAX arrays, port tensors) of (pose, mom, cen, aux) at trial
    poses; MULTI's built once per module."""
    if case is MULTI and "hess" in _MULTI_INPUTS:
        return _MULTI_INPUTS["hess"]
    _, _, _, packed, pose = (_multi_inputs() if case is MULTI
                             else _jax_inputs(case))
    csum = jpe.csum_packed_xla(pose, packed.mom, packed.cen, packed.cfix)
    _, aux = jpe._aux_from_csum(csum, packed, 1e-9)
    j = (pose, packed.mom, packed.cen, aux)
    out = j, [_t(x) for x in j]
    if case is MULTI:
        _MULTI_INPUTS["hess"] = out
    return out


def _check_hjd(out, ref, h_tol):
    H, J, D = out
    H0, J0, D0 = ref
    assert H.dtype == torch.float32 and H.shape == tuple(H0.shape)
    assert _relmax(H, H0) < h_tol
    assert _relmax(J, np.asarray(J0)[:, :6]) < 1e-4
    assert _relmax(D, np.asarray(D0)[:, :36]) < 1e-4


def test_hess_v1_plain_matches_jax():
    j, t = _hess_inputs(MULTI)
    _check_hjd(tpe.hess_packed(*t), jpe.hess_packed(*j, interpret=True),
               1e-5)


@pytest.mark.parametrize("split,h_tol", [("f32", 1e-5), ("bf16x3", 1e-5)])
def test_hess_v2_plain_matches_jax(split, h_tol):
    j, t = _hess_inputs(MULTI)
    _check_hjd(tpe.hess_packed_v2(*t, split=split),
               jpe.hess_packed_v2(*j, interpret=True, split=split), h_tol)


@pytest.mark.parametrize("bw,split,h_tol", [(8, "f32", 1e-5),
                                            (16, "f32", 1e-5),
                                            (8, "bf16x3", 1e-5),
                                            (16, "bf16x3", 1e-5)])
def test_hess_v3_plain_matches_jax(bw, split, h_tol):
    """bw=8 tiles Wp=24 exactly (3 blocks, 6 pairs); bw=16 leaves a ragged
    last block (WpB=32 > Wp=24)."""
    j, t = _hess_inputs(MULTI)
    out = tpe.hess_packed_v3(*t, split=split, bw=bw)
    _check_hjd(out, jpe.hess_packed_v3(*j, interpret=True, split=split,
                                       bw=bw, bg=128), h_tol)
    # the raw pair blocks hold the (j, w)-major lower-triangle blocks of
    # the full product of the same split, the padding scans zero
    Hblk, Jb, Db = tpe.hess_pairs_v3(*t, bw, split=split)
    Hjw = tpe.hess_packed_plain(*t, split=split)[0].view(6, 24, 6, 24)
    nB = -(-24 // bw)
    full = torch.nn.functional.pad(Hjw, (0, nB * bw - 24, 0, 0,
                                         0, nB * bw - 24))
    blocks = [full[:, I * bw:(I + 1) * bw, :, J * bw:(J + 1) * bw]
              .reshape(6 * bw, 6 * bw) for I, J in tpe._pairs(nB)]
    assert _relmax(Hblk, torch.cat(blocks)) < 1e-6
    assert Jb.shape == (nB * bw, 6) and not Jb[24:].any()


def test_split_bf16_matches_jax():
    """split_bf16's pieces are JAX's astype bits (pallas_evaluate.py:
    524-525 for bf16x3), and three pieces sum back to the input exactly."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=4096) * np.exp(rng.uniform(-30, 30, 4096))
         ).astype(np.float32)
    x[:4] = (0.0, -0.0, 1.0, np.float32(2.0 ** -130))
    hi, lo = tpe.split_bf16(torch.from_numpy(x), 2)
    jhi = jnp.asarray(x).astype(jnp.bfloat16)
    jlo = (jnp.asarray(x) - jhi.astype(jnp.float32)).astype(jnp.bfloat16)
    bits = lambda t: t.view(torch.int16).numpy()
    assert np.array_equal(bits(hi), np.asarray(jhi).view(np.int16))
    assert np.array_equal(bits(lo), np.asarray(jlo).view(np.int16))
    pieces = tpe.split_bf16(torch.from_numpy(x), 3)
    assert pieces[0].equal(hi) and pieces[1].equal(lo)
    total = sum(p.double() for p in pieces)
    assert np.array_equal(total.numpy(), x.astype(np.float64))
    with pytest.raises(ValueError, match="pieces"):
        tpe.split_bf16(torch.from_numpy(x), 4)


def test_smoke_reference_products():
    """chip_smoke.py's float64 references and the bf16x3 library form:
    f64_products gives the exact product of the rows and the three-piece
    bf16x3 sum; bf16x3_operands' one GEMM is that sum (exact in f64, the
    pieces being bf16); the plain versions come within 1e-5 of each."""
    import chip_smoke

    _, t = _hess_inputs(MULTI)
    rows = tpe.rows_packed_plain(*t)[0]
    H64, H64x3 = chip_smoke.f64_products(rows)
    M = rows.double().reshape(3, -1, rows.shape[-1])
    assert torch.allclose(H64, sum(m @ m.T for m in M), rtol=0, atol=0)
    A, B = chip_smoke.bf16x3_operands(rows)
    assert A.dtype == B.dtype == torch.bfloat16
    assert A.shape == B.shape == (M.shape[1], 9 * M.shape[2])
    assert _relmax(A.double() @ B.double().T, H64x3) < 1e-12
    for split, ref in (("f32", H64), ("bf16x3", H64x3)):
        assert _relmax(tpe.hess_packed_plain(*t, split=split)[0],
                       ref) < 1e-5
    assert _relmax(H64x3, H64) > 1e-7


@pytest.mark.parametrize("impl", ["pallas2", "pallas3"])
def test_split_follows_hess_precision_as_in_jax(impl, monkeypatch):
    """evaluate_packed hands the fused kernel JAX's split for each
    hess_precision (pallas_evaluate.py:999-1018, with lm.py:195's map of
    the strings): None and 'highest' give 'f32', 'high' gives 'bf16x3'."""
    R32, p32, f32, packed, _ = _multi_inputs()
    pkt = tpk.pack_factors(
        tF.factors_from_numpy([np.asarray(x) for x in f32]))
    seen = {"jax": [], "port": []}
    name = {"pallas2": "hess_packed_v2", "pallas3": "hess_packed_v3"}[impl]
    for mod, key in ((jpe, "jax"), (tpe, "port")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _k=key, **kw: (
            seen[_k].append(kw["split"]) or _r(*a, **kw)))
    for port_hp, jax_hp in ((None, None), ("highest", None),
                            ("high", lax.Precision.HIGH)):
        jpe.evaluate_packed(R32, p32, packed, impl=impl, interpret=True,
                            hess_precision=jax_hp)
        tpe.evaluate_packed(_t(R32), _t(p32), pkt, impl=impl,
                            hess_precision=port_hp)
    assert seen["port"] == seen["jax"] == ["f32", "f32", "bf16x3"]
    assert [tpe.split_of(h) for h in (None, "highest", "high")] == \
        ["f32", "f32", "bf16x3"]


def test_evaluate_pallas3_bf16x3_matches_jax():
    """At hess_precision 'high' (JAX: Precision.HIGH) evaluate_packed
    runs B5 with the bf16x3 split on both sides: H within 1e-5 of its
    max, as hess_packed_v3's own bar."""
    R32, p32, f32, packed, _ = _multi_inputs()
    res0, J0, H0 = jpe.evaluate_packed(R32, p32, packed, impl="pallas3",
                                       interpret=True,
                                       hess_precision=lax.Precision.HIGH)
    pkt = tpk.pack_factors(
        tF.factors_from_numpy([np.asarray(x) for x in f32]))
    res1, J1, H1 = tpe.evaluate_packed(_t(R32), _t(p32), pkt,
                                       impl="pallas3", hess_precision="high")
    assert abs(float(res1) - float(res0)) < 1e-5 * abs(float(res0))
    assert _relmax(J1, J0) < 1e-4
    assert _relmax(H1, H0) < 1e-5


def test_hess_xla_matches_jax():
    j, t = _hess_inputs(MULTI)
    _check_hjd(tpe.hess_packed_xla(*t), jpe.hess_packed_xla(*j), 1e-5)


@pytest.mark.parametrize("impl", ["xla", "hybrid", "pallas", "pallas2",
                                  "pallas3"])
def test_evaluate_packed_matches_jax(impl):
    R32, p32, f32, packed, _ = _multi_inputs()
    res0, J0, H0 = jpe.evaluate_packed(R32, p32, packed, impl=impl,
                                       interpret=True)
    pkt = tpk.pack_factors(
        tF.factors_from_numpy([np.asarray(x) for x in f32]))
    res1, J1, H1 = tpe.evaluate_packed(_t(R32), _t(p32), pkt, impl=impl)
    assert abs(float(res1) - float(res0)) < 1e-5 * abs(float(res0))
    assert _relmax(J1, J0) < 1e-4
    assert _relmax(H1, H0) < 1e-4
    # the (w, j)-major evaluate is the (j, w)-major one permuted
    _, Jjw, Hjw = tpe.evaluate_packed_jw(_t(R32), _t(p32), pkt)
    W = R32.shape[0]
    perm = torch.arange(6 * W).view(6, W).T.reshape(-1)
    assert _relmax(J1, Jjw[perm]) < 1e-5
    assert _relmax(H1, Hjw[perm][:, perm]) < 1e-5


def test_pallas2_dispatch_rule(monkeypatch):
    """impl='pallas2' runs the v3 kernel from Wp = 608, the JAX package's
    VMEM rule (pallas_evaluate.py:988-992), and gives the same result."""
    assert not tpe.pallas2_to_pallas3(600)
    assert tpe.pallas2_to_pallas3(608)
    for Wp in (600, 608):
        assert tpe.pallas2_to_pallas3(Wp) == (
            2 * 36 * Wp * Wp * 4 > 100 * 1024 * 1024)
    R32, p32, f32, _, _ = _multi_inputs()
    f = tF.factors_from_numpy([np.asarray(x) for x in f32])
    calls = []
    v3 = tpe.hess_packed_v3
    monkeypatch.setattr(tpe, "hess_packed_v3",
                        lambda *a, **k: calls.append(1) or v3(*a, **k))
    pk608 = tpk.pack_factors(f, wpad=608)
    assert pk608.wp == 608
    a = tpe.evaluate_packed(_t(R32), _t(p32), pk608, impl="pallas2")
    assert calls == [1]
    b = tpe.evaluate_packed(_t(R32), _t(p32), tpk.pack_factors(f),
                            impl="pallas2")
    assert calls == [1]
    for x, y in zip(a, b):
        assert _relmax(x, y) < 1e-5


def test_chunked_evaluate_matches_unchunked():
    R32, p32, f32, _, _ = _multi_inputs()
    f = tF.factors_from_numpy([np.asarray(x) for x in f32])
    pk = tpk.pack_factors(f)
    R, p = _t(R32), _t(p32)
    r0, J0, H0 = tpe.evaluate_packed(R, p, pk)
    pk2 = tpk.pad_planes(pk, 32)
    assert pk2 is pk and pk.gp == 128
    pk3 = tpk.pad_planes(pk, 96)
    assert pk3.gp == 192 and not pk3.coe[:, 128:].any()
    for pkc, n in ((pk2, 4), (pk3, 2)):
        r1, J1, H1 = tpe.evaluate_packed_chunked(R, p, pkc, n_chunks=n)
        assert abs(float(r0) - float(r1)) < 1e-5 * abs(float(r0))
        assert _relmax(J1, J0) < 1e-4
        assert _relmax(H1, H0) < 1e-4
        r2 = tpe.residual_only_packed_chunked(R, p, pkc, n_chunks=n)
        assert abs(float(r2) - float(r0)) < 1e-5 * abs(float(r0))
        # the chunk list a solve makes once gives the same sums
        chunks = tpe._chunk_pk(pkc, n)
        out = tpe.evaluate_packed_chunked(R, p, pkc, n_chunks=n,
                                          chunks=chunks)
        assert all(torch.equal(a, b) for a, b in zip(out, (r1, J1, H1)))
        assert torch.equal(tpe.residual_only_packed_chunked(
            R, p, pkc, n_chunks=n, chunks=chunks), r2)
    with pytest.raises(ValueError, match="do not divide"):
        tpe.evaluate_packed_chunked(R, p, pk, n_chunks=3)


@pytest.mark.parametrize("kw", [dict(packed_impl="xla"),
                                dict(packed_impl="hybrid"),
                                dict(packed_impl="pallas"),
                                dict(packed_impl="pallas2"),
                                dict(packed_impl="pallas3"),
                                dict(chunk_planes=128)],
                         ids=["xla", "hybrid", "pallas", "pallas2",
                              "pallas3", "chunk128"])
def test_damping_iter_packed_impl_matches_jax(kw):
    R32, p32, f32, _, fr, _, _ = _packed_problem(seed=13)
    dx = jnp.asarray(np.random.default_rng(5).normal(
        size=(R32.shape[0], 6)) * 0.02, jnp.float32)
    R0, p0 = jlie.se3_left_update(R32, p32, dx)
    jres = jlm.damping_iter(
        R0, p0, f32, JSolverConfig(max_iters=4, rel_tol=0.0,
                                   min_planes_per_pose=0),
        centered=True, backend="packed", **kw)
    tres = tlm.damping_iter(
        _t(R0), _t(p0), tF.factors_from_numpy([np.asarray(x) for x in f32]),
        SolverConfig(max_iters=4, rel_tol=0.0, min_planes_per_pose=0),
        centered=True, backend="packed", **kw)
    assert tres.iters == int(jres.iters) > 0
    n = tres.iters
    assert np.array_equal(tres.trace_accept[:n],
                          np.asarray(jres.trace_accept)[:n])
    assert abs(tres.residual - float(jres.residual)) \
        < 1e-3 * abs(float(jres.residual))
    assert np.max(np.abs(tres.p.numpy() - np.asarray(jres.p))) < 1e-3


def test_hess_wrappers_refuse_bad_inputs():
    pose, mom = torch.zeros(8, 12), torch.zeros(8, 10, 128)
    cen, aux = torch.zeros(3, 128), torch.zeros(17, 128)
    for fn in (tpe.hess_packed, tpe.hess_packed_v2,
               lambda *a: tpe.hess_pairs_v3(*a, 8)):
        with pytest.raises(ValueError, match="CPU or on one CUDA device"):
            fn(pose, mom.to("meta"), cen, aux)
    with pytest.raises(ValueError, match="bw must lie"):
        tpe.hess_packed_v3(pose, mom, cen, aux, bw=-1)
    for fn in (tpe.hess_packed_v2, tpe.hess_packed_v3,
               lambda *a, **k: tpe.hess_pairs_v3(*a, 8, **k),
               lambda *a, **k: tpe.hess_pairs_v3_plain(*a, 8, **k)):
        with pytest.raises(ValueError, match="unknown split"):
            fn(pose, mom, cen, aux, split="bf16")
    with pytest.raises(ValueError, match="unknown impl"):
        tpe.evaluate_packed(torch.zeros(1, 3, 3), torch.zeros(1, 3),
                            tpk.PackedFactors(mom, cen, cen[:1], mom[0]),
                            impl="pallas4")
