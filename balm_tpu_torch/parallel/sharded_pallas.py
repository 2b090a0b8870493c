"""Multi-device packed evaluation: the CUDA kernels per shard.

Counterpart: balm_tpu/parallel/sharded_pallas.py (shard_packed :29,
evaluate_packed_sharded :46, residual_only_packed_sharded :78).  The
packed layout (ops/packed.py) has the plane axis on the trailing (lane)
dimension, so cutting it into contiguous lane slices gives every shard a
self-contained PackedFactors: the kernels (B1 `csum` for every impl, B2
`rows` for 'xla' and 'hybrid', B6, B4 or B5 for 'pallas', 'pallas2',
'pallas3') run on each shard's device over its own planes, and one
`Mesh.psum` forms the global (residual, J, H), as parallel/sharded.py
does for the XLA-formulated path.  Each kernel launches once per shard
per evaluate.

The solvers do not take this path: the JAX package's mesh path runs the
'xla' evaluator (balm_tpu/pipelines/realworld.py:194-195), and so does
the port's.
"""

from __future__ import annotations

from typing import NamedTuple

from ..ops import packed as packed_mod
from ..ops import packed_evaluate as pe
from .sharded import Mesh


class ShardedPacked(NamedTuple):
    """This process's lane slices of a PackedFactors, shard k a
    contiguous PackedFactors on mesh.devices[k]; `gp` is the global
    padded plane count."""

    shards: tuple
    mesh: Mesh
    gp: int


def shard_packed(pk: packed_mod.PackedFactors, mesh: Mesh) -> ShardedPacked:
    """Split pk's plane (lane) axis over the mesh, zero-padded to a
    multiple of mesh.size * GPAD so that every shard holds whole kernel
    tiles (padding planes carry n = coe = 0).  Each shard is a contiguous
    copy on its device: the kernels index planes by contiguous lane
    tiles."""
    n = mesh.size
    pk = packed_mod.pad_planes(pk, n * packed_mod.GPAD)
    per = pk.gp // n
    lo = mesh.rank * len(mesh.devices)
    shards = tuple(
        packed_mod.PackedFactors(*[
            t[..., (lo + k) * per:(lo + k + 1) * per].to(dev).contiguous()
            for t in pk])
        for k, dev in enumerate(mesh.devices))
    return ShardedPacked(shards=shards, mesh=mesh, gp=pk.gp)


def evaluate_packed_sharded(R, p, spk: ShardedPacked, *, impl: str = "xla"):
    """(res, J (6W,), H (6W, 6W)) in (w, j)-major order on the mesh's
    home device: ops.packed_evaluate.evaluate_packed(impl=...) on every
    shard, then one psum.  impl: any of pe.IMPLS; the plane-axis split
    and the sum are the same for all of them."""
    outs = [pe.evaluate_packed(R.to(dev), p.to(dev), s, impl=impl)
            for s, dev in zip(spk.shards, spk.mesh.devices)]
    return tuple(spk.mesh.psum(list(o)) for o in zip(*outs))


def residual_only_packed_sharded(R, p, spk: ShardedPacked):
    """sum_g coe_g lambda_0(g) over every shard: B1 per shard, psum'd."""
    return spk.mesh.psum([pe.residual_only_packed(R.to(dev), p.to(dev), s)
                          for s, dev in zip(spk.shards, spk.mesh.devices)])
