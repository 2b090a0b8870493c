"""Multi-device execution: factor-parallel Hessian assembly over a mesh.

Counterpart: balm_tpu/parallel/sharded.py (make_mesh :32, pad_planes
:41, shard_factors :56, replicate :65, evaluate_shard_map :69).  The
reference's "distributed backend" is 4 std::threads over contiguous
plane ranges with private (6W, 6W) accumulators reduced by a join and a
matrix add (bavoxel.hpp:989-1059).  Here the PLANE axis of the factor
batch is split over the shards of a mesh; every per-plane quantity is
computed on the shard's device, and the (6W, 6W) normal equations are
the sum of the shards' partial ones (`Mesh.psum`).

The mesh, in PyTorch's idiom (JAX's is one process driving N devices,
and jax.distributed across processes):

  * `Mesh` is an ordered list of torch.devices — this process's shards —
    and optionally a torch.distributed process group.  A device may
    appear more than once: those are virtual shards of one device, the
    counterpart of XLA's --xla_force_host_platform_device_count (the CPU
    tests run 8 of them; chip_smoke.py runs 4 on its one card).
  * Each shard's factors live on its device.  Poses and the LM state
    ("replicated" in JAX) live on the mesh's first device, the home
    device; each evaluate copies them to the other devices of the mesh
    (a no-op for virtual shards of the home device).
  * `psum` sums the shards' partials in shard order on the home device
    (no float atomics anywhere: a run gives the same bits every time);
    with a process group of more than one rank it is followed by one
    `dist.all_reduce` over the group (parallel/mesh.py).
  * One rank per shard is not the design: NCCL refuses two ranks on one
    card, and gloo moves CUDA tensors only for all_reduce and broadcast.

The global shard count is the local device count times the group's world
size; the planes are padded to a multiple of it and rank r holds the
shards [r * n_local, (r + 1) * n_local).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..ops import factors as Fmod

FACTOR_AXIS = "factor"


class Mesh:
    """An ordered list of devices (this process's shards) and optionally
    a torch.distributed process group spanning several processes."""

    def __init__(self, devices: Sequence, group=None):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)
        self.group = group

    @property
    def home(self) -> torch.device:
        """The device of the replicated state and of every psum."""
        return self.devices[0]

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    @property
    def world(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    @property
    def size(self) -> int:
        """The global shard count (JAX's mesh.devices.size)."""
        return len(self.devices) * self.world

    def psum(self, parts):
        """Sum of this process's per-shard partials, in shard order on the
        home device, then over the process group (one all_reduce)."""
        acc = parts[0].to(self.home)
        for x in parts[1:]:
            acc = acc + x.to(self.home)
        if self.world > 1:
            import torch.distributed as dist

            if len(parts) == 1:
                acc = acc.clone()       # all_reduce works in place
            dist.all_reduce(acc, group=self.group)
        return acc

    def __repr__(self):
        return (f"Mesh(devices={[str(d) for d in self.devices]}, "
                f"world={self.world})")


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the factor axis: the visible CUDA devices by default
    (the first n_devices of them), or the given devices.  Repeat a
    device for virtual shards of it, e.g. devices=[torch.device('cpu')]
    * 8."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device visible; pass devices=["
                "torch.device('cpu')] * n for a mesh of virtual CPU shards")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"make_mesh: {n_devices} devices asked for, "
                             f"{len(devices)} given")
        devices = devices[:n_devices]
    return Mesh(devices)


class ShardedFactors(NamedTuple):
    """A factor batch with its plane axis split over a mesh: `shards`
    holds this process's shards (PlaneFactors or WindowedFactors of
    tensors), shard k on mesh.devices[k]; `num_planes` is the global
    padded plane count."""

    shards: tuple
    mesh: Mesh
    num_planes: int

    @property
    def span(self):
        return self.shards[0].span

    def planes_per_pose(self):
        """(W,) valid planes observed by each pose, over every shard."""
        return self.mesh.psum([s.planes_per_pose() for s in self.shards])

    def map_sum(self, fn, *replicated):
        """psum over the shards of fn(*replicated, shard), each call on
        the shard's device; fn returns a tensor or a tuple of them."""
        outs = [fn(*(x.to(dev) for x in replicated), s)
                for s, dev in zip(self.shards, self.mesh.devices)]
        if isinstance(outs[0], tuple):
            return tuple(self.mesh.psum(list(o)) for o in zip(*outs))
        return self.mesh.psum(outs)


def pad_planes(f, multiple: int):
    """Pad the plane axis (the leading axis of every leaf) with zeros to a
    multiple: padding planes have coe == 0 and contribute exactly zero
    (tests/test_factors.py::test_padding)."""
    G = f.num_planes
    Gp = -(-G // multiple) * multiple
    if Gp == G:
        return f

    def pad(x):
        out = torch.zeros((Gp,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out[:G] = x
        return out

    return type(f)(*[pad(x) for x in f])


def shard_factors(f, mesh: Mesh) -> ShardedFactors:
    """Split the plane axis of f (PlaneFactors or WindowedFactors of
    tensors) over the mesh: padded to a multiple of mesh.size, cut into
    mesh.size contiguous shards, this process's shards copied to their
    devices.  WindowedFactors are first sorted by `base` (stably), so
    that each shard is a segment of the trajectory (JAX
    balm_tpu/solver/large.py:15-19)."""
    n = mesh.size
    if hasattr(f, "base"):
        order = torch.argsort(f.base, stable=True)
        f = type(f)(*[x[order] for x in f])
    f = pad_planes(f, n)
    per = f.num_planes // n
    lo = mesh.rank * len(mesh.devices)
    shards = tuple(
        type(f)(*[x[(lo + k) * per:(lo + k + 1) * per].to(dev).contiguous()
                  for x in f])
        for k, dev in enumerate(mesh.devices))
    return ShardedFactors(shards=shards, mesh=mesh, num_planes=f.num_planes)


def replicate(x, mesh: Mesh):
    """x on the mesh's home device (the port's replicated placement)."""
    return x.to(mesh.home)


def evaluate_shard_map(T, f: ShardedFactors, **kw):
    """ops.factors.evaluate per shard, one psum: (res, J (6W,), H (6W,
    6W)) on the home device — the literal collective replacing the
    reference's 4-thread join + matrix add (bavoxel.hpp:1025-1059).  kw:
    factors.evaluate's options.  JAX's takes the mesh too; here it
    rides on the sharded factors."""
    return f.map_sum(lambda T_, s: Fmod.evaluate(T_, s, **kw), T)
