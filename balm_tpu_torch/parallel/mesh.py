"""Multi-process mesh: torch.distributed initialization and the global mesh.

Counterpart: balm_tpu/parallel/mesh.py (init_distributed :21,
make_global_mesh :44, local_factor_slice :48).  Single process: a mesh
over this process's devices (parallel/sharded.make_mesh).  Several
processes: call `init_distributed` once per process, then
`make_global_mesh` gives a mesh whose psum sums this process's shards
and then all-reduces over the group; rank r holds the global shards
[r * n_local, (r + 1) * n_local) (sharded.shard_factors), the factor
axis laid out process-major as JAX lays it out host-major.

The backend follows the devices: NCCL when every process has a card of
its own, gloo on the CPU and gloo when processes share one card (NCCL
refuses two ranks on one GPU; gloo all-reduces CUDA tensors through the
host).  The choice is logged; a failed initialization raises, and no
other backend is tried behind the caller's back.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
import torch.distributed as dist

from .sharded import Mesh

log = logging.getLogger(__name__)


def _backend(num_processes: int, device: torch.device) -> str:
    if device.type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.device_count() >= num_processes else "gloo"


def local_device() -> torch.device:
    """This process's card: rank % visible cards (its own card under
    NCCL, the shared one under gloo)."""
    if not torch.cuda.is_available():
        raise RuntimeError("local_device: no CUDA device; pass the CPU "
                           "devices of the mesh explicitly")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device="cuda") -> Optional[str]:
    """Initialize torch.distributed's default group; a no-op when
    coordinator is None (single process) or the group is already up.

    coordinator: 'host:port' (JAX's form) or 'tcp://host:port'; there is
    no cluster discovery, so it must be given with num_processes and
    process_id.  device: 'cuda' (the default: the port runs on the card)
    or 'cpu'.  Returns the backend of the group ('nccl' or 'gloo'), None
    for a single process."""
    if coordinator is None:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed needs num_processes and "
                         "process_id with a coordinator")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_distributed: no CUDA device; pass "
                           "device='cpu' for a gloo group on the CPU")
    backend = _backend(num_processes, device)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    log.info("init_distributed: backend %s, rank %d of %d at %s", backend,
             process_id, num_processes, url)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return backend


def make_global_mesh(local_devices=None) -> Mesh:
    """The factor mesh over every process of the group: this process's
    devices (default: its own device, local_device()) and the default
    group when one is up.  Repeat a device for virtual shards of it."""
    if local_devices is None:
        local_devices = [local_device()]
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(local_devices, group)


def local_factor_slice(num_planes_global: int):
    """[start, stop) of this process's plane range for process-local
    loading (the ceil-divided share of rank r)."""
    pc = dist.get_world_size() if dist.is_initialized() else 1
    pi = dist.get_rank() if dist.is_initialized() else 0
    per = -(-num_planes_global // pc)
    return min(pi * per, num_planes_global), \
        min(num_planes_global, (pi + 1) * per)
