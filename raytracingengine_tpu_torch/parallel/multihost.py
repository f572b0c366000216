"""Joining the ranks of several processes or hosts.

The reference is one process. The port's ranks are processes joined by
torch.distributed: `torchrun` (or any launcher) sets WORLD_SIZE, RANK and
MASTER_ADDR / MASTER_PORT, or a caller names a `file://` or `tcp://`
rendezvous. `initialize_distributed` joins them; without a launcher's
variables it does nothing, so the same entry points run on one device.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from raytracingengine_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, backend: str | None = None) -> bool:
    """init_process_group from the arguments or torchrun's variables
    (WORLD_SIZE, RANK; the rendezvous `init_method`, else env:// with
    MASTER_ADDR and MASTER_PORT) -> True; False, doing nothing, when
    neither names a world of more than one rank (or a world is already
    initialised). The backend is NCCL where a CUDA card is present, else
    gloo; each rank then works on the card of its LOCAL_RANK."""
    if dist.is_initialized():
        return False
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if init_method is None and world_size <= 1:
        return False
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init_method or "env://", world_size=world_size,
                            rank=rank)
    return True


def make_global_mesh(n_prim_shards: int = 1) -> Mesh:
    """The mesh over every process's ranks: rays across the world (ranks
    are numbered host by host, so a host's ranks hold neighbouring ray
    shards) and, with n_prim_shards > 1, prims within each run of
    n_prim_shards ranks, which should lie on one host."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % max(n_prim_shards, 1) != 0:
        raise ValueError(f"{n} ranks not divisible by {n_prim_shards} prim shards")
    return make_mesh(n_ray_shards=n // n_prim_shards, n_prim_shards=n_prim_shards)
