"""The ranks' layout for the renderer, over torch.distributed.

The reference's parallelism is one OpenMP `parallel for` over pixels
(Scene.h:318-320). The port shards two ways, as the JAX package's mesh
does:

  * `rays`: the pixels split across ranks, the scene replicated;
  * `prims`: the triangles split across ranks in contiguous blocks, the
    rays replicated, the closest hits combined by an all_gather argmin
    (geometry/intersect.py::closest_hit).

World rank r sits at ray index r // n_prim and prim index r % n_prim (the
JAX package's devices reshaped to [rays, prims]). Its ray group holds the
ranks of its prim index (across them the pixels split), its prim group
those of its ray index (across them the triangles split). The groups take
the world's backend: NCCL for CUDA tensors, gloo for CPU tensors
(multihost.py::initialize_distributed chooses). Without an initialised
world a mesh is one rank with no groups, so the same entry points run on
one device.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

RAY_AXIS = "rays"
PRIM_AXIS = "prims"


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_ray: int
    n_prim: int
    rank: int
    #: the ranks across which this rank's pixels split (None: one rank)
    ray_group: object = None
    #: the ranks across which this rank's triangles split (None: one rank)
    prim_group: object = None

    @property
    def size(self) -> int:
        return self.n_ray * self.n_prim

    @property
    def shape(self) -> dict[str, int]:
        return {RAY_AXIS: self.n_ray, PRIM_AXIS: self.n_prim}

    @property
    def ray_index(self) -> int:
        return self.rank // self.n_prim

    @property
    def prim_index(self) -> int:
        return self.rank % self.n_prim


def make_mesh(n_ray_shards: int | None = None, n_prim_shards: int = 1) -> Mesh:
    """A rays x prims mesh over the initialised world (every rank calls it,
    with the same arguments, since each new group is made by all ranks);
    n_ray_shards defaults to the world size over n_prim_shards. Without an
    initialised world: the one-rank mesh."""
    if not (dist.is_available() and dist.is_initialized()):
        if (n_ray_shards or 1) * n_prim_shards != 1:
            raise ValueError(f"mesh {n_ray_shards}x{n_prim_shards}: no torch.distributed world "
                             "is initialised (one rank)")
        return Mesh(1, 1, 0)
    world = dist.get_world_size()
    if n_ray_shards is None:
        n_ray_shards = world // n_prim_shards
    if n_ray_shards * n_prim_shards != world:
        raise ValueError(f"mesh {n_ray_shards}x{n_prim_shards} != {world} ranks")
    rank = dist.get_rank()
    rays = [dist.new_group([i * n_prim_shards + p for i in range(n_ray_shards)])
            for p in range(n_prim_shards)]
    prims = [dist.new_group([i * n_prim_shards + p for p in range(n_prim_shards)])
             for i in range(n_ray_shards)]
    return Mesh(n_ray_shards, n_prim_shards, rank, rays[rank % n_prim_shards],
                prims[rank // n_prim_shards])
