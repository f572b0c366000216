"""Rendering and training over several ranks (torch.distributed): the JAX
package's parallel/, with its `rays` x `prims` layout."""

from raytracingengine_tpu_torch.parallel.mesh import PRIM_AXIS, RAY_AXIS, Mesh, make_mesh
from raytracingengine_tpu_torch.parallel.sharded import (
    make_sharded_loss,
    render_hdr_auto,
    render_hdr_sharded,
)

__all__ = [
    "PRIM_AXIS",
    "RAY_AXIS",
    "Mesh",
    "make_mesh",
    "make_sharded_loss",
    "render_hdr_auto",
    "render_hdr_sharded",
]
