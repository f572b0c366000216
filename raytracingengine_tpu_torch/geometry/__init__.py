from raytracingengine_tpu_torch.geometry.intersect import EPS, FlatScene, flatten_scene
from raytracingengine_tpu_torch.geometry.materials import Material, Materials
from raytracingengine_tpu_torch.geometry.primitives import (
    Lights,
    Planes,
    Spheres,
    Triangles,
)

__all__ = [
    "EPS",
    "FlatScene",
    "flatten_scene",
    "Material",
    "Materials",
    "Spheres",
    "Planes",
    "Triangles",
    "Lights",
]
