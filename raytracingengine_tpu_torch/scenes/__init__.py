from raytracingengine_tpu_torch.scenes.assets import cube_mesh
from raytracingengine_tpu_torch.scenes.builders import (
    baseline_sphere_scene,
    glass_sphere_scene,
    head_box_scene,
)

__all__ = ["cube_mesh", "head_box_scene", "baseline_sphere_scene", "glass_sphere_scene"]
