from raytracingengine_tpu_torch.scenes.assets import bumpy_sphere_mesh, cube_mesh, cube_obj_text
from raytracingengine_tpu_torch.scenes.builders import (
    baseline_sphere_scene,
    dense_mesh_scene,
    glass_sphere_scene,
    head_box_scene,
    mixed_dense_scene,
    stress_scene,
)
from raytracingengine_tpu_torch.scenes.config import load_scene_json, scene_from_dict

__all__ = [
    "bumpy_sphere_mesh", "cube_mesh", "cube_obj_text", "head_box_scene", "baseline_sphere_scene",
    "glass_sphere_scene", "dense_mesh_scene", "mixed_dense_scene",
    "stress_scene", "load_scene_json", "scene_from_dict",
]
