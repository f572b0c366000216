"""raytracingengine_tpu_torch: the Whitted ray tracer in PyTorch, with
hand-written CUDA kernels for the H100 (sm_90a).

The port of the JAX package `raytracingengine_tpu`, which stays the
reference. It renders opaque and glass scenes end to end: scene -> camera
rays -> trace (spp=1, or each sample of the per-sample loop) or in-kernel
AA (spp>1) -> HDR -> tonemap -> uint8 -> PPM/PNG, and trains them at any
spp through the trace kernels and their adjoints (inverse/). The command
line is `python -m raytracingengine_tpu_torch.cli`. It imports torch and
numpy only.
"""

from raytracingengine_tpu_torch.core.camera import Camera
from raytracingengine_tpu_torch.geometry.materials import Material
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import render_hdr, render_rays
from raytracingengine_tpu_torch.scene import Scene, SceneBuilder

__all__ = [
    "Camera",
    "Material",
    "RenderConfig",
    "Scene",
    "SceneBuilder",
    "render_hdr",
    "render_rays",
]
