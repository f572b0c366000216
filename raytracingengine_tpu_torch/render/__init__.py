from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import render_hdr, render_rays, resolve_mode

__all__ = ["RenderConfig", "render_hdr", "render_rays", "resolve_mode"]
