"""Arbitrary output variables: depth, normal, albedo and hit-mask maps.

The reference advertises depth and normal map rendering (README.md:27-28)
through `CalculatePixelDepth` and `HitInfo::normalizedDistance`
(Scene.h:278-281, Shape.h:40-42) and its `visualizeNormals` debug branch
(Scene.h:150-159). Here they are one forward pass of centre rays through
`closest_hit`, as the JAX package's render/aov.py computes them.
"""

from __future__ import annotations

import torch

from raytracingengine_tpu_torch.core import vecmath as vm
from raytracingengine_tpu_torch.core.camera import Camera
from raytracingengine_tpu_torch.geometry.intersect import closest_hit, flatten_scene
from raytracingengine_tpu_torch.render.shading import sky_color
from raytracingengine_tpu_torch.scene import Scene


def render_aovs(scene: Scene, camera: Camera) -> dict[str, torch.Tensor]:
    """Single-sample centre-ray AOVs on the scene's device:

      depth  [H,W]   (t - near) / (far - near) clipped to [0, 1]; 1 on a miss;
      normal [H,W,3] the front-face-flipped normal * 0.5 + 0.5; magenta
                     where it is not finite; the sky gradient on a miss;
      albedo [H,W,3] the hit material's color; the sky gradient on a miss;
      hit    [H,W]   1.0 where a primitive was hit.
    """
    flat = flatten_scene(scene)
    o, d = camera.rays_for_pixels(*camera.pixel_grid())
    hit = closest_hit(flat, o, d)
    h, w = camera.height, camera.width
    miss = ~hit.valid

    depth = (hit.t - camera.near) / (camera.far - camera.near)
    depth = torch.where(miss, torch.ones_like(depth), vm.clamp01(depth))

    front = vm.dot(hit.normal, d) < 0.0
    n = vm.normalize(torch.where(front[:, None], hit.normal, -hit.normal))
    finite = torch.isfinite(n).all(dim=-1) & torch.isfinite(hit.t)
    magenta = torch.tensor([1.0, 0.0, 1.0], dtype=o.dtype, device=o.device).expand(n.shape)
    normal_rgb = torch.where(finite[:, None], n * 0.5 + 0.5, magenta)
    sky = sky_color(d)
    normal_rgb = torch.where(miss[:, None], sky, normal_rgb)
    albedo = torch.where(miss[:, None], sky, hit.albedo)
    return {
        "depth": depth.reshape(h, w),
        "normal": normal_rgb.reshape(h, w, 3),
        "albedo": albedo.reshape(h, w, 3),
        "hit": (~miss).to(o.dtype).reshape(h, w),
    }
