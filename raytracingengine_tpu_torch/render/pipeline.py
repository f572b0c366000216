"""Render pipeline: camera -> chunked pixel blocks -> trace -> HDR image.

The reference's RenderImage is one parallel loop over the flat pixel
index with an AA loop per pixel (Scene.h:283-328). Here pixels are traced
in chunks of `cfg.chunk_size`, each chunk one launch of a trace kernel:

  * spp == 1: camera rays (Camera.rays_for_pixels) -> kernels.chain_trace,
  * spp > 1: pixel coordinates -> kernels.spp_trace, which runs the whole
    AA loop per pixel with jitter keyed by (seed, pixel id, sample), so a
    render does not depend on how the frame is chunked.

The device of the scene decides: CUDA tensors launch the CUDA kernels,
CPU tensors run their plain PyTorch versions. Paths of the JAX pipeline
that have no port yet raise NotImplementedError naming the ROADMAP item
that brings them.
"""

from __future__ import annotations

import torch

from raytracingengine_tpu_torch.core.camera import Camera
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.kernels.chain_trace import chain_trace, pack_scene_tables
from raytracingengine_tpu_torch.kernels.spp_trace import spp_trace
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.scene import Scene


def resolve_mode(scene: Scene, cfg: RenderConfig) -> str:
    if cfg.mode != "auto":
        return cfg.mode
    return "wavefront" if scene.has_transparency else "chain"


def check_supported(mode: str, cfg: RenderConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    todo = None
    if mode != "chain":
        todo = f"mode={mode!r}: the wavefront path (ROADMAP queue 1 item 9)"
    elif cfg.shadow_mode != "binary":
        todo = (f"shadow_mode={cfg.shadow_mode!r}: the transmittance march and "
                "soft shadows (ROADMAP queue 1 item 3)")
    elif cfg.soft_primary:
        todo = "soft_primary: render/soft_primary.py (ROADMAP queue 1 item 11)"
    elif cfg.differentiable:
        todo = ("differentiable=True: the adjoint kernels and integrate_chain "
                "(ROADMAP queue 1 items 3-4, queue 2 item 2)")
    elif not cfg.use_pallas:
        todo = ("use_pallas=False: the integrate_chain integrator "
                "(ROADMAP queue 1 item 3); pass use_pallas=True")
    if todo is not None:
        raise NotImplementedError(f"not ported yet: {todo}")


def render_rays(
    scene: Scene,
    o: torch.Tensor,
    d: torch.Tensor,
    cfg: RenderConfig,
) -> torch.Tensor:
    """Trace an arbitrary ray block [R,3] x [R,3] -> HDR [R,3]."""
    check_supported(resolve_mode(scene, cfg), cfg)
    tables = pack_scene_tables(flatten_scene(scene))
    return chain_trace(tables, o.contiguous(), d.contiguous(), cfg)


def render_hdr(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    *,
    seed: int | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Full-frame HDR render -> [H, W, 3] float32 on the scene's device.

    `seed` keys the AA jitter (spp > 1). Without a seed, it is drawn from
    `generator`; without either it is 0, so a render is reproducible."""
    check_supported(resolve_mode(scene, cfg), cfg)
    device = scene.device
    if camera.device != device:
        raise ValueError(f"camera on {camera.device}, scene on {device}")
    if seed is None:
        seed = 0 if generator is None else int(
            torch.randint(0, 2**31 - 1, (), generator=generator, device=generator.device)
        )
    tables = pack_scene_tables(flatten_scene(scene))
    r = camera.num_pixels
    chunk = max(1, min(cfg.chunk_size, r))
    out = torch.empty((r, 3), dtype=torch.float32, device=device)
    for start in range(0, r, chunk):
        stop = min(start + chunk, r)
        pid = torch.arange(start, stop, dtype=torch.int32, device=device)
        px, py = pid % camera.width, pid // camera.width
        if camera.spp > 1:
            out[start:stop] = spp_trace(tables, camera, px, py, cfg, seed=seed)
        else:
            o, d = camera.rays_for_pixels(px, py)
            out[start:stop] = chain_trace(tables, o.contiguous(), d, cfg)
    return out.reshape(camera.height, camera.width, 3)
