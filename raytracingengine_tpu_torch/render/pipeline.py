"""Render pipeline: camera -> chunked pixel blocks -> trace -> HDR image.

The reference's RenderImage is one parallel loop over the flat pixel
index with an AA loop per pixel (Scene.h:283-328). Here pixels are traced
in chunks of `cfg.chunk_size`:

  * spp == 1, `use_pallas=True`: camera rays (Camera.rays_for_pixels) ->
    kernels.chain_grad.chain_trace_fused: the chain trace kernel forward
    and, when a scene or camera tensor requires grad, the adjoint kernel
    backward;
  * spp == 1, `use_pallas=False`: camera rays -> render.integrator.
    integrate_chain, the all-pairs integrator that autograd differentiates;
  * spp > 1: pixel coordinates -> kernels.spp_trace, which runs the whole
    AA loop per pixel with jitter keyed by (seed, pixel id, sample), so a
    render does not depend on how the frame is chunked. It is forward-only.

The chunks are joined with torch.cat, so gradients flow through the frame.
The device of the scene decides: CUDA tensors launch the CUDA kernels, CPU
tensors run their plain PyTorch versions. Paths of the JAX pipeline that
have no port yet raise NotImplementedError naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

import torch

from raytracingengine_tpu_torch.core.camera import Camera
from raytracingengine_tpu_torch.geometry.intersect import flatten_scene
from raytracingengine_tpu_torch.kernels.chain_grad import chain_trace_fused
from raytracingengine_tpu_torch.kernels.chain_trace import pack_scene_tables
from raytracingengine_tpu_torch.kernels.spp_trace import spp_trace
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.integrator import integrate_chain
from raytracingengine_tpu_torch.scene import Scene, tensor_leaves


def resolve_mode(scene: Scene, cfg: RenderConfig) -> str:
    if cfg.mode != "auto":
        return cfg.mode
    return "wavefront" if scene.has_transparency else "chain"


def _requires_grad(*objs) -> bool:
    """Does autograd record, and does a tensor of these dataclasses (scene,
    camera) require grad?"""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for x in objs for t in tensor_leaves(x).values()
    )


def check_supported(mode: str, cfg: RenderConfig, spp: int = 1, grad: bool = False) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    todo = None
    if mode != "chain":
        todo = f"mode={mode!r}: the wavefront path (ROADMAP queue 1 item 9)"
    elif cfg.shadow_mode != "binary":
        todo = (f"shadow_mode={cfg.shadow_mode!r}: the transmittance march and "
                "soft shadows (ROADMAP queue 1 item 3)")
    elif cfg.soft_primary:
        todo = "soft_primary: render/soft_primary.py (ROADMAP queue 1 item 11)"
    elif spp > 1 and (grad or cfg.differentiable or not cfg.use_pallas):
        todo = ("spp > 1 with gradients, differentiable=True or use_pallas=False: "
                "the per-sample differentiable loop (ROADMAP queue 1 item 13)")
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
    flat = flatten_scene(scene)
    if not cfg.use_pallas:
        return integrate_chain(flat, o, d, cfg)
    return chain_trace_fused(pack_scene_tables(flat), o, d, cfg)


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
    check_supported(resolve_mode(scene, cfg), cfg, camera.spp, _requires_grad(scene, camera))
    device = scene.device
    if camera.device != device:
        raise ValueError(f"camera on {camera.device}, scene on {device}")
    if seed is None:
        seed = 0 if generator is None else int(
            torch.randint(0, 2**31 - 1, (), generator=generator, device=generator.device)
        )
    flat = flatten_scene(scene)
    tables = pack_scene_tables(flat) if cfg.use_pallas else None
    r = camera.num_pixels
    chunk = max(1, min(cfg.chunk_size, r))
    parts = []
    for start in range(0, r, chunk):
        pid = torch.arange(start, min(start + chunk, r), dtype=torch.int32, device=device)
        px, py = pid % camera.width, pid // camera.width
        if camera.spp > 1:
            parts.append(spp_trace(tables, camera, px, py, cfg, seed=seed))
            continue
        o, d = camera.rays_for_pixels(px, py)
        if tables is None:
            parts.append(integrate_chain(flat, o, d, cfg))
        else:
            parts.append(chain_trace_fused(tables, o, d, cfg))
    return torch.cat(parts).reshape(camera.height, camera.width, 3)
