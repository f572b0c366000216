"""Render pipeline: camera -> chunked pixel blocks -> trace -> HDR image.

The reference's RenderImage is one parallel loop over the flat pixel
index with an AA loop per pixel (Scene.h:283-328). Here pixels are traced
in chunks of `cfg.chunk_size`. The mode is "chain" for opaque scenes and
"wavefront" when a material transmits (or as `cfg.mode` forces). Where a
kernel covers the mode and shadows (`kernels.chain_trace.
pallas_applicable`) and `use_pallas=True`, the routes are, as the JAX
package's `_render_chunk`:

  * chain, spp == 1: camera rays (Camera.rays_for_pixels) ->
    kernels.chain_grad.chain_trace_fused: the chain trace kernel forward
    and, when a scene or camera tensor requires grad, an adjoint kernel
    backward (`chain_grad`, or `chain_grad_dense` for dense scenes);
  * chain, spp > 1: pixel coordinates -> kernels.spp_trace, the whole AA
    loop per pixel;

above TRI_BLOCK triangles the chain kernels take culled tables
(`pack_forward_tables_perm`), ordered front to back along the chunk's mean
ray direction at spp == 1 (in no particular order at spp > 1, as the JAX
package's spp kernel);
  * wavefront, spp == 1: camera rays -> kernels.wavefront_grad.
    wavefront_trace_fused: the wavefront trace kernel forward and, when a
    scene or camera tensor requires grad, the glass adjoint kernel
    backward;
  * wavefront, spp > 1: pixel coordinates -> wavefront_spp_trace.

Otherwise (`use_pallas=False`, chain mode with march shadows, or a glass
tree deeper than the wavefront kernels' stack) camera rays go to
render.integrator.integrate_chain or integrate_wavefront, the all-pairs
integrators that autograd differentiates: no kernel covers that case in
either package. The AA loops key their jitter by (seed, pixel id,
sample), so a render does not depend on how the frame is chunked; they are
forward-only, so spp > 1 with gradients raises.

The chunks are joined with torch.cat, so gradients flow through the frame.
The device of the scene decides: CUDA tensors launch the CUDA kernels, CPU
tensors run their plain PyTorch versions. Paths of the JAX pipeline that
have no port yet raise NotImplementedError naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

import torch

from raytracingengine_tpu_torch.core.camera import Camera
from raytracingengine_tpu_torch.geometry.intersect import FlatScene, flatten_scene
from raytracingengine_tpu_torch.kernels.chain_grad import chain_trace_fused
from raytracingengine_tpu_torch.kernels.chain_trace import (
    TRI_BLOCK,
    SceneTables,
    pack_forward_tables_perm,
    pack_scene_tables,
    pallas_applicable,
)
from raytracingengine_tpu_torch.kernels.spp_trace import spp_trace
from raytracingengine_tpu_torch.kernels.wavefront_grad import wavefront_trace_fused
from raytracingengine_tpu_torch.kernels.wavefront_trace import wavefront_spp_trace
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.integrator import integrate_chain, integrate_wavefront
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


def uses_kernels(mode: str, cfg: RenderConfig) -> bool:
    return cfg.use_pallas and pallas_applicable(cfg, mode)


def check_supported(mode: str, cfg: RenderConfig, spp: int = 1, grad: bool = False) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if mode not in ("chain", "wavefront"):
        raise ValueError(f"mode {mode!r}: expected 'auto', 'chain' or 'wavefront'")
    kernels = uses_kernels(mode, cfg)
    todo = None
    if cfg.shadow_mode not in ("binary", "march"):
        todo = f"shadow_mode={cfg.shadow_mode!r}: soft visibility (ROADMAP queue 1 item 3)"
    elif cfg.soft_primary:
        todo = "soft_primary: render/soft_primary.py (ROADMAP queue 1 item 11)"
    elif spp > 1 and (grad or cfg.differentiable or not kernels):
        todo = ("spp > 1 with gradients, differentiable=True or no kernel for the mode "
                "and shadows: the per-sample differentiable loop (ROADMAP queue 1 item 13)")
    if todo is not None:
        raise NotImplementedError(f"not ported yet: {todo}")


def _culled(flat: FlatScene, mode: str, cfg: RenderConfig) -> bool:
    """Do the mode's kernels take culled tables for this scene?"""
    return uses_kernels(mode, cfg) and mode == "chain" and flat.n_triangles > TRI_BLOCK


def mean_direction(d: torch.Tensor) -> torch.Tensor:
    """The unit mean of the ray directions [R,3], a value only: the culled
    tables' front-to-back order, which changes no result."""
    dm = d.detach().mean(0)
    return dm * torch.rsqrt((dm * dm).sum().clamp_min(1e-20))


def _tables(flat: FlatScene, mode: str, cfg: RenderConfig, d=None) -> SceneTables | None:
    """The kernels' tables (culled above TRI_BLOCK triangles in chain mode,
    ordered along the mean of `d` when given), or None for the integrators."""
    if not uses_kernels(mode, cfg):
        return None
    if _culled(flat, mode, cfg):
        # A profiler span: the packing's host cost per frame or step.
        with torch.profiler.record_function("pack_forward_tables_perm"):
            return pack_forward_tables_perm(flat, None if d is None else mean_direction(d))
    return pack_scene_tables(flat)


def _trace(flat: FlatScene, tables: SceneTables | None, mode: str, o, d, cfg,
           width: int = 0) -> torch.Tensor:
    """Camera or arbitrary rays [R,3] -> HDR [R,3] by the mode's route;
    `width` is the image width of the rays' rows, or 0 (chain_trace_fused)."""
    if tables is None:
        integrate = integrate_wavefront if mode == "wavefront" else integrate_chain
        return integrate(flat, o, d, cfg)
    if mode == "wavefront":
        return wavefront_trace_fused(tables, o, d, cfg)
    return chain_trace_fused(tables, o, d, cfg, width)


def render_rays(
    scene: Scene,
    o: torch.Tensor,
    d: torch.Tensor,
    cfg: RenderConfig,
) -> torch.Tensor:
    """Trace an arbitrary ray block [R,3] x [R,3] -> HDR [R,3]."""
    mode = resolve_mode(scene, cfg)
    grad = _requires_grad(scene) or (torch.is_grad_enabled() and (o.requires_grad or d.requires_grad))
    check_supported(mode, cfg, 1, grad)
    flat = flatten_scene(scene)
    return _trace(flat, _tables(flat, mode, cfg, d), mode, o, d, cfg)


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
    mode = resolve_mode(scene, cfg)
    check_supported(mode, cfg, camera.spp, _requires_grad(scene, camera))
    device = scene.device
    if camera.device != device:
        raise ValueError(f"camera on {camera.device}, scene on {device}")
    if seed is None:
        seed = 0 if generator is None else int(
            torch.randint(0, 2**31 - 1, (), generator=generator, device=generator.device)
        )
    flat = flatten_scene(scene)
    per_chunk = camera.spp == 1 and _culled(flat, mode, cfg)  # ordered by each chunk's rays
    tables = None if per_chunk else _tables(flat, mode, cfg)
    aa = wavefront_spp_trace if mode == "wavefront" else spp_trace
    r = camera.num_pixels
    chunk = max(1, min(cfg.chunk_size, r))
    # Chunks of whole rows start at a row: the chain adjoint can then map its
    # CTAs to pixel tiles (kernels/chain_trace.py::thread_rays).
    width = camera.width if chunk % camera.width == 0 else 0
    parts = []
    for start in range(0, r, chunk):
        pid = torch.arange(start, min(start + chunk, r), dtype=torch.int32, device=device)
        px, py = pid % camera.width, pid // camera.width
        if camera.spp > 1:
            parts.append(aa(tables, camera, px, py, cfg, seed=seed))
            continue
        o, d = camera.rays_for_pixels(px, py)
        chunk_tables = _tables(flat, mode, cfg, d) if per_chunk else tables
        parts.append(_trace(flat, chunk_tables, mode, o, d, cfg, width))
    return torch.cat(parts).reshape(camera.height, camera.width, 3)
