"""Render pipeline: camera -> chunked pixel blocks -> trace -> HDR image.

The reference's RenderImage is one parallel loop over the flat pixel
index with an AA loop per pixel (Scene.h:283-328). Here pixels are traced
in chunks of `cfg.chunk_size`. The mode is "chain" for opaque scenes and
"wavefront" when a material transmits (or as `cfg.mode` forces). Each
chunk runs the JAX package's `_render_chunk`:

  * spp > 1 through the kernels (`uses_kernels`) without
    `cfg.differentiable`: pixel coordinates -> the in-kernel AA,
    kernels.spp_trace (chain) or wavefront_spp_trace, the whole sample loop
    per pixel. It is forward-only: with gradients this route raises
    ValueError and asks for `differentiable=True`;
  * otherwise the per-sample loop: sample 0 is the centre ray
    (Camera.rays_for_pixels), sample s >= 1 the ray jittered by
    `pixel_jitter(seed, pixel ids, s)`, the in-kernel AA's Philox stream,
    keyed by the row-major pixel id, so a pixel draws the same jitter
    whatever the chunking. Each sample goes through `_trace` and the chunk
    is their mean. `_trace` is, where `uses_kernels` holds, the kernels'
    autograd Functions: kernels.chain_grad.chain_trace_fused (the chain
    trace kernel forward and, when a scene or camera tensor requires grad,
    an adjoint kernel backward: `chain_grad`, or `chain_grad_dense` for
    culled tables) or kernels.wavefront_grad.wavefront_trace_fused (the
    wavefront trace kernel and the glass adjoint). Else the all-pairs
    integrators that autograd differentiates: render.integrator.
    integrate_chain or integrate_wavefront, or render.soft_primary.
    integrate_chain_soft for `soft_primary` in chain mode (wavefront mode
    ignores `soft_primary`, as the JAX package does).

Above TRI_BLOCK triangles the chain kernels take culled tables
(`pack_forward_tables_perm`): in the loop they are packed once per chunk,
ordered front to back along the chunk's centre rays' mean direction, and
reused by every sample; the in-kernel AA takes them in no particular order,
as the JAX package's spp kernel does.

The chunks are joined with torch.cat, so gradients flow through the frame.
The device of the scene decides: CUDA tensors launch the CUDA kernels, CPU
tensors run their plain PyTorch versions.
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
from raytracingengine_tpu_torch.kernels.spp_trace import pixel_jitter, spp_trace
from raytracingengine_tpu_torch.kernels.wavefront_grad import wavefront_trace_fused
from raytracingengine_tpu_torch.kernels.wavefront_trace import wavefront_spp_trace
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.integrator import integrate_chain, integrate_wavefront
from raytracingengine_tpu_torch.render.soft_primary import integrate_chain_soft
from raytracingengine_tpu_torch.scene import Scene, tensor_leaves

SHADOW_MODES = ("march", "binary", "soft")


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


def _soft_primary(mode: str, cfg: RenderConfig) -> bool:
    return cfg.soft_primary and mode == "chain"


def uses_kernels(mode: str, cfg: RenderConfig) -> bool:
    """Do the trace kernels take the mode's rays? `soft_primary` in chain
    mode takes the integrator whatever `use_pallas` says."""
    return cfg.use_pallas and pallas_applicable(cfg, mode) and not _soft_primary(mode, cfg)


def in_kernel_aa(mode: str, cfg: RenderConfig, spp: int) -> bool:
    """Does a frame at `spp` take the in-kernel AA (spp_trace,
    wavefront_spp_trace) rather than the per-sample loop?"""
    return spp > 1 and uses_kernels(mode, cfg) and not cfg.differentiable


def check_supported(mode: str, cfg: RenderConfig, spp: int = 1, grad: bool = False) -> None:
    """Raise ValueError for a configuration no route runs."""
    if mode not in ("chain", "wavefront"):
        raise ValueError(f"mode {mode!r}: expected 'auto', 'chain' or 'wavefront'")
    if cfg.shadow_mode not in SHADOW_MODES:
        raise ValueError(f"shadow_mode {cfg.shadow_mode!r}: expected one of {SHADOW_MODES}")
    if grad and in_kernel_aa(mode, cfg, spp):
        raise ValueError(
            "spp > 1 with gradients through the kernels needs differentiable=True: the "
            "in-kernel AA (spp_trace, wavefront_spp_trace) draws its jitter inside the kernel "
            "and has no backward; differentiable=True traces each sample through the fused "
            "forward and adjoint kernels"
        )


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
        if _soft_primary(mode, cfg):
            return integrate_chain_soft(flat, o, d, cfg)
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
    check_supported(mode, cfg)
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
    aa = in_kernel_aa(mode, cfg, camera.spp)
    per_chunk = not aa and _culled(flat, mode, cfg)  # ordered by each chunk's centre rays
    tables = None if per_chunk else _tables(flat, mode, cfg)
    aa_trace = wavefront_spp_trace if mode == "wavefront" else spp_trace
    r = camera.num_pixels
    chunk = max(1, min(cfg.chunk_size, r))
    # Chunks of whole rows start at a row: the chain adjoint can then map its
    # CTAs to pixel tiles (kernels/chain_trace.py::thread_rays).
    width = camera.width if chunk % camera.width == 0 else 0
    parts = []
    for start in range(0, r, chunk):
        pid = torch.arange(start, min(start + chunk, r), dtype=torch.int32, device=device)
        px, py = pid % camera.width, pid // camera.width
        if aa:
            parts.append(aa_trace(tables, camera, px, py, cfg, seed=seed))
            continue
        o, d = camera.rays_for_pixels(px, py)  # sample 0: the centre ray
        chunk_tables = _tables(flat, mode, cfg, d) if per_chunk else tables
        acc = _trace(flat, chunk_tables, mode, o, d, cfg, width)
        for sample in range(1, camera.spp):
            o, d = camera.rays_for_pixels(px, py, pixel_jitter(seed, pid, sample))
            acc = acc + _trace(flat, chunk_tables, mode, o, d, cfg, width)
        parts.append(acc / camera.spp)
    return torch.cat(parts).reshape(camera.height, camera.width, 3)
