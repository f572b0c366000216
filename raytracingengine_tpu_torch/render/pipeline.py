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
    wavefront trace kernel and the glass adjoint; past the glass adjoint's
    MAX_PRIMS primitives, with gradients, `WavefrontReplay`: the same
    forward kernel and autograd of integrate_wavefront's replay, as the
    JAX package's _wavefront_bwd). Else the all-pairs
    integrators that autograd differentiates: render.integrator.
    integrate_chain or integrate_wavefront, or render.soft_primary.
    integrate_chain_soft for `soft_primary` in chain mode (wavefront mode
    ignores `soft_primary`, as the JAX package does).

Above TRI_BLOCK triangles the kernels of either mode take culled tables
(`pack_forward_tables_perm`), the JAX package's rule. In chain mode the
loop packs them once per chunk, ordered front to back along the chunk's
centre rays' mean direction, and reuses them for every sample; the
in-kernel AA takes them in no particular order, as the JAX package's spp
kernel does. In wavefront mode they are packed once per frame in no
particular order, as the JAX package's glass kernels take them: a glass
tree sends rays every way. The triangle order and block boxes of an
unchanged mesh are kept from its last packing
(kernels/chain_trace.py::_culled_order). A glass training step forwards on them and
differentiates the linear tables they were packed from
(kernels/wavefront_grad.py::wavefront_trace_fused); past MAX_PRIMS
primitives `WavefrontReplay` forwards on them.

The chunks are joined with torch.cat, so gradients flow through the frame.
The device of the scene decides: CUDA tensors launch the CUDA kernels, CPU
tensors run their plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from raytracingengine_tpu_torch.core.camera import Camera
from raytracingengine_tpu_torch.geometry.intersect import FlatScene, flatten_scene
from raytracingengine_tpu_torch.kernels.chain_grad import MAX_PRIMS, chain_trace_fused
from raytracingengine_tpu_torch.kernels.chain_trace import (
    TRI_BLOCK,
    SceneTables,
    pack_forward_tables_perm,
    pack_scene_tables,
    pallas_applicable,
)
from raytracingengine_tpu_torch.kernels.spp_trace import pixel_jitter, spp_trace
from raytracingengine_tpu_torch.kernels.wavefront_grad import wavefront_trace_fused
from raytracingengine_tpu_torch.kernels.wavefront_trace import wavefront_spp_trace, wavefront_trace
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.integrator import integrate_chain, integrate_wavefront
from raytracingengine_tpu_torch.render.soft_primary import integrate_chain_soft
from raytracingengine_tpu_torch.scene import Scene, tensor_leaves
from raytracingengine_tpu_torch.utils.profiling import span, spanned

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
    """Do the mode's kernels take culled tables for this scene? Above
    TRI_BLOCK triangles, in either mode."""
    return uses_kernels(mode, cfg) and flat.n_triangles > TRI_BLOCK


def mean_direction(d: torch.Tensor) -> torch.Tensor:
    """The unit mean of the ray directions [R,3], a value only: the culled
    tables' front-to-back order, which changes no result."""
    dm = d.detach().mean(0)
    return dm * torch.rsqrt((dm * dm).sum().clamp_min(1e-20))


def _tables(flat: FlatScene, mode: str, cfg: RenderConfig, d=None) -> SceneTables | None:
    """The kernels' tables (culled above TRI_BLOCK triangles; in chain mode
    ordered along the mean of `d` when given), or None for the integrators."""
    if not uses_kernels(mode, cfg):
        return None
    if _culled(flat, mode, cfg):
        dmean = None if d is None or mode != "chain" else mean_direction(d)
        with span("rte.cull"):
            return pack_forward_tables_perm(flat, dmean)
    return pack_scene_tables(flat)


#: The warning of the glass backward past the adjoint kernel's scope (the
#: JAX package's, kernels/wavefront_trace.py::_wavefront_bwd).
REPLAY_WARNING = (
    "wavefront_trace backward runs autograd of the wavefront integrator (fixed-trip "
    "replay), not the fused kernel; expect a slower training step than the forward "
    "render suggests."
)


def _flat_leaves(flat: FlatScene) -> dict[str, torch.Tensor]:
    """The flat scene's float tensors, by field name."""
    return {f.name: v for f in dataclasses.fields(flat)
            if torch.is_tensor(v := getattr(flat, f.name)) and v.is_floating_point()}


class WavefrontReplay(torch.autograd.Function):
    """The glass trace past the glass adjoint's MAX_PRIMS primitives, with
    gradients: the route of the JAX package's _wavefront_bwd there. The
    forward is the `wavefront_trace` kernel on the frame's tables (culled
    above TRI_BLOCK triangles; its plain version on the CPU);
    the backward warns (REPLAY_WARNING) and takes autograd of
    integrate_wavefront with `differentiable=True` (its fixed-trip replay,
    `cfg.budget()` iterations) with respect to the rays and the flat
    scene's float tensors, at the forward's inputs. The replay holds its
    [rays, primitives] tensors for every iteration until its backward ends,
    so a training step sets `cfg.wavefront_budget` and a `chunk_size` that
    bound that peak."""

    @staticmethod
    @spanned("rte.autograd")
    def forward(ctx, flat, tables, cfg, o, d, *leaves):
        ctx.flat, ctx.cfg = flat, cfg
        ctx.save_for_backward(o, d, *leaves)
        values = dataclasses.replace(tables, **{n: getattr(tables, n).detach()
                                                for n in ("sph", "pl", "tri", "mat", "light")})
        return wavefront_trace(values, o.detach().contiguous(), d.detach().contiguous(), cfg)

    @staticmethod
    @spanned("rte.autograd")
    def backward(ctx, g):
        warnings.warn(REPLAY_WARNING, stacklevel=2)
        o, d, *leaves = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip((o, d, *leaves), need)]
            flat = dataclasses.replace(ctx.flat, **dict(zip(_flat_leaves(ctx.flat), inputs[2:])))
            img = integrate_wavefront(flat, inputs[0], inputs[1],
                                      dataclasses.replace(ctx.cfg, differentiable=True))
            wanted = [x for x, n in zip(inputs, need) if n]
            got = iter(torch.autograd.grad(img, wanted, g, allow_unused=True))
        return (None, None, None, *(next(got) if n else None for n in need))


def _trace(flat: FlatScene, tables: SceneTables | None, mode: str, o, d, cfg,
           width: int = 0, prim_group=None) -> torch.Tensor:
    """Camera or arbitrary rays [R,3] -> HDR [R,3] by the mode's route;
    `width` is the image width of the rays' rows, or 0 (chain_trace_fused);
    `prim_group` the integrators' prim axis (render/shading.py)."""
    if tables is None:
        if _soft_primary(mode, cfg):
            return integrate_chain_soft(flat, o, d, cfg)
        integrate = integrate_wavefront if mode == "wavefront" else integrate_chain
        return integrate(flat, o, d, cfg, prim_group)
    if mode == "wavefront":
        if tables.n_primitives > MAX_PRIMS and torch.is_grad_enabled() and any(
                t.requires_grad for t in (o, d, *tables.tensors())):
            leaves = _flat_leaves(flat)
            return WavefrontReplay.apply(flat, tables, cfg, o, d, *leaves.values())
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
    with span("rte.tables"):
        flat = flatten_scene(scene)
        tables = _tables(flat, mode, cfg, d)
    return _trace(flat, tables, mode, o, d, cfg)


#: The warning of a prim axis under use_pallas (the JAX package's,
#: render/pipeline.py::_render_chunk).
PRIM_AXIS_WARNING = (
    "use_pallas=True is ignored under a sharded primitive axis; rendering through the "
    "integrator. Shard rays only (no prims axis) to keep the fused kernels."
)


def render_pixels(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    start: int,
    stop: int,
    *,
    seed: int = 0,
    prim_group=None,
) -> torch.Tensor:
    """The pixels start .. stop - 1 of the frame, row-major -> HDR
    [stop - start, 3], in chunks of cfg.chunk_size from `start` (the JAX
    package's _render_chunk per chunk). A pixel's value does not depend on
    the range or the chunk it is traced in: its jitter is keyed by its
    row-major id, and the kernels and the integrators trace each ray on its
    own. `prim_group` (a torch.distributed group, parallel/) holds `scene`'s
    triangles as this rank's block of the scene's: the integrators combine
    the ranks' hits (under use_pallas it warns and takes them, since the
    kernels keep whole tables; soft_primary raises ValueError, its layers
    needing every primitive)."""
    mode = resolve_mode(scene, cfg)
    check_supported(mode, cfg, camera.spp, _requires_grad(scene, camera))
    device = scene.device
    if camera.device != device:
        raise ValueError(f"camera on {camera.device}, scene on {device}")
    if prim_group is not None:
        if _soft_primary(mode, cfg):
            raise ValueError("soft_primary under a prim axis: its layers need every primitive")
        if uses_kernels(mode, cfg):
            warnings.warn(PRIM_AXIS_WARNING, stacklevel=2)
            cfg = dataclasses.replace(cfg, use_pallas=False)
    aa = in_kernel_aa(mode, cfg, camera.spp)
    with span("rte.tables"):
        flat = flatten_scene(scene)
        # chain mode: ordered by each chunk's centre rays
        per_chunk = not aa and mode == "chain" and _culled(flat, mode, cfg)
        tables = None if per_chunk else _tables(flat, mode, cfg)
    aa_trace = wavefront_spp_trace if mode == "wavefront" else spp_trace
    chunk = max(1, min(cfg.chunk_size, stop - start))
    parts = []
    for lo in range(start, stop, chunk):
        hi = min(lo + chunk, stop)
        with span("rte.rays"):
            pid = torch.arange(lo, hi, dtype=torch.int32, device=device)
            px, py = pid % camera.width, pid // camera.width
            if not aa:
                o, d = camera.rays_for_pixels(px, py)  # sample 0: the centre ray
        if aa:
            parts.append(aa_trace(tables, camera, px, py, cfg, seed=seed))
            continue
        # A chunk of whole rows that starts at a row: the chain adjoint can
        # map its CTAs to pixel tiles (kernels/chain_trace.py::thread_rays).
        width = camera.width if lo % camera.width == 0 and (hi - lo) % camera.width == 0 else 0
        if per_chunk:
            with span("rte.tables"):
                chunk_tables = _tables(flat, mode, cfg, d)
        else:
            chunk_tables = tables
        acc = _trace(flat, chunk_tables, mode, o, d, cfg, width, prim_group)
        for sample in range(1, camera.spp):
            with span("rte.rays"):
                o, d = camera.rays_for_pixels(px, py, pixel_jitter(seed, pid, sample))
            radiance = _trace(flat, chunk_tables, mode, o, d, cfg, width, prim_group)
            with span("rte.autograd"):
                acc = acc + radiance
        with span("rte.autograd"):
            parts.append(acc / camera.spp)
    with span("rte.autograd"):
        return torch.cat(parts)


def render_hdr(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    *,
    seed: int | None = None,
    generator: torch.Generator | None = None,
    mesh=None,
) -> torch.Tensor:
    """Full-frame HDR render -> [H, W, 3] float32 on the scene's device.

    `seed` keys the AA jitter (spp > 1). Without a seed, it is drawn from
    `generator`; without either it is 0, so a render is reproducible.
    With `mesh` (parallel/mesh.py::make_mesh) every rank renders its share
    of the pixels and gathers the frame, differentiably
    (parallel/sharded.py::render_hdr_auto)."""
    if seed is None:
        seed = 0 if generator is None else int(
            torch.randint(0, 2**31 - 1, (), generator=generator, device=generator.device)
        )
    if mesh is not None:
        from raytracingengine_tpu_torch.parallel.sharded import render_hdr_auto

        return render_hdr_auto(scene, camera, cfg, mesh, seed=seed)
    img = render_pixels(scene, camera, cfg, 0, camera.num_pixels, seed=seed)
    return img.reshape(camera.height, camera.width, 3)
