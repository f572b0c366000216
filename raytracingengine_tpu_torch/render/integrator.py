"""Whitted integrator for opaque scenes: the recursion as a reflection chain.

The reference TraceRay (Scene.h:131-198) adds at each hit the local direct
lighting weighted by (1 - transparency) and recurses into a reflection ray
weighted by material.specular (opaque) or the Schlick Fresnel term
(transparent). Misses and depth exhaustion return the sky. With no
transparency every node has at most one child, so the recursion is a chain
and a loop over depth carries (ray, weight, live) per lane.

This is the JAX package's render/integrator.py::integrate_chain, the
all-pairs tensor form: plain PyTorch that autograd differentiates. It is
the reference the hand-written adjoint (kernels/chain_grad.py) is held to,
and the route of `render_hdr` with `use_pallas=False`. The branching
wavefront integrator is not ported yet.
"""

from __future__ import annotations

import torch

from raytracingengine_tpu_torch.core import vecmath as vm
from raytracingengine_tpu_torch.geometry.intersect import FlatScene, Hit, closest_hit
from raytracingengine_tpu_torch.render.shading import direct_light, sky_color


def _shade_node(flat: FlatScene, o, d, active, cfg) -> dict:
    """Intersect, classify, light and spawn the child rays of one node."""
    return _shade_from_hit(flat, closest_hit(flat, o, d), d, active, cfg)


def _shade_from_hit(flat: FlatScene, hit: Hit, d, active, cfg) -> dict:
    """Shading and child rays for a computed hit record -> dict of [R] /
    [R,3] tensors (the refraction child included, for the glass path)."""
    zero = torch.zeros_like(hit.t)
    miss = active & ~hit.valid
    shade = active & hit.valid

    incoming = d  # unit: camera rays and normalized children
    front = vm.dot(hit.normal, incoming) < 0.0
    normal = torch.where(front[:, None], hit.normal, -hit.normal)
    view = -incoming
    cos_theta = torch.maximum(zero, vm.dot(normal, view))

    eta_t = hit.refractive_index
    f0 = ((eta_t - 1.0) / (eta_t + 1.0)) ** 2
    fresnel = f0 + (1.0 - f0) * (1.0 - cos_theta) ** 5
    tau = vm.clip(hit.transparency, 0.0, 1.0)

    local = direct_light(flat, hit, view, normal, shade, cfg)
    local_term = local * (1.0 - tau)[:, None]  # Scene.h:171-173

    # Refraction child (Scene.h:175-187)
    eta = torch.where(front, 1.0 / eta_t, eta_t)
    refr_raw = vm.refract(incoming, normal, eta)
    refr_len = vm.length(refr_raw)
    wants_refr = shade & (tau > 0.0)
    has_refr = wants_refr & (refr_len > cfg.bias)
    tir = wants_refr & (refr_len <= cfg.bias)
    fresnel_eff = torch.where(tir, torch.ones_like(fresnel), fresnel)  # TIR: F = 1
    refr_dir = vm.normalize(refr_raw)
    refr_o = hit.point + refr_dir * (cfg.bias * 1e2)
    refr_w = tau * (1.0 - fresnel)  # pre-TIR F (Scene.h:182)

    # Reflection child (Scene.h:189-195)
    reflectiveness = torch.where(tau > 0.0, fresnel_eff, hit.specular)
    has_refl = shade & (reflectiveness > cfg.bias)
    refl_dir = vm.normalize(vm.reflect(incoming, normal))
    refl_o = hit.point + refl_dir * cfg.bias

    return dict(
        hit=hit, miss=miss, shade=shade, local_term=local_term,
        has_refr=has_refr, refr_o=refr_o, refr_dir=refr_dir, refr_w=refr_w,
        has_refl=has_refl, refl_o=refl_o, refl_dir=refl_dir, refl_w=reflectiveness,
    )


def integrate_chain(flat: FlatScene, o: torch.Tensor, d: torch.Tensor, cfg) -> torch.Tensor:
    """Opaque-scene integrator [R,3] x [R,3] -> HDR [R,3]. Requires all
    transparencies == 0: then the refraction branch never spawns and the
    weight update is weight *= specular."""
    r = o.shape[0]
    accum0 = torch.zeros((r, 3), dtype=o.dtype, device=o.device)
    w0 = torch.ones((r,), dtype=o.dtype, device=o.device)
    live0 = torch.ones((r,), dtype=torch.bool, device=o.device)
    return _chain_scan(flat, o, d, w0, live0, accum0, 0, cfg)


def _chain_scan(flat, o, d, w, live, accum, start_depth, cfg):
    """The reflection chain from depth start_depth; lanes still live at
    max_depth return the sky (Scene.h:132-134). The JAX scan runs every
    depth; a depth where no lane is live adds exact zeros, so the loop
    stops there."""
    for _ in range(start_depth, cfg.max_depth):
        if not bool(live.any()):
            return accum
        nd = _shade_node(flat, o, d, live, cfg)
        accum = accum + torch.where(nd["miss"][:, None], w[:, None] * sky_color(d), 0.0)
        accum = accum + torch.where(nd["shade"][:, None], w[:, None] * nd["local_term"], 0.0)
        # Weight-pruned chains (RenderConfig.min_weight), as the kernels.
        cont = nd["has_refl"] & (w * nd["refl_w"] >= cfg.min_weight)
        o = torch.where(cont[:, None], nd["refl_o"], o)
        d = torch.where(cont[:, None], nd["refl_dir"], d)
        w = torch.where(cont, w * nd["refl_w"], w)
        live = cont
    return accum + torch.where(live[:, None], w[:, None] * sky_color(d), 0.0)
