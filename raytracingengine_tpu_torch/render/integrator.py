"""Whitted integrator: the recursion re-expressed as masked ray batches.

The reference TraceRay (Scene.h:131-198) adds at each hit the local direct
lighting weighted by (1 - transparency), then recurses into a refraction
ray weighted transparency * (1 - F) and a reflection ray weighted F
(transparent) or material.specular (opaque), with Schlick Fresnel F and
TIR forcing F = 1 (Scene.h:161-195). Misses and depth exhaustion return
the sky. Radiance is linear in the children, so the tree flattens into a
sum over nodes of (path weight x local term), run two ways:

  * `integrate_chain`: with no transparency every node has at most one
    child, so a loop over depth carries (ray, weight, live) per lane;
  * `integrate_wavefront`: the general case, a per-lane LIFO stack of
    (o, d, weight, depth) with cap = max_depth + 2 slots; each iteration
    pops one node per lane and pushes up to two children.

These are the JAX package's render/integrator.py, the all-pairs tensor
form: plain PyTorch that autograd differentiates. Each takes the JAX
package's `prim_axis` as `prim_group` (render/shading.py), which every
closest hit and shadow test of the render passes on. They are the route of
`render_hdr` with `use_pallas=False` and the references the hand-written
adjoints are held to (integrate_chain: kernels/chain_grad.py).
"""

from __future__ import annotations

import torch

from raytracingengine_tpu_torch.core import vecmath as vm
from raytracingengine_tpu_torch.geometry.intersect import FlatScene, Hit, closest_hit
from raytracingengine_tpu_torch.render.shading import direct_light, sky_color


def _shade_node(flat: FlatScene, o, d, active, cfg, prim_group=None) -> dict:
    """Intersect, classify, light and spawn the child rays of one node."""
    return _shade_from_hit(flat, closest_hit(flat, o, d, prim_group), d, active, cfg, prim_group)


def _shade_from_hit(flat: FlatScene, hit: Hit, d, active, cfg, prim_group=None) -> dict:
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

    local = direct_light(flat, hit, view, normal, shade, cfg, prim_group)
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


def integrate_chain(flat: FlatScene, o: torch.Tensor, d: torch.Tensor, cfg,
                    prim_group=None) -> torch.Tensor:
    """Opaque-scene integrator [R,3] x [R,3] -> HDR [R,3]. Requires all
    transparencies == 0: then the refraction branch never spawns and the
    weight update is weight *= specular."""
    r = o.shape[0]
    accum0 = torch.zeros((r, 3), dtype=o.dtype, device=o.device)
    w0 = torch.ones((r,), dtype=o.dtype, device=o.device)
    live0 = torch.ones((r,), dtype=torch.bool, device=o.device)
    return _chain_scan(flat, o, d, w0, live0, accum0, 0, cfg, prim_group)


def _chain_scan(flat, o, d, w, live, accum, start_depth, cfg, prim_group=None):
    """The reflection chain from depth start_depth; lanes still live at
    max_depth return the sky (Scene.h:132-134). The JAX scan runs every
    depth; a depth where no lane is live adds exact zeros, so the loop
    stops there."""
    for _ in range(start_depth, cfg.max_depth):
        if not bool(live.any()):
            return accum
        nd = _shade_node(flat, o, d, live, cfg, prim_group)
        accum = accum + torch.where(nd["miss"][:, None], w[:, None] * sky_color(d), 0.0)
        accum = accum + torch.where(nd["shade"][:, None], w[:, None] * nd["local_term"], 0.0)
        # Weight-pruned chains (RenderConfig.min_weight), as the kernels.
        cont = nd["has_refl"] & (w * nd["refl_w"] >= cfg.min_weight)
        o = torch.where(cont[:, None], nd["refl_o"], o)
        d = torch.where(cont[:, None], nd["refl_dir"], d)
        w = torch.where(cont, w * nd["refl_w"], w)
        live = cont
    return accum + torch.where(live[:, None], w[:, None] * sky_color(d), 0.0)


def integrate_wavefront(flat: FlatScene, o: torch.Tensor, d: torch.Tensor, cfg,
                        prim_group=None) -> torch.Tensor:
    """General integrator [R,3] x [R,3] -> HDR [R,3]: per-lane DFS over the
    binary recursion tree.

    The stack is [R, cap] tensors of origins, directions, weights and
    depths. A push writes slot clip(sp, 0, cap - 1) where its mask holds:
    the reflection child first, then the refraction child, so refraction
    pops first, as the reference visits it; each is pruned by min_weight.
    The loop stops when every stack is empty or after `cfg.budget()`
    iterations; with `cfg.differentiable` it runs all `cfg.budget()`
    iterations, which gives the same result (an empty lane adds zeros)."""
    r = o.shape[0]
    cap = cfg.max_depth + 2  # the DFS bound: net +1 per level
    lanes = torch.arange(r, device=o.device)
    slots = torch.arange(cap, device=o.device)
    stack_o = torch.cat([o[:, None], o.new_zeros((r, cap - 1, 3))], dim=1)
    unused_d = o.new_tensor([0.0, 0.0, 1.0]).expand(r, cap - 1, 3)  # benign unit dir
    stack_d = torch.cat([d[:, None], unused_d], dim=1)
    stack_w = torch.cat([o.new_ones((r, 1)), o.new_zeros((r, cap - 1))], dim=1)
    stack_depth = torch.zeros((r, cap), dtype=torch.long, device=o.device)
    sp = torch.ones(r, dtype=torch.long, device=o.device)
    accum = o.new_zeros((r, 3))

    def push(stacks, sp, mask, o_new, d_new, w_new, depth_new):
        at = mask[:, None] & (slots[None, :] == sp.clamp(0, cap - 1)[:, None])  # [R, cap]
        s_o, s_d, s_w, s_dep = stacks
        stacks = (
            torch.where(at[..., None], o_new[:, None], s_o),
            torch.where(at[..., None], d_new[:, None], s_d),
            torch.where(at, w_new[:, None], s_w),
            torch.where(at, depth_new[:, None], s_dep),
        )
        return stacks, sp + mask.long()

    stacks = (stack_o, stack_d, stack_w, stack_depth)
    for _ in range(cfg.budget()):
        live = sp > 0
        if not cfg.differentiable and not bool(live.any()):
            break
        s_o, s_d, s_w, s_dep = stacks
        top = (sp - 1).clamp(0, cap - 1)
        o_c, d_c, w, depth = s_o[lanes, top], s_d[lanes, top], s_w[lanes, top], s_dep[lanes, top]
        sp = sp - live.long()

        at_max = depth >= cfg.max_depth
        if_max_sky = live & at_max
        nd = _shade_node(flat, o_c, d_c, live & ~at_max, cfg, prim_group)
        sky_lanes = if_max_sky | nd["miss"]
        accum = accum + torch.where(sky_lanes[:, None], w[:, None] * sky_color(d_c), 0.0)
        accum = accum + torch.where(nd["shade"][:, None], w[:, None] * nd["local_term"], 0.0)

        refl_w, refr_w = w * nd["refl_w"], w * nd["refr_w"]
        stacks, sp = push(
            stacks, sp, nd["has_refl"] & (refl_w >= cfg.min_weight),
            nd["refl_o"], nd["refl_dir"], refl_w, depth + 1,
        )
        stacks, sp = push(
            stacks, sp, nd["has_refr"] & (refr_w >= cfg.min_weight),
            nd["refr_o"], nd["refr_dir"], refr_w, depth + 1,
        )
    return accum
