"""Shading: sky, shadow transmittance, direct lighting.

The same formulas as the JAX package's render/shading.py, on tensors:

  * `sky_color` — vertical sky gradient (Scene.h:30-33),
  * `transmittance_hard` — the reference's multiplicative-transparency
    shadow march (Scene.h:35-77, `shadow_mode="march"`), a masked loop in
    which every lane steps in lockstep until all are done,
  * `transmittance_binary` — hard visibility in one any-hit pass, equal to
    the march on opaque scenes,
  * `visibility_soft` — sigmoid visibility over sphere clearance
    (`shadow_mode="soft"`), smooth in the sphere parameters,
  * `direct_light` — per-light diffuse + Blinn-Phong specular with 1/d^2
    falloff (Scene.h:79-129).

Every guard that keeps the JAX backward pass NaN-free is kept: square
roots and reciprocals are taken on masked-safe operands, so a masked lane
never feeds inf into a zero cotangent.

`prim_group` (a torch.distributed group, or None) is the prim axis
(geometry/intersect.py::closest_hit): the march takes the combined closest
hit, and binary and soft occlusion combine by a max over the group.
"""

from __future__ import annotations

import torch

from raytracingengine_tpu_torch.core import vecmath as vm
from raytracingengine_tpu_torch.geometry.intersect import (
    FlatScene,
    Hit,
    all_distances,
    any_over,
    closest_hit,
    intersect_planes,
    intersect_triangles,
)


def sky_color(d: torch.Tensor) -> torch.Tensor:
    """lerp(white, (0.5, 0.7, 1.0), 0.5 * (dir.y + 1)) — Scene.h:30-33."""
    dn = vm.normalize(d)
    t = 0.5 * (dn[..., 1] + 1.0)
    white = torch.ones(3, dtype=d.dtype, device=d.device)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
    return white * (1.0 - t)[..., None] + blue * t[..., None]


def transmittance_hard(
    flat: FlatScene,
    origin: torch.Tensor,  # [B,3]
    direction: torch.Tensor,  # [B,3]
    max_dist: torch.Tensor,  # [B]
    active: torch.Tensor,  # [B] bool, lanes to march
    cfg,
    prim_group=None,
) -> torch.Tensor:
    """computeTransmittance (Scene.h:35-77) for a lane batch -> T [B].

    Per step: closest hit from the current origin; no hit ends the march;
    t <= 0 micro-steps by bias; 0 < t <= bias steps past the surface
    without attenuating; a hit at or beyond max_dist ends it; otherwise
    T *= clip(transparency, 0, 1) and the march steps past the hit. A lane
    stops when T <= shadow_min_t, traveled >= max_dist, or after
    shadow_max_steps steps. The while form stops once no lane is live;
    `cfg.differentiable` runs all shadow_max_steps steps, which gives the
    same T (a dead lane's state is held)."""
    bias = cfg.bias
    o = origin
    traveled = torch.zeros_like(max_dist)
    T = torch.ones_like(max_dist)
    live = active & (max_dist > 0.0)
    for _ in range(cfg.shadow_max_steps):
        if not cfg.differentiable and not bool(live.any()):
            break
        hit = closest_hit(flat, o, direction, prim_group)
        valid = hit.valid
        t = torch.where(valid, hit.t, 0.0)  # keeps the arithmetic NaN-free
        c_zero = valid & (t <= 0.0)
        c_near = valid & (t > 0.0) & (t <= bias)
        c_beyond = valid & (t > bias) & (traveled + t >= max_dist)
        c_pass = valid & (t > bias) & (traveled + t < max_dist)

        step = torch.where(c_zero, bias, torch.where(c_near | c_pass, t + bias, 0.0))
        new_T = torch.where(c_pass, T * vm.clip(hit.transparency, 0.0, 1.0), T)
        o = torch.where(live[:, None], o + direction * step[:, None], o)
        traveled = torch.where(live, traveled + step, traveled)
        T = torch.where(live, new_T, T)
        live = live & valid & ~c_beyond & (T > cfg.shadow_min_t) & (traveled < max_dist)
    return vm.clip(T, 0.0, 1.0)


def transmittance_binary(
    flat: FlatScene,
    origin: torch.Tensor,  # [B,3]
    direction: torch.Tensor,  # [B,3]
    max_dist: torch.Tensor,  # [B]
    cfg,
    prim_group=None,
) -> torch.Tensor:
    """Hard binary visibility -> T in {0, 1} [B]: 0 iff any surface lies at
    bias < t < max_dist. Its gradient is the a.e.-zero one of a hard shadow."""
    t_all = all_distances(flat, origin, direction)
    occluded = ((t_all > cfg.bias) & (t_all < max_dist[None, :])).any(dim=0)
    if prim_group is not None:
        occluded = any_over(occluded, prim_group)
    return torch.where(occluded, 0.0, 1.0).to(max_dist.dtype)


def visibility_soft(
    flat: FlatScene,
    origin: torch.Tensor,  # [B,3]
    direction: torch.Tensor,  # [B,3] unit
    max_dist: torch.Tensor,  # [B]
    cfg,
    prim_group=None,
) -> torch.Tensor:
    """Differentiable visibility in [0,1] -> [B].

    Each sphere gives tr + (1 - tr) * sigmoid(delta / soft_sigma), where
    delta is the signed clearance of the shadow segment past the sphere
    (distance of its closest approach on [0, max_dist] to the centre, minus
    the radius) and tr its clipped transparency: sigma -> 0 recovers the
    hard shadow. Planes and triangles give the hard crossing at 0 < t <
    max_dist, with no gradient (their silhouettes are not the inverse
    rendering's target)."""
    v = torch.ones_like(max_dist)
    if flat.n_spheres > 0:
        oc = flat.sph_centers[None, :, :] - origin[:, None, :]  # [B,S,3]
        t_along = (oc * direction[:, None, :]).sum(-1)
        # jnp.clip's form (and subgradient) with a per-ray upper bound
        t_close = torch.minimum(torch.maximum(t_along, torch.zeros_like(t_along)), max_dist[:, None])
        closest = origin[:, None, :] + direction[:, None, :] * t_close[..., None]
        delta = torch.linalg.vector_norm(closest - flat.sph_centers[None, :, :], dim=-1) \
            - flat.sph_radii[None, :]
        soft = torch.sigmoid(delta / cfg.soft_sigma)
        tr = vm.clip(flat.transparency[: flat.n_spheres], 0.0, 1.0)[None, :]
        factor = tr + (1.0 - tr) * soft
        factor = torch.where(flat.sph_active[None, :], factor, torch.ones_like(factor))
        v = v * torch.prod(factor, dim=1)
    if flat.n_planes + flat.n_triangles > 0:
        with torch.no_grad():
            t_all = torch.cat([intersect_planes(flat, origin, direction),
                               intersect_triangles(flat, origin, direction)], dim=0)  # [P+T, B]
            blocked = ((t_all > 0.0) & (t_all < max_dist[None, :])).any(dim=0)
            if prim_group is not None:
                blocked = any_over(blocked, prim_group)
        v = v * torch.where(blocked, 0.0, 1.0).to(v.dtype)
    return v


def direct_light(
    flat: FlatScene,
    hit: Hit,
    view_dir: torch.Tensor,  # [R,3] (-incoming)
    normal: torch.Tensor,  # [R,3] front-face-flipped unit normal
    active: torch.Tensor,  # [R] bool, lanes being shaded
    cfg,
    prim_group=None,
) -> torch.Tensor:
    """directLightning (Scene.h:79-129) -> [R,3].

    Per light: skip if dist <= 0, N.L <= 0 or dist <= bias; shadow ray from
    point + normal * bias to dist - bias; skip if T <= bias; diffuse +=
    emitted / d^2 * N.L * T; Blinn-Phong specular (opaque materials with
    specular > 0) shares the falloff and T. Result = albedo * sum(diffuse)
    + sum(spec) * specular."""
    bias = cfg.bias
    r = hit.point.shape[0]
    zeros3 = torch.zeros((r, 3), dtype=hit.point.dtype, device=hit.point.device)
    if flat.n_lights == 0:
        return zeros3
    shadow_o = hit.point + normal * bias
    spec_enabled = (hit.transparency <= 0.0) & (hit.specular > 0.0)
    diffuse, spec = zeros3, zeros3
    zero = torch.zeros_like(hit.t)
    one = torch.ones_like(hit.t)

    for li in range(flat.n_lights):
        vec = flat.light_positions[li][None, :] - hit.point
        # sqrt of the squared distance with the zero case masked: the norm's
        # VJP v/|v| is NaN at v = 0 even under a zero cotangent.
        dist2 = vm.dot(vec, vec)
        dist_pos = dist2 > 0.0
        dist = torch.sqrt(torch.where(dist_pos, dist2, one))
        dist = torch.where(dist_pos, dist, zero)
        dist_safe = torch.where(dist > 0.0, dist, one)
        ldir = vec / dist_safe[:, None]
        ndotl = torch.maximum(zero, vm.dot(normal, ldir))
        ok0 = (
            active & flat.light_active[li] & (dist > 0.0) & (ndotl > 0.0) & (dist > bias)
        )
        if cfg.shadow_mode == "soft":
            T = visibility_soft(flat, shadow_o, ldir, dist - bias, cfg, prim_group)
        elif cfg.shadow_mode == "binary":
            T = transmittance_binary(flat, shadow_o, ldir, dist - bias, cfg, prim_group)
        else:
            T = transmittance_hard(flat, shadow_o, ldir, dist - bias, ok0, cfg, prim_group)
        ok = ok0 & (T > bias)

        emitted = flat.light_colors[li] * flat.light_intensities[li]  # [3]
        inv_d2 = 1.0 / (dist_safe * dist_safe)
        contrib = (inv_d2 * ndotl * T)[:, None] * emitted[None, :]
        diffuse = diffuse + torch.where(ok[:, None], contrib, 0.0)

        half = vm.normalize(ldir + view_dir)
        ndoth = torch.maximum(zero, vm.dot(normal, half))
        spec_ok = ok & (ndoth > 0.0) & spec_enabled
        ndoth_safe = torch.where(spec_ok, ndoth, one)  # pow's gradient stays finite
        spec_factor = ndoth_safe**hit.shininess
        spec_term = (inv_d2 * spec_factor * T)[:, None] * emitted[None, :]
        spec = spec + torch.where(spec_ok[:, None], spec_term, 0.0)

    return hit.albedo * diffuse + spec * hit.specular[:, None]
