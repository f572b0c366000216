"""Soft primary visibility: differentiable sphere silhouettes.

Hard closest-hit gives pixel colors that are piecewise-constant in the
geometry across silhouette edges, so the silhouette term of an image loss
has no gradient with respect to sphere centres and radii. This module
relaxes the primary bounce into two layers, as the JAX package's
render/soft_primary.py does:

  * per sphere, the ray's signed silhouette clearance
        delta_i = |closest_approach - c_i| - r_i
    is smooth in (c_i, r_i); the nearest-silhouette sphere j is the FRONT
    layer, with coverage sigmoid(-delta_j / soft_sigma);
  * the BACK layer is the closest hit with sphere j's distance row masked
    out (geometry/intersect.hit_from_distances), the sky on a total miss;
  * the coverage is 0 where the back layer's surface is nearer than the
    sphere layer (a sphere behind a wall casts no silhouette);
  * pixel = cov * shade(front) + (1 - cov) * shade(back), and the
    reflection chain continues from both layers with weights cov and
    1 - cov.

soft_sigma -> 0 recovers the hard renderer. Secondary bounces stay hard,
and plane and triangle silhouettes too. No kernel runs this: the pipeline
routes `soft_primary` in chain mode here whatever `use_pallas` says.
"""

from __future__ import annotations

import torch

from raytracingengine_tpu_torch.core import vecmath as vm
from raytracingengine_tpu_torch.geometry.intersect import (
    FAMILY_SPHERE,
    FlatScene,
    Hit,
    all_distances,
    hit_from_distances,
)
from raytracingengine_tpu_torch.render.integrator import _chain_scan, _shade_from_hit
from raytracingengine_tpu_torch.render.shading import sky_color


def soft_primary_layers(flat: FlatScene, o: torch.Tensor, d: torch.Tensor, cfg) -> tuple[Hit, Hit, torch.Tensor]:
    """-> (front hit, background hit, coverage [R]).

    Front: the nearest-silhouette sphere j, its hard hit where the ray
    meets it, else a pseudo-hit at the sphere point nearest the ray (its
    true normal and material), so the blend means something just outside
    the edge too. Background: the closest hit with sphere j left out.
    Coverage: the sigmoid silhouette, 0 where the background is in front
    of the sphere layer."""
    r = o.shape[0]
    t_all = all_distances(flat, o, d)  # [N,R]
    hit = hit_from_distances(flat, o, d, t_all)
    if flat.n_spheres == 0:
        return hit, hit, hit.valid.to(o.dtype)

    # Signed clearance per sphere: [S, R].
    oc = flat.sph_centers[:, None, :] - o[None, :, :]  # [S,R,3]
    t_along = (oc * d[None, :, :]).sum(-1)
    t_c = torch.maximum(t_along, torch.zeros_like(t_along))  # [S,R]
    closest = o[None, :, :] + d[None, :, :] * t_c[..., None]  # [S,R,3]
    cc = closest - flat.sph_centers[:, None, :]
    cc2 = (cc * cc).sum(-1)
    dist_c = torch.sqrt(torch.maximum(cc2, torch.full_like(cc2, 1e-20)))
    delta = dist_c - flat.sph_radii[:, None]
    delta = torch.where(flat.sph_active[:, None], delta, torch.full_like(delta, torch.inf))

    j = torch.argmin(delta, dim=0)  # nearest-silhouette sphere per ray
    ar = torch.arange(r, device=o.device)
    delta_min = delta[j, ar]
    delta_min = torch.where(torch.isfinite(delta_min), delta_min, torch.full_like(delta_min, 1e6))

    # Background: the scene without sphere j (spheres lead the flat
    # primitive order, so the global row index is j).
    row = torch.arange(t_all.shape[0], device=o.device)[:, None]
    t_bg = torch.where(row == j[None, :], torch.full_like(t_all, torch.inf), t_all)
    bg = hit_from_distances(flat, o, d, t_bg)

    # Front layer: the hard sphere-j hit where it exists, else a pseudo-hit.
    c_j = flat.sph_centers[j]
    r_j = flat.sph_radii[j]
    n_pseudo = vm.normalize(closest[j, ar] - c_j)
    p_pseudo = c_j + n_pseudo * r_j[:, None]
    t_pseudo = t_c[j, ar]
    use_pseudo = ~(hit.valid & (hit.family == FAMILY_SPHERE) & (hit.index == j))

    def fill(field_hit, field_pseudo):
        mask = use_pseudo[:, None] if field_hit.dim() == 2 else use_pseudo
        return torch.where(mask, field_pseudo, field_hit)

    front = Hit(
        t=fill(hit.t, t_pseudo),
        valid=torch.ones((r,), dtype=torch.bool, device=o.device),
        point=fill(hit.point, p_pseudo),
        normal=fill(hit.normal, n_pseudo),
        albedo=fill(hit.albedo, flat.albedo[j]),
        shininess=fill(hit.shininess, flat.shininess[j]),
        specular=fill(hit.specular, flat.specular[j]),
        transparency=fill(hit.transparency, flat.transparency[j]),
        refractive_index=fill(hit.refractive_index, flat.refractive_index[j]),
        family=torch.full((r,), FAMILY_SPHERE, dtype=torch.int32, device=o.device),
        index=j.to(torch.int32),
    )

    cov = torch.sigmoid(-delta_min / cfg.soft_sigma)
    # Depth gate: the silhouette shows only where the sphere layer is in
    # front of the background surface.
    in_front = ~bg.valid | (front.t < bg.t)
    cov = torch.where(in_front, cov, torch.zeros_like(cov))
    return front, bg, cov.to(o.dtype)


def integrate_chain_soft(flat: FlatScene, o: torch.Tensor, d: torch.Tensor, cfg) -> torch.Tensor:
    """The chain integrator [R,3] x [R,3] -> HDR [R,3] with a two-layer
    soft-silhouette primary bounce."""
    r = o.shape[0]
    active = torch.ones((r,), dtype=torch.bool, device=o.device)
    front, bg, cov = soft_primary_layers(flat, o, d, cfg)
    nd_f = _shade_from_hit(flat, front, d, active, cfg)
    nd_b = _shade_from_hit(flat, bg, d, active, cfg)

    one_m_cov = 1.0 - cov
    accum = torch.where(nd_b["miss"][:, None], one_m_cov[:, None] * sky_color(d), 0.0)
    accum = accum + torch.where(nd_f["shade"][:, None], cov[:, None] * nd_f["local_term"], 0.0)
    accum = accum + torch.where(nd_b["shade"][:, None], one_m_cov[:, None] * nd_b["local_term"], 0.0)

    # Reflection chains from both layers, weighted by their coverage.
    for nd, weight in ((nd_f, cov), (nd_b, one_m_cov)):
        cont = nd["has_refl"]
        accum = _chain_scan(
            flat,
            torch.where(cont[:, None], nd["refl_o"], o),
            torch.where(cont[:, None], nd["refl_dir"], d),
            torch.where(cont, weight * nd["refl_w"], 0.0),
            cont,
            accum,
            1,
            cfg,
        )
    return accum
