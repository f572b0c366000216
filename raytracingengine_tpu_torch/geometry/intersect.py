"""The render-ready flattened scene.

`FlatScene` holds per-family geometry blocks plus the per-primitive
shading attributes concatenated in family order (spheres, planes,
triangles) — the order of the reference's linear scan (Scene.h:218-257),
whose strict-< first-wins tie-break the trace kernels reproduce.

Intersection epsilons follow the reference exactly: the sphere accepts
t >= 1e-6 preferring the near root (Shape.h:89-97), the plane requires
|denom| > 1e-6 and t >= 0 (Shape.h:149-159), the triangle uses
EPSILON = 1e-6 with u in [0,1], v >= 0, u+v <= 1, t > eps (Shape.h:202-220).

Two forms of the per-primitive math live in the port:

  * here, the all-pairs form of the JAX package's geometry/intersect.py:
    a block of R rays against every primitive at once, giving an [N, R]
    distance matrix whose first-minimum argmin is the closest hit. The
    triangle test is Moller-Trumbore rewritten with scalar triple products
    over per-triangle constants from `flatten_scene`. This is what the
    differentiable integrator (render/integrator.py) runs under autograd;
  * the per-primitive scan of the trace kernels, in kernels/chain_trace.py
    (plain version) and csrc/trace_common.cuh (CUDA).

The prim axis (parallel/): `closest_hit(..., prim_group=)` treats the
flat scene's triangles as this rank's contiguous block of a larger scene,
and combines the ranks' closest hits by an all_gather of 16 floats per ray
and an argmin on t, the JAX package's all_gather argmin over its `prims`
mesh axis. `gather_over` and `any_over` are the two collectives the
integrators need, over a torch.distributed group.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from raytracingengine_tpu_torch.core import vecmath as vm

#: Matches the reference's intersection epsilons (Shape.h:89, :151, :203).
EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class FlatScene:
    # Spheres
    sph_centers: torch.Tensor  # [S,3]
    sph_radii: torch.Tensor  # [S]
    sph_active: torch.Tensor  # [S] bool
    # Planes
    pl_points: torch.Tensor  # [P,3]
    pl_normals: torch.Tensor  # [P,3] unit
    pl_active: torch.Tensor  # [P] bool
    # Triangles (freestanding + mesh, concatenated)
    tri_v0: torch.Tensor  # [T,3]
    tri_e1: torch.Tensor  # [T,3] v1-v0
    tri_e2: torch.Tensor  # [T,3] v2-v0
    tri_ngeo: torch.Tensor  # [T,3] e1 x e2 (unnormalized)
    tri_nunit: torch.Tensor  # [T,3] safe-normalized geometric normal
    tri_c1: torch.Tensor  # [T,3] e1 x v0
    tri_c2: torch.Tensor  # [T,3] e2 x v0
    tri_k: torch.Tensor  # [T]   v0 . n_geo
    tri_active: torch.Tensor  # [T] bool
    # Per-primitive (N = S+P+T), family order: spheres, planes, triangles
    aux: torch.Tensor  # [N,3] sphere center / plane normal / tri unit normal
    albedo: torch.Tensor  # [N,3]
    shininess: torch.Tensor  # [N]
    specular: torch.Tensor  # [N]
    transparency: torch.Tensor  # [N]
    refractive_index: torch.Tensor  # [N]
    index: torch.Tensor  # [N] int32 family-local index (model id for meshes)
    # Lights
    light_positions: torch.Tensor  # [L,3]
    light_colors: torch.Tensor  # [L,3]
    light_intensities: torch.Tensor  # [L]
    light_active: torch.Tensor  # [L] bool
    # Counts (padded slots included)
    n_spheres: int
    n_planes: int
    n_triangles: int

    @property
    def n_primitives(self) -> int:
        return self.n_spheres + self.n_planes + self.n_triangles

    @property
    def n_lights(self) -> int:
        return self.light_intensities.shape[0]


def flatten_scene(scene) -> FlatScene:
    """Scene (scene.py) -> FlatScene."""
    sph, pl, tri, lights = scene.spheres, scene.planes, scene.triangles, scene.lights
    e1 = tri.v1 - tri.v0
    e2 = tri.v2 - tri.v0
    ngeo = vm.cross(e1, e2)
    mats = [sph.materials, pl.materials, tri.materials]
    cat = lambda xs: torch.cat(xs, dim=0)
    s, p, t = len(sph), len(pl), len(tri)
    dev = tri.v0.device
    nunit = vm.normalize(ngeo)
    return FlatScene(
        sph_centers=sph.centers,
        sph_radii=sph.radii,
        sph_active=sph.active,
        pl_points=pl.points,
        pl_normals=pl.normals,
        pl_active=pl.active,
        tri_v0=tri.v0,
        tri_e1=e1,
        tri_e2=e2,
        tri_ngeo=ngeo,
        tri_nunit=nunit,
        tri_c1=vm.cross(e1, tri.v0),
        tri_c2=vm.cross(e2, tri.v0),
        tri_k=vm.dot(tri.v0, ngeo),
        tri_active=tri.active,
        aux=cat([sph.centers, pl.normals, nunit]),
        albedo=cat([m.color for m in mats]),
        shininess=cat([m.shininess for m in mats]),
        specular=cat([m.specular for m in mats]),
        transparency=cat([m.transparency for m in mats]),
        refractive_index=cat([m.refractive_index for m in mats]),
        index=cat(
            [
                torch.arange(s, dtype=torch.int32, device=dev),
                torch.arange(p, dtype=torch.int32, device=dev),
                tri.group.to(torch.int32),
            ]
        ),
        light_positions=lights.positions,
        light_colors=lights.colors,
        light_intensities=lights.intensities,
        light_active=lights.active,
        n_spheres=s,
        n_planes=p,
        n_triangles=t,
    )


# Family codes in the flattened primitive ordering.
FAMILY_NONE = -1
FAMILY_SPHERE = 0
FAMILY_PLANE = 1
FAMILY_TRIANGLE = 2


def _contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N,3] x [R,3] -> [N,R]: a[n] . b[r] in full fp32, summed x, y, z."""
    return (
        a[:, None, 0] * b[None, :, 0]
        + a[:, None, 1] * b[None, :, 1]
        + a[:, None, 2] * b[None, :, 2]
    )


def _no_hits(o: torch.Tensor) -> torch.Tensor:
    return torch.full((0, o.shape[0]), torch.inf, dtype=o.dtype, device=o.device)


def intersect_spheres(flat: FlatScene, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Analytic quadratic (Shape.h:72-98) for all pairs -> t [S,R], +inf on
    miss; the near root t0 when t0 >= eps, else t1."""
    if flat.n_spheres == 0:
        return _no_hits(o)
    a = vm.dot(d, d)[None, :]
    b = 2.0 * (vm.dot(o, d)[None, :] - _contract(flat.sph_centers, d))  # 2 (o-c).d
    cc = (
        vm.dot(o, o)[None, :]
        - 2.0 * _contract(flat.sph_centers, o)
        + (vm.dot(flat.sph_centers, flat.sph_centers) - flat.sph_radii**2)[:, None]
    )  # |o-c|^2 - r^2
    disc = b * b - 4.0 * a * cc
    disc_ok = disc >= 0.0
    # sqrt of 1 in the miss branch, and a bounded derivative at disc == 0
    # (a tangent ray, which the hit branch accepts): no inf * 0 = NaN.
    disc_pos = torch.maximum(disc, torch.zeros_like(disc))
    sq = vm.sqrt_grad_safe(torch.where(disc_ok, disc_pos, torch.ones_like(disc)))
    inv2a = 0.5 / a
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t = torch.where(t0 >= EPS, t0, t1)
    hit = disc_ok & (t >= EPS) & flat.sph_active[:, None]
    return torch.where(hit, t, torch.inf)


def intersect_planes(flat: FlatScene, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Point-normal plane (Shape.h:149-159) -> t [P,R], +inf on miss;
    |d.n| > 1e-6 and t >= 0 (not >= eps)."""
    if flat.n_planes == 0:
        return _no_hits(o)
    denom = _contract(flat.pl_normals, d)
    pn = vm.dot(flat.pl_points, flat.pl_normals)[:, None]
    on = _contract(flat.pl_normals, o)
    denom_ok = denom.abs() > EPS
    t = (pn - on) / torch.where(denom_ok, denom, torch.ones_like(denom))
    hit = denom_ok & (t >= 0.0) & flat.pl_active[:, None]
    return torch.where(hit, t, torch.inf)


def intersect_triangles(flat: FlatScene, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Moller-Trumbore (Shape.h:202-220) in triple-product form -> t [T,R],
    +inf on miss:

        a = e1.(d x e2) = -(d . n_geo)      s.h = (o x d).e2 - d.(e2 x v0)
        d.q = d.(e1 x v0) - (o x d).e1      e2.q = o.n_geo - v0.n_geo
    """
    if flat.n_triangles == 0:
        return _no_hits(o)
    m = vm.cross(o, d)
    a = -_contract(flat.tri_ngeo, d)
    sh = _contract(flat.tri_e2, m) - _contract(flat.tri_c2, d)
    dq = _contract(flat.tri_c1, d) - _contract(flat.tri_e1, m)
    tk = _contract(flat.tri_ngeo, o) - flat.tri_k[:, None]
    a_ok = a.abs() > EPS
    f = 1.0 / torch.where(a_ok, a, torch.ones_like(a))
    u, v, t = f * sh, f * dq, f * tk
    hit = (
        a_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
        & flat.tri_active[:, None]
    )
    return torch.where(hit, t, torch.inf)


def all_distances(flat: FlatScene, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[S+P+T, R] distances, +inf on miss, in the reference's scan order."""
    return torch.cat(
        [intersect_spheres(flat, o, d), intersect_planes(flat, o, d),
         intersect_triangles(flat, o, d)],
        dim=0,
    )


@dataclasses.dataclass(frozen=True)
class Hit:
    """Batched hit record (the reference's HitInfo, Shape.h:28-57).

    `normal` is the geometric normal, not flipped toward the viewer (the
    flip happens in the integrator, Scene.h:145-146): sphere
    normalize(p - center), plane its normal, triangle its unit normal.
    Miss lanes have t = +inf, valid = False and finite garbage elsewhere.
    """

    t: torch.Tensor  # [R]
    valid: torch.Tensor  # [R] bool
    point: torch.Tensor  # [R,3]
    normal: torch.Tensor  # [R,3]
    albedo: torch.Tensor  # [R,3]
    shininess: torch.Tensor  # [R]
    specular: torch.Tensor  # [R]
    transparency: torch.Tensor  # [R]
    refractive_index: torch.Tensor  # [R]
    family: torch.Tensor  # [R] int32 (FAMILY_*)
    index: torch.Tensor  # [R] int32 family-local index / model id


def hit_from_distances(
    flat: FlatScene, o: torch.Tensor, d: torch.Tensor, t_all: torch.Tensor
) -> Hit:
    """Hit record from an [N,R] distance matrix. torch.argmin returns the
    first minimal index: the reference's strict-< first-wins tie-break."""
    j = torch.argmin(t_all, dim=0)
    t = torch.gather(t_all, 0, j[None, :])[0]
    valid = torch.isfinite(t)
    s, p = flat.n_spheres, flat.n_planes
    family = torch.where(
        j < s, FAMILY_SPHERE, torch.where(j < s + p, FAMILY_PLANE, FAMILY_TRIANGLE)
    ).to(torch.int32)
    family = torch.where(valid, family, torch.full_like(family, FAMILY_NONE))
    t_safe = torch.where(valid, t, torch.zeros_like(t))
    point = o + d * t_safe[:, None]
    aux = flat.aux[j]
    n_sphere = vm.normalize(point - aux)
    normal = torch.where((family == FAMILY_SPHERE)[:, None], n_sphere, aux)
    return Hit(
        t=t,
        valid=valid,
        point=point,
        normal=normal,
        albedo=flat.albedo[j],
        shininess=flat.shininess[j],
        specular=flat.specular[j],
        transparency=flat.transparency[j],
        refractive_index=flat.refractive_index[j],
        family=family,
        index=flat.index[j],
    )


def gather_over(t: torch.Tensor, group) -> torch.Tensor:
    """[...] on each rank of `group` -> [ranks, ...], in rank order (a
    value: no gradient flows through it)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def any_over(mask: torch.Tensor, group) -> torch.Tensor:
    """bool [...] -> True where it holds on any rank of `group` (a max)."""
    m = mask.to(torch.int32)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    return m > 0


def closest_hit(flat: FlatScene, o: torch.Tensor, d: torch.Tensor, prim_group=None) -> Hit:
    """Closest hit for a ray block: IntersectClosest (Scene.h:218-257).

    With `prim_group` (a torch.distributed group), `flat`'s triangles are
    this rank's contiguous block of the scene's, in rank order, and its
    spheres and planes every rank's: each rank finds its closest hit and
    the ranks' winners combine by the smallest t, the lowest rank winning
    a tie. That is the global scan order, so the combined hit is the
    one-process hit. The combine is a value: it carries no gradient."""
    local = _closest_hit_local(flat, o, d)
    return local if prim_group is None else _combine_hits(local, prim_group)


def _combine_hits(hit: Hit, group) -> Hit:
    packed = torch.cat([
        torch.where(hit.valid, hit.t, torch.inf)[:, None], hit.point, hit.normal, hit.albedo,
        hit.shininess[:, None], hit.specular[:, None], hit.transparency[:, None],
        hit.refractive_index[:, None], hit.family.to(hit.t.dtype)[:, None],
        hit.index.to(hit.t.dtype)[:, None],
    ], dim=1).detach()  # [R, 16]
    gathered = gather_over(packed, group)  # [ranks, R, 16]
    win = torch.argmin(gathered[..., 0], dim=0)  # the first minimum: the lowest rank
    best = gathered[win, torch.arange(packed.shape[0], device=packed.device)]
    t = best[:, 0]
    valid = torch.isfinite(t)
    family = torch.where(valid, best[:, 14].to(torch.int32), FAMILY_NONE)
    return Hit(t=t, valid=valid, point=best[:, 1:4], normal=best[:, 4:7], albedo=best[:, 7:10],
               shininess=best[:, 10], specular=best[:, 11], transparency=best[:, 12],
               refractive_index=best[:, 13], family=family, index=best[:, 15].to(torch.int32))


def _closest_hit_local(flat: FlatScene, o: torch.Tensor, d: torch.Tensor) -> Hit:
    r = o.shape[0]
    if flat.n_primitives == 0:
        z3 = torch.zeros((r, 3), dtype=o.dtype, device=o.device)
        z1 = torch.zeros((r,), dtype=o.dtype, device=o.device)
        return Hit(
            t=torch.full((r,), torch.inf, dtype=o.dtype, device=o.device),
            valid=torch.zeros((r,), dtype=torch.bool, device=o.device),
            point=z3, normal=z3, albedo=z3, shininess=z1, specular=z1,
            transparency=z1, refractive_index=torch.ones_like(z1),
            family=torch.full((r,), FAMILY_NONE, dtype=torch.int32, device=o.device),
            index=torch.zeros((r,), dtype=torch.int32, device=o.device),
        )
    return hit_from_distances(flat, o, d, all_distances(flat, o, d))


def any_hit_before(
    flat: FlatScene, o: torch.Tensor, d: torch.Tensor, max_dist: torch.Tensor
) -> torch.Tensor:
    """Binary occlusion: any primitive with 0 < t < max_dist -> bool [R]
    (the reference's Scene::IntersectAnyBefore, Scene.h:259-276)."""
    t_all = all_distances(flat, o, d)
    return ((t_all > 0.0) & (t_all < max_dist[None, :])).any(dim=0)
