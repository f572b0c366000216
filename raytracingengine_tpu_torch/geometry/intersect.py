"""The render-ready flattened scene.

`FlatScene` holds per-family geometry blocks plus the per-primitive
shading attributes concatenated in family order (spheres, planes,
triangles) — the order of the reference's linear scan (Scene.h:218-257),
whose strict-< first-wins tie-break the trace kernels reproduce.

Intersection epsilons follow the reference exactly: the sphere accepts
t >= 1e-6 preferring the near root (Shape.h:89-97), the plane requires
|denom| > 1e-6 and t >= 0 (Shape.h:149-159), the triangle uses
EPSILON = 1e-6 with u in [0,1], v >= 0, u+v <= 1, t > eps (Shape.h:202-220).
The per-primitive math lives in kernels/chain_trace.py (plain version) and
csrc/trace_common.cuh (CUDA).
"""

from __future__ import annotations

import dataclasses

import torch

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
