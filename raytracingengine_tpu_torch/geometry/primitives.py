"""Structure-of-arrays primitive batches (the scene's parameters).

Each primitive family is one SoA dataclass of tensors, so a whole family
is intersected by one pass over its table. Every family carries an
`active` mask: padded slots never hit, which keeps shapes fixed across
scene edits of the same capacity.

`Triangles` covers both freestanding triangles and the reference's `Model`
meshes (Shape.h:248-307): a mesh becomes a triangle block with a shared
material and a `group` id (the reference reports hit.index = model index
for mesh hits, Shape.h:276).
"""

from __future__ import annotations

import dataclasses

import torch

from raytracingengine_tpu_torch.geometry.materials import Materials


@dataclasses.dataclass(frozen=True)
class Spheres:
    centers: torch.Tensor  # [S, 3]
    radii: torch.Tensor  # [S]
    materials: Materials  # fields [S, ...]
    active: torch.Tensor  # [S] bool

    def __len__(self) -> int:
        return self.radii.shape[0]


@dataclasses.dataclass(frozen=True)
class Planes:
    """Infinite planes: a point on the plane + a unit normal (normalized at
    construction, Shape.h:141-142)."""

    points: torch.Tensor  # [P, 3]
    normals: torch.Tensor  # [P, 3], unit
    materials: Materials
    active: torch.Tensor  # [P] bool

    def __len__(self) -> int:
        return self.points.shape[0]


@dataclasses.dataclass(frozen=True)
class Triangles:
    """Triangle soup, vertices in world space (the reference's per-hit
    translation by transform.position, Shape.h:198-200, is baked in).

    `group` is the reported hit index: the freestanding-triangle index, or
    the model index for mesh triangles.
    """

    v0: torch.Tensor  # [T, 3]
    v1: torch.Tensor  # [T, 3]
    v2: torch.Tensor  # [T, 3]
    materials: Materials
    active: torch.Tensor  # [T] bool
    group: torch.Tensor  # [T] int32

    def __len__(self) -> int:
        return self.v0.shape[0]


@dataclasses.dataclass(frozen=True)
class Lights:
    """Point lights (Light.h:6-15): emitted = color * intensity
    (Light.h:48-50); the 1/d^2 falloff is applied by the shading."""

    positions: torch.Tensor  # [L, 3]
    colors: torch.Tensor  # [L, 3]
    intensities: torch.Tensor  # [L]
    active: torch.Tensor  # [L] bool

    def __len__(self) -> int:
        return self.intensities.shape[0]
