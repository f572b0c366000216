"""Carry JAX-package state into the port and back, as numpy arrays.

The leaves of the JAX package's `Scene` and `Camera` pytrees arrive as a
dict of numpy arrays keyed by their dotted field paths ("spheres.centers",
"triangles.materials.color", "position", ...). This module never imports
JAX: the caller does the `np.asarray` on its side. The same keys name the
port's trainable params (inverse/params.py), so a parameter set or its
gradients can be compared key by key.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingengine_tpu_torch.core.camera import Camera
from raytracingengine_tpu_torch.geometry.materials import Materials
from raytracingengine_tpu_torch.geometry.primitives import (
    Lights,
    Planes,
    Spheres,
    Triangles,
)
from raytracingengine_tpu_torch.scene import Scene, tensor_leaves


def _tensor(leaves: dict[str, np.ndarray], key: str, device) -> torch.Tensor:
    return torch.as_tensor(np.array(leaves[key]), device=device)


def scene_from_numpy(
    leaves: dict[str, np.ndarray],
    *,
    has_transparency: bool,
    device: torch.device | str = "cuda",
) -> Scene:
    t = lambda key: _tensor(leaves, key, device)

    def mats(family: str) -> Materials:
        return Materials(
            color=t(f"{family}.materials.color"),
            shininess=t(f"{family}.materials.shininess"),
            specular=t(f"{family}.materials.specular"),
            transparency=t(f"{family}.materials.transparency"),
            refractive_index=t(f"{family}.materials.refractive_index"),
        )

    return Scene(
        spheres=Spheres(
            centers=t("spheres.centers"),
            radii=t("spheres.radii"),
            materials=mats("spheres"),
            active=t("spheres.active"),
        ),
        planes=Planes(
            points=t("planes.points"),
            normals=t("planes.normals"),
            materials=mats("planes"),
            active=t("planes.active"),
        ),
        triangles=Triangles(
            v0=t("triangles.v0"),
            v1=t("triangles.v1"),
            v2=t("triangles.v2"),
            materials=mats("triangles"),
            active=t("triangles.active"),
            group=t("triangles.group"),
        ),
        lights=Lights(
            positions=t("lights.positions"),
            colors=t("lights.colors"),
            intensities=t("lights.intensities"),
            active=t("lights.active"),
        ),
        has_transparency=has_transparency,
    )


def camera_from_numpy(
    leaves: dict[str, np.ndarray],
    *,
    width: int,
    height: int,
    spp: int,
    device: torch.device | str = "cuda",
) -> Camera:
    t = lambda key: _tensor(leaves, key, device)
    return Camera(
        position=t("position"),
        focal=t("focal"),
        near=t("near"),
        far=t("far"),
        width=int(width),
        height=int(height),
        spp=int(spp),
    )


def params_from_numpy(
    leaves: dict[str, np.ndarray], device: torch.device | str = "cuda"
) -> dict[str, torch.Tensor]:
    """The float leaves as trainable tensors (requires_grad), same keys:
    a JAX `partition` params tree carried into the port's `combine`."""
    return {
        k: _tensor(leaves, k, device).requires_grad_(True)
        for k, v in leaves.items()
        if np.issubdtype(np.asarray(v).dtype, np.floating)
    }


def scene_to_numpy(scene) -> dict[str, np.ndarray]:
    """A Scene's (or any dataclass tree's) tensor leaves as numpy arrays
    under their dotted paths."""
    return {
        k: v.detach().cpu().numpy() for k, v in tensor_leaves(scene).items() if v is not None
    }
