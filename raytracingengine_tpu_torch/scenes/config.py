"""Declarative scene description (JSON) -> Scene and Camera.

The reference hard-codes its scene in main() (RaytracingEngine.cpp:223-290);
here a scene is data, in the JAX package's schema:

{
  "camera":  {"position": [x,y,z], "focal": f, "width": w, "height": h,
              "near": n, "far": f, "spp": s},
  "spheres": [{"center": [..], "radius": r, "material": {...}}],
  "planes":  [{"point": [..], "normal": [..], "material": {...}}],
  "triangles": [{"v0": [..], "v1": [..], "v2": [..], "material": {...},
                 "translation": [..]}],
  "models":  [{"obj": "path.obj", "translation": [..], "material": {...}}],
  "lights":  [{"position": [..], "color": [..], "intensity": i}]
}

material: {"color": [r,g,b], "shininess": 128, "specular": 0,
           "transparency": 0, "refractive_index": 1}; the defaults are
Shape.h:13-19's. A model's path is relative to the JSON file's directory.
"""

from __future__ import annotations

import json
import os

import torch

from raytracingengine_tpu_torch.core.camera import Camera
from raytracingengine_tpu_torch.geometry.materials import Material
from raytracingengine_tpu_torch.imageio.obj import load_obj
from raytracingengine_tpu_torch.scene import Scene, SceneBuilder


def _material(d: dict | None) -> Material:
    d = d or {}
    return Material(
        color=tuple(d.get("color", (0.0, 0.0, 0.0))),
        shininess=float(d.get("shininess", 128.0)),
        specular=float(d.get("specular", 0.0)),
        transparency=float(d.get("transparency", 0.0)),
        refractive_index=float(d.get("refractive_index", 1.0)),
    )


def scene_from_dict(
    cfg: dict,
    base_dir: str = ".",
    dtype=torch.float32,
    pad_multiple: int | None = None,
    device: torch.device | str = "cuda",
) -> tuple[Scene, Camera]:
    """A scene description (the schema above) -> (Scene, Camera) on `device`."""
    b = SceneBuilder()
    for s in cfg.get("spheres", []):
        b.add_sphere(s["center"], s["radius"], _material(s.get("material")))
    for p in cfg.get("planes", []):
        b.add_plane(p["point"], p["normal"], _material(p.get("material")))
    for t in cfg.get("triangles", []):
        b.add_triangle(t["v0"], t["v1"], t["v2"], _material(t.get("material")),
                       translation=t.get("translation", (0, 0, 0)))
    for m in cfg.get("models", []):
        path = m["obj"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        data = load_obj(path)
        b.add_model(data["vertices"], data["indices"], _material(m.get("material")),
                    translation=m.get("translation", (0, 0, 0)))
    for light in cfg.get("lights", []):
        b.add_light(light["position"], light.get("color", (1, 1, 1)), light["intensity"])
    scene = b.build(dtype=dtype, pad_multiple=pad_multiple, device=device)

    c = cfg.get("camera", {})
    camera = Camera.create(
        c.get("position", (0, 0, 0)),
        focal=c.get("focal", 1.0),
        width=c.get("width", 800),
        height=c.get("height", 600),
        near=c.get("near", 1.0),
        far=c.get("far", 1000.0),
        spp=c.get("spp", 32),
        dtype=dtype,
        device=device,
    )
    return scene, camera


def load_scene_json(
    path: str,
    dtype=torch.float32,
    pad_multiple: int | None = None,
    device: torch.device | str = "cuda",
    **overrides,
) -> tuple[Scene, Camera]:
    """A scene JSON file -> (Scene, Camera); keyword `overrides` that are
    not None replace camera fields (width, height, spp, ...)."""
    with open(path) as f:
        cfg = json.load(f)
    if overrides:
        cfg.setdefault("camera", {}).update({k: v for k, v in overrides.items() if v is not None})
    return scene_from_dict(cfg, base_dir=os.path.dirname(os.path.abspath(path)), dtype=dtype,
                           pad_multiple=pad_multiple, device=device)
