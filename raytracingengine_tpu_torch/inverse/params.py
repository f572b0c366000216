"""Parameter partitioning for inverse rendering.

A Scene mixes float leaves (centers, radii, albedos, light positions and
intensities, ...) with bool/int leaves (active masks, group ids).
`partition` splits it into a dict of trainable float leaves keyed by their
dotted field paths ("spheres.centers", "lights.intensities", the keys of
convert.py) and a static Scene whose float leaves are None; `combine`
merges them back. The dict is what a torch.optim optimizer trains.
"""

from __future__ import annotations

import dataclasses

import torch

from raytracingengine_tpu_torch.scene import tensor_leaves


def _replace(obj, values: dict, prefix: str = ""):
    """Copy of a dataclass tree with the leaves named in `values` replaced."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(v):
            changes[f.name] = _replace(v, values, key + ".")
        elif key in values:
            changes[f.name] = values[key]
    return dataclasses.replace(obj, **changes)


def partition(scene):
    """-> (params, static). params: {path: float leaf}, each a fresh leaf
    tensor that requires grad; static: the scene with those leaves None."""
    floats = {k: v for k, v in tensor_leaves(scene).items() if v is not None and v.is_floating_point()}
    params = {k: v.detach().clone().requires_grad_(True) for k, v in floats.items()}
    return params, _replace(scene, dict.fromkeys(floats))


def combine(params: dict[str, torch.Tensor], static):
    """Inverse of `partition`: the scene with the param tensors as leaves
    (autograd flows from a render of it back to `params`)."""
    return _replace(static, params)


def select(params: dict[str, torch.Tensor], keep: list[str]) -> dict[str, bool]:
    """Mask of the params whose path contains one of `keep` (e.g.
    'spheres.centers', 'lights'): True where trainable."""
    return {k: any(s in k for s in keep) for k in params}
