"""The 7-operator tonemap family on HDR tensors [..., 3].

The reference's free functions (RaytracingEngine.cpp:70-214):

  simple                       clamp01                        (:123-131)
  reinhard_simple              c / (c+1)                      (:133-135)
  reinhard_extended            c * (1 + c/w^2) / (1 + c), w=5 (:137-141)
  reinhard_extended_luminance  luminance-space extended, Rec.709 weights
                               (0.2126, 0.7152, 0.0722)       (:100-110, :143-148)
  reinhard_jodie               a=0.18 log-based L map         (:150-154)
  uncharted2                   Hable filmic, exposureBias=2, W=11.2
                               (:78-87, :156-163)
  aces_approx                  Narkowicz ACES fit, v*=0.6     (:89-98)

The reference writes several curve constants as float literals (0.15f,
2.51f, ...); they are rounded through float32 here as in the JAX package.

`to_uint8` is toColor (:113-121): clamp01 then a TRUNCATING cast of v*255.
`change_luminance` divides by the input luminance with no zero guard
(:106-110), like the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracingengine_tpu_torch.utils.profiling import spanned

_F32 = lambda x: float(np.float32(x))

#: Rec.709 luminance weights (RaytracingEngine.cpp:100-104).
LUMA_WEIGHTS = (0.2126, 0.7152, 0.0722)


def luminance(c: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(LUMA_WEIGHTS, dtype=c.dtype, device=c.device)
    return torch.sum(c * w, dim=-1)


def change_luminance(c: torch.Tensor, l_out: torch.Tensor) -> torch.Tensor:
    l_in = luminance(c)
    return c * (l_out / l_in)[..., None]


def simple(c: torch.Tensor) -> torch.Tensor:
    return torch.clamp(c, 0.0, 1.0)


def reinhard_simple(c: torch.Tensor) -> torch.Tensor:
    return c / (c + 1.0)


def reinhard_extended(c: torch.Tensor, max_white: float = 5.0) -> torch.Tensor:
    white_sq = max_white * max_white
    return (c * (c / white_sq + 1.0)) / (c + 1.0)


def reinhard_extended_luminance(
    c: torch.Tensor, max_white: float = 5.0
) -> torch.Tensor:
    l_old = luminance(c)
    l_new = (l_old * (1.0 + l_old / (max_white * max_white))) / (1.0 + l_old)
    return change_luminance(c, l_new)


def reinhard_jodie(c: torch.Tensor, a: float = 0.18) -> torch.Tensor:
    l = luminance(c)
    l_mapped = (a / torch.log(2.0 + (l / 0.85) ** 1.7)) * torch.log(1.0 + l)
    return change_luminance(c, l_mapped)


def _uncharted2_partial(x: torch.Tensor) -> torch.Tensor:
    a, b, c, d, e, f = (
        _F32(0.15),
        _F32(0.50),
        _F32(0.10),
        _F32(0.20),
        _F32(0.02),
        _F32(0.30),
    )
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def uncharted2(c: torch.Tensor) -> torch.Tensor:
    exposure_bias = 2.0
    curr = _uncharted2_partial(c * exposure_bias)
    w = torch.full((3,), 11.2, dtype=c.dtype, device=c.device)
    white_scale = 1.0 / _uncharted2_partial(w)
    return curr * white_scale


def aces_approx(c: torch.Tensor) -> torch.Tensor:
    v = c * _F32(0.6)
    a, b, cc, d, e = _F32(2.51), _F32(0.03), _F32(2.43), _F32(0.59), _F32(0.14)
    return torch.clamp((v * (a * v + b)) / (v * (cc * v + d) + e), 0.0, 1.0)


#: Name -> operator, in the reference's export order
#: (RaytracingEngine.cpp:303-311).
OPERATORS = {
    "simple": simple,
    "reinhard_simple": reinhard_simple,
    "reinhard_extended": reinhard_extended,
    "reinhard_extended_luminance": reinhard_extended_luminance,
    "reinhard_jodie": reinhard_jodie,
    "uncharted2": uncharted2,
    "aces": aces_approx,
}


@spanned("rte.tonemap")
def tonemap(hdr: torch.Tensor, operator: str = "aces") -> torch.Tensor:
    """Apply one operator (the reference's `tonemap` applies ACES,
    RaytracingEngine.cpp:165-174)."""
    return OPERATORS[operator](hdr)


def tonemap_all(hdr: torch.Tensor) -> dict[str, torch.Tensor]:
    """All 7 operators (tonemapAll, RaytracingEngine.cpp:176-214)."""
    return {name: op(hdr) for name, op in OPERATORS.items()}


@spanned("rte.tonemap")
def to_uint8(mapped: torch.Tensor) -> torch.Tensor:
    """toColor (RaytracingEngine.cpp:113-121): clamp01, * 255, truncate."""
    return (torch.clamp(mapped, 0.0, 1.0) * 255.0).to(torch.uint8)
