"""Batched 3-vector math on tensors of shape [..., 3].

The same semantics as the reference engine's Vec3 (Math.h:9-71):

  * ``normalize`` is *safe*: vectors with length <= 1e-12 map to the zero
    vector (Math.h:31-37).
  * ``reflect`` is v - 2 (v.n) n (Math.h:39-41) and does NOT normalize its
    arguments.

Sums over the vector axis are written out as ``(x + y) + z`` so that the
rounding order is fixed and does not depend on a reduction kernel.
"""

from __future__ import annotations

import torch

#: Length threshold below which `normalize` returns the zero vector
#: (Math.h:33 uses 1e-12).
SAFE_NORMALIZE_EPS = 1e-12


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis: [..., 3] -> [...]."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product over the trailing axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: torch.Tensor, eps: float = SAFE_NORMALIZE_EPS) -> torch.Tensor:
    """Safe normalize: zero vector out when |a| <= eps (Math.h:31-37).

    Works on the squared length, so the zero-vector branch never takes the
    reciprocal square root of 0.
    """
    d2 = dot(a, a)
    small = d2 <= eps * eps
    inv = torch.rsqrt(torch.where(small, torch.ones_like(d2), d2))
    return torch.where(small[..., None], torch.zeros_like(a), a * inv[..., None])


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """v - 2 (v.n) n (Math.h:39-41); no normalization of inputs."""
    return v - n * (2.0 * dot(v, n))[..., None]


def clamp01(a: torch.Tensor) -> torch.Tensor:
    return torch.clamp(a, 0.0, 1.0)
