"""Batched 3-vector math on tensors of shape [..., 3].

The same semantics as the reference engine's Vec3 (Math.h:9-71):

  * ``normalize`` is *safe*: vectors with length <= 1e-12 map to the zero
    vector (Math.h:31-37).
  * ``reflect`` is v - 2 (v.n) n (Math.h:39-41) and does NOT normalize its
    arguments.
  * ``refract`` normalizes both arguments, clamps cos(theta_i) into [-1, 1]
    and returns the zero vector on total internal reflection (Math.h:43-52).

Clamps are written as ``minimum(maximum(x, lo), hi)``: at a tie both
``torch.maximum`` and ``jnp.maximum`` split the gradient 0.5/0.5, so the
port's subgradients are the JAX package's (``torch.clamp`` gives 1 there).

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


class _SqrtGradSafe(torch.autograd.Function):
    """sqrt whose derivative is clamped to 0.5/sqrt(max(x, 1e-12))."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sqrt(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * 0.5 * torch.rsqrt(torch.clamp_min(x, 1e-12))


def sqrt_grad_safe(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a bounded derivative: the value is exactly torch.sqrt(x),
    the derivative 0.5/sqrt(max(x, 1e-12)), so tangent-grazing rays (sphere
    discriminant == 0, refraction k == 0) give large but finite gradients
    instead of inf -> NaN."""
    return _SqrtGradSafe.apply(x)


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


def clip(a: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip with JAX's subgradient: 0.5 at either bound."""
    return torch.minimum(torch.maximum(a, torch.full_like(a, lo)), torch.full_like(a, hi))


def refract(v: torch.Tensor, n: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Snell refraction with TIR -> zero vector (Math.h:43-52); `eta` is
    eta_i/eta_t, batched [...]."""
    i = normalize(v)
    nn = normalize(n)
    cosi = clip(dot(i, nn), -1.0, 1.0)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    k_safe = torch.maximum(k, torch.zeros_like(k))
    out = i * eta[..., None] - nn * (eta * cosi + sqrt_grad_safe(k_safe))[..., None]
    return torch.where((k < 0.0)[..., None], torch.zeros_like(out), out)


def lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """a + (b - a) * t (Math.h:63-68); t broadcasts over the vector axis."""
    return a + (b - a) * t


def clamp01(a: torch.Tensor) -> torch.Tensor:
    return clip(a, 0.0, 1.0)
