"""Render configuration: the same fields and defaults as the JAX package.

The reference hard-codes these: maxRecursion=10 (Scene.h:24), bias=1e-3
(Scene.h:291), shadow-march safety=64 and min-transmittance 1e-4
(Scene.h:39-42). A configuration means the same in both packages.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    #: Whitted recursion limit (depth >= max_depth returns sky, Scene.h:132-134).
    max_depth: int = 10
    #: Shadow/secondary-ray offset bias (Scene.h:291).
    bias: float = 1e-3
    #: Transmittance march: max steps (Scene.h:39) and early-exit threshold
    #: (Scene.h:42).
    shadow_max_steps: int = 64
    shadow_min_t: float = 1e-4
    #: Integrator: 'auto' picks 'chain' for opaque scenes and 'wavefront'
    #: when any material transmits; either can be forced.
    mode: str = "auto"
    #: Wavefront mode: max nodes of the recursion tree per pixel; None ->
    #: min(2^(max_depth+1), 4096).
    wavefront_budget: int | None = None
    #: Shadow visibility: 'march' (the reference's transmittance march),
    #: 'binary' (one any-hit pass; identical to the march on opaque
    #: scenes) or 'soft' (sigmoid visibility).
    shadow_mode: str = "march"
    #: Soft-shadow smoothing width (world units).
    soft_sigma: float = 0.05
    #: Differentiable sphere silhouettes on the primary bounce
    #: (render/soft_primary.py). Chain mode only; it takes the integrator.
    soft_primary: bool = False
    #: Fixed-trip loops (shadow march, wavefront) for the JAX package's
    #: reverse mode. With use_pallas, spp > 1 frames under this flag trace
    #: each sample through the fused forward and adjoint kernels (the
    #: per-sample loop, render/pipeline.py) instead of the in-kernel AA,
    #: which has no backward: set it to train at spp > 1 through the
    #: kernels, and leave it off for renders.
    differentiable: bool = False
    #: Terminate reflection chains whose accumulated path weight falls
    #: below this; pruning at 1e-8 keeps HDR output within ~3e-6 of the
    #: trace-everything reference. 0.0 traces every bounce.
    min_weight: float = 1e-8
    #: Rays (pixels) per launch of the trace.
    chunk_size: int = 16384
    #: Use the hand-written trace kernels (kernels/) where they apply.
    use_pallas: bool = False

    def budget(self) -> int:
        """Wavefront iterations (nodes popped per pixel) before the loop stops."""
        if self.wavefront_budget is not None:
            return self.wavefront_budget
        return min(2 ** (self.max_depth + 1), 4096)
