"""Gradient-descent inverse rendering (BASELINE config #4) on torch.optim.

A train step renders the current scene, takes a loss against a target
image, backpropagates through the whole pipeline (camera rays ->
intersection -> shading -> integrator -> optional tonemap; with
`use_pallas=True` a trace kernel forward and its adjoint kernel backward)
and lets the optimizer update the params in place.

Use a differentiable configuration at spp=1: an opaque scene with
shadow_mode="binary" (the chain kernels, or the chain integrator), or a
glass scene with `use_pallas=True` and binary or march shadows (the
wavefront trace kernel and the glass adjoint, at most 512 primitives).
With `use_pallas=False` glass scenes differentiate the fixed-trip
integrate_wavefront (`differentiable=True`), which runs every
`cfg.budget()` iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from raytracingengine_tpu_torch.core.camera import Camera
from raytracingengine_tpu_torch.inverse.loss import l2_image_loss
from raytracingengine_tpu_torch.inverse.params import combine, partition
from raytracingengine_tpu_torch.render.config import RenderConfig
from raytracingengine_tpu_torch.render.pipeline import render_hdr

#: Builds an optimizer over the trainable params, e.g.
#: ``lambda ps: torch.optim.Adam(ps.values(), lr=1e-2)``.
OptimizerFactory = Callable[[dict[str, torch.Tensor]], torch.optim.Optimizer]


def masked_optimizer(
    params: dict[str, torch.Tensor], mask: dict[str, bool] | None, make: OptimizerFactory
) -> torch.optim.Optimizer:
    """The optimizer from `make` over the params where `mask` is True.

    A frozen leaf never moves: it stops requiring grad and is never handed
    to the optimizer, so no update rule (weight decay, momentum, Adam's
    moments) can touch it. Zeroing its gradient alone would not do that."""
    trainable = {k: p for k, p in params.items() if mask is None or mask[k]}
    for k, p in params.items():
        p.requires_grad_(k in trainable)
    return make(trainable)


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    static: Any
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_train_step(
    camera: Camera,
    cfg: RenderConfig,
    optimizer: torch.optim.Optimizer,
    loss_fn: Callable = l2_image_loss,
    tonemap: Callable | None = None,
):
    """-> step(params, static, target) -> (loss, grads): one forward,
    backward and optimizer update; `grads` maps each param path to its
    gradient (None for a frozen leaf). Camera tensors that require grad get
    their `.grad` too (add them to the optimizer to train them)."""

    def step(params, static, target):
        optimizer.zero_grad(set_to_none=True)
        img = render_hdr(combine(params, static), camera, cfg)
        if tonemap is not None:
            img = tonemap(img)
        loss = loss_fn(img, target)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: p.grad for k, p in params.items()}

    return step


def fit(
    scene_init,
    camera: Camera,
    cfg: RenderConfig,
    target: torch.Tensor,
    steps: int = 200,
    learning_rate: float = 1e-2,
    optimizer: OptimizerFactory | None = None,
    mask: dict[str, bool] | None = None,
    loss_fn: Callable = l2_image_loss,
    callback: Callable[[int, float], None] | None = None,
):
    """Run the optimization loop -> (fitted scene, loss curve). The default
    optimizer is Adam(learning_rate); `mask` freezes the params where it is
    False (see masked_optimizer)."""
    if optimizer is None:
        optimizer = lambda ps: torch.optim.Adam(ps.values(), lr=learning_rate)  # noqa: E731
    params, static = partition(scene_init)
    state = TrainState(params, static, masked_optimizer(params, mask, optimizer))
    train_step = make_train_step(camera, cfg, state.optimizer, loss_fn=loss_fn)
    losses = []
    for i in range(steps):
        loss, _ = train_step(state.params, state.static, target)
        state.step += 1
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1])
    fitted = {k: p.detach() for k, p in state.params.items()}
    return combine(fitted, state.static), losses
