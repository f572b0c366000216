"""Gradient-descent inverse rendering (BASELINE config #4) on torch.optim.

A train step renders the current scene, takes a loss against a target
image, backpropagates through the whole pipeline (camera rays ->
intersection -> shading -> integrator -> optional tonemap; with
`use_pallas=True` a trace kernel forward and its adjoint kernel backward)
and lets the optimizer update the params in place.

Every route renders with gradients: the kernels (binary shadows in chain
mode; binary or march shadows on glass scenes of at most 512 primitives)
and the integrators (`use_pallas=False`, march or soft shadows,
`soft_primary`). At spp > 1 each sample is traced and differentiated on
its own (render/pipeline.py's per-sample loop); through the kernels that
takes `differentiable=True`, since the in-kernel AA has no backward. A
step's `seed` keys the samples' jitter: `fit` draws one per step from its
own generator, as the JAX package splits its key per step.
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
from raytracingengine_tpu_torch.utils.profiling import span

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
    """-> step(params, static, target, seed=None) -> (loss, grads): one
    forward, backward and optimizer update; `grads` maps each param path to
    its gradient (None for a frozen leaf). Camera tensors that require grad
    get their `.grad` too (add them to the optimizer to train them). `seed`
    keys the AA jitter at spp > 1 (render_hdr's; None is seed 0)."""

    def step(params, static, target, seed: int | None = None):
        with span("rte.optimizer"):
            optimizer.zero_grad(set_to_none=True)
        with span("rte.tables"):
            scene = combine(params, static)
        img = render_hdr(scene, camera, cfg, seed=seed)
        if tonemap is not None:
            img = tonemap(img)
        with span("rte.autograd"):
            loss = loss_fn(img, target)
            loss.backward()
        with span("rte.optimizer"):
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
    seed: int = 0,
):
    """Run the optimization loop -> (fitted scene, loss curve). The default
    optimizer is Adam(learning_rate); `mask` freezes the params where it is
    False (see masked_optimizer). Each step's jitter seed comes from a
    torch.Generator seeded with `seed`, so a fit is reproducible."""
    if optimizer is None:
        optimizer = lambda ps: torch.optim.Adam(ps.values(), lr=learning_rate)  # noqa: E731
    params, static = partition(scene_init)
    state = TrainState(params, static, masked_optimizer(params, mask, optimizer))
    train_step = make_train_step(camera, cfg, state.optimizer, loss_fn=loss_fn)
    generator = torch.Generator().manual_seed(seed)
    losses = []
    for i in range(steps):
        step_seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
        loss, _ = train_step(state.params, state.static, target, step_seed)
        state.step += 1
        losses.append(float(loss))
        if callback is not None:
            callback(i, losses[-1])
    fitted = {k: p.detach() for k, p in state.params.items()}
    return combine(fitted, state.static), losses
