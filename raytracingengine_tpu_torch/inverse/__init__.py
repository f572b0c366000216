from raytracingengine_tpu_torch.inverse.loss import l1_image_loss, l2_image_loss
from raytracingengine_tpu_torch.inverse.optimize import (
    TrainState,
    fit,
    make_train_step,
    masked_optimizer,
)
from raytracingengine_tpu_torch.inverse.params import combine, partition, select

__all__ = [
    "TrainState",
    "l1_image_loss",
    "l2_image_loss",
    "fit",
    "make_train_step",
    "masked_optimizer",
    "combine",
    "partition",
    "select",
]
