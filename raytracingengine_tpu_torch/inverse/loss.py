"""Losses for inverse rendering (pixel-space L2 per BASELINE config #4)."""

from __future__ import annotations

import torch


def l2_image_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((img - target) ** 2)


def l1_image_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(img - target))
