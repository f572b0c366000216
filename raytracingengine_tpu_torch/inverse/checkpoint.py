"""Checkpoint and resume for the inverse-rendering loop (torch.save).

One file holds the params, the optimizer's state_dict and the step, so a
long optimization resumes where it stopped.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path: str, params: dict[str, torch.Tensor], opt_state: dict, step: int) -> None:
    """Write atomically: a temporary file in the same directory, then a rename."""
    state = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "opt_state": opt_state,
        "step": int(step),
    }
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, device: torch.device | str = "cuda") -> dict:
    """-> {"params": {path: tensor on device}, "opt_state": dict, "step": int}.
    Tensors land on the card unless `device` says otherwise. Load the
    optimizer state with `optimizer.load_state_dict`."""
    return torch.load(path, map_location=device, weights_only=True)
