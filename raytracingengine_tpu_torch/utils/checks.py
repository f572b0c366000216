"""NaN/Inf guards on tensors and on what a function returns.

The JAX package checks inside the traced computation with
jax.experimental.checkify, which has no PyTorch counterpart. Here the
checks run on the values: `assert_finite` over a tree of tensors and
`checked(fn)` on a function's outputs. Each check reads the values back
to the host, so it synchronises with the card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch


def _leaves(tree: Any, path: str):
    """(path, tensor) for every tensor in a tree of dicts, lists, tuples and
    dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}" if path else f.name)


def assert_finite(tree: Any, name: str = "value") -> None:
    """Raise FloatingPointError naming the first floating-point leaf of
    `tree` (a tensor, or dicts, lists, tuples and dataclasses of them) that
    holds a NaN or an Inf, and how many."""
    for path, t in _leaves(tree, ""):
        if t.is_floating_point() or t.is_complex():
            bad = int((~torch.isfinite(t.detach())).sum())
            if bad:
                where = f" leaf {path}" if path else ""
                raise FloatingPointError(f"{name}:{where} has {bad} non-finite values")


def checked(fn: Callable, name: str | None = None) -> Callable:
    """`fn` with a NaN/Inf guard on its outputs: the wrapper returns what
    `fn` returns, or raises FloatingPointError (assert_finite)."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, name or getattr(fn, "__name__", "output"))
        return out

    return run
