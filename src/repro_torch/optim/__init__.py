"""Optimizers, schedules and gradient utilities of the port.

Functional, as in the JAX package: an update takes the gradients, the
state and the params and returns new params and a new state; nothing is
updated in place.  Param trees are the model's dicts, lists and tuples of
tensors.  AdamW, and Adafactor for the configs that name it (grok-1,
kimi-k2).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .adafactor import adafactor_init, adafactor_update
from .adamw import adamw_init, adamw_update, tree_leaves, tree_map
from .schedule import constant, warmup_cosine, warmup_linear

__all__ = [
    "adamw_init",
    "adamw_update",
    "adafactor_init",
    "adafactor_update",
    "warmup_cosine",
    "warmup_linear",
    "constant",
    "clip_by_global_norm",
    "make_optimizer",
    "tree_leaves",
    "tree_map",
]


def clip_by_global_norm(grads, max_norm: float):
    """Scale the gradient tree so its global L2 norm is at most
    ``max_norm``; returns (clipped tree, norm before clipping)."""
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def make_optimizer(name: str, **kw) -> Tuple[Callable, Callable]:
    """Returns (init_fn(params) -> state, update_fn(grads, state, params, lr))."""
    if name == "adamw":
        return adamw_init, lambda g, s, p, lr: adamw_update(g, s, p, lr, **kw)
    if name == "adafactor":
        return adafactor_init, lambda g, s, p, lr: adafactor_update(g, s, p, lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
