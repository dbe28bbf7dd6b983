"""Optimizers, schedules and gradient utilities of the port.

Functional, as in the JAX package: an update takes the gradients, the
state and the params and returns new params and a new state; nothing is
updated in place.  Param trees are the model's dicts, lists and tuples of
tensors.  AdamW, and Adafactor for the configs that name it (grok-1,
kimi-k2).  Each has the update of one rank of a mesh beside it
(``adamw_update_zero1``, ``adafactor_update_zero1``), which the train
step takes on one rank too, over a mesh of one (``make_zero1_update``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .adafactor import adafactor_init, adafactor_update, adafactor_update_zero1
from .adamw import adamw_init, adamw_update, adamw_update_zero1, tree_leaves, tree_map
from .schedule import constant, warmup_cosine, warmup_linear

__all__ = [
    "adamw_init",
    "adamw_update",
    "adamw_update_zero1",
    "adafactor_init",
    "adafactor_update",
    "adafactor_update_zero1",
    "warmup_cosine",
    "warmup_linear",
    "constant",
    "clip_by_global_norm",
    "global_norm",
    "make_optimizer",
    "make_zero1_update",
    "tree_leaves",
    "tree_map",
]


def global_norm(grads, specs=None, mesh=None) -> torch.Tensor:
    """The L2 norm of the gradient tree.  With ``specs`` (the pieces' specs,
    ``distributed.sharding``) each rank holds pieces of the leaves of
    ``mesh``: the squares are summed over each leaf's pieces once -- one
    all-reduce per set of axes that splits some leaf, over those axes --
    so a leaf that the mesh replicates counts once, not once a rank."""
    if specs is None:
        return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree_leaves(grads)))
    from repro_torch.distributed.collectives import all_reduce
    from repro_torch.distributed.sharding import map_with_path, spec_axes

    sums = {}

    def add(_, g, spec):
        axes = tuple(a for a in mesh.axis_names
                     if mesh.shape[a] > 1 and any(a in spec_axes(e) for e in spec))
        sq = torch.sum(g.float() ** 2)
        sums[axes] = sums[axes] + sq if axes in sums else sq

    map_with_path(add, grads, specs)
    total = sum(all_reduce(v, axes, mesh=mesh) if axes else v
                for axes, v in sorted(sums.items()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, specs=None, mesh=None):
    """Scale the gradient tree so its global L2 norm (``global_norm``) is
    at most ``max_norm``; returns (clipped tree, norm before clipping)."""
    gn = global_norm(grads, specs, mesh)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def make_optimizer(name: str, **kw) -> Tuple[Callable, Callable]:
    """Returns (init_fn(params) -> state, update_fn(grads, state, params, lr))."""
    if name == "adamw":
        return adamw_init, lambda g, s, p, lr: adamw_update(g, s, p, lr, **kw)
    if name == "adafactor":
        return adafactor_init, lambda g, s, p, lr: adafactor_update(g, s, p, lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")


def make_zero1_update(name: str, **kw) -> Callable:
    """The update of one rank of a mesh for optimizer ``name``:
    ``update(grads, state, params, lr, p_specs, o_specs, mesh,
    max_grad_norm, reduced) -> (params, state, norm)``, the data-mean of
    the gradients, their global-norm clip and the step in one;
    ``reduced``: a leaf with a ZeRO-1 dim comes as its piece of the sum
    over the data axes already (``launch/steps.py``'s ``zero1_grads``)."""
    fn = {"adamw": adamw_update_zero1, "adafactor": adafactor_update_zero1}.get(name)
    if fn is None:
        raise ValueError(f"unknown optimizer {name!r}")
    return lambda g, s, p, lr, p_specs, o_specs, mesh, max_grad_norm=1.0, reduced=False: fn(
        g, s, p, lr, p_specs, o_specs, mesh, max_grad_norm=max_grad_norm, reduced=reduced,
        **kw)
