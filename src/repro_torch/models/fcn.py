"""Fully connected networks -- the paper's §VI-C Caffe experiment.

Weights are stored row-major ``(out, in)`` (the Caffe/paper convention),
so every forward projection is the NT operation ``y = x @ W^T`` and routes
through ``core.engine.dispatch("NT")``; its gradients dispatch the NN
(data) and TN (weight) GEMMs.  The paper's configurations (MNIST-sized
and the large "synthetic" net) live in ``configs/fcn_paper.py``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device

from repro_torch.core.policy import SelectionPolicy, use_policy
from repro_torch.optim import tree_leaves, tree_map

from .layers import Param, cross_entropy_loss, dense, init_dense

__all__ = ["FCNConfig", "init_fcn", "fcn_forward", "fcn_loss", "fcn_loss_and_grads"]


@dataclass(frozen=True)
class FCNConfig:
    name: str
    input_dim: int
    output_dim: int
    hidden: Tuple[int, ...]

    @property
    def dims(self) -> Tuple[int, ...]:
        return (self.input_dim,) + self.hidden + (self.output_dim,)


def init_fcn(gen, cfg: FCNConfig, dtype=torch.float32, *, device="cuda") -> Param:
    """Random params on ``device``: per layer ``w`` (out, in) drawn
    N(0, 1/in) and a zero bias ``b``.  ``gen`` is a ``torch.Generator`` or
    an int seed (for a CPU generator, so a seed gives the same weights on
    every device).  Raises ``RuntimeError`` if CUDA is asked for and there
    is no card."""
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(gen))
    dims = cfg.dims
    return {
        "layers": [
            init_dense(gen, dims[i + 1], dims[i], dtype, dev, bias=True)
            for i in range(len(dims) - 1)
        ]
    }


def fcn_forward(params: Param, x: torch.Tensor) -> torch.Tensor:
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        x = dense(layer, x)  # NT op -- policy dispatch point
        if i < n - 1:
            x = torch.relu(x)
    return x


def fcn_loss(params: Param, batch: Dict[str, torch.Tensor]):
    logits = fcn_forward(params, batch["x"])
    loss = cross_entropy_loss(logits, batch["labels"])
    return loss, {"loss": loss}


def fcn_loss_and_grads(params: Param, batch: Dict[str, torch.Tensor],
                       policy: Optional[SelectionPolicy] = None):
    """(loss, gradient tree) of ``fcn_loss`` at ``params``, the forward and
    the backward in one ``use_policy(policy)`` block (with no policy, the
    caller's scope or the default policy selects); gradients come in the
    params' dtypes."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with use_policy(policy) if policy is not None else contextlib.nullcontext():
        loss, _ = fcn_loss(live, batch)
        grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)
