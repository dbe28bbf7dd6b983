"""The train step: gradient accumulation over microbatches with f32
accumulators, global-norm clipping, the LR schedule and the config's
optimizer (AdamW, or Adafactor for the MoE giants), on one device.

``make_train_step(cfg, step_cfg, policy)`` returns ``train_step(state,
batch) -> (state, metrics)``.  The state is ``{"params", "opt", "step"}``
(``init_train_state`` builds it); ``batch`` holds ``tokens`` and ``labels``
tensors on the params' device; the metrics are ``loss`` and ``grad_norm``
(0-d tensors on the device) and ``lr`` (a float).  The forward and the
backward of every microbatch run in one ``use_policy`` block, as the JAX
package wraps ``value_and_grad``, so the policy selects the gradient GEMMs
too.  Updates are functional: the step returns new params and optimizer
state and leaves its inputs as they were.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.policy import SelectionPolicy, use_policy
from repro_torch.models import lm
from repro_torch.optim import (
    clip_by_global_norm,
    make_optimizer,
    tree_leaves,
    tree_map,
    warmup_cosine,
)

__all__ = ["TrainStepConfig", "make_train_step", "init_train_state", "loss_and_grads"]


class TrainStepConfig:
    def __init__(
        self,
        accum: int = 1,
        lr: float = 3e-4,
        warmup: int = 100,
        total_steps: int = 10000,
        max_grad_norm: float = 1.0,
        weight_decay: float = 0.1,
    ):
        self.accum = accum
        self.lr = lr
        self.warmup = warmup
        self.total_steps = total_steps
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay


def init_train_state(cfg, params) -> Dict:
    """The train state of fresh ``params``: optimizer state and step 0."""
    opt_init, _ = make_optimizer(cfg.optimizer)
    return {"params": params, "opt": opt_init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def _policy_scope(policy: Optional[SelectionPolicy]):
    """The block a microbatch's forward and backward run in; with no
    policy, the caller's scope governs (or, with none, the default
    policy)."""
    return use_policy(policy) if policy is not None else contextlib.nullcontext()


def _split_micro(batch: Dict[str, torch.Tensor], accum: int):
    """(B, ...) -> ``accum`` microbatches of (B/accum, ...)."""
    def split(x):
        if x.shape[0] % accum:
            raise ValueError(f"batch {x.shape[0]} not divisible by accum {accum}")
        return x.chunk(accum)

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum)]


def loss_and_grads(cfg, params, batch: Dict[str, torch.Tensor],
                   policy: Optional[SelectionPolicy] = None):
    """(loss, gradient tree) of ``lm.lm_loss`` at ``params``, the forward
    and the backward in one ``use_policy(policy)`` block; gradients come
    in the params' dtypes."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with _policy_scope(policy):
        loss, _ = lm.lm_loss(live, cfg, batch)
        grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(
    cfg,
    step_cfg: Optional[TrainStepConfig] = None,
    policy: Optional[SelectionPolicy] = None,
) -> Callable:
    sc = step_cfg or TrainStepConfig()
    opt_kw = {"weight_decay": sc.weight_decay} if cfg.optimizer == "adamw" else {}
    _, opt_update = make_optimizer(cfg.optimizer, **opt_kw)
    sched = warmup_cosine(sc.lr, sc.warmup, sc.total_steps)

    def train_step(state, batch):
        params = state["params"]
        if sc.accum == 1:
            loss, grads = loss_and_grads(cfg, params, batch, policy)
            grads = tree_map(lambda g: g.float(), grads)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for mb in _split_micro(batch, sc.accum):
                loss_mb, g = loss_and_grads(cfg, params, mb, policy)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + loss_mb
            loss = loss / sc.accum
            grads = tree_map(lambda g: g / sc.accum, grads)
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, sc.max_grad_norm)
            lr = sched(int(state["step"]))
            new_params, new_opt = opt_update(grads, state["opt"], params, lr)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step
