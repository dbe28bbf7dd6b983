"""The reference's training loop: gradients by autograd over plain
float32 operations, global-norm clipping, and AdamW with decoupled
weight decay on every leaf (b1 0.9, b2 0.95, eps 1e-8), the learning
rate from a constant or a warm-up-then-cosine schedule.  Parameters are
a flat ``{name: tensor}`` dict.  Plain PyTorch; imports nothing of the
program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Tuple

import torch

__all__ = ["schedule", "train_steps", "leaf_norms"]

B1, B2, EPS = 0.9, 0.95, 1e-8


def schedule(hp: Dict) -> Callable[[int], float]:
    """The learning rate of step ``i`` (0-based): ``constant`` at ``lr``,
    or ``warmup_cosine``: linear warm-up to ``lr`` over ``warmup`` steps,
    then a cosine to a tenth of it at ``total_steps``."""
    lr = float(hp["lr"])
    if hp.get("schedule", "constant") == "constant":
        return lambda i: lr
    warmup, total = int(hp["warmup"]), int(hp["total_steps"])

    def sched(i: int) -> float:
        if i < warmup:
            return lr * min(1.0, (i + 1) / max(warmup, 1))
        frac = min(max((i - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return lr * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * frac)))

    return sched


def leaf_norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tree.items()}


def train_steps(
    params: Dict[str, torch.Tensor],
    loss_fn: Callable[[Dict[str, torch.Tensor], Dict], torch.Tensor],
    microbatches: Callable[[int], Iterable[Tuple[Dict, float]]],
    hp: Dict,
    steps: int,
) -> Dict:
    """``steps`` AdamW steps from ``params`` (float32, updated in place).
    ``microbatches(i)`` yields ``(batch, weight)`` pairs whose weighted
    losses sum to step ``i``'s loss.  Returns each step's loss, the
    first step's gradient norm before clipping, each leaf's norm of the
    first clipped gradient (as the optimizer takes it) and of the change
    of the parameters over all the steps."""
    sched = schedule(hp)
    wd = float(hp.get("weight_decay", 0.1))
    max_norm = float(hp.get("max_grad_norm", 1.0))
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    for p in params.values():
        p.requires_grad_(True)
    losses: List[float] = []
    out: Dict = {}
    for i in range(steps):
        for p in params.values():
            p.grad = None
        total = 0.0
        for batch, weight in microbatches(i):
            loss = loss_fn(params, batch)
            (loss * weight).backward()
            total += float(loss.detach()) * weight
            del loss
        losses.append(total)
        with torch.no_grad():
            grads = {k: p.grad for k, p in params.items()}
            gn = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))
            scale = min(max_norm / max(gn, 1e-12), 1.0)
            c = i + 1
            bc1, bc2 = 1.0 - B1 ** c, 1.0 - B2 ** c
            lr = sched(i)
            for k, p in params.items():
                g = grads[k] * scale
                m[k].mul_(B1).add_(g, alpha=1 - B1)
                v2[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                upd = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + EPS) + wd * p
                p.sub_(lr * upd)
            if i == 0:
                out["grad_norm"] = gn
                out["first_grad"] = leaf_norms({k: g * scale for k, g in grads.items()})
            del grads
    for p in params.values():
        p.grad = None
        p.requires_grad_(False)
    out["losses"] = losses
    out["change"] = leaf_norms({k: params[k] - start[k] for k in params})
    return out
