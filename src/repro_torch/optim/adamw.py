"""AdamW with decoupled weight decay on every leaf.  The moments are f32
whatever the param dtype (bf16-safe statistics); each step returns new
params and a new state."""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

__all__ = ["adamw_init", "adamw_update", "tree_leaves", "tree_map"]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of same-structure trees of dicts, lists and
    tuples, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in ``tree_map`` order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def adamw_init(params) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32),
    }


@torch.no_grad()
def adamw_update(
    grads,
    state,
    params,
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
):
    count = state["count"] + 1
    c = count.float()
    bc1 = float(1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), c))
    bc2 = float(1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), c))
    new_m = tree_map(lambda g, m: b1 * m + (1 - b1) * g.float(), grads, state["m"])
    new_v = tree_map(lambda g, v: b2 * v + (1 - b2) * torch.square(g.float()), grads, state["v"])

    def upd(p, m2, v2):
        step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        step = step + weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype)

    new_params = tree_map(upd, params, new_m, new_v)
    return new_params, {"m": new_m, "v": new_v, "count": count}
