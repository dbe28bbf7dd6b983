"""AdamW with decoupled weight decay on every leaf.  The moments are f32
whatever the param dtype (bf16-safe statistics); each step returns new
params and a new state.

``adamw_update_zero1`` is the update of one rank of a mesh under ZeRO-1
(``distributed.sharding.opt_state_specs``): each rank holds the ``m`` and
``v`` pieces that the specs give it -- its piece of the parameter, cut
once more over the data axes along the leaf's ZeRO-1 dim -- updates its
piece of the parameter from the data-mean gradient, and the pieces are
then all-gathered back over the data axes."""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

__all__ = ["adamw_init", "adamw_update", "adamw_update_zero1", "tree_leaves", "tree_map"]


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

    new_params = tree_map(lambda p, m2, v2: _step(p, m2, v2, lr, bc1, bc2, eps, weight_decay),
                          params, new_m, new_v)
    return new_params, {"m": new_m, "v": new_v, "count": count}


def _step(p, m2, v2, lr, bc1, bc2, eps, weight_decay):
    step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
    step = step + weight_decay * p.float()
    return (p.float() - lr * step).to(p.dtype)


def _zero1_dim(p_spec, o_spec):
    """The dim the data axes cut the moments along, or None."""
    return next((d for d, (a, b) in enumerate(zip(p_spec, o_spec)) if a != b), None)


@torch.no_grad()
def adamw_update_zero1(
    grads,
    state,
    params,
    lr,
    p_specs,
    o_specs,
    mesh,
    max_grad_norm: float = 1.0,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    reduced: bool = False,
):
    """One ZeRO-1 AdamW step of this rank.  ``grads`` are the gradients of
    this rank's param pieces on its own batch shard; ``p_specs`` and
    ``o_specs`` the params' and moments' specs (``state["m"]``'s).  Each
    gradient is reduce-scattered over the data axes along its ZeRO-1 dim
    (all-reduced where it has none; left as it is where the params split
    it over the data axes already, as FSDP's experts, whose backward
    reduce-scattered it) and divided by their size, the global
    norm is taken over those pieces (``global_norm``) and clipped to
    ``max_grad_norm`` (as ``clip_by_global_norm``), the pieces are
    updated, and the updated pieces all-gathered back.  On a mesh of one
    rank this is ``clip_by_global_norm`` and ``adamw_update``, value for
    value.  ``reduced``: a leaf with a ZeRO-1 dim comes as its piece of the
    sum already (``zero1_grads``' accumulator), taken as it is, divided
    once and counted once in the norm.  Returns (params, state, norm)."""
    from repro_torch.distributed.collectives import all_gather, all_reduce, reduce_scatter
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import data_axes, map_with_path

    from . import global_norm

    daxes = data_axes(mesh)
    n = mesh.axis_size(daxes)

    def piece(_, g, ps, os_):
        d = _zero1_dim(ps, os_)
        g = g.float()
        if d is not None:
            if not reduced:
                g = reduce_scatter(g, daxes, d, mesh=mesh)
        elif not sharding.splits(ps, daxes):
            g = all_reduce(g, daxes, mesh=mesh)
        # else the params split the leaf over the data axes (FSDP): its
        # backward reduce-scattered the gradient already
        return g / n

    g_pieces = map_with_path(piece, grads, p_specs, o_specs["m"])
    gn = global_norm(g_pieces, o_specs["m"], mesh)
    scale = torch.clamp(max_grad_norm / torch.clamp(gn, min=1e-12), max=1.0)

    count = state["count"] + 1
    c = count.float()
    bc1 = float(1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), c))
    bc2 = float(1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), c))
    new_m, new_v = {}, {}

    def update(names, p, g, m, v, ps, os_):
        g = g * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * torch.square(g)
        new_m[names], new_v[names] = m2, v2
        d = _zero1_dim(ps, os_)
        if d is None:
            return _step(p, m2, v2, lr, bc1, bc2, eps, weight_decay)
        part = p.shape[d] // n
        mine = p.narrow(d, mesh.axis_index(daxes) * part, part)
        return all_gather(_step(mine, m2, v2, lr, bc1, bc2, eps, weight_decay).contiguous(),
                          daxes, d, mesh=mesh)

    new_params = map_with_path(update, params, g_pieces, state["m"], state["v"],
                               p_specs, o_specs["m"])
    pick = lambda table: map_with_path(lambda names, _: table[names], params)  # noqa: E731
    return new_params, {"m": pick(new_m), "v": pick(new_v), "count": count}, gn
