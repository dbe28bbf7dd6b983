"""The reference's training steps over a data-parallel group: each rank
takes the gradient of its own rows by autograd over plain float32
operations, the ranks' gradients are summed (one ``all_reduce`` a leaf,
in float32), the global-norm clipping and AdamW are ``train.py``'s (b1
0.9, b2 0.95, eps 1e-8, decoupled weight decay, the same schedule), and
each leaf is updated by one rank, which holds its moments, and broadcast
from it, so every rank ends each step with the same parameters.  The
starting point, for the change of each leaf, is kept in the dtype the
weights were drawn in (``start_dtype``), which holds them exactly.
``decoder_loss`` is ``decoder.loss`` with each layer's activations
recomputed in the backward, so that a layer's activations, not every
layer's, sit beside the float32 parameters and gradients.  Plain
PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint

from . import decoder
from .train import B1, B2, EPS, leaf_norms, schedule

__all__ = ["decoder_loss", "train_steps"]


def decoder_loss(params: Dict[str, torch.Tensor], cfg: Dict, batch: Dict,
                 precision: str = "f32") -> torch.Tensor:
    """``decoder.loss``, each layer recomputed in the backward."""
    eps = cfg["rms_norm_eps"]
    tokens = batch["tokens"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    layers = {k: params[k].unbind(0) for k in decoder.LEAVES[2:]}

    def layer(x, i):
        one = {k: [v[i]] for k, v in layers.items()}
        x = x + decoder._attention(one, 0, decoder._rmsnorm(x, one["ln1"][0], eps), cfg, pos,
                                   precision)
        return x + decoder._mlp(one, 0, decoder._rmsnorm(x, one["ln2"][0], eps), precision)

    x = F.embedding(tokens.long(), params["embed"])
    for i in range(cfg["num_hidden_layers"]):
        x = torch.utils.checkpoint.checkpoint(layer, x, i, use_reentrant=False)
    x = decoder._rmsnorm(x, params["final_norm"], eps)
    head = params["embed"] if cfg["tie_word_embeddings"] else params["lm_head"]
    logits = decoder.linear(x, head, precision)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), batch["labels"].reshape(-1).long())


def train_steps(
    params: Dict[str, torch.Tensor],
    loss_fn: Callable[[Dict[str, torch.Tensor], Dict], torch.Tensor],
    microbatches: Callable[[int], Iterable[Tuple[Dict, float]]],
    hp: Dict,
    steps: int,
    start_dtype: torch.dtype = torch.bfloat16,
) -> Dict:
    """``train.train_steps`` over the process group: ``microbatches(i)``
    yields this rank's ``(batch, weight)`` pairs, whose weighted losses
    summed over every rank give step ``i``'s loss.  Returns what
    ``train.train_steps`` returns, the same on every rank."""
    sched = schedule(hp)
    wd = float(hp.get("weight_decay", 0.1))
    max_norm = float(hp.get("max_grad_norm", 1.0))
    start = {k: v.detach().to(start_dtype) for k, v in params.items()}
    # each leaf's owner: the largest leaves first, each to the rank holding least
    owner, load = {}, [0] * dist.get_world_size()
    for k in sorted(params, key=lambda k: -params[k].numel()):
        owner[k] = load.index(min(load))
        load[owner[k]] += params[k].numel()
    mine = [k for k in params if owner[k] == dist.get_rank()]
    m = {k: torch.zeros_like(params[k]) for k in mine}
    v2 = {k: torch.zeros_like(params[k]) for k in mine}
    for p in params.values():
        p.requires_grad_(True)
    losses: List[float] = []
    out: Dict = {}
    for i in range(steps):
        for p in params.values():
            p.grad = None
        total = torch.zeros((), dtype=torch.float64, device=next(iter(params.values())).device)
        for batch, weight in microbatches(i):
            loss = loss_fn(params, batch)
            (loss * weight).backward()
            total += loss.detach().double() * weight
            del loss
        dist.all_reduce(total)
        losses.append(float(total))
        with torch.no_grad():
            grads = {k: p.grad for k, p in params.items()}
            for g in grads.values():
                dist.all_reduce(g)
            gn = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))
            scale = min(max_norm / max(gn, 1e-12), 1.0)
            c = i + 1
            bc1, bc2 = 1.0 - B1 ** c, 1.0 - B2 ** c
            lr = sched(i)
            for k in mine:
                p, g = params[k], grads[k] * scale
                m[k].mul_(B1).add_(g, alpha=1 - B1)
                v2[k].mul_(B2).addcmul_(g, g, value=1 - B2)
                upd = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + EPS) + wd * p
                p.sub_(lr * upd)
                del g, upd
            for k, p in params.items():
                dist.broadcast(p, owner[k])
            if i == 0:
                out["grad_norm"] = gn
                out["first_grad"] = leaf_norms({k: g * scale for k, g in grads.items()})
            del grads
    for p in params.values():
        p.grad = None
        p.requires_grad_(False)
    out["losses"] = losses
    out["change"] = {k: float(torch.linalg.vector_norm(params[k] - start[k].float()))
                     for k in params}
    return out
