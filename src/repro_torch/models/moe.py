"""Top-k mixture-of-experts with GShard-style grouped dense dispatch.

Tokens are routed within fixed-size groups, so the dispatch and combine
products stay O(tokens * group * d); tokens beyond an expert's capacity
are dropped (``capacity_factor``).  Expert weights are stored ``(E, out,
in)``.  As in the JAX package, the router is the one policy-dispatched
GEMM (an f32 NT op: an f32 weight against the f32-cast tokens); the
dispatch, expert and combine contractions are ``torch.einsum`` products,
which the JAX package leaves to ``jnp.einsum``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.engine import dispatch

from .layers import Param, _normal, init_dense

__all__ = ["MoEConfig", "init_moe", "moe_layer", "router_aux_loss"]


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int  # per-expert hidden
    n_experts: int
    top_k: int
    group: int = 256
    capacity_factor: float = 2.0
    shard: str = "expert"  # 'expert' (EP) or 'ffn' (TP within expert); one device here

    def capacity(self, group: int) -> int:
        c = int(math.ceil(group * self.top_k * self.capacity_factor / self.n_experts))
        return max(c, 1)


def init_moe(gen: torch.Generator, cfg: MoEConfig, dtype=torch.float32, device="cpu") -> Param:
    """The JAX package's tree; the router weight is f32 whatever ``dtype``
    is."""
    E, f, d = cfg.n_experts, cfg.d_ff, cfg.d_model
    return {
        "router": init_dense(gen, E, d, torch.float32, device),
        "gate": _normal(gen, (E, f, d), 1.0 / math.sqrt(d), dtype, device),
        "up": _normal(gen, (E, f, d), 1.0 / math.sqrt(d), dtype, device),
        "down": _normal(gen, (E, d, f), 1.0 / math.sqrt(f), dtype, device),
    }


def _route(logits: torch.Tensor, cfg: MoEConfig, capacity: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits: (G, T, E) -> dispatch (G, T, E, C) and combine (G, T, E, C), f32.

    A token keeps every expert whose probability reaches its k-th largest
    (ties keep more than k, as the JAX package's threshold does).  Its
    position in an expert's queue is a cumulative sum over the group
    (GShard); a position at or past ``capacity`` encodes as a zero row,
    so the token is dropped there."""
    probs = torch.softmax(logits.float(), dim=-1)
    thresh = torch.topk(probs, cfg.top_k, dim=-1).values[..., -1:]
    kmask = probs >= thresh  # (G, T, E)
    gates = probs * kmask
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    k_int = kmask.to(torch.int32)
    pos_in_expert = torch.cumsum(k_int, dim=1) - k_int  # (G, T, E)
    keep = kmask & (pos_in_expert < capacity)
    onehot_c = F.one_hot(torch.where(keep, pos_in_expert, 0).long(), capacity).float()
    dispatch_mask = onehot_c * keep[..., None].float()  # (G, T, E, C)
    return dispatch_mask, dispatch_mask * gates[..., None]


def moe_layer(p: Param, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    group = min(cfg.group, S)
    if S % group != 0:  # ragged tail: one group per sequence
        group = S
    G = B * (S // group)
    xg = x.reshape(G, group, d)
    capacity = cfg.capacity(group)

    # router GEMM: (G*T, d) @ (E, d)^T -- an NT op, policy-dispatched, in f32
    router_logits = dispatch("NT", xg.float(), p["router"]["w"])
    dispatch_mask, combine = _route(router_logits, cfg, capacity)

    expert_in = torch.einsum("gtec,gtd->egcd", dispatch_mask.to(x.dtype), xg)
    g = torch.einsum("egcd,efd->egcf", expert_in, p["gate"])
    u = torch.einsum("egcd,efd->egcf", expert_in, p["up"])
    h = F.silu(g) * u
    expert_out = torch.einsum("egcf,edf->egcd", h, p["down"])
    out = torch.einsum("gtec,egcd->gtd", combine.to(x.dtype), expert_out)
    return out.reshape(B, S, d)


def router_aux_loss(logits: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balancing loss on (G, T, E) router logits."""
    probs = torch.softmax(logits.float(), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = F.one_hot(top1, cfg.n_experts).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)
