"""Top-k mixture-of-experts, on one of two paths by ``capacity_factor``.

With a capacity (the default, the JAX package's layer): GShard-style
grouped dense dispatch.  Tokens are routed within fixed-size groups, so
the dispatch and combine products stay O(tokens * group * d); tokens
beyond an expert's capacity are dropped.  The dispatch, expert and
combine contractions are ``torch.einsum`` products, which the JAX
package leaves to ``jnp.einsum``.

With ``capacity_factor=None``: dropless, as granite-4.0-h-small's
published layer routes.  Each token takes exactly its top-k experts (the
softmax over its k largest logits, the same weights as the softmax over
all E renormalised over those k); the token-expert pairs are sorted by
expert (each expert's row range found in the sorted picks on the device,
so the layer never waits for the card and a CUDA graph can hold it),
gate and up run as two grouped GEMMs over the experts' row ranges and
down as a third (``grouped_mm``: ``torch._grouped_mm`` on
the card, an NT dispatch an expert elsewhere), and each token's k
outputs are summed under its gates.  Every routed row is computed once,
whatever the load.  Not served on a mesh: it raises there.

``shared_d_ff`` > 0 adds a shared expert: a SiLU-gated MLP of that
width that every token passes through (``layers.gated_mlp``'s dense
calls), summed with the routed experts' output.

Expert weights are stored ``(E, out, in)``.  As in the JAX package, the
router is the one policy-dispatched GEMM of the routed experts (an f32
NT op: an f32 weight against the f32-cast tokens).

Span and counters (``core/spans.py``, recording only while a profiler
runs or inside ``spans.recording()``): ``repro_torch.moe.experts``
around one layer's routed expert work on the dropless path (the sort,
the grouped GEMMs and the combine; ids ``rows``, the token-expert rows,
and ``experts``, the experts that took any); counters ``moe.rows`` (the
rows routed) and ``moe.rows_max`` (the busiest expert's rows, a call).
The experts taken and the busiest expert's rows stay device tensors
until the records are read: recording adds no wait for the device.

Under a mesh each rank holds the pieces of the expert tensors that the
sharding rules give (``distributed/sharding.py``: one dim over
``model``, and with it a second over the data axes), read through
``layers.weight_spec``:

  expert parallel (E divides ``model``)  each rank holds E/M experts; the
      router's E is split too, and its logits are gathered before the
      softmax and top-k, so routing is computed over all E on every rank.
      The dispatch and combine masks are cut to this rank's experts, and
      the combine's partial sums are summed over the group.  Tokens are
      replicated over ``model``, so no all-to-all is needed;
  tensor parallel within each expert (E does not divide ``model``, d_ff
      does)  gate and up split d_ff and down sums its partial outputs, as
      ``layers.gated_mlp`` does; the combine's partial sums are summed;
  FSDP  the expert tensors' second dim over the data axes is gathered
      whole once a layer, at compute time, and its gradient
      reduce-scattered (``layers.gather_data_dims``).

The tokens and the combine mask enter each rank's share through
``copy_to_group`` (the combine cut to its experts through
``scatter_to_group``), so their gradients are the group's sum and the
router's backward sees the whole gradient on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import spans
from repro_torch.distributed.collectives import (
    copy_to_group,
    gather_from_group,
    reduce_from_group,
    scatter_to_group,
)
from repro_torch.distributed.context import current_mesh

from .layers import (
    Param,
    _normal,
    dense,
    dense_tp,
    gated_mlp,
    gather_data_dims,
    init_dense,
    init_gated_mlp,
    weight_dim,
    weight_spec,
)

__all__ = ["MoEConfig", "init_moe", "moe_layer", "grouped_mm", "router_aux_loss"]


@dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int  # per-expert hidden
    n_experts: int
    top_k: int
    group: int = 256
    # None: dropless (the module docstring)
    capacity_factor: Optional[float] = 2.0
    # 'expert' (EP) or 'ffn' (TP within expert): the JAX package's label; the
    # split under a mesh is the sharding rules' (the module docstring)
    shard: str = "expert"
    # the shared expert's hidden width (0: none)
    shared_d_ff: int = 0

    def capacity(self, group: int) -> int:
        c = int(math.ceil(group * self.top_k * self.capacity_factor / self.n_experts))
        return max(c, 1)


def init_moe(gen: torch.Generator, cfg: MoEConfig, dtype=torch.float32, device="cpu") -> Param:
    """The JAX package's tree, and ``shared`` (a gated MLP) with a shared
    expert; the router weight is f32 whatever ``dtype`` is."""
    E, f, d = cfg.n_experts, cfg.d_ff, cfg.d_model
    p = {
        "router": init_dense(gen, E, d, torch.float32, device),
        "gate": _normal(gen, (E, f, d), 1.0 / math.sqrt(d), dtype, device),
        "up": _normal(gen, (E, f, d), 1.0 / math.sqrt(d), dtype, device),
        "down": _normal(gen, (E, d, f), 1.0 / math.sqrt(f), dtype, device),
    }
    if cfg.shared_d_ff:
        p["shared"] = init_gated_mlp(gen, d, cfg.shared_d_ff, dtype, device)
    return p


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


def _expert_specs(cfg: MoEConfig):
    """{name: spec} of the expert tensors on the current mesh, and the dim
    of ``gate`` that ``model`` splits (0 the experts, 1 d_ff; None
    whole)."""
    E, f, d = cfg.n_experts, cfg.d_ff, cfg.d_model
    specs = {n: weight_spec(("moe", n), shape)
             for n, shape in (("gate", (E, f, d)), ("up", (E, f, d)), ("down", (E, d, f)))}
    return specs, weight_dim(("moe", "gate"), (E, f, d))


def moe_layer(p: Param, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d); under a mesh, this rank's program on its
    pieces (the module docstring)."""
    routed = _capacity_layer if cfg.capacity_factor is not None else _dropless_layer
    out = routed(p, x, cfg)
    if cfg.shared_d_ff:
        out = out + gated_mlp(p["shared"], x, "silu", d_ff=cfg.shared_d_ff)
    return out


def grouped_mm(a: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows ``[offs[e-1], offs[e])`` of ``a`` (M, k) times ``w[e]^T``, for
    ``w`` (E, n, k) stored ``(out, in)``: (M, n).  On the card one
    ``torch._grouped_mm`` (bf16); elsewhere, or in another dtype, one NT
    dispatch an expert that takes rows."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch._grouped_mm(a, w.transpose(-2, -1), offs=offs)
    out = a.new_empty((a.shape[0], w.shape[1]))
    lo = 0
    for e, hi in enumerate(offs.tolist()):
        if hi > lo:
            out[lo:hi] = dense({"w": w[e]}, a[lo:hi])
        lo = hi
    return out


def _dropless_layer(p: Param, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The dropless path (the module docstring): x (B, S, d) -> (B, S, d)."""
    mesh = current_mesh()
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError("the dropless MoE (capacity_factor=None) is not served on "
                                  "a mesh")
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(B * S, d)
    T = xt.shape[0]
    logits = dense(p["router"], xt.float())  # (T, E): the f32 NT router
    top, experts = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top, dim=-1)  # (T, k)
    with spans.span("repro_torch.moe.experts", rows=T * k) as rec:
        flat = experts.reshape(-1)
        order = torch.argsort(flat, stable=True)
        # each expert's row range from the sorted picks: no wait for the device
        # (``bincount`` reads the largest pick back to size its output)
        ends = torch.searchsorted(flat[order], torch.arange(E, device=flat.device), right=True)
        offs = ends.to(torch.int32)
        counts = torch.diff(ends, prepend=ends.new_zeros(1))
        rows = xt[order // k]  # (T k, d), by expert
        h = F.silu(grouped_mm(rows, p["gate"], offs)) * grouped_mm(rows, p["up"], offs)
        y = grouped_mm(h, p["down"], offs)  # (T k, d), by expert
        y = torch.empty_like(y).index_copy_(0, order, y)  # back to (token, pick) order
        out = (y.view(T, k, d) * gates.to(x.dtype)[..., None]).sum(1)
    if rec is not None:  # after the span, so that its kernels are not the span's
        rec.ids["experts"] = (counts > 0).sum()
        spans.add("moe.rows", T * k)
        spans.add("moe.rows_max", counts.max())
    return out.reshape(B, S, d)


def _capacity_layer(p: Param, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The capacity path (the module docstring): x (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    group = min(cfg.group, S)
    if S % group != 0:  # ragged tail: one group per sequence
        group = S
    G = B * (S // group)
    xg = x.reshape(G, group, d)
    capacity = cfg.capacity(group)

    # router GEMM: (G*T, d) @ (E, d)^T -- an NT op, policy-dispatched, in f32
    rdim = weight_dim(("router", "w"), (cfg.n_experts, d))
    router_logits, split = dense_tp(p["router"], xg.float(), rdim)
    if split:
        router_logits = gather_from_group(router_logits)
    dispatch_mask, combine = _route(router_logits, cfg, capacity)

    specs, mdim = _expert_specs(cfg)
    if mdim == 0:  # expert parallel: this rank's experts
        n = p["gate"].shape[0]
        dispatch_mask = dispatch_mask.narrow(2, current_mesh().axis_index("model") * n, n)
        combine = scatter_to_group(combine, dim=2)
    elif mdim is not None:  # tensor parallel within each expert
        combine = copy_to_group(combine)
    if mdim is not None:
        xg = copy_to_group(xg)
    gate, up, down = (gather_data_dims(p[k], specs[k]) for k in ("gate", "up", "down"))

    expert_in = torch.einsum("gtec,gtd->egcd", dispatch_mask.to(x.dtype), xg)
    g = torch.einsum("egcd,efd->egcf", expert_in, gate)
    u = torch.einsum("egcd,efd->egcf", expert_in, up)
    h = F.silu(g) * u
    expert_out = torch.einsum("egcf,edf->egcd", h, down)
    out = torch.einsum("gtec,egcd->gtd", combine.to(x.dtype), expert_out)
    if mdim is not None:
        out = reduce_from_group(out)
    return out.reshape(B, S, d)


def router_aux_loss(logits: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balancing loss on (G, T, E) router logits."""
    probs = torch.softmax(logits.float(), dim=-1)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = F.one_hot(top1, cfg.n_experts).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)
