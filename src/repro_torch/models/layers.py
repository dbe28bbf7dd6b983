"""Foundational layers.  Every projection stores its weight row-major
``(out, in)``, so the forward pass of each dense layer is the paper's NT
operation ``C = A @ B^T`` and routes through ``core.engine.dispatch``.
Which candidate runs it is decided by the scoped policy
(``core.policy.use_policy``); layers take no selector argument.

Parameters are plain dicts of tensors, the same tree as the JAX
package's; initialisers draw from an explicit ``torch.Generator`` on
its own device (a CPU one gives the same weights on every device; a CUDA
one draws billions of normals in seconds) and place the result on
``device``.

Tensor parallelism.  Under a mesh whose ``model`` axis is larger than
one (``distributed.context.use_mesh``), each rank holds the pieces of
its weights that ``distributed.sharding.param_spec`` gives -- the
sharding rules themselves, read at each weight's full shape -- and
``dense_tp`` runs a projection on them:

  out-dim split (wq, wk, wv, gate, up)  the input enters the group
      (``copy_to_group``: its gradient is summed over the group in the
      backward) and each rank computes its slice of the output;
  in-dim split (wo, down, out)  each rank contracts its slice of the
      input, and the partial outputs are summed (``reduce_from_group``);
  whole  the projection runs on the full input on every rank.

An activation is either whole on every rank or split along its last
dim; ``dense_tp`` gathers or slices it to what the weight needs.  A
whole tensor that feeds this rank's share of a split computation (a
per-head vector sliced to this rank's heads, ``group_slice``; the
Mamba blocks' B and C, which every head contracts) enters it through
``copy_to_group``: its gradient is the group's sum.  A weight that the
rules split over the data axes as well (the MoE experts' second dim,
FSDP) is gathered whole over them for its use (``gather_data_dims``).  A
vocab-split embedding (``emb`` (V, d) over ``model``) looks up the
tokens of its rows and sums over the group (``embed``), computes its
slice of the logits (``unembed``), and the loss over those slices
(``cross_entropy_loss``) all-reduces each position's max and sum of
exponentials and its gold logit -- two floats a position where gathered
logits would move the whole vocabulary (262144 wide for gemma3).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.engine import dispatch
from repro_torch.distributed.collectives import (
    all_reduce,
    copy_to_group,
    gather_from_group,
    gather_params,
    reduce_from_group,
    scatter_to_group,
)
from repro_torch.distributed.context import current_mesh, model_size
from repro_torch.distributed.sharding import param_spec, spec_axes

__all__ = [
    "Param",
    "init_dense",
    "dense",
    "init_rmsnorm",
    "rmsnorm",
    "init_embedding",
    "embed",
    "unembed",
    "softcap",
    "init_gated_mlp",
    "gated_mlp",
    "cross_entropy_loss",
    "tp_mesh",
    "weight_dim",
    "weight_spec",
    "gather_data_dims",
    "group_slice",
    "dense_tp",
]

Param = Dict[str, Any]


def _normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    """N(0, std^2) drawn in f32 on the generator's device, then cast and
    moved; on the ``meta`` device nothing is drawn (a tree of shapes and
    dtypes only)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, device=gen.device).mul_(std)
    return x.to(device=device, dtype=dtype)


def init_dense(
    gen: torch.Generator,
    out_dim: int,
    in_dim: int,
    dtype=torch.float32,
    device="cpu",
    bias: bool = False,
    scale: Optional[float] = None,
) -> Param:
    """Weight stored (out, in): forward is the NT op x @ W^T."""
    std = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    p = {"w": _normal(gen, (out_dim, in_dim), std, dtype, device)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def dense(p: Param, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W^T (+ b) -- the paper's NT operation, policy-dispatched."""
    y = dispatch("NT", x, p["w"])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def tp_mesh():
    """The current mesh if its ``model`` axis splits work, else None."""
    mesh = current_mesh()
    return mesh if mesh is not None and model_size(mesh) > 1 else None


def weight_dim(names, shape) -> Optional[int]:
    """The dim of a weight of full ``shape`` at tree path ``names`` that the
    current mesh's ``model`` axis splits (None: every rank holds it
    whole), by ``distributed.sharding``'s rules."""
    if tp_mesh() is None:
        return None
    return next((d for d, e in enumerate(weight_spec(names, shape)) if e == "model"), None)


def weight_spec(names, shape):
    """The spec of a weight of full ``shape`` at tree path ``names`` on the
    current mesh (None off a mesh of more than one rank)."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return None
    return param_spec(names, shape, mesh)


def gather_data_dims(w: torch.Tensor, spec) -> torch.Tensor:
    """``w`` whole over the data axes: each dim that ``spec`` splits over
    them is all-gathered for this use, and its gradient reduce-scattered
    back (``collectives.gather_params``)."""
    for d, e in enumerate(spec or ()):
        axes = spec_axes(e)
        if axes and "model" not in axes and current_mesh().axis_size(axes) > 1:
            w = gather_params(w, axes, d)
    return w


def group_slice(t: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """This rank's ``n`` entries along ``dim`` of a tensor every rank of the
    ``model`` group holds whole (rank r's are ``[r n, (r+1) n)``); the
    gradient of ``t`` is the group's sum."""
    return copy_to_group(t).narrow(dim, current_mesh().axis_index("model") * n, n)


def dense_tp(p: Param, x: torch.Tensor, wdim: Optional[int], x_split: bool = False,
             copied: bool = False):
    """A projection on this rank's piece of its weight (the module
    docstring).  ``wdim`` is the weight's split dim (``weight_dim``: 0 the
    output, 1 the input, None whole); ``x_split`` says ``x`` is split
    along its last dim; ``copied`` that an out-split projection's input
    already went through ``copy_to_group`` (projections of one input share
    one copy).  Returns ``(y, y_split)``."""
    if wdim is None or (wdim == 0 and x_split):
        if x_split:
            x = gather_from_group(x)
        if wdim is None:
            return dense(p, x), False
        x_split, copied = False, False
    if wdim == 0:
        y = dispatch("NT", x if copied else copy_to_group(x), p["w"])
        if "b" in p:  # a whole bias, this rank's slice of it
            y = y + group_slice(p["b"], p["w"].shape[0]).to(y.dtype)
        return y, True
    if not x_split:
        x = scatter_to_group(x)
    y = reduce_from_group(dispatch("NT", x, p["w"]))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y, False


def init_rmsnorm(d: int, dtype=torch.float32, device="cpu") -> Param:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(p: Param, x: torch.Tensor, eps: float = 1e-6, split: bool = False) -> torch.Tensor:
    """Gemma-style RMSNorm: weight is (1 + scale), computed in f32.
    ``split``: ``x`` is this rank's slice of the normed dim, split over the
    ``model`` group; the mean square is the group's (the partial sums of
    squares all-reduced, their gradient too) and ``scale`` is whole."""
    xf = x.float()
    scale = p["scale"]
    if split:
        n = xf.shape[-1]
        sq = reduce_from_group(torch.sum(xf * xf, dim=-1, keepdim=True))
        var = copy_to_group(sq) / (n * model_size())
        scale = group_slice(scale, n)
    else:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32,
                   device="cpu") -> Param:
    return {"emb": _normal(gen, (vocab, d), 0.02, dtype, device)}


def _vocab_lo(p: Param) -> int:
    return current_mesh().axis_index("model") * p["emb"].shape[0]


def embed(p: Param, tokens: torch.Tensor, scale_by_sqrt_dim: bool = False,
          vocab_split: bool = False) -> torch.Tensor:
    """Token embeddings; ``vocab_split``: this rank holds rows
    ``[r V/M, (r+1) V/M)`` of ``emb``, looks up the tokens among them and
    the group sums (one rank contributes each token)."""
    if vocab_split:
        rows = p["emb"].shape[0]
        t = tokens.long() - _vocab_lo(p)
        mine = (t >= 0) & (t < rows)
        x = F.embedding(t.clamp(0, rows - 1), p["emb"]).masked_fill(~mine[..., None], 0)
        x = reduce_from_group(x)
    else:
        x = F.embedding(tokens, p["emb"])
    if scale_by_sqrt_dim:
        x = x * torch.tensor(math.sqrt(p["emb"].shape[1]), dtype=x.dtype, device=x.device)
    return x


def unembed(p: Param, x: torch.Tensor, vocab_split: bool = False) -> torch.Tensor:
    """logits = x @ E^T -- the LM head is an NT op over (vocab, d); under
    ``vocab_split`` this rank's slice of the vocabulary."""
    return dispatch("NT", copy_to_group(x) if vocab_split else x, p["emb"])


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    c = torch.tensor(cap, dtype=x.dtype, device=x.device)
    return c * torch.tanh(x / c)


def init_gated_mlp(gen: torch.Generator, d: int, d_ff: int, dtype=torch.float32,
                   device="cpu") -> Param:
    return {
        "gate": init_dense(gen, d_ff, d, dtype, device),
        "up": init_dense(gen, d_ff, d, dtype, device),
        "down": init_dense(gen, d, d_ff, dtype, device),
    }


def _act(g: torch.Tensor, activation: str) -> torch.Tensor:
    return F.gelu(g, approximate="tanh") if activation == "gelu" else F.silu(g)


def gated_mlp(p: Param, x: torch.Tensor, activation: str = "gelu",
              d_ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU/GeGLU MLP: three NT matmuls.  Under a ``model`` axis gate
    and up split the hidden dim and down sums its partial outputs
    (``dense_tp``).  ``d_ff`` is the hidden dim of the full weights; it
    defaults to the weights' own, which are whole off a ``model`` axis."""
    d = x.shape[-1]
    d_ff = p["gate"]["w"].shape[0] if d_ff is None else d_ff
    wg, wu = weight_dim(("gate", "w"), (d_ff, d)), weight_dim(("up", "w"), (d_ff, d))
    xc = copy_to_group(x) if 0 in (wg, wu) else x
    g, g_split = dense_tp(p["gate"], xc if wg == 0 else x, wg, copied=True)
    u, u_split = dense_tp(p["up"], xc if wu == 0 else x, wu, copied=True)
    if g_split != u_split:  # one whole, one split: both whole
        g = gather_from_group(g) if g_split else g
        u = gather_from_group(u) if u_split else u
        g_split = False
    y, y_split = dense_tp(p["down"], _act(g, activation) * u,
                          weight_dim(("down", "w"), (d, d_ff)), x_split=g_split)
    return gather_from_group(y) if y_split else y


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    z_loss: float = 0.0,
    vocab_split: bool = False,
) -> torch.Tensor:
    """Mean next-token CE in f32; ``mask`` zeroes ignored positions.
    ``vocab_split``: ``logits`` is this rank's slice of the vocabulary;
    the log-partition is built from all-reduces of each position's max
    and sum of exponentials, the gold logit from its owner's slice."""
    logits = logits.float()
    if vocab_split:
        cols = logits.shape[-1]
        lo = current_mesh().axis_index("model") * cols
        mx = all_reduce(logits.detach().amax(dim=-1), "model", op="max")
        logz = torch.log(reduce_from_group(torch.exp(logits - mx[..., None]).sum(dim=-1))) + mx
        t = labels.long() - lo
        mine = (t >= 0) & (t < cols)
        gold = torch.gather(logits, -1, t.clamp(0, cols - 1)[..., None])[..., 0]
        gold = reduce_from_group(gold.masked_fill(~mine, 0))
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if z_loss:
        nll = nll + z_loss * torch.square(logz)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
