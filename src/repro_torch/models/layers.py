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
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.engine import dispatch

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


def init_rmsnorm(d: int, dtype=torch.float32, device="cpu") -> Param:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(p: Param, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm: weight is (1 + scale), computed in f32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (1.0 + p["scale"].float())).to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32,
                   device="cpu") -> Param:
    return {"emb": _normal(gen, (vocab, d), 0.02, dtype, device)}


def embed(p: Param, tokens: torch.Tensor, scale_by_sqrt_dim: bool = False) -> torch.Tensor:
    x = F.embedding(tokens, p["emb"])
    if scale_by_sqrt_dim:
        x = x * torch.tensor(math.sqrt(p["emb"].shape[1]), dtype=x.dtype, device=x.device)
    return x


def unembed(p: Param, x: torch.Tensor) -> torch.Tensor:
    """logits = x @ E^T -- the LM head is an NT op over (vocab, d)."""
    return dispatch("NT", x, p["emb"])


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


def gated_mlp(p: Param, x: torch.Tensor, activation: str = "gelu") -> torch.Tensor:
    """SwiGLU/GeGLU MLP: three NT matmuls."""
    g = dense(p["gate"], x)
    act = F.gelu(g, approximate="tanh") if activation == "gelu" else F.silu(g)
    h = act * dense(p["up"], x)
    return dense(p["down"], h)


def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Mean next-token CE in f32; ``mask`` zeroes ignored positions."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if z_loss:
        nll = nll + z_loss * torch.square(logz)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
