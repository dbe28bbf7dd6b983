"""Plain reference of a dense decoder LM of the Llama/Mistral kind, as the
H2O-Danube3 family describes it (arXiv:2407.09276): token embedding;
per layer a pre-normed grouped-query attention with rotary positions
(half-rotation convention) under a causal mask and a sliding window,
and a pre-normed SiLU-gated MLP, each added to the residual; a final
RMSNorm and logits through the head, or through the embedding where
the configuration ties them.

Departures from the published description, each as the port's
configuration states it (the configuration file's ``assumed``): the
RMSNorm weight is stored as ``scale`` and applied as ``1 + scale``
(zero at initialisation, so weight decay pulls it to 1); its epsilon is
``rms_norm_eps``.

Parameters are a flat dict in float32: ``embed`` (V, d), ``final_norm``
(d,), ``lm_head`` (V, d) where the head is untied, and per layer, stacked on a leading axis, ``ln1`` (L, d), ``wq``
(L, H dh, d), ``wk`` and ``wv`` (L, KV dh, d), ``wo`` (L, d, H dh),
``ln2`` (L, d), ``gate`` and ``up`` (L, ff, d), ``down`` (L, d, ff).
Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .numerics import linear, mm

__all__ = ["LEAVES", "forward", "loss"]

LEAVES = ("embed", "final_norm", "ln1", "wq", "wk", "wv", "wo", "ln2", "gate", "up", "down")


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, heads, dh), pos: (S,)."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh)
    ang = pos.float()[:, None] * inv  # (S, dh/2)
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p: Dict, i: int, h: torch.Tensor, cfg: Dict, pos: torch.Tensor,
               precision: str) -> torch.Tensor:
    B, S, _ = h.shape
    H, KV, dh = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    q = _rope(linear(h, p["wq"][i], precision).reshape(B, S, H, dh), pos, cfg["rope_theta"])
    k = _rope(linear(h, p["wk"][i], precision).reshape(B, S, KV, dh), pos, cfg["rope_theta"])
    v = linear(h, p["wv"][i], precision).reshape(B, S, KV, dh)
    # query head j reads kv head j // (H / KV)
    k = k.repeat_interleave(H // KV, dim=2).transpose(1, 2)  # (B, H, S, dh)
    v = v.repeat_interleave(H // KV, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    scores = mm(q, k.transpose(-1, -2), precision) * dh ** -0.5  # (B, H, S, S)
    qp, kp = pos[:, None], pos[None, :]
    visible = kp <= qp
    window = cfg.get("sliding_window") or 0
    if window:
        visible = visible & (kp > qp - window)
    probs = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
    del scores
    out = mm(probs, v, precision).transpose(1, 2).reshape(B, S, H * dh)
    return linear(out, p["wo"][i], precision)


def _mlp(p: Dict, i: int, h: torch.Tensor, precision: str) -> torch.Tensor:
    g = linear(h, p["gate"][i], precision)
    u = linear(h, p["up"][i], precision)
    return linear(F.silu(g) * u, p["down"][i], precision)


def forward(params: Dict[str, torch.Tensor], cfg: Dict, tokens: torch.Tensor,
            precision: str = "f32", at: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits (B, S, V) of ``tokens`` (B, S) at positions 0 .. S-1, or
    (B, len(at), V) at the positions ``at`` only."""
    eps = cfg["rms_norm_eps"]
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    x = F.embedding(tokens.long(), params["embed"])
    # one unbind per stacked leaf: its backward stacks the layers' gradients at once
    layers = {k: params[k].unbind(0) for k in LEAVES[2:]}
    for i in range(cfg["num_hidden_layers"]):
        x = x + _attention(layers, i, _rmsnorm(x, layers["ln1"][i], eps), cfg, pos, precision)
        x = x + _mlp(layers, i, _rmsnorm(x, layers["ln2"][i], eps), precision)
    if at is not None:
        x = x[:, at]
    x = _rmsnorm(x, params["final_norm"], eps)
    head = params["embed"] if cfg["tie_word_embeddings"] else params["lm_head"]
    return linear(x, head, precision)


def loss(params: Dict[str, torch.Tensor], cfg: Dict, batch: Dict,
         precision: str = "f32") -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch["tokens"]`` against
    ``batch["labels"]``."""
    logits = forward(params, cfg, batch["tokens"], precision)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), batch["labels"].reshape(-1).long())
