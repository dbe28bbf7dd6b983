"""Residual blocks: a pre-normed mixer + a pre-normed FFN, with optional
post-norms.  This slice ports the attention mixer with the gated MLP
(``BlockCfg("attn", "mlp")``, windowed or not); the Mamba-2 and shared
attention mixers and the MoE FFN raise ``NotImplementedError`` (ROADMAP
queue A, "MoE and SSM").  Layer params stack along a leading axis (the
JAX package's scan layout); ``lm.py`` loops over it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .attention import (
    AttnConfig,
    attention,
    attention_decode,
    init_attention,
    init_attn_cache,
)
from .layers import Param, gated_mlp, init_gated_mlp, init_rmsnorm, rmsnorm

__all__ = [
    "BlockCfg",
    "init_block",
    "apply_block",
    "prefill_block",
    "decode_block",
    "init_block_cache",
]


@dataclass(frozen=True)
class BlockCfg:
    mixer: str  # 'attn' (this slice) | 'mamba' | 'shared_attn'
    ffn: str = "mlp"  # 'mlp' (this slice) | 'moe' | 'none'
    window: Optional[int] = None  # sliding window for attn mixers


def check_block(b: BlockCfg) -> None:
    if b.mixer != "attn" or b.ffn != "mlp":
        raise NotImplementedError(
            f"block {b} is not ported: this slice runs BlockCfg('attn', 'mlp') "
            "only (ROADMAP.md queue A, 'MoE and SSM')"
        )


def _attn_cfg(b: BlockCfg, mc) -> AttnConfig:
    return AttnConfig(
        d_model=mc.d_model,
        n_heads=mc.n_heads,
        n_kv=mc.n_kv,
        d_head=mc.d_head,
        window=b.window,
        softcap=mc.attn_softcap,
        rope_theta=mc.rope_theta,
        qk_norm=mc.qk_norm,
        chunk=mc.attn_chunk,
    )


def init_block(gen: torch.Generator, b: BlockCfg, mc, dtype=torch.float32,
               device="cpu") -> Param:
    """mc: the ArchConfig."""
    check_block(b)
    p: Param = {"ln1": init_rmsnorm(mc.d_model, dtype, device)}
    p["attn"] = init_attention(gen, _attn_cfg(b, mc), dtype, device)
    if mc.post_norm:
        p["ln1b"] = init_rmsnorm(mc.d_model, dtype, device)
    p["ln2"] = init_rmsnorm(mc.d_model, dtype, device)
    p["mlp"] = init_gated_mlp(gen, mc.d_model, mc.d_ff, dtype, device)
    if mc.post_norm:
        p["ln2b"] = init_rmsnorm(mc.d_model, dtype, device)
    return p


def _ffn(p: Param, x: torch.Tensor, mc) -> torch.Tensor:
    h = gated_mlp(p["mlp"], rmsnorm(p["ln2"], x), mc.activation)
    if mc.post_norm:
        h = rmsnorm(p["ln2b"], h)
    return x + h


def _residual(p: Param, x: torch.Tensor, h: torch.Tensor, mc) -> torch.Tensor:
    if mc.post_norm:
        h = rmsnorm(p["ln1b"], h)
    return x + h


def apply_block(p: Param, x: torch.Tensor, b: BlockCfg, mc, positions=None,
                prefix_len: int = 0) -> torch.Tensor:
    check_block(b)
    h = attention(p["attn"], rmsnorm(p["ln1"], x), _attn_cfg(b, mc), positions, prefix_len)
    return _ffn(p, _residual(p, x, h, mc), mc)


def prefill_block(
    p: Param,
    x: torch.Tensor,
    b: BlockCfg,
    mc,
    max_seq: int,
    positions=None,
    prefix_len: int = 0,
    cache_dtype=torch.bfloat16,
    true_len=None,
):
    """apply_block + build this layer's decode cache (``true_len`` marks a
    right-padded prefill, see ``attention``)."""
    check_block(b)
    h, cache = attention(
        p["attn"], rmsnorm(p["ln1"], x), _attn_cfg(b, mc), positions, prefix_len,
        return_kv=True, max_seq=max_seq, cache_dtype=cache_dtype, true_len=true_len,
    )
    return _ffn(p, _residual(p, x, h, mc), mc), cache


# -- decode -------------------------------------------------------------------


def init_block_cache(b: BlockCfg, mc, batch: int, max_seq: int, dtype=torch.bfloat16,
                     device="cpu"):
    check_block(b)
    return init_attn_cache(batch, _attn_cfg(b, mc), max_seq, dtype, device)


def decode_block(p: Param, x: torch.Tensor, b: BlockCfg, mc, cache, pos):
    """One decode step of one block; the cache is updated in place."""
    check_block(b)
    h, cache = attention_decode(p["attn"], rmsnorm(p["ln1"], x), _attn_cfg(b, mc), cache, pos)
    return _ffn(p, _residual(p, x, h, mc), mc), cache
