"""Residual blocks: a pre-normed mixer (attention, Mamba-2 SSD, or
Zamba-style *shared* attention whose weights live in the model-level
``shared`` slot) and an optional pre-normed FFN (gated MLP or MoE), with
optional post-norms (Gemma-2/3).  Layer params stack along a leading
axis (the JAX package's scan layout); ``lm.py`` loops over it.  The
model's ``residual_mult`` scales the mixer's and the FFN's outputs
before each residual add, and ``rms_eps`` is the epsilon of the blocks'
norms and the Mamba gated norm (``configs/arch.py``; the QK-norms keep
1e-6).
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
from .moe import init_moe, moe_layer
from .ssm import init_ssm, init_ssm_cache, ssm_decode, ssm_layer

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
    mixer: str  # 'attn' | 'mamba' | 'shared_attn'
    ffn: str = "mlp"  # 'mlp' | 'moe' | 'none'
    window: Optional[int] = None  # sliding window for attn mixers


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
        sp_attention=mc.sp_attention,
        rope=mc.attn_rope,
        q_scale=mc.attn_scale,
    )


def init_block(gen: torch.Generator, b: BlockCfg, mc, dtype=torch.float32,
               device="cpu") -> Param:
    """mc: the ArchConfig."""
    p: Param = {"ln1": init_rmsnorm(mc.d_model, dtype, device)}
    if b.mixer == "attn":
        p["attn"] = init_attention(gen, _attn_cfg(b, mc), dtype, device)
    elif b.mixer == "mamba":
        p["ssm"] = init_ssm(gen, mc.ssm, dtype, device)
    elif b.mixer != "shared_attn":  # shared attention's weights live in lm's 'shared'
        raise ValueError(f"unknown mixer {b.mixer!r}")
    if mc.post_norm:
        p["ln1b"] = init_rmsnorm(mc.d_model, dtype, device)
    if b.ffn != "none":
        p["ln2"] = init_rmsnorm(mc.d_model, dtype, device)
        if b.ffn == "mlp":
            p["mlp"] = init_gated_mlp(gen, mc.d_model, mc.d_ff, dtype, device)
        elif b.ffn == "moe":
            p["moe"] = init_moe(gen, mc.moe, dtype, device)
        else:
            raise ValueError(f"unknown ffn {b.ffn!r}")
        if mc.post_norm:
            p["ln2b"] = init_rmsnorm(mc.d_model, dtype, device)
    return p


def _add(x: torch.Tensor, h: torch.Tensor, mc) -> torch.Tensor:
    return x + h if mc.residual_mult == 1.0 else x + mc.residual_mult * h


def _ffn(p: Param, x: torch.Tensor, b: BlockCfg, mc) -> torch.Tensor:
    if b.ffn == "none":
        return x
    h = rmsnorm(p["ln2"], x, eps=mc.rms_eps)
    h = (gated_mlp(p["mlp"], h, mc.activation, d_ff=mc.d_ff) if b.ffn == "mlp"
         else moe_layer(p["moe"], h, mc.moe))
    if mc.post_norm:
        h = rmsnorm(p["ln2b"], h, eps=mc.rms_eps)
    return _add(x, h, mc)


def _residual(p: Param, x: torch.Tensor, h: torch.Tensor, mc) -> torch.Tensor:
    if mc.post_norm:
        h = rmsnorm(p["ln1b"], h, eps=mc.rms_eps)
    return _add(x, h, mc)


def _attn_params(p: Param, b: BlockCfg, shared: Optional[Param]) -> Param:
    return p["attn"] if b.mixer == "attn" else shared["attn"]


def apply_block(p: Param, x: torch.Tensor, b: BlockCfg, mc, shared: Optional[Param] = None,
                positions=None, prefix_len: int = 0) -> torch.Tensor:
    h = rmsnorm(p["ln1"], x, eps=mc.rms_eps)
    if b.mixer == "mamba":
        h = ssm_layer(p["ssm"], h, mc.ssm, eps=mc.rms_eps)
    else:
        h = attention(_attn_params(p, b, shared), h, _attn_cfg(b, mc), positions, prefix_len)
    return _ffn(p, _residual(p, x, h, mc), b, mc)


def prefill_block(
    p: Param,
    x: torch.Tensor,
    b: BlockCfg,
    mc,
    max_seq: int,
    shared: Optional[Param] = None,
    positions=None,
    prefix_len: int = 0,
    cache_dtype=torch.bfloat16,
    true_len=None,
):
    """apply_block + build this layer's decode cache.

    ``true_len`` marks a right-padded prefill (see ``attention``): the
    attention cache is built over the real positions only.  SSM state is
    cumulative over the whole padded sequence, so padded prefill is an
    attention-only feature: the serving engine prefills SSM archs at exact
    lengths."""
    h = rmsnorm(p["ln1"], x, eps=mc.rms_eps)
    if b.mixer == "mamba":
        h, cache = ssm_layer(p["ssm"], h, mc.ssm, return_state=True, cache_dtype=cache_dtype,
                             eps=mc.rms_eps)
    else:
        h, cache = attention(
            _attn_params(p, b, shared), h, _attn_cfg(b, mc), positions, prefix_len,
            return_kv=True, max_seq=max_seq, cache_dtype=cache_dtype, true_len=true_len,
        )
    return _ffn(p, _residual(p, x, h, mc), b, mc), cache


# -- decode -------------------------------------------------------------------


def init_block_cache(b: BlockCfg, mc, batch: int, max_seq: int, dtype=torch.bfloat16,
                     device="cpu"):
    if b.mixer == "mamba":
        return init_ssm_cache(batch, mc.ssm, dtype, device)
    return init_attn_cache(batch, _attn_cfg(b, mc), max_seq, dtype, device)


def decode_block(p: Param, x: torch.Tensor, b: BlockCfg, mc, cache, pos,
                 shared: Optional[Param] = None, cspec=None):
    """One decode step of one block.  An attention cache is updated in
    place and returned; a Mamba block returns a new ``{"conv", "ssm"}``
    cache, which the caller writes back.  ``cspec``, the spec of its
    ``k`` leaf: see ``attention_decode``."""
    h = rmsnorm(p["ln1"], x, eps=mc.rms_eps)
    if b.mixer == "mamba":
        h, cache = ssm_decode(p["ssm"], h, mc.ssm, cache, eps=mc.rms_eps)
    else:
        h, cache = attention_decode(_attn_params(p, b, shared), h, _attn_cfg(b, mc), cache, pos,
                                    cspec=cspec)
    return _ffn(p, _residual(p, x, h, mc), b, mc), cache
