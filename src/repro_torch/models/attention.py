"""Grouped-query attention with RoPE, sliding windows, logit soft-capping,
QK-norm and prefix-LM masking.

Prefill uses the statically-chunked causal schedule of the JAX package: a
loop over query chunks where chunk ``i`` attends the key prefix
``[start_i, (i+1)*chunk)``.  Torch runs the chunks in order, so no
barrier between them is needed.

The whole ``softmax(mask(Q K^T)) V`` subgraph routes through
``core.dispatch_attention``: the scoped policy picks the fused kernel or
the unfused plan.  The leading ``(batch, kv)`` axes collapse to the
OpKey's batch extent ``g`` and the GQA group folds into the per-slice
query extent (declared with ``q_seg``), so K/V are never materialised at
``n_heads`` width.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.engine import dispatch_attention

from .layers import Param, dense, init_dense, init_rmsnorm, rmsnorm
from .rope import apply_rope

__all__ = [
    "AttnConfig",
    "init_attention",
    "attention",
    "attention_decode",
    "init_attn_cache",
]


@dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    window: Optional[int] = None  # None => global attention
    softcap: float = 0.0
    rope_theta: float = 10000.0
    qk_norm: bool = False
    chunk: int = 1024  # query-chunk length for the blocked schedule

    @property
    def group(self) -> int:
        assert self.n_heads % self.n_kv == 0
        return self.n_heads // self.n_kv


def init_attention(gen: torch.Generator, cfg: AttnConfig, dtype=torch.float32,
                   device="cpu") -> Param:
    p = {
        "wq": init_dense(gen, cfg.n_heads * cfg.d_head, cfg.d_model, dtype, device),
        "wk": init_dense(gen, cfg.n_kv * cfg.d_head, cfg.d_model, dtype, device),
        "wv": init_dense(gen, cfg.n_kv * cfg.d_head, cfg.d_model, dtype, device),
        "wo": init_dense(gen, cfg.d_model, cfg.n_heads * cfg.d_head, dtype, device),
    }
    if cfg.qk_norm:
        p["qn"] = init_rmsnorm(cfg.d_head, dtype, device)
        p["kn"] = init_rmsnorm(cfg.d_head, dtype, device)
    return p


def _project_qkv(
    p: Param, x: torch.Tensor, cfg: AttnConfig, positions: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x:(B,S,d) -> q:(B,S,kv,g,dh), k/v:(B,S,kv,dh), RoPE'd and normed."""
    B, S, _ = x.shape
    q = dense(p["wq"], x).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = dense(p["wk"], x).reshape(B, S, cfg.n_kv, cfg.d_head)
    v = dense(p["wv"], x).reshape(B, S, cfg.n_kv, cfg.d_head)
    if cfg.qk_norm:
        q = rmsnorm(p["qn"], q)
        k = rmsnorm(p["kn"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = q.reshape(B, S, cfg.n_kv, cfg.group, cfg.d_head)
    return q, k, v


def _chunk_attend(
    q_chunk: torch.Tensor,  # (B, C, kv, g, dh) already scaled
    k_slab: torch.Tensor,  # (B, L, kv, dh)
    v_slab: torch.Tensor,  # (B, L, kv, dh)
    cfg: AttnConfig,
    q_lo: int,  # absolute position of this chunk's first query
    k_lo: int,  # absolute position of the slab's first key
    prefix_len: int,
) -> torch.Tensor:
    """One query chunk's attention as a policy-dispatched plan.  The GQA
    group folds into the per-slice query extent (m = g*C); ``q_seg=C``
    puts row ``r`` of a slice at position ``q_lo + r % C``."""
    B, C, kv, g, dh = q_chunk.shape
    L = k_slab.shape[1]
    q2 = q_chunk.permute(0, 2, 3, 1, 4).reshape(B * kv, g * C, dh)
    k2 = k_slab.transpose(1, 2).reshape(B * kv, L, dh)
    v2 = v_slab.transpose(1, 2).reshape(B * kv, L, dh)
    out = dispatch_attention(
        q2, k2, v2,
        causal=True,
        window=cfg.window or 0,
        q_start=q_lo,
        k_start=k_lo,
        prefix_len=prefix_len,
        q_seg=C,
        softcap=cfg.softcap,
    )
    out = out.reshape(B, kv, g, C, dh)
    return out.permute(0, 3, 1, 2, 4)  # (B, C, kv, g, dh)


def attention(
    p: Param,
    x: torch.Tensor,
    cfg: AttnConfig,
    positions: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
    return_kv: bool = False,
    max_seq: Optional[int] = None,
    cache_dtype=torch.bfloat16,
    true_len=None,
):
    """Prefill attention.  x: (B, S, d_model) -> (B, S, d_model).

    With ``return_kv`` also returns a decode cache covering this prefill
    (ring-ordered for windowed layers; padded to ``max_seq`` for global).
    ``true_len`` (int or ``(B,)`` tensor) marks a right-padded prefill:
    only the first ``true_len`` positions of each row are real tokens, and
    the windowed ring holds the last ``window`` real positions."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    q = q * (cfg.d_head**-0.5)

    chunk = min(cfg.chunk, S)
    if S % chunk != 0:  # ragged tail: single chunk
        chunk = S
    outs = []
    for i in range(S // chunk):
        q_lo, q_hi = i * chunk, (i + 1) * chunk
        if cfg.window is not None:
            # earliest key any query in this chunk may see, block-aligned
            lo = max(0, ((q_lo - cfg.window + 1) // chunk) * chunk)
        else:
            lo = 0
        if prefix_len > 0:
            lo = 0  # prefix keys always visible
        outs.append(_chunk_attend(
            q[:, q_lo:q_hi], k[:, lo:q_hi], v[:, lo:q_hi], cfg, q_lo, lo, prefix_len
        ))
    out = torch.cat(outs, dim=1).reshape(B, S, cfg.n_heads * cfg.d_head)
    out = dense(p["wo"], out)
    if not return_kv:
        return out
    max_seq = max_seq or S
    slots = min(cfg.window, max_seq) if cfg.window is not None else max_seq
    if cfg.window is not None and (true_len is not None or S >= slots):
        # Ring order: slot i holds the newest position p < true_len with
        # p = i (mod slots); slots with no such position gather junk that
        # the decode validity mask excludes.
        tl = torch.as_tensor(S if true_len is None else true_len, device=x.device)
        tl_b = tl.reshape(-1).expand(B)[:, None].long()  # (B, 1)
        i = torch.arange(slots, device=x.device)[None, :]
        src = (tl_b - 1 - ((tl_b - 1 - i) % slots)).clamp(0, S - 1)  # (B, slots)
        rows = torch.arange(B, device=x.device)[:, None]
        ck, cv = k[rows, src], v[rows, src]
    else:
        pad = (0, 0, 0, 0, 0, slots - S)
        ck, cv = F.pad(k, pad), F.pad(v, pad)
    return out, {"k": ck.to(cache_dtype), "v": cv.to(cache_dtype)}


# -- decode (one new token against a cache) ----------------------------------


def init_attn_cache(batch: int, cfg: AttnConfig, max_seq: int, dtype=torch.bfloat16,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """Ring buffer of ``window`` slots for local layers, else ``max_seq``."""
    slots = min(cfg.window, max_seq) if cfg.window is not None else max_seq
    shape = (batch, slots, cfg.n_kv, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def attention_decode(
    p: Param,
    x: torch.Tensor,  # (B, 1, d_model)
    cfg: AttnConfig,
    cache: Dict[str, torch.Tensor],
    pos,  # int / scalar tensor, or (B,) per-sequence positions
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  ``pos`` is the index of each row's new token.

    Each row writes its K/V at its own position -- in place, with
    ``index_copy_`` into the cache tensors (the JAX package returns a new
    cache from donated buffers) -- and attends only the slots its own
    length has filled (per-row ``lengths`` of the attention plan)."""
    B = x.shape[0]
    slots = cache["k"].shape[1]
    pos_b = torch.as_tensor(pos, device=x.device).reshape(-1).expand(B).long()
    q, k_new, v_new = _project_qkv(p, x, cfg, pos_b[:, None])
    q = q * (cfg.d_head**-0.5)

    write = pos_b % slots if cfg.window is not None else pos_b
    flat = torch.arange(B, device=x.device) * slots + write
    for name, new in (("k", k_new), ("v", v_new)):
        c = cache[name]
        c.view(B * slots, cfg.n_kv, cfg.d_head).index_copy_(0, flat, new[:, 0].to(c.dtype))

    lengths = torch.repeat_interleave(torch.clamp(pos_b + 1, max=slots), cfg.n_kv)
    q2 = q.permute(0, 2, 3, 1, 4).reshape(B * cfg.n_kv, cfg.group, cfg.d_head)
    k2 = cache["k"].to(q.dtype).transpose(1, 2).reshape(B * cfg.n_kv, slots, cfg.d_head)
    v2 = cache["v"].to(q.dtype).transpose(1, 2).reshape(B * cfg.n_kv, slots, cfg.d_head)
    out = dispatch_attention(q2, k2, v2, lengths=lengths, softcap=cfg.softcap)
    out = out.reshape(B, 1, cfg.n_heads * cfg.d_head)
    return dense(p["wo"], out), cache
