"""The work of granite-4.0-h-small (``granitemoehybrid``) from a
configuration file's keys, by the rules of ``cellbench/flops``: model
FLOPs count every matrix product the model needs once; causal
attention counts the visible query-key pairs; a GEMM's bound counts
each operand byte read once and its result written once.

Model FLOPs of one token through the layers: the Mamba layers'
projections (z, x, B, C and dt in, ``out_proj`` out) and their SSD at
its linear-time least (the state update and the read-out, 4 H P N a
token), the attention layers' projections, every layer's router, its
``num_experts_per_tok`` routed experts and its shared expert; the head
at the positions whose logits are taken.  The conv and the elementwise
work are not counted.

The routed experts' grouped GEMMs (gate and up over the rows, down
after them), for a call of ``rows`` token-expert rows spread over
``experts`` experts: each expert touched reads its three weights once.
"""

from __future__ import annotations

from typing import Dict

from . import HBM_BYTES_PER_S, PEAK_FLOPS, visible_pairs

__all__ = ["token_flops", "head_flops", "attention_layers", "prefill_flops",
           "decode_token_flops", "expert_flops", "expert_bytes", "expert_bound_s"]

_DSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def attention_layers(cfg: Dict) -> int:
    return sum(1 for k in cfg["layer_types"] if k == "attention")


def _attn_width(cfg: Dict) -> int:
    return cfg["hidden_size"]  # heads x (hidden / heads)


def token_flops(cfg: Dict) -> float:
    """One token through every layer, attention's query-key work apart."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    di = cfg["mamba_expand"] * d
    N, H, P = cfg["mamba_d_state"], cfg["mamba_n_heads"], cfg["mamba_d_head"]
    kv = cfg["num_key_value_heads"] * d // cfg["num_attention_heads"]
    mamba = 2.0 * d * (2 * di + 2 * N + H) + 2.0 * di * d + 4.0 * H * P * N
    attn = 2.0 * d * (d + 2 * kv) + 2.0 * d * d
    ffn = (2.0 * d * cfg["num_local_experts"]
           + 6.0 * d * f * cfg["num_experts_per_tok"]
           + 6.0 * d * cfg["shared_intermediate_size"])
    n_attn = attention_layers(cfg)
    n_mamba = cfg["num_hidden_layers"] - n_attn
    return n_mamba * mamba + n_attn * attn + cfg["num_hidden_layers"] * ffn


def head_flops(cfg: Dict) -> float:
    return 2.0 * cfg["vocab_size"] * cfg["hidden_size"]


def prefill_flops(cfg: Dict, prompt_len: int) -> float:
    """A prefill of ``prompt_len`` tokens: the layers at every position,
    the head at the last one, and causal attention."""
    return (token_flops(cfg) * prompt_len + head_flops(cfg)
            + 4.0 * _attn_width(cfg) * visible_pairs(prompt_len) * attention_layers(cfg))


def decode_token_flops(cfg: Dict, keys: int) -> float:
    """One decoded token that attends ``keys`` cached positions (itself
    included)."""
    return (token_flops(cfg) + head_flops(cfg)
            + 4.0 * _attn_width(cfg) * keys * attention_layers(cfg))


def expert_flops(cfg: Dict, rows: int) -> float:
    """The grouped GEMMs of ``rows`` token-expert rows: gate, up, down."""
    return 6.0 * rows * cfg["hidden_size"] * cfg["intermediate_size"]


def expert_bytes(cfg: Dict, rows: int, experts: int) -> float:
    """Their operands read once and results written once: per GEMM the
    rows in, the touched experts' weights, the rows out."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    per = 3.0 * experts * d * f + 3.0 * rows * d + 3.0 * rows * f
    return _DSIZE[cfg["torch_dtype"]] * per


def expert_bound_s(cfg: Dict, rows: int, experts: int) -> float:
    """The least time the card could take for one call's grouped GEMMs."""
    return max(expert_flops(cfg, rows) / PEAK_FLOPS[cfg["torch_dtype"]],
               expert_bytes(cfg, rows, experts) / HBM_BYTES_PER_S)
