"""The benchmark's frozen yardstick of work: model FLOPs from shapes, the
roofline bound of one GEMM from its OpKey fields, and the H100 datasheet
peaks they are measured against.

These are copies of the counting rules of the port's own
``launch/accounting.py`` and ``core/hardware.py`` (bf16 989 TF/s, f32 67
TF/s outside the tensor cores, HBM 3.35 TB/s; NVIDIA's data sheet, SXM
part at 700 W), kept here so that a change to the program cannot move
the yardstick.  Nothing here imports the program.

Rules:
  * a GEMM of (g, m, n, k) performs 2 g m n k FLOPs; its bound counts
    each operand byte read once and the result written once;
  * the model FLOPs of a step count every matrix product the model
    needs once (forward, and for training the backward's two products,
    the first layer's input gradient excluded where the input needs
    none), never a recompute;
  * causal attention counts the visible query-key pairs only (about
    half of the square), a sliding window fewer.
"""

from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA H100 SXM data sheet, dense rates, 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

_DSIZE_DTYPE = {2: "bfloat16", 4: "float32"}

__all__ = [
    "PEAK_FLOPS",
    "HBM_BYTES_PER_S",
    "peak_flops",
    "gemm_flops",
    "gemm_bytes",
    "gemm_bound_s",
    "visible_pairs",
    "fcn_train_step_flops",
    "lm_layer_matmul_params",
    "lm_train_step_flops",
    "lm_prefill_flops",
    "lm_decode_token_flops",
]


def peak_flops(dtype: str) -> float:
    """The datasheet peak for ``dtype`` (a torch dtype name)."""
    return PEAK_FLOPS[dtype]


def gemm_flops(m: int, n: int, k: int, g: int = 1) -> float:
    return 2.0 * g * m * n * k


def gemm_bytes(m: int, n: int, k: int, dsize: int, g: int = 1) -> float:
    """Operands read once and the result written once: g (mk + kn + mn)
    elements of ``dsize`` bytes."""
    return float(dsize) * g * (m * k + k * n + m * n)


def gemm_bound_s(m: int, n: int, k: int, dsize: int, g: int = 1) -> float:
    """The least time the card could take for one GEMM: the larger of its
    FLOPs over the dtype's peak and its bytes over HBM bandwidth.  The
    same for every candidate that computes it (a TNN's transpose is no
    extra work)."""
    peak = PEAK_FLOPS[_DSIZE_DTYPE[dsize]]
    return max(gemm_flops(m, n, k, g) / peak, gemm_bytes(m, n, k, dsize, g) / HBM_BYTES_PER_S)


def visible_pairs(s: int, window: int = 0, start: int = 0) -> int:
    """Query-key pairs a causal mask leaves visible for queries at
    positions ``start .. start + s - 1`` over keys from 0: query ``q``
    sees ``q + 1`` keys, at most ``window`` of them when one is set."""
    total = 0
    lo, hi = start, start + s
    if not window:
        return (hi * (hi + 1) - lo * (lo + 1)) // 2
    # queries below the window see q + 1 keys, the rest see window keys
    cut = min(max(window - 1, lo), hi)  # first query that sees `window`
    total += (cut * (cut + 1) - lo * (lo + 1)) // 2
    total += (hi - cut) * window
    return total


def fcn_train_step_flops(dims: Sequence[int], batch: int) -> float:
    """One training step of a fully connected net of widths ``dims``:
    every layer's forward and weight gradient, and the input gradient of
    every layer but the first (the data needs none)."""
    per_layer = [gemm_flops(batch, dims[i + 1], dims[i]) for i in range(len(dims) - 1)]
    return 2 * sum(per_layer) + sum(per_layer[1:])


def lm_layer_matmul_params(cfg: Dict) -> Dict[str, int]:
    """Weights that enter a matrix product, per decoder layer and in the
    head, from a configuration file's keys."""
    d = cfg["hidden_size"]
    qw = cfg["num_attention_heads"] * cfg["head_dim"]
    kw = cfg["num_key_value_heads"] * cfg["head_dim"]
    attn = d * qw + 2 * d * kw + qw * d
    mlp = 3 * d * cfg["intermediate_size"]
    return {"layer": attn + mlp, "head": cfg["vocab_size"] * d}


def _attn_width(cfg: Dict) -> int:
    return cfg["num_attention_heads"] * cfg["head_dim"]


def lm_train_step_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step of ``batch`` sequences of ``seq``
    tokens: 6 per weight per token in the layers and the head, and the
    two attention products at the visible pairs, forward and backward
    (3x).  No recompute."""
    w = lm_layer_matmul_params(cfg)
    layers = cfg["num_hidden_layers"]
    dense = 6.0 * (layers * w["layer"] + w["head"]) * batch * seq
    pairs = visible_pairs(seq, cfg.get("sliding_window") or 0)
    attn = 3 * 4.0 * _attn_width(cfg) * pairs * layers * batch
    return dense + attn


def lm_prefill_flops(cfg: Dict, prompt_len: int) -> float:
    """A prefill of ``prompt_len`` real tokens: the layers at every
    position, the head at the last one only, and causal attention."""
    w = lm_layer_matmul_params(cfg)
    layers = cfg["num_hidden_layers"]
    pairs = visible_pairs(prompt_len, cfg.get("sliding_window") or 0)
    return (2.0 * layers * w["layer"] * prompt_len + 2.0 * w["head"]
            + 4.0 * _attn_width(cfg) * pairs * layers)


def lm_decode_token_flops(cfg: Dict, keys: int) -> float:
    """One decoded token that attends ``keys`` cached positions (itself
    included): the layers, the head, and attention over those keys."""
    w = lm_layer_matmul_params(cfg)
    layers = cfg["num_hidden_layers"]
    window = cfg.get("sliding_window") or 0
    seen = min(keys, window) if window else keys
    return 2.0 * (layers * w["layer"] + w["head"]) + 4.0 * _attn_width(cfg) * seen * layers
