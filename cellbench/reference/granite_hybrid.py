"""Plain reference of IBM Granite 4.0-H (``granitemoehybrid``), as the
Hugging Face ``GraniteMoeHybrid`` model computes it: the token
embeddings times ``embedding_multiplier``; per layer

  h = x + residual_multiplier * mixer(rmsnorm(x))
  x = h + residual_multiplier * (moe(rmsnorm(h)) + shared_mlp(rmsnorm(h)))

where the mixer is a Mamba-2 layer or grouped-query attention with no
positions (NoPE) by ``layer_types``; a final RMSNorm, and logits through
the tied embedding divided by ``logits_scaling``.

Mamba-2 (one group): ``in_proj`` gives z, xBC and dt; a depthwise causal
conv with a bias and SiLU over x, B and C together; ``dt = softplus(dt +
dt_bias)``, ``A = -exp(A_log)``; the SSD in its quadratic (attention-like)
form over the whole sequence,

  y_t = sum_{s <= t} (C_t . B_s) exp(A (dt_{s+1} + ... + dt_t)) dt_s x_s + D x_t,

computed in blocks of query rows so that it fits; then ``rmsnorm(y *
silu(z))`` over all of d_inner and ``out_proj``.  Attention: scores
``q . k * attention_multiplier`` under a causal mask.  MoE: the router's
logits (in float32), the softmax over each token's top ``k`` of them,
and each expert's SiLU-gated MLP on the tokens routed to it, summed
under those weights; the shared expert is a SiLU-gated MLP of its own
width on every token.

Departures from the published model, each as the configuration file's
``assumed`` states it: every RMSNorm weight is stored as ``scale`` and
applied as ``1 + scale``; ``in_proj`` is stored as its five row blocks
(``wz``, ``wx``, ``wB``, ``wC``, ``wdt``), and each gated MLP's
``input_linear`` as ``gate`` and ``up`` apart, which is the same
product; the router weight is float32.

Parameters: ``embed`` (V, d), ``final_norm`` (d,) and ``layers``, one
dict a layer in order, kept in the program's dtype and upcast to
float32 one layer at a time (the whole model in float32 fits no card).
A Mamba layer's dict: ``ln1``, ``wz``, ``wx``, ``wB``, ``wC``, ``wdt``,
``conv_w`` (d_conv, d_inner + 2N), ``conv_b``, ``A_log``, ``D``,
``dt_bias``, ``norm``, ``out``; an attention layer's: ``ln1``, ``wq``,
``wk``, ``wv``, ``wo``; every layer's: ``ln2``, ``router`` (E, d),
``gate`` and ``up`` (E, f, d), ``down`` (E, d, f), ``shared_gate``,
``shared_up``, ``shared_down``.  Plain PyTorch; imports nothing of the
program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .numerics import linear, mm

__all__ = ["MAMBA_LEAVES", "ATTN_LEAVES", "FFN_LEAVES", "forward", "QUERY_BLOCK"]

MAMBA_LEAVES = ("ln1", "wz", "wx", "wB", "wC", "wdt", "conv_w", "conv_b", "A_log", "D",
                "dt_bias", "norm", "out")
ATTN_LEAVES = ("ln1", "wq", "wk", "wv", "wo")
FFN_LEAVES = ("ln2", "router", "gate", "up", "down", "shared_gate", "shared_up", "shared_down")
QUERY_BLOCK = 256  # query rows a block of the SSD's quadratic form


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * (1.0 + scale)


def _ssd(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bv: torch.Tensor,
         Cv: torch.Tensor, precision: str) -> torch.Tensor:
    """y (S, H, P) of x (S, H, P), dt (S, H), A (H,), B and C (S, N), in
    the quadratic form; the exponents from a float64 running sum."""
    S, H, P = xh.shape
    cum = torch.cumsum(dt.double() * A.double(), dim=0)  # (S, H)
    xdt = (xh * dt[..., None]).permute(1, 0, 2)  # (H, S, P): dt_s x_s
    y = torch.empty_like(xh)
    for lo in range(0, S, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, S)
        cb = mm(Cv[lo:hi], Bv[:hi].t(), precision)  # (q, s)
        expo = cum[lo:hi, None, :] - cum[None, :hi, :]  # (q, s, H)
        visible = torch.arange(lo, hi, device=xh.device)[:, None] >= torch.arange(
            hi, device=xh.device)[None, :]
        expo = expo.masked_fill(~visible[..., None], float("-inf"))
        weights = (torch.exp(expo).float() * cb[..., None]).permute(2, 0, 1)  # (H, q, s)
        del expo
        y[lo:hi] = mm(weights, xdt[:, :hi], precision).permute(1, 0, 2)
        del weights
    return y


def _mamba(p: Dict, h: torch.Tensor, cfg: Dict, precision: str) -> torch.Tensor:
    """h: (S, d) -> (S, d), one sequence."""
    S = h.shape[0]
    di = cfg["mamba_expand"] * cfg["hidden_size"]
    N, H, P = cfg["mamba_d_state"], cfg["mamba_n_heads"], cfg["mamba_d_head"]
    z = linear(h, p["wz"], precision)
    xbc = torch.cat([linear(h, p[n], precision) for n in ("wx", "wB", "wC")], dim=-1)
    dt = linear(h, p["wdt"], precision)
    k = p["conv_w"].shape[0]
    conv = F.conv1d(xbc.t()[None], p["conv_w"].t()[:, None, :], p["conv_b"], padding=k - 1,
                    groups=xbc.shape[-1])[0, :, :S].t()
    xbc = F.silu(conv)
    x, Bv, Cv = xbc[:, :di], xbc[:, di:di + N], xbc[:, di + N:]
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(S, H, P)
    y = _ssd(xh, dt, A, Bv, Cv, precision) + xh * p["D"][:, None]
    y = _rmsnorm(y.reshape(S, di) * F.silu(z), p["norm"], cfg["rms_norm_eps"])
    return linear(y, p["out"], precision)


def _attention(p: Dict, h: torch.Tensor, cfg: Dict, precision: str) -> torch.Tensor:
    S = h.shape[0]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = cfg["hidden_size"] // H
    q = linear(h, p["wq"], precision).reshape(S, H, dh).transpose(0, 1)
    k = linear(h, p["wk"], precision).reshape(S, KV, dh).transpose(0, 1)
    v = linear(h, p["wv"], precision).reshape(S, KV, dh).transpose(0, 1)
    # query head j reads kv head j // (H / KV)
    k, v = k.repeat_interleave(H // KV, dim=0), v.repeat_interleave(H // KV, dim=0)
    scores = mm(q, k.transpose(-1, -2), precision) * cfg["attention_multiplier"]
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    del scores
    out = mm(probs, v, precision).transpose(0, 1).reshape(S, H * dh)
    return linear(out, p["wo"], precision)


def _gated(h: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
           precision: str) -> torch.Tensor:
    return linear(F.silu(linear(h, gate, precision)) * linear(h, up, precision), down, precision)


def _ffn(p: Dict, h: torch.Tensor, cfg: Dict, precision: str) -> torch.Tensor:
    """The routed experts plus the shared expert: h (S, d) -> (S, d)."""
    k = cfg["num_experts_per_tok"]
    logits = linear(h, p["router"], precision)
    top, experts = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top, dim=-1)
    out = torch.zeros_like(h)
    for e in range(p["router"].shape[0]):
        tok, pick = torch.nonzero(experts == e, as_tuple=True)
        if tok.numel():
            y = _gated(h[tok], p["gate"][e], p["up"][e], p["down"][e], precision)
            out.index_add_(0, tok, y * gates[tok, pick][:, None])
    return out + _gated(h, p["shared_gate"], p["shared_up"], p["shared_down"], precision)


def forward(params: Dict, cfg: Dict, tokens: torch.Tensor, precision: str = "f32",
            at: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits (S, V) of one sequence ``tokens`` (S,) at positions 0 ..
    S-1, or (len(at), V) at the positions ``at`` only."""
    eps, mult = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    emb = params["embed"].float()
    x = F.embedding(tokens.long(), emb) * cfg["embedding_multiplier"]
    for kind, layer in zip(cfg["layer_types"], params["layers"]):
        p = {n: t.float() for n, t in layer.items()}
        h = _rmsnorm(x, p["ln1"], eps)
        mixer = _mamba if kind == "mamba" else _attention
        x = x + mult * mixer(p, h, cfg, precision)
        x = x + mult * _ffn(p, _rmsnorm(x, p["ln2"], eps), cfg, precision)
        del p
    if at is not None:
        x = x[at]
    x = _rmsnorm(x, params["final_norm"].float(), eps)
    return linear(x, emb, precision) / cfg["logits_scaling"]
