"""Mamba-2 SSD (state-space duality) layer: the chunked training form,
quadratic within a chunk and linear across chunks, and the O(1)-state
decode form.

The JAX package's layer (Dao & Gu 2024, section 6) with its two
simplifications: ``ngroups=1`` (B and C shared across heads) and the
short causal conv applied to x only.  Every projection is ``dense``, the
paper's NT op through ``core.engine.dispatch``; the SSD's contractions
are ``torch.einsum`` products, as the JAX package leaves them to
``jnp.einsum``.  The inter-chunk scan is a Python loop over chunks (the
JAX package scans them).  The casts follow the JAX package's: B and C
run in the activation dtype, the scores and the carried state too, and
decode works in f32 and stores the state in the cache dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import Param, _normal, dense, init_dense, init_rmsnorm, rmsnorm

__all__ = ["SSMConfig", "init_ssm", "ssm_layer", "ssm_decode", "init_ssm_cache"]


@dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim


def init_ssm(gen: torch.Generator, cfg: SSMConfig, dtype=torch.float32, device="cpu") -> Param:
    """The JAX package's tree; ``A_log``, ``D`` and ``dt_bias`` are f32
    whatever ``dtype`` is."""
    H = cfg.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wz": init_dense(gen, cfg.d_inner, cfg.d_model, dtype, device),
        "wx": init_dense(gen, cfg.d_inner, cfg.d_model, dtype, device),
        "wB": init_dense(gen, cfg.d_state, cfg.d_model, dtype, device),
        "wC": init_dense(gen, cfg.d_state, cfg.d_model, dtype, device),
        "wdt": init_dense(gen, H, cfg.d_model, dtype, device),
        "conv_w": _normal(gen, (cfg.d_conv, cfg.d_inner), 0.1, dtype, device),
        "conv_b": torch.zeros((cfg.d_inner,), dtype=dtype, device=device),
        "A_log": torch.zeros((H,), **f32),  # A = -exp(A_log) = -1
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": init_rmsnorm(cfg.d_inner, dtype, device),
        "out": init_dense(gen, cfg.d_model, cfg.d_inner, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, d_inner) with taps (d_conv, d_inner)."""
    d_conv, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, d_conv - 1, 0))
    out = torch.zeros_like(x)
    for t in range(d_conv):
        out = out + pad[:, t: t + S] * w[t]
    return F.silu(out + b)


def _ssd_chunked(
    xh: torch.Tensor,  # (B, S, H, P)
    Bv: torch.Tensor,  # (B, S, N)
    Cv: torch.Tensor,  # (B, S, N)
    dt: torch.Tensor,  # (B, S, H) post-softplus, f32
    A: torch.Tensor,  # (H,) negative, f32
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B, S, H, P), h_final: (B, H, P, N))."""
    Bsz, S, H, P = xh.shape
    N = Bv.shape[-1]
    L = min(chunk, S)
    if S % L != 0:  # ragged tail: fall back to one chunk
        L = S
    nc = S // L
    xh, Bv, Cv, dt = (t.reshape((Bsz, nc, L) + t.shape[2:]) for t in (xh, Bv, Cv, dt))

    a = dt * A  # (B, nc, L, H) log-decay per step
    cum = torch.cumsum(a, dim=2)  # inclusive within-chunk cumsum

    # intra-chunk (quadratic in L): scores[b,c,l,s,h] = (C_l.B_s) L[l,s,h].
    # Above the diagonal exp(cum_l - cum_s) overflows to inf for a long
    # chunk; ``where`` drops it (a 0/1 mask would give inf * 0 = NaN).
    cb = torch.einsum("bcln,bcsn->bcls", Cv, Bv)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])  # (B,nc,L,L,H)
    causal = torch.ones((L, L), dtype=torch.bool, device=xh.device).tril()
    scores = cb[..., None] * decay * dt[:, :, None, :, :]
    scores = torch.where(causal[None, None, :, :, None], scores, 0.0)
    del decay
    y = torch.einsum("bclsh,bcshp->bclhp", scores.to(xh.dtype), xh)
    del scores

    # chunk summaries: S_c[b,h,p,n] = sum_s exp(cum_L - cum_s) dt_s x_s B_s
    seg = torch.exp(cum[:, :, -1:, :] - cum) * dt  # (B, nc, L, H)
    states = torch.einsum("bclh,bclhp,bcln->bchpn", seg.to(xh.dtype), xh, Bv)

    # inter-chunk scan: H_c = exp(cum_L_c) H_{c-1} + S_c, carried in xh's dtype
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)
    h = torch.zeros((Bsz, H, P, N), dtype=xh.dtype, device=xh.device) if h0 is None else h0
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)  # the state *before* chunk c
        h = h * chunk_decay[:, c, :, None, None].to(h.dtype) + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)  # (B, nc, H, P, N)

    # inter-chunk contribution: y_t += C_t . (exp(cum_t) H_prev)
    inter = torch.einsum("bcln,bchpn,bclh->bclhp", Cv, h_prevs, torch.exp(cum).to(xh.dtype))
    y = (y + inter).reshape(Bsz, S, H, P)
    return y, h


def ssm_layer(p: Param, x: torch.Tensor, cfg: SSMConfig, return_state: bool = False,
              cache_dtype=torch.bfloat16):
    """x: (B, S, d_model) -> (B, S, d_model) [, decode cache]."""
    B, S, _ = x.shape
    z = dense(p["wz"], x)
    xi_raw = dense(p["wx"], x)
    xi = _causal_conv(xi_raw, p["conv_w"], p["conv_b"])
    Bv = dense(p["wB"], x).float()
    Cv = dense(p["wC"], x).float()
    dt = F.softplus(dense(p["wdt"], x).float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B, S, cfg.n_heads, cfg.head_dim)
    y, h_final = _ssd_chunked(xh, Bv.to(xh.dtype), Cv.to(xh.dtype), dt, A, cfg.chunk)
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    y = y.reshape(B, S, cfg.d_inner)
    y = rmsnorm(p["norm"], y * F.silu(z))
    out = dense(p["out"], y)
    if not return_state:
        return out
    tail = cfg.d_conv - 1
    conv_cache = xi_raw[:, S - tail:] if S >= tail else F.pad(xi_raw, (0, 0, tail - S, 0))
    return out, {"conv": conv_cache.to(cache_dtype), "ssm": h_final.to(cache_dtype)}


# -- decode -------------------------------------------------------------------


def init_ssm_cache(batch: int, cfg: SSMConfig, dtype=torch.bfloat16,
                   device="cpu") -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state), dtype=dtype,
                           device=device),
    }


def ssm_decode(
    p: Param,
    x: torch.Tensor,  # (B, 1, d_model)
    cfg: SSMConfig,
    cache: Dict[str, Any],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step; returns the output and a new cache (the input
    cache is left as it was)."""
    B = x.shape[0]
    z = dense(p["wz"], x)[:, 0]
    xi_raw = dense(p["wx"], x)[:, 0]  # (B, d_inner)

    # conv ring: taps over [cache, new]
    hist = torch.cat([cache["conv"].to(xi_raw.dtype), xi_raw[:, None]], dim=1)
    conv_out = torch.einsum("btd,td->bd", hist, p["conv_w"]) + p["conv_b"]
    xi = F.silu(conv_out)
    new_conv = hist[:, 1:].to(cache["conv"].dtype)

    Bv = dense(p["wB"], x)[:, 0].float()  # (B, N)
    Cv = dense(p["wC"], x)[:, 0].float()
    dt = F.softplus(dense(p["wdt"], x)[:, 0].float() + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"])
    xh = xi.reshape(B, cfg.n_heads, cfg.head_dim)

    dA = torch.exp(dt * A)  # (B, H)
    h = cache["ssm"].float()
    h = h * dA[..., None, None] + torch.einsum("bh,bhp,bn->bhpn", dt, xh.float(), Bv)
    y = torch.einsum("bn,bhpn->bhp", Cv, h) + xh.float() * p["D"][None, :, None]
    y = y.reshape(B, 1, cfg.d_inner).to(x.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z)[:, None])
    out = dense(p["out"], y)
    return out, {"conv": new_conv, "ssm": h.to(cache["ssm"].dtype)}
