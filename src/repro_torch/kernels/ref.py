"""Plain PyTorch versions of every kernel on the port's path.

Each function is the specification its CUDA kernel must match: the CPU
route of every wrapper runs it, and ``chip_smoke.py`` holds each kernel
against it on the card.  Products accumulate in f32 and cast to the
input dtype at the end, as ``repro/kernels/ref.py`` does.
"""

from __future__ import annotations

import torch

__all__ = [
    "transpose",
    "matmul_nn",
    "matmul_nt",
    "matmul_tn",
    "matmul_tnn",
    "attention_visibility",
    "attention_fused",
]


def transpose(b: torch.Tensor) -> torch.Tensor:
    """Out-of-place transpose of a 2-D tensor: (n, k) -> (k, n), contiguous."""
    return b.t().contiguous()


def matmul_nn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with A:(m,k), B:(k,n) -> C:(m,n); accumulate in f32."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def matmul_nt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B^T with A:(m,k), B:(n,k) -> C:(m,n); accumulate in f32."""
    return torch.matmul(a.float(), b.float().t()).to(a.dtype)


def matmul_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A^T @ B with A:(k,m), B:(k,n) -> C:(m,n); accumulate in f32."""
    return torch.matmul(a.float().t(), b.float()).to(a.dtype)


# TNN computes the same function as NT; only the schedule differs.
matmul_tnn = matmul_nt


def attention_visibility(mask, lengths: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """The (g, m, n) boolean visibility of ``MaskParams`` plus per-slice
    ``lengths``: query row ``r`` sits at ``q_start + r % q_seg``, key
    column ``c`` at ``k_start + c``; a column is valid below its slice's
    length.  Visible = valid AND causal AND window, OR valid AND prefix."""
    dev = lengths.device
    rows = torch.arange(m, device=dev)
    cols = torch.arange(n, device=dev)
    q_seg = mask.q_seg if mask.q_seg else m
    q_pos = (mask.q_start + rows % q_seg)[None, :, None]  # (1, m, 1)
    k_pos = (mask.k_start + cols)[None, None, :]  # (1, 1, n)
    valid = cols[None, None, :] < lengths.reshape(-1, 1, 1)  # (g, 1, n)
    vis = valid
    if mask.causal:
        vis = vis & (k_pos <= q_pos)
    if mask.window:
        vis = vis & (k_pos > q_pos - mask.window)
    if mask.prefix_len:
        vis = vis | (valid & (k_pos < mask.prefix_len))
    return vis.expand(-1, m, n)


def attention_fused(q, k, v, lengths, mask) -> torch.Tensor:
    """softmax(mask(Q K^T)) V per slice, computed densely.

    q:(g,m,dh), k/v:(g,n,dh), lengths:(g,) int -> (g,m,dh) in q's dtype.
    Logits in f32, softcapped, masked at the finite ``NEG_INF``; masked
    entries weigh exactly 0; p is cast to V's dtype before the PV product
    while the denominator sums the f32 p, and a zero denominator becomes
    1; V rows beyond ``lengths`` are zeroed.  A row that sees no key at
    all comes out 0 (the model never produces one)."""
    from .attention_fused import NEG_INF

    g, m, _ = q.shape
    n = k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    if mask.softcap:
        s = mask.softcap * torch.tanh(s / mask.softcap)
    vis = attention_visibility(mask, lengths, m, n)
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    p = torch.where(vis, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    valid = torch.arange(n, device=k.device)[None, :, None] < lengths.reshape(-1, 1, 1)
    vz = torch.where(valid, v, torch.zeros_like(v))
    out = torch.matmul(p.to(v.dtype).float(), vz.float()) / denom
    return out.to(q.dtype)
