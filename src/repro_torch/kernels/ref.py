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
    "matmul_tnn_fused",
    "matmul_bnt",
    "matmul_bnn",
    "attention_visibility",
    "attention_fused",
    "attention_split_partials",
    "attention_split_combine",
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


# TNN and fused TNN compute the same function as NT; only the schedule
# differs.
matmul_tnn = matmul_nt
matmul_tnn_fused = matmul_nt


def matmul_bnt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C_i = A_i @ B_i^T with A:(g,m,k), B:(g,n,k) -> (g,m,n); accumulate in
    f32."""
    return torch.bmm(a.float(), b.float().transpose(1, 2)).to(a.dtype)


def matmul_bnn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C_i = A_i @ B_i with A:(g,m,k), B:(g,k,n) -> (g,m,n); accumulate in
    f32."""
    return torch.bmm(a.float(), b.float()).to(a.dtype)


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


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in the accumulation dtype: f32, or f64 for f64 inputs (which
    makes these functions the f64 references of the tests)."""
    return x if x.dtype == torch.float64 else x.float()


def _masked_logits(q, k, lengths, mask):
    """f32 (f64 for f64 inputs) logits, softcapped, at the finite NEG_INF
    where not visible, and the visibility."""
    from .attention_fused import NEG_INF

    s = torch.matmul(_acc(q), _acc(k).transpose(1, 2))
    if mask.softcap:
        s = mask.softcap * torch.tanh(s / mask.softcap)
    vis = attention_visibility(mask, lengths, q.shape[1], k.shape[1])
    return torch.where(vis, s, torch.full_like(s, NEG_INF)), vis


def _zero_v_beyond_lengths(v, lengths):
    valid = torch.arange(v.shape[1], device=v.device)[None, :, None] < lengths.reshape(-1, 1, 1)
    return torch.where(valid, v, torch.zeros_like(v))


def attention_fused(q, k, v, lengths, mask) -> torch.Tensor:
    """softmax(mask(Q K^T)) V per slice, computed densely.

    q:(g,m,dh), k/v:(g,n,dh), lengths:(g,) int -> (g,m,dh) in q's dtype.
    Logits in f32 (f64 for f64 inputs), softcapped, masked at the finite
    ``NEG_INF``; masked entries weigh exactly 0; p is cast to V's dtype
    before the PV product while the denominator sums the unrounded p, and
    a zero denominator becomes 1; V rows beyond ``lengths`` are zeroed.  A
    row that sees no key at all comes out 0 (the model never produces
    one)."""
    s, vis = _masked_logits(q, k, lengths, mask)
    p = torch.where(vis, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
    denom = p.sum(dim=-1, keepdim=True)
    denom = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    vz = _zero_v_beyond_lengths(v, lengths)
    out = torch.matmul(_acc(p.to(v.dtype)), _acc(vz)) / denom
    return out.to(q.dtype)


def attention_split_partials(q, k, v, lengths, mask, per: int):
    """The split-KV arithmetic of the decode kernel, split by split: the
    keys cut into runs of ``per``, each run's f32 partial (max, sum, acc)
    over the keys it sees, (splits, g, m, 1), (splits, g, m, 1) and
    (splits, g, m, dh).  A run in which a row sees no key gives that row
    max NEG_INF, sum 0 and acc 0.  p is relative to the run's own max and
    cast to V's dtype before its PV product.  Used by tests only."""
    s, vis = _masked_logits(q, k, lengths, mask)
    vz = _zero_v_beyond_lengths(v, lengths)
    maxes, sums, accs = [], [], []
    for k0 in range(0, k.shape[1], per):
        s_i, vis_i = s[..., k0:k0 + per], vis[..., k0:k0 + per]
        mx = s_i.amax(dim=-1, keepdim=True)
        p = torch.where(vis_i, torch.exp(s_i - mx), torch.zeros_like(s_i))
        maxes.append(mx)
        sums.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.matmul(p.to(v.dtype).float(), vz[:, k0:k0 + per].float()))
    return torch.stack(maxes), torch.stack(sums), torch.stack(accs)


def attention_split_combine(maxes, sums, accs, dtype) -> torch.Tensor:
    """The combine kernel's arithmetic: (sum_i acc_i e^(max_i - M)) /
    (sum_i sum_i e^(max_i - M)), M the largest max, added in split order; a
    split whose max is NEG_INF adds exactly 0, and a zero denominator
    becomes 1.  Used by tests only."""
    from .attention_fused import NEG_INF

    top = maxes.amax(dim=0)
    num = torch.zeros_like(accs[0])
    den = torch.zeros_like(sums[0])
    for mx, sm, acc in zip(maxes, sums, accs):
        seen = mx != NEG_INF
        scale = torch.where(seen, torch.exp(mx - top), torch.zeros_like(mx))
        num = num + torch.where(seen, acc * scale, torch.zeros_like(acc))
        den = den + torch.where(seen, sm * scale, torch.zeros_like(sm))
    den = torch.where(den == 0.0, torch.ones_like(den), den)
    return (num / den).to(dtype)
