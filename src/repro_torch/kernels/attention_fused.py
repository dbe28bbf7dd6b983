"""Fused masked attention: the whole ``Q K^T -> softmax -> probs V``
subgraph as one kernel.

  attention_fused   q:(g, m, dh)  k:(g, n, dh)  v:(g, n, dh) -> (g, m, dh)

Replaces the Pallas kernel ``repro/kernels/attention_fused.py:338``.  On
CUDA tensors the wrapper launches ``csrc/attention_fused.cu``: one block
per (slice, 16 query rows) looping over the 32-key tiles the mask leaves
live, with an online f32 softmax, so the (m, n) logits never reach
device memory.  On CPU tensors it runs the dense plain version in
``ref.py``.  Bound on the H100: bytes at decode (K and V of the live
prefix, read once), which the kernel meets by visiting only live tiles;
its own limit at decode is latency (few blocks, a serial softmax per row).

Masking follows ``MaskParams`` plus the per-slice ``lengths``: query row
``r`` of a slice sits at ``q_start + r % q_seg`` (``q_seg`` is the GQA
fold width; 0 means no fold), key column ``c`` at ``k_start + c``.
Masked logits use a finite ``NEG_INF`` so ``exp`` gives an exact 0 and
never ``inf - inf``; V rows beyond ``lengths`` are zeroed before the mix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build, ref
from .common import LAUNCHES, check_operand, route, validate_config

__all__ = ["MaskParams", "NEG_INF", "DH_MAX", "attention_fused"]

NEG_INF = -1e30  # finite: exp(NEG_INF - finite_max) == 0.0 exactly, no nan

DH_MAX = 128  # largest head dim the kernel takes (csrc kDhMax)
_MAX_Q_BLOCKS = 65535  # gridDim.y of the 16-row query blocks


@dataclass(frozen=True)
class MaskParams:
    """Static mask description for one fused-attention call.

    Visibility is ``valid(c) AND causal AND window``, OR'd with
    ``valid(c) AND prefix``, where ``valid(c) = c < lengths[slice]``.
    The default instance masks nothing beyond validity."""

    causal: bool = False
    window: int = 0  # 0 => no sliding window
    q_start: int = 0
    k_start: int = 0
    prefix_len: int = 0
    q_seg: int = 0  # 0 => q_seg = full query extent (no group fold)
    softcap: float = 0.0


def attention_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    *,
    mask: MaskParams = MaskParams(),
    block: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """softmax(mask(Q K^T)) V per batch slice, in q's dtype.

    ``lengths`` (g,) marks each slice's valid key count (None => all n).
    Queries come pre-scaled by ``d_head**-0.5``.  ``block`` is validated
    as a (bq, bk) tile config; the CUDA kernel's tiles are fixed."""
    if block is not None:
        validate_config(block, arity=2)
    for name, x in (("q", q), ("k", k), ("v", v)):
        check_operand(name, x, 3)
    g, m, dh = q.shape
    n = k.shape[1]
    if k.shape != v.shape or k.shape[0] != g or k.shape[2] != dh:
        raise ValueError(f"attention operand mismatch: {tuple(q.shape)} vs "
                         f"{tuple(k.shape)} vs {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"attention operands differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if dh > DH_MAX:
        raise ValueError(f"attention kernel takes head dims up to {DH_MAX}, got {dh}")
    if n < 1:
        raise ValueError("attention needs at least one key")
    if lengths is None:
        lengths = torch.full((g,), n, dtype=torch.int32, device=q.device)
    else:
        lengths = lengths.reshape(g).to(device=q.device, dtype=torch.int32).contiguous()
    if route(q, k, v, lengths) == "plain":
        return ref.attention_fused(q, k, v, lengths, mask)
    if -(-m // 16) > _MAX_Q_BLOCKS:
        raise ValueError(f"attention kernel takes at most {_MAX_Q_BLOCKS * 16} query rows")
    out = torch.empty_like(q)
    if out.numel():
        _build.launch(
            "attention_fused", "repro_attention_fused",
            _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(lengths),
            _build.ptr(out), g, m, n, dh,
            int(mask.causal), int(mask.window), int(mask.q_start),
            int(mask.k_start), int(mask.prefix_len), int(mask.q_seg),
            float(mask.softcap), _build.dtype_code(q.dtype), _build.stream_of(q),
        )
        LAUNCHES["attention_fused"] += 1
    return out
