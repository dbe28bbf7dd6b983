"""Rotary position embeddings (RoPE), half-rotation convention, in f32."""

from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope"]


def rope_freqs(d_head: int, theta: float = 10000.0, device="cpu") -> torch.Tensor:
    """(d_head/2,) inverse frequencies, f32."""
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta**exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, d_head), positions: broadcastable to (..., S)."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)  # (d/2,)
    ang = positions.float()[..., None] * inv  # (..., S, d/2)
    sin = torch.sin(ang)[..., None, :]  # (..., S, 1, d/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
