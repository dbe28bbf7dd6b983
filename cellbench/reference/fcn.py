"""Plain reference of the paper's fully connected network (arXiv:1702.03192,
§VI-C): dense layers ``y = x W^T + b`` with ReLU between them, and the
mean cross-entropy of the last layer's logits.  Parameters are
``{"w0": (out, in), "b0": (out,), "w1": ...}`` in float32.  Plain
PyTorch; imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .numerics import linear

__all__ = ["forward", "loss"]


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, precision: str = "f32"):
    n = sum(1 for k in params if k.startswith("w"))
    for i in range(n):
        x = linear(x, params[f"w{i}"], precision) + params[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def loss(params: Dict[str, torch.Tensor], batch: Dict, precision: str = "f32") -> torch.Tensor:
    logits = forward(params, batch["x"].float(), precision)
    return F.cross_entropy(logits, batch["labels"].long())
