"""Carry the JAX package's parameters over to the port.

``params_from_numpy(tree, cfg)`` takes the tree ``repro.models.lm.init_lm``
returns, with every leaf already converted to a numpy f32 array by the
caller (numpy has no bf16), and returns the port's params: the same tree
of dicts, lists and tuples, with torch tensors in ``cfg.param_dtype`` on
``device``.  Both packages then compute the same function; a shared seed
would not do it, since ``jax.random`` and ``torch.Generator`` differ.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["params_from_numpy"]


def params_from_numpy(tree, cfg, *, device="cuda"):
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(v) for v in node)
        arr = np.asarray(node)
        if arr.dtype != np.float32:
            raise TypeError(f"leaves must be numpy float32 arrays, got {arr.dtype}")
        return torch.tensor(arr).to(device=dev, dtype=dtype)

    return convert(tree)
