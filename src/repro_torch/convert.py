"""Carry the JAX package's parameters over to the port.

``params_from_numpy(tree, cfg)`` takes the tree ``repro.models.lm.init_lm``
returns, with every leaf already converted to a numpy f32 array by the
caller (numpy has no bf16), and returns the port's params: the same tree
of dicts, lists and tuples, with torch tensors in ``cfg.param_dtype`` on
``device``.  ``fcn_params_from_numpy(tree)`` does the same for the tree
``repro.models.fcn.init_fcn`` returns: ``{"layers": [{"w": (out, in),
"b": (out,)}, ...]}``.  Both packages then compute the same function; a
shared seed would not do it, since ``jax.random`` and ``torch.Generator``
differ.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["params_from_numpy", "fcn_params_from_numpy"]


def params_from_numpy(tree, cfg, *, device="cuda"):
    return _convert(tree, cfg.param_dtype, device)


def fcn_params_from_numpy(tree, *, dtype="float32", device="cuda"):
    if not (isinstance(tree, dict) and set(tree) == {"layers"} and tree["layers"]
            and all(isinstance(layer, dict) and set(layer) == {"w", "b"}
                    for layer in tree["layers"])):
        raise ValueError("an FCN tree is {'layers': [{'w': (out, in), 'b': (out,)}, ...]}")
    return _convert(tree, dtype, device)


def _convert(tree, dtype_name: str, device):
    dev = resolve_device(device)
    dtype = getattr(torch, dtype_name)

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
