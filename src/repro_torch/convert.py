"""Carry the JAX package's parameters over to the port.

``params_from_numpy(tree, cfg)`` takes the tree ``repro.models.lm.init_lm``
returns, with every leaf already converted to a numpy f32 array by the
caller (numpy has no bf16), and returns the port's params: the same tree
of dicts, lists and tuples on ``device``, every leaf in the dtype the
port's own ``init_lm`` gives it for ``cfg`` (``cfg.param_dtype``, but f32
for the MoE routers and the Mamba blocks' ``A_log``, ``D`` and
``dt_bias``, as in the JAX package).  ``fcn_params_from_numpy(tree)``
does the same for the tree ``repro.models.fcn.init_fcn`` returns:
``{"layers": [{"w": (out, in), "b": (out,)}, ...]}``.  Both packages then
compute the same function; a shared seed would not do it, since
``jax.random`` and ``torch.Generator`` differ.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import lm

__all__ = ["params_from_numpy", "fcn_params_from_numpy"]


def params_from_numpy(tree, cfg, *, device="cuda"):
    shapes = lm.init_lm(0, cfg, device="meta")  # the port's tree: dtypes, no draws
    return _convert(tree, shapes, device)


def fcn_params_from_numpy(tree, *, dtype="float32", device="cuda"):
    if not (isinstance(tree, dict) and set(tree) == {"layers"} and tree["layers"]
            and all(isinstance(layer, dict) and set(layer) == {"w", "b"}
                    for layer in tree["layers"])):
        raise ValueError("an FCN tree is {'layers': [{'w': (out, in), 'b': (out,)}, ...]}")
    return _convert(tree, getattr(torch, dtype), device)


def _convert(tree, like, device):
    """``tree``'s leaves as tensors on ``device``, each in the dtype of the
    matching leaf of ``like`` (a tree of the same structure), or in
    ``like`` itself where it is a dtype."""
    dev = resolve_device(device)

    def convert(node, ref, path):
        if isinstance(node, dict):
            if isinstance(ref, dict) and set(ref) != set(node):
                raise ValueError(f"{path or 'the tree'}: keys {sorted(node)}, the port "
                                 f"has {sorted(ref)}")
            return {k: convert(v, ref[k] if isinstance(ref, dict) else ref, f"{path}/{k}")
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            if isinstance(ref, (list, tuple)) and len(ref) != len(node):
                raise ValueError(f"{path}: {len(node)} entries, the port has {len(ref)}")
            return type(node)(convert(v, ref[i] if isinstance(ref, (list, tuple)) else ref,
                                      f"{path}/{i}") for i, v in enumerate(node))
        arr = np.asarray(node)
        if arr.dtype != np.float32:
            raise TypeError(f"leaves must be numpy float32 arrays, got {arr.dtype}")
        if isinstance(ref, torch.Tensor) and tuple(ref.shape) != arr.shape:
            raise ValueError(f"{path}: shape {arr.shape}, the port has {tuple(ref.shape)}")
        dtype = ref.dtype if isinstance(ref, torch.Tensor) else ref
        return torch.tensor(arr).to(device=dev, dtype=dtype)

    return convert(tree, like, "")
