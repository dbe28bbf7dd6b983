"""Seeded weights, made by the benchmark and handed to both sides.

The program's parameter tree is read from its own initialiser on the
``meta`` device (shapes only, nothing drawn); the values are the
benchmark's: one ``torch.randn`` on the device for every normal leaf
together, in the dtype the configuration runs, cut into views and
scaled per leaf (a dense weight ``(out, in)`` by 1/sqrt(in), an
embedding by 0.02); norm scales and biases are zero.  The same seed on
the same device gives the same values, so the reference draws them
again instead of reading the program's.

Leaves are named as the reference names them (``leaf_name``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, Tuple

import torch

from .traffic import derive

__all__ = ["tree_items", "tree_build", "leaf_name", "fill", "named", "reference_copy"]

Path = Tuple


def tree_items(tree, path: Path = ()) -> Iterator[Tuple[Path, torch.Tensor]]:
    """(path, leaf) in the order the program's ``tree_leaves`` walks."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_items(v, path + (i,))
    else:
        yield path, tree


def tree_build(tree, fn: Callable[[Path, torch.Tensor], torch.Tensor], path: Path = ()):
    """A tree of the same structure with each leaf replaced by ``fn``."""
    if isinstance(tree, dict):
        return {k: tree_build(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_build(v, fn, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def leaf_name(path: Path) -> str:
    """The reference's name of a program leaf: ``w<i>``/``b<i>`` for the
    FCN's layer ``i``, else the leaf's owner (``wq``, ``ln1``, ``embed``)."""
    if path[0] == "layers":
        return f"{path[-1]}{path[1]}"
    return path[-2]


def _std(path: Path, shape) -> float:
    """0.0 for a zero leaf."""
    if path[-1] in ("scale", "b"):
        return 0.0
    if path[-1] == "emb":
        return 0.02
    return 1.0 / math.sqrt(shape[-1])


def fill(shapes, seed: int, device, dtype: torch.dtype):
    """Values for the tree of meta tensors ``shapes``, drawn from ``seed``
    on ``device`` in ``dtype``: one draw for all normal leaves."""
    normal = [(p, t) for p, t in tree_items(shapes) if _std(p, t.shape)]
    total = sum(t.numel() for _, t in normal)
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    views: Dict[Path, torch.Tensor] = {}
    at = 0
    for p, t in normal:
        views[p] = flat[at:at + t.numel()].view(t.shape).mul_(_std(p, t.shape))
        at += t.numel()

    def leaf(path, t):
        if path in views:
            return views[path]
        return torch.zeros(t.shape, dtype=dtype, device=device)

    return tree_build(shapes, leaf)


def named(tree) -> Dict[str, torch.Tensor]:
    """The tree's leaves by reference name (each name once)."""
    out: Dict[str, torch.Tensor] = {}
    for p, t in tree_items(tree):
        name = leaf_name(p)
        if name in out:
            raise ValueError(f"two leaves named {name!r}: one segment of one block is read")
        out[name] = t
    return out


def reference_copy(tree) -> Dict[str, torch.Tensor]:
    """The reference's float32 copy of the benchmark's weights."""
    return {k: v.detach().float().clone() for k, v in named(tree).items()}
