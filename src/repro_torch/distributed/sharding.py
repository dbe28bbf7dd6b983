"""Sharding rules: params / optimizer state / batches / decode caches.

A line-for-line port of the JAX package's rules.  Mesh axes:
``("data", "model")`` single-pod, ``("pod", "data", "model")`` multi-pod.
DP runs over ``("pod", "data")`` jointly; TP over ``"model"``.  Rules are
*divisibility-guarded*: a dim is only sharded when it divides evenly,
falling back along a documented chain (out-dim -> in-dim -> replicate).
The rules read only ``mesh.shape`` and ``mesh.axis_names``.

A spec is a ``PartitionSpec``: a tuple with one entry per dimension,
``None`` (replicated), an axis name, or a tuple of axis names (the dim
split over them jointly, the first major).  Trees are the model's dicts,
lists and tuples; a spec tree has a ``PartitionSpec`` where the tree has
a tensor.

In place of the JAX package's ``named`` (specs -> shardings),
``shard(tree, specs, mesh, rank)`` slices a full tree to one rank's
pieces and ``unshard(tree, specs, mesh)`` gathers them back over the
mesh's process groups: ``convert.params_from_numpy`` followed by
``shard`` carries the JAX package's weights to each rank.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Iterator, Optional, Tuple

import torch

__all__ = [
    "PartitionSpec",
    "P",
    "data_axes",
    "param_specs",
    "opt_state_specs",
    "batch_specs",
    "cache_specs_tree",
    "param_spec",
    "spec_axes",
    "splits",
    "local_shape",
    "shard",
    "unshard",
    "map_with_path",
    "MIN_MODEL_DIM",
    "min_model_dim",
    "zero1_dim",
]


class PartitionSpec(tuple):
    """One entry per dimension: None, an axis name or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# weights whose *input* dim carries the model axis (their producer's output
# dim is model-sharded, so contraction happens model-local then sums)
_ROW_IN = {"wo", "down", "out"}

# projections whose candidate dim is smaller than this are replicated
# instead of model-sharded; 0 = the JAX package's baseline behaviour
MIN_MODEL_DIM = 0


@contextlib.contextmanager
def min_model_dim(n: int) -> Iterator[int]:
    """``MIN_MODEL_DIM`` set to ``n`` in the block and put back after it
    (the dry run's ``optimized`` variant sets 1024 for one cell; the JAX
    package's leaves it set)."""
    global MIN_MODEL_DIM
    prev, MIN_MODEL_DIM = MIN_MODEL_DIM, n
    try:
        yield n
    finally:
        MIN_MODEL_DIM = prev


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _axis_size(mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    return int(math.prod(mesh.shape[n] for n in names))


def map_with_path(fn: Callable, tree, *rest, path: Tuple[str, ...] = ()):
    """``fn(names, leaf, *rest_leaves)`` over a tree of dicts, lists and
    tuples (a ``PartitionSpec`` is a leaf); ``names`` holds each dict key
    and ``[i]`` for each sequence index, as the JAX package's paths."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), path=path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(map_with_path(fn, v, *(r[i] for r in rest), path=path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _spec_for_param(names: Tuple[str, ...], shape, mesh) -> PartitionSpec:
    msize = _axis_size(mesh, "model")
    nd = len(shape)
    none = [None] * nd

    def with_model(dim: int, check_min: bool = True) -> Optional[PartitionSpec]:
        # MIN_MODEL_DIM guards *projection width* dims only (thin shards);
        # expert-count / vocab dims bypass it via check_min=False
        if check_min and shape[dim] < max(MIN_MODEL_DIM, msize):
            return None
        s = list(none)
        s[dim] = "model"
        return P(*s)

    # 0/1-D: norms, biases, scalars -- replicated
    if nd <= 1:
        return P(*none)

    # embeddings / LM head: (V, d) vocab-sharded
    if "emb" in names:
        if shape[-2] % msize == 0:
            s = with_model(nd - 2, check_min=False)
            if s is not None:
                return s
        return P(*none)

    # MoE expert tensors: (..., E, f|d, d|f) -- one dim over 'model' (EP, or
    # TP within an expert when E doesn't divide) plus a second dim over the
    # data axes (FSDP)
    if "moe" in names and names[-1] in ("gate", "up", "down"):
        daxes = data_axes(mesh)
        dsize = _axis_size(mesh, daxes)
        d_entry = daxes if len(daxes) > 1 else daxes[0]
        e_dim, mid, last = nd - 3, nd - 2, nd - 1
        ff_dim = mid if names[-1] in ("gate", "up") else last
        other = last if ff_dim == mid else mid
        s = list(none)
        if shape[e_dim] % msize == 0:  # EP on experts
            s[e_dim] = "model"
            if shape[ff_dim] % dsize == 0:  # FSDP on the hidden dim
                s[ff_dim] = d_entry
        elif shape[ff_dim] % msize == 0:  # TP within expert
            s[ff_dim] = "model"
            if shape[other] % dsize == 0:  # FSDP on d_model
                s[other] = d_entry
        return P(*s)

    # depthwise conv taps: (d_conv, d_inner)
    if names[-1] == "conv_w":
        if shape[-1] % msize == 0:
            s = with_model(nd - 1)
            if s is not None:
                return s
        return P(*none)

    # dense weights "w" under a named projection
    if names[-1] == "w" and nd >= 2:
        parent = names[-2] if len(names) >= 2 else ""
        # wdt's out-dim is the SSD head axis: head-axis projections bypass
        # the thin-shard rule
        anchor = parent in ("wdt",)
        if parent in _ROW_IN:
            order = (nd - 1, nd - 2)  # prefer in-dim (model-sharded producer)
        else:
            order = (nd - 2, nd - 1)  # prefer out-dim
        for dim in order:
            if shape[dim] % msize == 0:
                s = with_model(dim, check_min=not anchor)
                if s is not None:
                    return s
        return P(*none)

    return P(*none)


def param_specs(shapes_tree, mesh):
    """Tree of ``PartitionSpec`` matching ``shapes_tree`` (tensors, meta
    tensors included)."""
    return map_with_path(lambda names, leaf: _spec_for_param(names, leaf.shape, mesh),
                         shapes_tree)


@functools.lru_cache(maxsize=None)
def _param_spec_cached(names, shape, axis_names, sizes, min_dim) -> PartitionSpec:
    from repro_torch.launch.mesh import Mesh

    return _spec_for_param(names, shape, Mesh(sizes, axis_names))


def param_spec(names: Tuple[str, ...], shape, mesh) -> PartitionSpec:
    """The spec of one parameter of full ``shape`` at tree path ``names``
    (memoised): how the model's layers learn which of their weights'
    dims the ``model`` axis splits, from the rules themselves (keyed by
    ``MIN_MODEL_DIM`` too, which the rules read)."""
    return _param_spec_cached(tuple(names), tuple(int(s) for s in shape),
                              mesh.axis_names, mesh.devices_shape, MIN_MODEL_DIM)


def _zero1(spec: PartitionSpec, shape, mesh) -> PartitionSpec:
    """ZeRO-1: extend a param spec by sharding the largest free dim over the
    data axes (optimizer state only)."""
    daxes = data_axes(mesh)
    dsize = _axis_size(mesh, daxes)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for e in entries if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}
    if used & set(daxes):  # already data-sharded (2-D FSDP tensors)
        return P(*entries)
    free = [
        (shape[i], i)
        for i in range(len(shape))
        if entries[i] is None and shape[i] % dsize == 0 and shape[i] >= dsize
    ]
    if not free:
        return P(*entries)
    _, dim = max(free)
    entries[dim] = daxes if len(daxes) > 1 else daxes[0]
    return P(*entries)


def zero1_dim(spec: PartitionSpec, shape, mesh) -> Optional[int]:
    """The dim ZeRO-1 cuts over the data axes (``_zero1``) of a leaf of
    ``shape`` whose param spec is ``spec``, or None: no free dim divides,
    or the params split the leaf over the data axes already (FSDP).  The
    dims it may cut are whole in a rank's piece, so ``shape`` may be the
    piece's."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return next((d for d, (a, b) in enumerate(zip(entries, _zero1(spec, shape, mesh)))
                 if a != b), None)


def opt_state_specs(opt_state_shapes, params_specs, mesh, zero1: bool = True):
    """Optimizer-state specs.  Leaves that match a param shape inherit its
    spec (+ZeRO-1 data sharding); factored/scalar stats get generic rules."""

    def spec(names, leaf):
        s = _spec_for_param(names, leaf.shape, mesh)
        if zero1 and len(leaf.shape) >= 1:
            s = _zero1(s, leaf.shape, mesh)
        return s

    return map_with_path(spec, opt_state_shapes)


def batch_specs(batch_shapes, mesh):
    """Shard the leading batch dim over ('pod','data') when divisible."""
    daxes = data_axes(mesh)
    dsize = _axis_size(mesh, daxes)
    axes = daxes if len(daxes) > 1 else daxes[0]

    def spec(names, leaf):
        shape = leaf.shape
        s: list = [None] * len(shape)
        if len(shape) >= 1 and shape[0] % dsize == 0 and shape[0] >= dsize:
            s[0] = axes
        return P(*s)

    return map_with_path(spec, batch_shapes)


def _spec_for_cache(names, shape, mesh) -> PartitionSpec:
    """Decode-cache leaves.

    attn 'k'/'v': (layers, B, slots, kv, dh); ssm 'ssm': (layers, B, H, P, N);
    'conv': (layers, B, taps, d_inner).  Greedy: B -> data axes (else slots),
    kv/H -> model (else slots/d_inner).
    """
    daxes = data_axes(mesh)
    dsize = _axis_size(mesh, daxes)
    msize = _axis_size(mesh, "model")
    axes_entry = daxes if len(daxes) > 1 else daxes[0]
    nd = len(shape)
    s: list = [None] * nd
    kind = names[-1] if names else ""
    if kind in ("k", "v"):
        b_dim, slot_dim, kv_dim = nd - 4, nd - 3, nd - 2
        if shape[b_dim] % dsize == 0 and shape[b_dim] >= dsize:
            s[b_dim] = axes_entry
        elif shape[slot_dim] % dsize == 0:
            s[slot_dim] = axes_entry
        if shape[kv_dim] % msize == 0:
            s[kv_dim] = "model"
        elif s[slot_dim] is None and shape[slot_dim] % msize == 0:
            s[slot_dim] = "model"
    elif kind == "ssm":
        b_dim, h_dim = nd - 4, nd - 3
        if shape[b_dim] % dsize == 0 and shape[b_dim] >= dsize:
            s[b_dim] = axes_entry
        if shape[h_dim] % msize == 0:
            s[h_dim] = "model"
    elif kind == "conv":
        b_dim, d_dim = nd - 3, nd - 1
        if shape[b_dim] % dsize == 0 and shape[b_dim] >= dsize:
            s[b_dim] = axes_entry
        if shape[d_dim] % msize == 0:
            s[d_dim] = "model"
    elif kind == "pos":
        pass  # scalar position: replicated
    return P(*s)


def cache_specs_tree(cache_shapes, mesh):
    return map_with_path(lambda names, leaf: _spec_for_cache(names, leaf.shape, mesh),
                         cache_shapes)


# -- one rank's pieces ------------------------------------------------------------


def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry (empty for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def splits(spec, axes) -> bool:
    """Whether ``spec`` splits some dim over any of ``axes`` (a leaf FSDP
    splits over the data axes, for one)."""
    return any(a in axes for e in spec for a in spec_axes(e))


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's piece of a leaf of full ``shape``."""
    out = list(shape)
    for d, e in enumerate(spec):
        if e is not None:
            out[d] //= _axis_size(mesh, spec_axes(e))
    return tuple(out)


def _slice(x: torch.Tensor, spec, mesh, rank) -> torch.Tensor:
    sliced = False
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = spec_axes(e)
        n = _axis_size(mesh, axes)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide over {axes} ({n})")
        part = x.shape[d] // n
        x = x.narrow(d, mesh.axis_index(axes, rank) * part, part)
        sliced = True
    # a piece of its own, so the full leaf can be freed
    return x.clone(memory_format=torch.contiguous_format) if sliced else x


def shard(tree, specs, mesh, rank: Optional[int] = None):
    """``tree``'s leaves cut to the pieces rank ``rank`` (default: the
    mesh's own) holds under ``specs``; replicated leaves are returned as
    they are, sharded ones as contiguous tensors of their own."""
    return map_with_path(lambda _, x, s: _slice(x, s, mesh, rank), tree, specs)


def unshard(tree, specs, mesh):
    """The full tree back from every rank's pieces: one all-gather per
    sharded dimension, over the spec entry's axes (``collectives``)."""
    from .collectives import all_gather

    def gather(_, x, spec):
        for d, e in enumerate(spec):
            if e is not None:
                x = all_gather(x, spec_axes(e), dim=d, mesh=mesh)
        return x

    return map_with_path(gather, tree, specs)
