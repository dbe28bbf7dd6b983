"""Adafactor (Shazeer & Stern 2018): factored second moments.

The state is O(rows + cols) per matrix instead of AdamW's O(rows * cols)
f32 pair.  As in the JAX package, every leaf with ``ndim >= 2`` is
factored over its last two axes, so a stacked norm scale ``(layers, d)``
is factored too.  Functional like AdamW: an update returns new params and
a new state.  A leaf's full-size f32 temporaries are made one or two at a
time and updated in place, so a leaf of billions of entries (an MoE
layer's experts) needs about two f32 copies of itself beside the new
param.

``adafactor_update_zero1`` is the update of one rank of a mesh: each
rank updates its piece of every parameter (``distributed.sharding``'s
param specs) from the data-mean gradient of that piece, and keeps the
statistics as ``opt_state_specs`` gives them (replicated over ``model``,
cut over the data axes along their largest dim).  Four things reduce
over a whole leaf -- the factored statistics' row and column means, the
row statistic's mean, the update-RMS clip and the relative step's
parameter RMS -- and each sums its partial sums over the axes that split
the leaf.  On a mesh of one rank it is ``clip_by_global_norm`` followed
by ``adafactor_update``, value for value.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict

import torch

from .adamw import tree_leaves, tree_map

__all__ = ["adafactor_init", "adafactor_update", "adafactor_update_zero1"]

_EPS1 = 1e-30
_EPS2 = 1e-3


def _factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2


def adafactor_init(params) -> Dict[str, Any]:
    def init(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}

    return {"stats": tree_map(init, params), "count": torch.zeros((), dtype=torch.int32)}


def _leaf_map(fn, params, *trees):
    """``fn(p, *nodes)`` over the leaves of ``params``; each of ``trees`` is
    walked alongside, and gives the node at the leaf's place: a tensor or
    spec of a param-shaped tree, the ``{"v"}`` or ``{"vr", "vc"}``
    subtree of a statistics-shaped one."""
    if isinstance(params, dict):
        return {k: _leaf_map(fn, params[k], *(t[k] for t in trees)) for k in params}
    if isinstance(params, (list, tuple)):
        return type(params)(_leaf_map(fn, p, *(t[i] for t in trees))
                            for i, p in enumerate(params))
    return fn(params, *trees)


class _Split:
    """The axes (of ``mesh``, larger than one) that split each dim of a
    leaf's piece; no dims is a whole leaf, whose reductions are the plain
    ones of ``adafactor_update``."""

    def __init__(self, dims=(), mesh=None):
        self.dims, self.mesh = list(dims), mesh

    @classmethod
    def of(cls, spec, mesh) -> "_Split":
        from repro_torch.distributed.sharding import spec_axes

        return cls([tuple(a for a in spec_axes(e) if mesh.shape[a] > 1) for e in spec], mesh)

    def axes(self, dim=None):
        """The axes that split ``dim`` (every dim: None), in mesh order."""
        if not self.dims:
            return ()
        wanted = set(self.dims[dim] if dim is not None else sum(self.dims, ()))
        return tuple(a for a in self.mesh.axis_names if a in wanted)

    def mean(self, x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
        """The mean over ``dim`` of the whole leaf's ``x``."""
        axes = self.axes(dim)
        if not axes:
            return x.mean(dim=dim, keepdim=keepdim)
        from repro_torch.distributed.collectives import all_reduce

        full = x.shape[dim] * self.mesh.axis_size(axes)
        return all_reduce(x.sum(dim=dim, keepdim=keepdim), axes, mesh=self.mesh) / full

    def mean_square(self, x: torch.Tensor) -> torch.Tensor:
        """mean(x * x) over the whole leaf, without a full-size temporary."""
        flat = x.reshape(-1)
        axes = self.axes()
        if not axes:
            return torch.dot(flat, flat) / flat.numel()
        from repro_torch.distributed.collectives import all_reduce

        total = all_reduce(torch.dot(flat, flat), axes, mesh=self.mesh)
        return total / (flat.numel() * self.mesh.axis_size(axes))

    def rows(self) -> "_Split":
        """The split of the row statistic (the leaf without its last dim)."""
        return _Split(self.dims[:-1], self.mesh)


def _new_stats(g: torch.Tensor, s, beta2, split: _Split):
    """Pass 1 of one leaf: its new statistics from its f32 gradient."""
    g2 = torch.square(g).add_(_EPS1)
    if "vr" in s:
        return {"vr": beta2 * s["vr"] + (1 - beta2) * split.mean(g2, -1),
                "vc": beta2 * s["vc"] + (1 - beta2) * split.mean(g2, -2)}
    return {"v": beta2 * s["v"] + (1 - beta2) * g2}


def _direction(g: torch.Tensor, s, clip_threshold, split: _Split) -> torch.Tensor:
    """Pass 2 of one leaf, first half: its clipped step from its f32
    gradient and its new statistics (a new full-size f32 tensor)."""
    if "vr" in s:
        vr, vc = s["vr"], s["vc"]
        denom = split.rows().mean(vr, -1, keepdim=True)[..., None]
        step = (vr[..., None] / torch.clamp(denom, min=_EPS1)) * vc[..., None, :]
    else:
        step = s["v"].clone()
    step = step.clamp_(min=_EPS1).rsqrt_().mul_(g)  # g / sqrt(vhat)
    rms = torch.sqrt(split.mean_square(step) + _EPS1)  # update-RMS clipping
    return step.div_(torch.clamp(rms / clip_threshold, min=1.0))


def _apply(p: torch.Tensor, step: torch.Tensor, lr, weight_decay, split: _Split) -> torch.Tensor:
    """Pass 2, second half: the new parameter (``step`` is consumed)."""
    pf = p.float()
    scale = torch.clamp(torch.sqrt(split.mean_square(pf)), min=_EPS2)  # relative step
    new_p = step.mul_(lr * scale).neg_().add_(pf)  # pf - lr * scale * step
    if weight_decay:
        new_p = new_p - lr * weight_decay * pf
    return new_p.to(p.dtype)


def _beta2(count: torch.Tensor) -> torch.Tensor:
    return 1.0 - torch.pow(count.float(), -0.8)


@torch.no_grad()
def adafactor_update(grads, state, params, lr, clip_threshold: float = 1.0,
                     weight_decay: float = 0.0):
    count = state["count"] + 1
    beta2 = _beta2(count)
    whole = _Split()
    new_stats = _leaf_map(lambda p, g, s: _new_stats(g.float(), s, beta2, whole),
                          params, grads, state["stats"])
    new_params = _leaf_map(
        lambda p, g, s: _apply(p, _direction(g.float(), s, clip_threshold, whole), lr,
                               weight_decay, whole),
        params, grads, new_stats)
    return new_params, {"stats": new_stats, "count": count}


def _stat_specs(spec, factored: bool):
    """The specs a leaf's statistics have in its piece's layout."""
    from repro_torch.distributed.sharding import P

    if not factored:
        return {"v": spec}
    return {"vr": P(*spec[:-1]), "vc": P(*(tuple(spec[:-2]) + tuple(spec[-1:])))}


def _relayout(t: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """A piece under spec ``src`` as its piece under ``dst``: each dim the
    two split differently gathered whole, then cut."""
    from repro_torch.distributed.collectives import all_gather
    from repro_torch.distributed.sharding import spec_axes

    def live(e):
        return e if e is not None and mesh.axis_size(spec_axes(e)) > 1 else None

    cut = False
    for d, (a, b) in enumerate(zip(src, dst)):
        a, b = live(a), live(b)
        if a == b:
            continue
        if a is not None:
            t = all_gather(t, spec_axes(a), dim=d, mesh=mesh)
        if b is not None:
            axes = spec_axes(b)
            part = t.shape[d] // mesh.axis_size(axes)
            t, cut = t.narrow(d, mesh.axis_index(axes) * part, part), True
    return t.clone(memory_format=torch.contiguous_format) if cut else t


@torch.no_grad()
def adafactor_update_zero1(grads, state, params, lr, p_specs, o_specs, mesh,
                           max_grad_norm: float = 1.0, clip_threshold: float = 1.0,
                           weight_decay: float = 0.0, reduced: bool = False):
    """One Adafactor step of this rank (the module docstring).  ``grads``
    are the gradients of this rank's param pieces on its own batch shard;
    ``p_specs`` and ``o_specs`` the params' and optimizer state's specs.
    Each gradient is all-reduced over the data axes, except a leaf the
    params already split over them (FSDP's, whose backward summed it),
    divided by their size, the global norm taken over the pieces and
    clipped to ``max_grad_norm`` (as ``clip_by_global_norm``); each
    leaf's statistics come in from their stored layout and go back to it.
    ``reduced``: a leaf with a ZeRO-1 dim comes as its piece of the sum
    already (``zero1_grads``' accumulator), which is gathered whole over
    the data axes, not summed again.  Returns (params, state, norm)."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.collectives import all_gather, all_reduce
    from repro_torch.distributed.sharding import data_axes, zero1_dim

    from . import global_norm

    daxes = data_axes(mesh)
    n = mesh.axis_size(daxes)

    def piece(p, g, ps):
        """The sum over the data axes (divided by ``n`` below, with the
        clip): a gradient no collective touches stays in its dtype until
        its own update."""
        if sharding.splits(ps, daxes):
            return g
        d = zero1_dim(ps, p.shape, mesh) if reduced else None
        if d is not None:  # summed already: this rank's piece of the sum
            return all_gather(g, daxes, d, mesh=mesh)
        return all_reduce(g.float(), daxes, mesh=mesh) if n > 1 else g

    pieces = _leaf_map(piece, params, grads, p_specs)
    gn = global_norm(pieces, p_specs, mesh) / n
    scale = torch.clamp(max_grad_norm / torch.clamp(gn, min=1e-12), max=1.0) / n
    queue = deque(tree_leaves(pieces))  # each piece dropped once its leaf is updated
    del pieces

    count = state["count"] + 1
    beta2 = _beta2(count)

    def update(p, ps, s, ss):
        """(new param, new statistics as stored).  The clipped f32
        gradient is made for each pass and dropped after it, so a leaf
        needs about two f32 copies of itself at a time."""
        g = queue.popleft()
        split = _Split.of(ps, mesh)
        here = _stat_specs(ps, _factored(p))
        old = {k: _relayout(v, ss[k], here[k], mesh) for k, v in s.items()}
        new = _new_stats(g.float() * scale, old, beta2, split)
        stored = {k: _relayout(v, here[k], ss[k], mesh) for k, v in new.items()}
        step = _direction(g.float() * scale, new, clip_threshold, split)
        del g
        return _apply(p, step, lr, weight_decay, split), stored

    pairs = _leaf_map(update, params, p_specs, state["stats"], o_specs["stats"])
    new_params = _leaf_map(lambda p, pair: pair[0], params, pairs)
    new_stats = _leaf_map(lambda p, pair: pair[1], params, pairs)
    return new_params, {"stats": new_stats, "count": count}, gn
