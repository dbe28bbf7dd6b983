"""Adafactor (Shazeer & Stern 2018): factored second moments.

The state is O(rows + cols) per matrix instead of AdamW's O(rows * cols)
f32 pair.  As in the JAX package, every leaf with ``ndim >= 2`` is
factored over its last two axes, so a stacked norm scale ``(layers, d)``
is factored too.  Functional like AdamW: an update returns new params and
a new state.  A leaf's full-size f32 temporaries are made one or two at a
time and updated in place, so a leaf of billions of entries (an MoE
layer's experts) needs about two f32 copies of itself beside the new
param.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .adamw import tree_map

__all__ = ["adafactor_init", "adafactor_update"]

_EPS1 = 1e-30
_EPS2 = 1e-3


def _factored(p: torch.Tensor) -> bool:
    return p.ndim >= 2


def _mean_square(x: torch.Tensor) -> torch.Tensor:
    """mean(x * x) without a full-size temporary."""
    flat = x.reshape(-1)
    return torch.dot(flat, flat) / flat.numel()


def adafactor_init(params) -> Dict[str, Any]:
    def init(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}

    return {"stats": tree_map(init, params), "count": torch.zeros((), dtype=torch.int32)}


def _is_stats(node) -> bool:
    return isinstance(node, dict) and set(node) in ({"v"}, {"vr", "vc"})


def _stats_map(fn, params, grads, stats):
    """``fn(p, g, s)`` over the leaves of ``params``, where ``s`` is the
    matching ``{"v"}`` or ``{"vr", "vc"}`` subtree of ``stats``."""
    if _is_stats(stats):
        return fn(params, grads, stats)
    if isinstance(params, dict):
        return {k: _stats_map(fn, params[k], grads[k], stats[k]) for k in params}
    return type(params)(_stats_map(fn, p, g, s) for p, g, s in zip(params, grads, stats))


@torch.no_grad()
def adafactor_update(grads, state, params, lr, clip_threshold: float = 1.0,
                     weight_decay: float = 0.0):
    count = state["count"] + 1
    c = count.float()
    beta2 = 1.0 - torch.pow(c, -0.8)

    # pass 1: the new stats
    def upd_stats(p, g, s):
        g2 = torch.square(g.float()).add_(_EPS1)
        if _factored(p):
            return {"vr": beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1),
                    "vc": beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)}
        return {"v": beta2 * s["v"] + (1 - beta2) * g2}

    new_stats = _stats_map(upd_stats, params, grads, state["stats"])

    # pass 2: each parameter's update from the new stats
    def upd_param(p, g, s):
        if _factored(p):
            vr, vc = s["vr"], s["vc"]
            denom = vr.mean(dim=-1, keepdim=True)[..., None]
            step = (vr[..., None] / torch.clamp(denom, min=_EPS1)) * vc[..., None, :]
        else:
            step = s["v"].clone()
        step = step.clamp_(min=_EPS1).rsqrt_().mul_(g.float())  # g / sqrt(vhat)
        rms = torch.sqrt(_mean_square(step) + _EPS1)  # update-RMS clipping
        step.div_(torch.clamp(rms / clip_threshold, min=1.0))
        pf = p.float()
        scale = torch.clamp(torch.sqrt(_mean_square(pf)), min=_EPS2)  # relative step
        new_p = step.mul_(lr * scale).neg_().add_(pf)  # pf - lr * scale * step
        if weight_decay:
            new_p = new_p - lr * weight_decay * pf
        return new_p.to(p.dtype)

    new_params = _stats_map(upd_param, params, grads, new_stats)
    return new_params, {"stats": new_stats, "count": count}
