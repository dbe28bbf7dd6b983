"""The train step: gradient accumulation over microbatches with f32
accumulators, global-norm clipping, the LR schedule and the config's
optimizer (AdamW, or Adafactor for the MoE giants), on one device or one
rank of a mesh.

``make_train_step(cfg, step_cfg, policy)`` returns ``train_step(state,
batch) -> (state, metrics)``.  The state is ``{"params", "opt", "step"}``
(``init_train_state`` builds it); ``batch`` holds ``tokens`` and ``labels``
tensors on the params' device; the metrics are ``loss`` and ``grad_norm``
(0-d tensors on the device) and ``lr`` (a float).  The update, clipping
included, is the span ``repro_torch.optim.update`` (``core/spans.py``).
The forward and the backward of every microbatch run in one
``use_policy`` block, as the JAX package wraps ``value_and_grad``, so the
policy selects the gradient GEMMs too.  Updates are functional: the step returns new params and optimizer
state and leaves its inputs as they were.

``make_prefill_step(cfg, max_seq, policy)`` and ``make_serve_step(cfg,
policy)`` are the fixed-batch serving steps of ``launch/serve.py
--legacy``: ``lm_prefill`` of a rectangular batch, then one ``lm_decode``
token at a time against its cache, each under ``use_policy(policy)``.

With ``mesh=`` (``launch/mesh.py``) each step is one rank's program
(``distributed/``): the state holds this rank's pieces under
``train_state_specs`` (``shard_train_state`` cuts a full state to them,
``unshard_train_state`` gathers it back), the batch is this rank's shard
under ``batch_specs``, and the train step splits that shard into its
microbatches, takes the gradient mean over the data axes and applies the
mesh update of the config's optimizer (``optim.make_zero1_update``:
ZeRO-1 AdamW, or Adafactor on the pieces).  The serving steps return
the whole vocabulary's logits.

``TrainStepConfig(zero1_grads=True)`` (the JAX package's ZeRO-2-style
accumulation, which the dry run's ``optimized`` variant takes) shards
the f32 accumulators as the ZeRO-1 optimizer state is sharded: at
``accum`` > 1, each microbatch's gradient of a leaf with a ZeRO-1 dim
(``sharding.zero1_dim``) is reduce-scattered over the data axes into an
accumulator of 1/data of the leaf's piece, and the update takes those
pieces as they are, already summed.  A leaf with no ZeRO-1 dim is
accumulated whole and reduced once by the update, and an FSDP leaf's
gradient arrives reduce-scattered by its backward, as without it.  It
trades memory for traffic: the accumulators shrink by the data size,
and a step issues ``accum`` reduce-scatters of such a leaf in place of
one.  The step equals the step without it up to the order of
summation; at ``accum`` 1 it changes nothing (the JAX package then
scans no microbatches).  ``train_state_shapes``,
``train_state_specs`` and ``shardings_for_train`` are the JAX package's,
on meta tensors.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import spans
from repro_torch.core.policy import SelectionPolicy, use_policy
from repro_torch.distributed.collectives import all_reduce, reduce_scatter
from repro_torch.distributed.context import mesh_scope
from repro_torch.distributed.sharding import (
    P,
    batch_specs,
    data_axes,
    local_shape,
    map_with_path,
    opt_state_specs,
    param_specs,
    shard,
    unshard,
    zero1_dim,
)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm
from repro_torch.optim import (
    make_optimizer,
    make_zero1_update,
    tree_leaves,
    tree_map,
    warmup_cosine,
)

__all__ = ["TrainStepConfig", "make_train_step", "init_train_state", "loss_and_grads",
           "grad_accumulators", "accumulate",
           "make_prefill_step", "make_serve_step", "train_state_shapes", "train_state_specs",
           "shardings_for_train", "shard_train_state", "unshard_train_state"]


class TrainStepConfig:
    def __init__(
        self,
        accum: int = 1,
        lr: float = 3e-4,
        warmup: int = 100,
        total_steps: int = 10000,
        max_grad_norm: float = 1.0,
        weight_decay: float = 0.1,
        zero1_grads: bool = False,
    ):
        self.accum = accum
        self.lr = lr
        self.warmup = warmup
        self.total_steps = total_steps
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay
        # the f32 accumulators sharded over the data axes (module docstring)
        self.zero1_grads = zero1_grads


def init_train_state(cfg, params, mesh=None) -> Dict:
    """The train state of fresh ``params``: optimizer state and step 0.
    With ``mesh``, ``params`` are this rank's pieces and the optimizer
    state is this rank's zeros under ``train_state_specs``."""
    opt_init, _ = make_optimizer(cfg.optimizer)
    if mesh is None:
        return {"params": params, "opt": opt_init(params),
                "step": torch.zeros((), dtype=torch.int32)}
    shapes = train_state_shapes(cfg)
    specs = train_state_specs(shapes, mesh)
    device = tree_leaves(params)[0].device
    opt = map_with_path(
        lambda _, t, s: torch.zeros(local_shape(t.shape, s, mesh), dtype=t.dtype,
                                    device=device if t.ndim else "cpu"),
        shapes["opt"], specs["opt"])
    return {"params": params, "opt": opt, "step": torch.zeros((), dtype=torch.int32)}


def train_state_shapes(cfg) -> Dict:
    """The full train state of ``cfg`` as meta tensors (no allocation);
    the 0-d counters stay host tensors, which the optimizer reads."""
    opt_init, _ = make_optimizer(cfg.optimizer)
    params = lm.init_lm(0, cfg, device="meta")
    state = {"params": params, "opt": opt_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    return tree_map(lambda t: t.to("meta") if t.ndim else t, state)


def train_state_specs(state_shapes, mesh) -> Dict:
    return {
        "params": param_specs(state_shapes["params"], mesh),
        "opt": opt_state_specs(state_shapes["opt"], None, mesh),
        "step": P(),
    }


def shardings_for_train(cfg, mesh, batch_shapes):
    state_shapes = train_state_shapes(cfg)
    state_specs = train_state_specs(state_shapes, mesh)
    b_specs = batch_specs(batch_shapes, mesh)
    metrics_specs = {"loss": P(), "grad_norm": P(), "lr": P()}
    return state_shapes, state_specs, b_specs, metrics_specs


def shard_train_state(cfg, state, mesh, rank=None) -> Dict:
    """A full train state cut to rank ``rank``'s pieces (default: the
    mesh's own)."""
    return shard(state, train_state_specs(train_state_shapes(cfg), mesh), mesh, rank)


def unshard_train_state(cfg, state, mesh) -> Dict:
    """The full train state from every rank's pieces (a collective: every
    rank of the mesh calls it), as a checkpoint keeps it."""
    return unshard(state, train_state_specs(train_state_shapes(cfg), mesh), mesh)


def _policy_scope(policy: Optional[SelectionPolicy]):
    """The block a microbatch's forward and backward run in; with no
    policy, the caller's scope governs (or, with none, the default
    policy)."""
    return use_policy(policy) if policy is not None else contextlib.nullcontext()


def _split_micro(batch: Dict[str, torch.Tensor], accum: int):
    """(B, ...) -> ``accum`` microbatches of (B/accum, ...)."""
    def split(x):
        if x.shape[0] % accum:
            raise ValueError(f"batch {x.shape[0]} not divisible by accum {accum}")
        return x.chunk(accum)

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum)]


def grad_accumulators(params, p_specs, mesh, zero1_grads: bool):
    """The f32 zeros the microbatches' gradients add into: each leaf's
    piece, cut over the data axes along its ZeRO-1 dim under
    ``zero1_grads`` (the module docstring)."""
    n = mesh.axis_size(data_axes(mesh))

    def zeros(_, p, ps):
        shape = list(p.shape)
        d = zero1_dim(ps, shape, mesh) if zero1_grads else None
        if d is not None:
            shape[d] //= n
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return map_with_path(zeros, params, p_specs)


def accumulate(acc, grads, p_specs, mesh, zero1_grads: bool):
    """``acc`` plus one microbatch's ``grads`` in f32; under ``zero1_grads``
    a leaf with a ZeRO-1 dim arrives reduce-scattered over the data
    axes."""
    daxes = data_axes(mesh)

    def add(_, a, g, ps):
        g = g.float()
        d = zero1_dim(ps, g.shape, mesh) if zero1_grads else None
        if d is not None:
            g = reduce_scatter(g, daxes, d, mesh=mesh)
        return a + g

    return map_with_path(add, acc, grads, p_specs)


def loss_and_grads(cfg, params, batch: Dict[str, torch.Tensor],
                   policy: Optional[SelectionPolicy] = None):
    """(loss, gradient tree) of ``lm.lm_loss`` at ``params``, the forward
    and the backward in one ``use_policy(policy)`` block; gradients come
    in the params' dtypes."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with _policy_scope(policy):
        loss, _ = lm.lm_loss(live, cfg, batch)
        grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(
    cfg,
    step_cfg: Optional[TrainStepConfig] = None,
    policy: Optional[SelectionPolicy] = None,
    mesh=None,
) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; with ``mesh`` one
    rank's step (the module docstring).  Both optimizers take their mesh
    update, on one rank over a mesh of one (every collective the
    identity, every leaf whole)."""
    sc = step_cfg or TrainStepConfig()
    sched = warmup_cosine(sc.lr, sc.warmup, sc.total_steps)
    opt_kw = {"weight_decay": sc.weight_decay} if cfg.optimizer == "adamw" else {}
    update = make_zero1_update(cfg.optimizer, **opt_kw)
    ranks = mesh if mesh is not None else Mesh((1, 1), ("data", "model"))
    specs = train_state_specs(train_state_shapes(cfg), ranks)
    daxes = data_axes(ranks)
    zero1 = sc.zero1_grads and sc.accum > 1

    def _grads(params, batch):
        """(loss, gradients): the mean over ``batch``'s microbatches, f32
        accumulators (ZeRO-1 pieces under ``zero1_grads``); one
        microbatch's come in the params' dtypes, which the update casts
        leaf by leaf."""
        if sc.accum == 1:
            return loss_and_grads(cfg, params, batch, policy)
        loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        grads = grad_accumulators(params, specs["params"], ranks, zero1)
        for mb in _split_micro(batch, sc.accum):
            loss_mb, g = loss_and_grads(cfg, params, mb, policy)
            grads = accumulate(grads, g, specs["params"], ranks, zero1)
            del g
            loss = loss + loss_mb
        return loss / sc.accum, tree_map(lambda g: g / sc.accum, grads)

    def train_step(state, batch):
        with mesh_scope(mesh):
            params = state["params"]
            loss, grads = _grads(params, batch)
            loss = all_reduce(loss, daxes, mesh=ranks) / ranks.axis_size(daxes)
            step = int(state["step"])
            lr = sched(step)
            with spans.span("repro_torch.optim.update", device=loss.device, step=step):
                new_params, new_opt, gnorm = update(grads, state["opt"], params, lr,
                                                    specs["params"], specs["opt"], ranks,
                                                    max_grad_norm=sc.max_grad_norm,
                                                    reduced=zero1)
        new_state = {"params": new_params, "opt": new_opt, "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def make_prefill_step(cfg, max_seq: int, policy: Optional[SelectionPolicy] = None,
                      cache_dtype=torch.bfloat16, mesh=None) -> Callable:
    """``prefill_step(params, batch) -> (logits, cache)``: ``lm_prefill``
    of a rectangular batch into a ``max_seq`` cache of ``cache_dtype``
    (bf16 by default, as in the JAX package); with ``mesh``, this rank's
    pieces of the params and the cache, and the whole vocabulary's
    logits."""
    def prefill_step(params, batch):
        with torch.no_grad(), _policy_scope(policy), mesh_scope(mesh):
            logits, cache = lm.lm_prefill(params, cfg, batch, max_seq=max_seq,
                                          cache_dtype=cache_dtype)
            return lm.gather_logits(cfg, logits), cache

    return prefill_step


def make_serve_step(cfg, policy: Optional[SelectionPolicy] = None, mesh=None,
                    cache_specs=None) -> Callable:
    """``serve_step(params, cache, batch) -> (logits, cache)``: one
    ``lm_decode`` token, the cache updated in place; with ``mesh`` (and
    ``cache_specs``, the specs of the cache ``make_prefill_step`` made:
    ``serving.kv_cache.pool_specs``) as ``make_prefill_step``."""
    def serve_step(params, cache, batch):
        with torch.no_grad(), _policy_scope(policy), mesh_scope(mesh):
            logits, cache = lm.lm_decode(params, cfg, cache, batch, cache_specs=cache_specs)
            return lm.gather_logits(cfg, logits), cache

    return serve_step
