"""Per-step cost accounting of one rank's program, on meta tensors.

The JAX package reads XLA's ``cost_analysis()``, which counts a ``while``
body once, and corrects it with unrolled probes.  Here the rank's step
runs eagerly on meta tensors (shapes and dtypes, no storage), so every
layer executes once and is counted as it runs: no probe linearity is
needed.  The outer structure is the JAX package's: for a train cell one
microbatch's gradient (forward, recompute and backward) times ``accum``,
plus one optimizer update; for a prefill or decode cell one step.

What is counted, per device:

  * each dispatch once, by its operands and its result, whatever
    candidate the policy picks (``core.engine.account_dispatches``): a
    GEMM 2 g m n k FLOPs, an attention plan its two contractions at full
    m x n (4 g m n d_head FLOPs); bytes are its operands read once and
    its result written once.  The aten ops beneath a dispatch (a plain
    version, the unfused plan's sub-dispatches) are not counted again;
  * every other aten op its bytes (its tensor inputs and outputs), and a
    matrix product outside a dispatch its FLOPs; views, metadata and
    allocations count nothing;
  * collectives: the effective wire bytes the wrappers of
    ``distributed/collectives.py`` record, by kind -- the FSDP gathers of
    the MoE experts in the forward and the recompute, and their
    gradients' reduce-scatters, among them.  With ``zero1_grads`` (the
    train step's sharded accumulators, ``launch/steps.py``) each
    microbatch counts the reduce-scatters that land its gradients, the
    accumulators count at their sharded size and the optimizer counts
    the pieces it is given.

Memory: ``peak_temp_bytes`` is the most bytes held at once by the
storages the step allocates (tracked in the dispatch mode from creation
until the last tensor on them dies), on top of its arguments
(``argument_bytes``: the rank's pieces of the state, cache and batch,
exact from the specs).  It includes activations saved for the backward,
the f32 gradient accumulators and the optimizer's temporaries; it does
not include the CUDA caching allocator's rounding and fragmentation,
workspaces a kernel allocates inside its launch, NCCL's buffers, or the
CUDA context -- so it is a lower bound on what the card needs.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from repro_torch.configs import cache_specs, input_specs
from repro_torch.core.engine import account_dispatches, dispatch_depth
from repro_torch.core.policy import default_policy, use_policy
from repro_torch.distributed import collectives
from repro_torch.distributed.context import use_mesh
from repro_torch.distributed.sharding import (
    batch_specs,
    cache_specs_tree,
    data_axes,
    param_specs,
    shard,
)
from repro_torch.models import lm
from repro_torch.optim import make_zero1_update, tree_leaves

__all__ = ["account_cell", "CellCosts", "CostLedger", "tree_bytes"]

_aten = torch.ops.aten
_MATMULS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default, _aten.baddbmm.default}
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten._unsafe_view.default, _aten.lift_fresh.default}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    return sum(_nbytes(t) for t in tree_leaves(tree))


def _tensors(x):
    return [t for t in _pytree_leaves(x) if isinstance(t, torch.Tensor)]


class CostLedger(TorchDispatchMode):
    """Counts FLOPs and bytes (module docstring) and tracks the live bytes
    of the storages created under it.  ``exclude``: tensors whose storages
    are arguments, never counted as allocated (an in-place update of the
    cache returns it)."""

    def __init__(self, exclude=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.dispatches = 0
        self.dispatch_flops = 0.0
        self._args = {t.untyped_storage()._cdata for t in _tensors(exclude)}
        self._live: Dict[int, list] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def snapshot(self) -> Dict[str, float]:
        c = collectives.STATS
        out = {"flops": self.flops, "bytes": self.bytes, "coll_bytes": c.effective_bytes,
               "dispatches": float(self.dispatches), "dispatch_flops": self.dispatch_flops}
        for k, v in c.by_kind.items():
            out[f"coll_{k}"] = v
        return out

    # -- dispatches ------------------------------------------------------------

    def on_dispatch(self, key, operands, out) -> None:
        if key.op == "ATTN":
            flops = 4.0 * key.g * key.m * key.n * key.k
        else:
            flops = 2.0 * key.g * key.m * key.n * key.k
        self.flops += flops
        self.dispatch_flops += flops
        self.dispatches += 1
        self.bytes += sum(_nbytes(t) for t in operands) + _nbytes(out)

    # -- aten ops --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if dispatch_depth() == 0 and not (func.is_view or func in _FREE):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
            if func in _MATMULS:
                a, b = (args[1], args[2]) if func in (_aten.addmm.default,
                                                     _aten.baddbmm.default) else args[:2]
                g = a.shape[0] if a.ndim == 3 else 1
                self.flops += 2.0 * g * a.shape[-2] * a.shape[-1] * b.shape[-1]
        for t in outs:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._args:
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [st.nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]


class CellCosts(dict):
    """Per-device totals: flops / bytes / coll_bytes (+ by kind), the
    dispatch count and FLOPs, and the memory keys: ``argument_bytes`` and
    its parts (``param_bytes``, ``opt_bytes``, ``cache_bytes``,
    ``batch_bytes``), ``peak_temp_bytes``."""


def _diff(after: Dict[str, float], before: Dict[str, float]) -> Dict[str, float]:
    return {k: after.get(k, 0.0) - before.get(k, 0.0) for k in set(after) | set(before)}


def account_cell(cfg, shape, mesh, accum: int = 1, policy=None,
                 zero1_grads: bool = False) -> CellCosts:
    """Run one rank's step of the (cfg, shape) cell on ``mesh`` on meta
    tensors and return its costs (the module docstring).  ``policy``
    selects each dispatch's candidate (default: the learned selector),
    which moves no number here but the peak of an unfused attention
    plan's probabilities; ``zero1_grads`` is the train step's (at
    ``accum`` 1 it changes nothing)."""
    from repro_torch.launch.steps import (
        accumulate,
        grad_accumulators,
        loss_and_grads,
        train_state_shapes,
        train_state_specs,
    )

    policy = policy or default_policy()
    collectives.reset_stats()
    if shape.kind == "train":
        shapes = train_state_shapes(cfg)
        specs = train_state_specs(shapes, mesh)
        state = shard(shapes, specs, mesh)
        micro = dataclasses.replace(shape, global_batch=max(1, shape.global_batch // accum))
        b = input_specs(cfg, micro)
        batch = shard(b, batch_specs(b, mesh), mesh)
        args = (state, batch)
        # the whole step's batch shard is an argument too
        full = input_specs(cfg, shape)
        parts = {"param_bytes": tree_bytes(state["params"]), "opt_bytes": tree_bytes(state["opt"]),
                 "batch_bytes": tree_bytes(shard(full, batch_specs(full, mesh), mesh))}
    elif shape.kind == "prefill":
        params = lm.init_lm(0, cfg, device="meta")
        params = shard(params, param_specs(params, mesh), mesh)
        b = input_specs(cfg, shape)
        batch = shard(b, batch_specs(b, mesh), mesh)
        args = (params, batch)
        parts = {"param_bytes": tree_bytes(params), "batch_bytes": tree_bytes(batch)}
    else:
        params = lm.init_lm(0, cfg, device="meta")
        params = shard(params, param_specs(params, mesh), mesh)
        c = cache_specs(cfg, shape)
        c_specs = cache_specs_tree(c, mesh)
        cache = shard(c, c_specs, mesh)
        b = input_specs(cfg, shape)
        batch = shard(b, batch_specs(b, mesh), mesh)
        args = (params, cache, batch)
        parts = {"param_bytes": tree_bytes(params), "cache_bytes": tree_bytes(cache),
                 "batch_bytes": tree_bytes(batch)}

    ledger = CostLedger(exclude=args)
    with use_mesh(mesh), use_policy(policy), account_dispatches(ledger.on_dispatch), ledger:
        if shape.kind == "train":
            params = state["params"]
            zero1 = zero1_grads and accum > 1
            acc = grad_accumulators(params, specs["params"], mesh, zero1)
            before = ledger.snapshot()
            loss, grads = loss_and_grads(cfg, params, batch)
            acc = accumulate(acc, grads, specs["params"], mesh, zero1)
            del grads
            micro_costs = _diff(ledger.snapshot(), before)
            before = ledger.snapshot()
            with torch.no_grad():
                daxes = data_axes(mesh)
                collectives.all_reduce(loss, daxes)
                make_zero1_update(cfg.optimizer)(acc, state["opt"], params, 1e-3,
                                                 specs["params"], specs["opt"], mesh,
                                                 reduced=zero1)
            opt_costs = _diff(ledger.snapshot(), before)
            totals = {k: micro_costs.get(k, 0.0) * accum + opt_costs.get(k, 0.0)
                      for k in set(micro_costs) | set(opt_costs)}
        else:
            with torch.no_grad():
                if shape.kind == "prefill":
                    lm.lm_prefill(params, cfg, batch, max_seq=shape.seq_len)
                else:
                    lm.lm_decode(params, cfg, cache, batch, cache_specs=c_specs)
            totals = ledger.snapshot()
    totals = {k: v for k, v in totals.items() if v}
    totals.update({k: float(v) for k, v in parts.items()})
    totals.update(argument_bytes=float(sum(parts.values())),
                  peak_temp_bytes=float(ledger.peak_bytes))
    for k in ("flops", "bytes", "coll_bytes", "dispatches", "dispatch_flops"):
        totals.setdefault(k, 0.0)
    return CellCosts(totals)
