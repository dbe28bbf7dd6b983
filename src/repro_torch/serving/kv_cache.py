"""Slot-based paged KV cache for the continuous-batching engine.

One device-resident cache tree (the ``segments`` half of
``models/lm.py::init_lm_cache``) holds ``n_slots + 1`` sequences: every
leaf has the sequence axis at position 1 -- ``(layers, n_slots + 1,
slots, kv, dh)`` for attention K/V, and for a Mamba block's state, which
has no position axis, ``(layers, n_slots + 1, d_conv - 1, conv_width)``
(``conv_width`` is ``d_inner``, or ``d_inner + 2 d_state`` with the xBC
conv) and ``(layers, n_slots + 1, heads, head_dim, d_state)``.  A
request is admitted by allocating a slot and copying its (batch=1)
prefill cache into that row; it is evicted by freeing the slot.
Every slot carries its own write position (``lengths``).

The extra row -- ``null_slot`` -- is scratch: decode steps run at
bucketed batch sizes, and the padding rows of a partially-filled bucket
all point at it, so their writes land on it instead of a live sequence
(which of several duplicate writes lands is undefined; nobody reads the
row).

Device updates are in place (``index_copy_``) where the JAX package
donates the pool to a jitted update.  Slot bookkeeping (free list,
lengths, owners) is host-side numpy.

With a ``mesh`` whose ``model`` axis is larger than one, each rank holds
its piece of every leaf under ``distributed.sharding.cache_specs_tree``
on that axis (``pool_specs``: attention K/V over kv heads, else slots;
a Mamba block's ``ssm`` state over heads and ``conv`` state over
d_inner): the data axes replicate the pool, so every data replica
serves the same requests.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed.sharding import P, cache_specs_tree, local_shape, map_with_path
from repro_torch.launch.mesh import Mesh
from repro_torch.models import lm

__all__ = ["PagedKVCache", "pool_specs"]


def pool_specs(cfg, batch: int, max_seq: int, mesh):
    """The cache specs of a serving pool of ``batch`` sequences on
    ``mesh``: the rules on its ``model`` axis alone (the data axes
    replicate the pool), as ``{"segments": ..., "pos": ...}``."""
    view = Mesh((1, mesh.shape.get("model", 1)), ("data", "model"))
    specs = cache_specs_tree(lm.init_lm_cache(cfg, batch, max_seq, device="meta"), view)
    return map_with_path(lambda _, s: P(*(e if e == "model" else None for e in s)), specs)


class PagedKVCache:
    """Fixed pool of ``n_slots`` sequence slots + 1 null scratch row."""

    def __init__(self, cfg, n_slots: int, max_seq: int, dtype=torch.bfloat16,
                 device="cuda", mesh=None):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_seq = int(max_seq)
        self.device = resolve_device(device)
        self.null_slot = self.n_slots  # scratch row for bucket padding
        mesh = mesh if mesh is not None else Mesh((1, 1), ("data", "model"))
        specs = pool_specs(cfg, self.n_slots + 1, max_seq, mesh)
        # the pool's cache specs on a mesh larger than one, else None
        self.specs = specs if mesh.size > 1 else None
        full = lm.init_lm_cache(cfg, self.n_slots + 1, max_seq, dtype=dtype, device="meta")
        self.data = map_with_path(
            lambda _, t, s: torch.zeros(local_shape(t.shape, s, mesh), dtype=t.dtype,
                                        device=self.device),
            full["segments"], specs["segments"])
        # slot bookkeeping is shared with the engine's admission path;
        # allocate/free must be atomic under concurrent submitters
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.n_slots))  # guarded-by: _lock
        self.lengths = np.zeros(self.n_slots + 1, np.int32)
        self.owner: Dict[int, Any] = {}  # slot -> request id; guarded-by: _lock

    def leaves(self, tree=None):
        """The pool's cache tensors, in tree order."""
        tree = self.data if tree is None else tree
        return [leaf for seg in tree for slot in seg for leaf in slot.values()]

    # -- slot lifecycle --------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> List[int]:
        return sorted(self.owner)

    def allocate(self, owner: Any) -> Optional[int]:
        """Claim a free slot for ``owner`` (None when the pool is full)."""
        with self._lock:
            if not self._free:
                return None
            slot = self._free.pop(0)
            self.owner[slot] = owner
        self.lengths[slot] = 0
        return slot

    def free(self, slot: int) -> None:
        """Release a slot back to the pool.  The rows stay in place: the
        next occupant's ``insert`` overwrites every leaf of its row, the
        SSM state whole, and until then a zero length masks every stale
        K/V position."""
        with self._lock:
            if slot not in self.owner:
                raise KeyError(f"slot {slot} is not allocated")
            del self.owner[slot]
            self._free.append(slot)
        self.lengths[slot] = 0

    def insert(self, prefill_cache: Dict[str, Any], slot: int, length: int) -> None:
        """Copy a request's prefill cache (batch=1 tree from
        ``lm_prefill``) into its slot, in place, and record its length."""
        if slot not in self.owner:
            raise KeyError(f"slot {slot} is not allocated")
        idx = torch.tensor([slot], device=self.device)
        for big, rows in zip(self.leaves(), self.leaves(prefill_cache["segments"])):
            big.index_copy_(1, idx, rows.to(big.dtype))
        self.lengths[slot] = int(length)

    def advance(self, slots) -> None:
        """One decode step happened for ``slots``: their lengths grew."""
        for s in slots:
            self.lengths[s] += 1

    def __repr__(self):
        return (
            f"PagedKVCache(slots={self.n_slots}, free={self.n_free}, "
            f"max_seq={self.max_seq})"
        )
