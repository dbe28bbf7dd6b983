"""Slot-based paged KV cache for the continuous-batching engine.

One device-resident cache tree (the ``segments`` half of
``models/lm.py::init_lm_cache``) holds ``n_slots + 1`` sequences: every
leaf is ``(layers, n_slots + 1, slots, kv, dh)`` with the sequence axis at
position 1.  A request is admitted by allocating a slot and copying its
(batch=1) prefill cache into that row; it is evicted by freeing the slot.
Every slot carries its own write position (``lengths``).

The extra row -- ``null_slot`` -- is scratch: decode steps run at
bucketed batch sizes, and the padding rows of a partially-filled bucket
all point at it, so their writes land on it instead of a live sequence
(which of several duplicate writes lands is undefined; nobody reads the
row).

Device updates are in place (``index_copy_``) where the JAX package
donates the pool to a jitted update.  Slot bookkeeping (free list,
lengths, owners) is host-side numpy.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import lm

__all__ = ["PagedKVCache"]


class PagedKVCache:
    """Fixed pool of ``n_slots`` sequence slots + 1 null scratch row."""

    def __init__(self, cfg, n_slots: int, max_seq: int, dtype=torch.bfloat16,
                 device="cuda"):
        if n_slots < 1:
            raise ValueError(f"need at least one slot, got {n_slots}")
        self.cfg = cfg
        self.n_slots = int(n_slots)
        self.max_seq = int(max_seq)
        self.device = resolve_device(device)
        self.null_slot = self.n_slots  # scratch row for bucket padding
        self.data = lm.init_lm_cache(
            cfg, self.n_slots + 1, max_seq, dtype=dtype, device=self.device
        )["segments"]
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
        """Release a slot back to the pool.  The KV rows stay in place --
        the next occupant's prefill overwrites them, and until then its
        zero length masks every stale position."""
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
