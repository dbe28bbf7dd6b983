"""Decode/prefill shape bucketing for the serving engine.

Continuous batching changes the decode batch every step and every request
arrives with its own prompt length.  A ``BucketSpec`` rounds both axes to
a small fixed set, as in the JAX package:

  * the active decode batch rounds **up** to the next batch bucket
    (powers of two, capped at the engine's slot count) -- padding rows
    point at the engine's null slot and are discarded;
  * prompt lengths round **up** to a multiple of ``len_step`` -- prompts
    are right-padded and prefilled with ``true_len`` (``models/lm.py``),
    which keeps the pad junk out of the logits and the KV cache.

Eager PyTorch compiles nothing per shape, but the bucket grid still bounds
the set of kernel shapes a run launches, and ``ServeEngine.warmup`` runs
each of them once before traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["BucketSpec", "default_buckets"]


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """The bucket grid: decode batch sizes + prefill length step."""

    batch_buckets: Tuple[int, ...]  # ascending, last == engine slot count
    len_step: int  # prompt lengths round up to a multiple of this
    max_prompt_len: int  # longest bucketed prompt (inclusive)

    def __post_init__(self):
        if not self.batch_buckets:
            raise ValueError("BucketSpec needs at least one batch bucket")
        if tuple(sorted(self.batch_buckets)) != tuple(self.batch_buckets):
            raise ValueError(f"batch buckets must ascend: {self.batch_buckets}")
        if self.len_step < 1:
            raise ValueError(f"len_step must be >= 1, got {self.len_step}")
        if self.max_prompt_len < self.len_step:
            raise ValueError(
                f"max_prompt_len {self.max_prompt_len} < len_step "
                f"{self.len_step}"
            )

    def bucket_batch(self, n: int) -> int:
        """Smallest batch bucket >= n (the decode step's padded batch)."""
        if n < 1:
            raise ValueError(f"batch must be >= 1, got {n}")
        for b in self.batch_buckets:
            if b >= n:
                return b
        raise ValueError(
            f"active batch {n} exceeds the largest bucket "
            f"{self.batch_buckets[-1]} (engine slot count)"
        )

    def bucket_len(self, prompt_len: int) -> int:
        """Prompt length rounded up to the bucket grid."""
        if prompt_len < 1:
            raise ValueError(f"prompt length must be >= 1, got {prompt_len}")
        b = ((prompt_len + self.len_step - 1) // self.len_step) * self.len_step
        if b > self.max_prompt_len:
            raise ValueError(
                f"prompt length {prompt_len} exceeds max bucketed length "
                f"{self.max_prompt_len}"
            )
        return b

    @property
    def prefill_lens(self) -> Tuple[int, ...]:
        """Every prefill shape the engine can dispatch — the warmup set."""
        return tuple(
            range(self.len_step, self.max_prompt_len + 1, self.len_step)
        )

    @property
    def decode_batches(self) -> Tuple[int, ...]:
        """Every decode batch shape the engine can dispatch."""
        return self.batch_buckets


def default_buckets(
    n_slots: int, max_prompt_len: int, window: int = 0, len_step: int = 0
) -> BucketSpec:
    """Sensible grid for an engine with ``n_slots`` slots.

    Batch buckets are the powers of two up to ``n_slots`` (plus
    ``n_slots`` itself).  The length step defaults to 16 and is raised to
    a multiple of ``window`` when the arch has windowed layers, so padded
    prefills stay ring-alignable.
    """
    buckets = []
    b = 1
    while b < n_slots:
        buckets.append(b)
        b *= 2
    buckets.append(n_slots)
    step = len_step or 16
    if window:
        step = max(step, window)
        step = ((step + window - 1) // window) * window
    max_len = ((max_prompt_len + step - 1) // step) * step
    return BucketSpec(tuple(buckets), step, max_len)
