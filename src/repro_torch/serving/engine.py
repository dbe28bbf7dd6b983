"""Continuous-batching serving engine with per-request-class policy scopes.

Lifecycle of a request (``Request``/``RequestState``):

  QUEUED            submitted, waiting FCFS for a slot + admission budget
  ACTIVE            admitted: prefilled into a ``PagedKVCache`` slot, decoding
  FINISHED          emitted ``max_new`` tokens (or hit the cache extent)
  EVICTED           cancelled mid-stream (or its decode step crashed)
  DEADLINE_EXCEEDED its wall-clock deadline passed; evicted between steps

Between decode steps the scheduler admits queued requests (strict FCFS,
gated by free slots and a max-tokens budget) and evicts finished or
cancelled ones, so the decode batch is recomposed every step.  Every
request carries a class (``interactive`` / ``bulk``) mapped to its own
``SelectionPolicy``; each class's prefill and decode run inside
``use_policy(policy)``, so the two classes route the same GEMM shapes
through different candidates, and ``class_reports()`` renders one
``dispatch_report`` per class.

Crash containment is the JAX engine's: a prefill or decode step that
raises evicts the requests of that batch, counts a ``crashed_steps`` and
the engine keeps serving.  A caller that must not tolerate a crash (a
smoke test, a benchmark) checks ``health()["crashed_steps"] == 0``.
Decode batches are bucketed (``buckets.BucketSpec``): padding rows point
at the cache's null slot with length 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import threading
import time
import warnings
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.engine import dispatch_report
from repro_torch.core.policy import SelectionPolicy, use_policy
from repro_torch.models import lm

from .buckets import BucketSpec, default_buckets
from .kv_cache import PagedKVCache

__all__ = ["Request", "RequestState", "ServeEngine", "QueueFullError"]


class RequestState(enum.Enum):
    QUEUED = "queued"
    ACTIVE = "active"
    FINISHED = "finished"
    EVICTED = "evicted"
    DEADLINE_EXCEEDED = "deadline_exceeded"


# states a request never leaves (slot released, out of queue)
TERMINAL_STATES = (
    RequestState.FINISHED,
    RequestState.EVICTED,
    RequestState.DEADLINE_EXCEEDED,
)


class QueueFullError(RuntimeError):
    """Admission queue at capacity -- explicit backpressure."""


@dataclasses.dataclass
class Request:
    """One generation request and its runtime bookkeeping."""

    rid: int
    tokens: np.ndarray  # (prompt_len,) int32 prompt
    max_new: int
    cls: str = "interactive"
    deadline_s: Optional[float] = None  # wall-clock budget from submit
    # runtime state (engine-owned)
    state: RequestState = RequestState.QUEUED
    slot: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    token_lat: List[float] = dataclasses.field(default_factory=list)
    submit_step: int = -1
    admit_step: int = -1
    finish_step: int = -1
    submit_time: float = 0.0  # monotonic wall clock at submit

    def overdue(self, now: float) -> bool:
        return self.deadline_s is not None and now - self.submit_time >= self.deadline_s

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[-1])

    @property
    def reserve(self) -> int:
        """Tokens this request can occupy -- the admission-budget unit."""
        return self.prompt_len + self.max_new


def _policy_scope(policy: Optional[SelectionPolicy]):
    return use_policy(policy) if policy is not None else contextlib.nullcontext()


class ServeEngine:
    """Request-queue engine: continuous batching over a paged KV cache.

    ``policies`` maps request classes to ``SelectionPolicy`` instances
    (``None``: the caller's scope).  ``budget_tokens`` caps the sum of
    ``prompt_len + max_new`` over admitted requests (default:
    ``n_slots * max_seq``); admission is strictly FCFS.  ``max_queue``
    bounds the waiting queue (default ``8 * n_slots``).  ``params`` must
    lie on ``device``; asking for CUDA without a card raises
    ``RuntimeError``.
    """

    def __init__(
        self,
        cfg,
        params,
        *,
        n_slots: int = 8,
        max_seq: int = 128,
        policies: Optional[Dict[str, Optional[SelectionPolicy]]] = None,
        bucket_spec: Optional[BucketSpec] = None,
        budget_tokens: Optional[int] = None,
        max_queue: Optional[int] = None,
        cache_dtype=torch.bfloat16,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if cfg.input_mode != "tokens":
            raise ValueError(
                f"ServeEngine serves token LMs; arch {cfg.name!r} has "
                f"input_mode={cfg.input_mode!r}"
            )
        self.cfg = cfg
        self.params = params
        self.max_seq = int(max_seq)
        self.policies = dict(policies or {"interactive": None, "bulk": None})
        self.cache_dtype = cache_dtype
        self.kv = PagedKVCache(cfg, n_slots, max_seq, dtype=cache_dtype, device=self.device)
        windows = [b.window for _, blocks in cfg.segments for b in blocks
                   if b.window is not None]
        self.buckets = bucket_spec or default_buckets(
            n_slots, max_seq, window=max(windows) if windows else 0
        )
        if self.buckets.batch_buckets[-1] > n_slots:
            raise ValueError(
                f"largest batch bucket {self.buckets.batch_buckets[-1]} "
                f"exceeds slot count {n_slots}"
            )
        self.budget_tokens = int(budget_tokens) if budget_tokens else n_slots * self.max_seq
        self.max_queue = int(max_queue) if max_queue else 8 * n_slots
        # graceful-degradation counters (health())
        self.crashed_steps = 0
        self.deadline_evictions = 0
        self.rejected_submits = 0
        self.run_seconds = 0.0  # wall time spent in run()
        # admission state is the submit/step contention surface
        self._lock = threading.Lock()
        self.queue: deque = deque()  # guarded-by: _lock
        self.requests: Dict[int, Request] = {}
        self.clock = 0  # engine iterations
        self._next_rid = 0
        self._reserved = 0  # guarded-by: _lock

    # -- steps (run under the class's policy scope) --------------------------

    def _decode_step(self, cls: str, tok, slot_ids, lengths) -> torch.Tensor:
        """Decode one bucketed batch: gather its slots' cache rows, run
        ``lm_decode`` (which writes each row's new K/V in place), and copy
        the rows back into the pool in place.  Padding rows all target
        the null slot, so duplicate copies land only there."""
        with _policy_scope(self.policies[cls]):
            gathered = [
                tuple({k: leaf.index_select(1, slot_ids) for k, leaf in slot.items()}
                      for slot in seg)
                for seg in self.kv.data
            ]
            logits, new = lm.lm_decode(
                self.params, self.cfg, {"segments": gathered, "pos": lengths},
                {"tokens": tok},
            )
            for big, rows in zip(self.kv.leaves(), self.kv.leaves(new["segments"])):
                big.index_copy_(1, slot_ids, rows)
            return torch.argmax(logits[:, -1, : self.cfg.vocab], dim=-1)

    def _prefill_step(self, cls: str, tokens, true_len: int):
        with _policy_scope(self.policies[cls]):
            logits, cache = lm.lm_prefill(
                self.params, self.cfg, {"tokens": tokens}, max_seq=self.max_seq,
                cache_dtype=self.cache_dtype, true_len=true_len,
            )
            return torch.argmax(logits[:, -1, : self.cfg.vocab], dim=-1), cache

    # -- request lifecycle -------------------------------------------------

    def submit(self, tokens, max_new: int, cls: str = "interactive",
               deadline_s: Optional[float] = None) -> Request:
        """Queue one request (FCFS).  Raises ``QueueFullError`` when the
        admission queue is at ``max_queue``."""
        with self._lock:
            if len(self.queue) >= self.max_queue:
                self.rejected_submits += 1
                raise QueueFullError(
                    f"admission queue is full ({self.max_queue} waiting); "
                    "shed load or retry after the queue drains"
                )
        if cls not in self.policies:
            raise KeyError(
                f"unknown request class {cls!r}; engine classes: {sorted(self.policies)}"
            )
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size < 1:
            raise ValueError("request needs at least one prompt token")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if tokens.size + max_new > self.max_seq:
            raise ValueError(
                f"request needs {tokens.size} + {max_new} tokens; cache "
                f"slots hold max_seq={self.max_seq}"
            )
        self.buckets.bucket_len(tokens.size)  # fail fast on oversize
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        req = Request(
            rid=self._next_rid, tokens=tokens, max_new=int(max_new), cls=cls,
            deadline_s=deadline_s, submit_step=self.clock,
            submit_time=time.monotonic(),
        )
        self._next_rid += 1
        self.requests[req.rid] = req
        with self._lock:
            self.queue.append(req)
        return req

    def _release(self, req: Request, state: RequestState) -> None:
        """Move a live request to a terminal state, returning its slot and
        budget (ACTIVE) or its queue position (QUEUED)."""
        if req.state is RequestState.ACTIVE:
            self.kv.free(req.slot)
            with self._lock:
                self._reserved -= req.reserve
        elif req.state is RequestState.QUEUED:
            with self._lock:
                self.queue.remove(req)
        req.state = state
        req.finish_step = self.clock

    def evict(self, rid: int) -> Request:
        """Cancel a request mid-stream; an ACTIVE one's slot returns to the
        pool at once."""
        req = self.requests[rid]
        if req.state in TERMINAL_STATES:
            return req
        self._release(req, RequestState.EVICTED)
        return req

    def _finish(self, req: Request) -> None:
        self._release(req, RequestState.FINISHED)

    def _expire_deadlines(self) -> List[Request]:
        """Evict every live request past its wall-clock deadline."""
        now = time.monotonic()
        expired = []
        for req in self.requests.values():
            if req.state not in TERMINAL_STATES and req.overdue(now):
                self._release(req, RequestState.DEADLINE_EXCEEDED)
                self.deadline_evictions += 1
                expired.append(req)
        return expired

    def _admit(self) -> List[Request]:
        """FCFS admission: pop the queue head while a slot is free and the
        budget holds, prefill it, land its cache in the slot."""
        admitted = []
        while self.queue:
            with self._lock:
                if not self.queue:
                    break
                req = self.queue[0]
                if self._reserved + req.reserve > self.budget_tokens:
                    break  # head-of-line blocks: strict FCFS, no skip-ahead
                slot = self.kv.allocate(req.rid)
                if slot is None:
                    break
                self.queue.popleft()
                self._reserved += req.reserve
            req.slot = slot
            req.state = RequestState.ACTIVE
            req.admit_step = self.clock
            P = req.prompt_len
            padded = np.zeros((1, self.buckets.bucket_len(P)), np.int64)
            padded[0, :P] = req.tokens
            t0 = time.perf_counter()
            try:
                tok, cache = self._prefill_step(
                    req.cls, torch.from_numpy(padded).to(self.device), P
                )
                self.kv.insert(cache, slot, P)
                tok = int(tok[0])  # synchronises with the device
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                # contain the blast radius: this request dies, the engine lives
                self.crashed_steps += 1
                self._release(req, RequestState.EVICTED)
                warnings.warn(
                    f"prefill for request {req.rid} (class {req.cls!r}) "
                    f"crashed ({type(e).__name__}: {e}); request evicted",
                    UserWarning,
                )
                continue
            req.generated.append(tok)
            req.token_lat.append(time.perf_counter() - t0)
            admitted.append(req)
        return admitted

    def _active_by_class(self) -> Dict[str, List[Request]]:
        by_cls: Dict[str, List[Request]] = {}
        for req in self.requests.values():
            if req.state is RequestState.ACTIVE:
                by_cls.setdefault(req.cls, []).append(req)
        for reqs in by_cls.values():
            reqs.sort(key=lambda r: r.slot)
        return by_cls

    def _decode_class(self, cls: str, reqs: List[Request]) -> None:
        """One bucketed decode step for one class's active requests."""
        Bb = self.buckets.bucket_batch(len(reqs))
        slot_ids = np.full(Bb, self.kv.null_slot, np.int64)
        tok = np.zeros((Bb, 1), np.int64)
        lengths = np.zeros(Bb, np.int64)
        for i, req in enumerate(reqs):
            slot_ids[i] = req.slot
            tok[i, 0] = req.generated[-1]
            lengths[i] = self.kv.lengths[req.slot]
        t0 = time.perf_counter()
        next_tok = self._decode_step(
            cls, torch.from_numpy(tok).to(self.device),
            torch.from_numpy(slot_ids).to(self.device),
            torch.from_numpy(lengths).to(self.device),
        ).cpu().numpy()  # synchronises with the device
        dt = time.perf_counter() - t0
        self.kv.advance([r.slot for r in reqs])
        for i, req in enumerate(reqs):
            req.generated.append(int(next_tok[i]))
            req.token_lat.append(dt)
            done = len(req.generated) >= req.max_new
            # the token just written sits at lengths[i]; the next one
            # would land at lengths[i] + 1 -- stop at the cache extent
            if done or int(self.kv.lengths[req.slot]) + 1 >= self.max_seq:
                self._finish(req)

    # -- the serve loop ------------------------------------------------------

    def step(self) -> int:
        """One engine iteration: expire overdue deadlines, admit, then one
        decode step per class with active requests.  Returns the number of
        tokens emitted.  A class whose decode step raises loses only that
        batch (evicted, ``crashed_steps`` counted)."""
        before = sum(len(r.generated) for r in self.requests.values())
        self._expire_deadlines()
        self._admit()
        by_cls = self._active_by_class()
        for cls in sorted(by_cls):
            try:
                self._decode_class(cls, by_cls[cls])
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                self.crashed_steps += 1
                for req in by_cls[cls]:
                    if req.state is RequestState.ACTIVE:
                        self._release(req, RequestState.EVICTED)
                warnings.warn(
                    f"decode step for class {cls!r} crashed "
                    f"({type(e).__name__}: {e}); {len(by_cls[cls])} "
                    "request(s) evicted, engine continues",
                    UserWarning,
                )
        self.clock += 1
        return sum(len(r.generated) for r in self.requests.values()) - before

    def run(self, max_steps: int = 100_000) -> None:
        """Drain: step until queue and slots are empty."""
        t0 = time.perf_counter()
        try:
            for _ in range(max_steps):
                if not self.queue and not self.kv.owner:
                    return
                self.step()
            raise RuntimeError(f"engine did not drain within {max_steps} steps")
        finally:
            self.run_seconds += time.perf_counter() - t0

    # -- warmup + observability ----------------------------------------------

    def warmup(self) -> Dict[str, int]:
        """Run every bucketed shape once under every class policy before
        traffic: every decode-batch bucket (all rows on the null slot) and
        every prefill-length bucket.  This builds the kernels and warms
        the libraries, so no request pays for it."""
        n_shapes = 0
        for cls in sorted(self.policies):
            for Bb in self.buckets.decode_batches:
                null = torch.full((Bb,), self.kv.null_slot, dtype=torch.long,
                                  device=self.device)
                zeros = torch.zeros((Bb,), dtype=torch.long, device=self.device)
                self._decode_step(cls, zeros[:, None], null, zeros)
                n_shapes += 1
            for Lb in self.buckets.prefill_lens:
                tokens = torch.zeros((1, Lb), dtype=torch.long, device=self.device)
                self._prefill_step(cls, tokens, Lb)
                n_shapes += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.kv.lengths[:] = 0  # warmup scribbled on the null row only
        return {"shapes_run": n_shapes}

    def health(self) -> Dict[str, int]:
        """Graceful-degradation counters + terminal-state tallies."""
        by_state: Dict[str, int] = {s.value: 0 for s in RequestState}
        for req in self.requests.values():
            by_state[req.state.value] += 1
        return {
            "crashed_steps": self.crashed_steps,
            "deadline_evictions": self.deadline_evictions,
            "rejected_submits": self.rejected_submits,
            **by_state,
        }

    def class_reports(self) -> Dict[str, str]:
        """One rendered ``dispatch_report`` per request class."""
        return {
            cls: dispatch_report(policy) if policy is not None
            else "(the caller's policy scope)"
            for cls, policy in self.policies.items()
        }

    def class_dispatch_rows(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """Structured per-class decision counts: cls -> op -> label -> n."""
        return {
            cls: {} if policy is None else
            {op: dict(labels) for op, labels in policy.stats.by_op.items()}
            for cls, policy in self.policies.items()
        }

    def __repr__(self):
        active = sum(1 for r in self.requests.values() if r.state is RequestState.ACTIVE)
        return (
            f"ServeEngine(arch={self.cfg.name!r}, slots={self.kv.n_slots}, "
            f"queued={len(self.queue)}, active={active}, "
            f"classes={sorted(self.policies)}, device={self.device})"
        )
