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
at the cache's null slot with length 0.  Prompts bucket too, except for
architectures with Mamba blocks (``exact_prefill``): an SSM state sums
over every position of a right-padded prompt, so they prefill at each
prompt's exact length (mamba2, zamba2, and granite-4.0-h-small, whose
Mamba conv runs over x, B and C and whose every layer's MoE is dropless,
``models/ssm.py`` and ``models/moe.py``); the SSD keeps its chunk length
at any prompt length, padding the last chunk.

Spans (``core/spans.py``, while a profiler session runs or inside
``spans.recording()``): ``repro_torch.engine.step`` around each step;
``repro_torch.engine.prefill`` around one request's admission, from its
padded tokens to its first token's read and slot insert;
``repro_torch.engine.decode`` around one class's decode step, from its
rows to the synchronising read and the cache's advance; and
``repro_torch.engine.queued``, one request's wait from ``submit`` to the
start of its prefill, recorded at admission.  Every timestamp of the
engine (``submit_time``, ``token_lat``, deadlines, the spans) is on
``time.perf_counter``.

``ServeEngine(decode_graphs=True)`` on a card runs each class's decode
step at each batch bucket as a CUDA graph, captured by ``warmup()``
(largest bucket first, all of them in one memory pool) and replayed on
the step's slots, tokens and lengths copied into its static inputs: the
step's kernels then run without the host launching each one, so a step
takes the card's time rather than the host's.  The graph runs the eager
step's kernels on the same inputs (the same tokens, bit for bit); the
dispatch accounting hook sees the dispatches made at capture again at
every replay (``core.engine.account_replayed``), and a span or counter
inside the step records at capture only.  A step that reads the device
back cannot be captured (the f32 dropless MoE's per-expert loop reads
its row ranges): ``warmup`` raises there.  Off by default; on the CPU it
changes nothing, and a mesh refuses it.

``ServeEngine(mesh=)`` serves on a mesh: each rank holds its pieces of
the params (it shards the full ``params`` it is given) and of the cache
pool, runs the same schedule on the same requests, and takes its greedy
tokens from the gathered logits, so every rank admits, decodes and
evicts alike and issues the same collectives.  Wall-clock deadlines are
refused there: a rank's own clock would desynchronise the schedules.
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
from repro_torch.core import spans
from repro_torch.core.engine import account_dispatches, account_replayed, dispatch_report
from repro_torch.core.policy import SelectionPolicy, use_policy
from repro_torch.distributed.context import mesh_scope
from repro_torch.distributed.sharding import param_specs, shard
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
    submit_time: float = 0.0  # time.perf_counter() at submit

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


class _DecodeGraph:
    """One class's decode step at one batch bucket as a CUDA graph: its
    static inputs (all rows on the null slot until replayed), the step
    captured once after a warm-up run on a side stream, its output, and
    the outermost dispatches it made (``keys``)."""

    def __init__(self, engine: "ServeEngine", cls: str, batch: int, pool):
        dev = engine.device
        self.tok = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        self.slot_ids = torch.full((batch,), engine.kv.null_slot, dtype=torch.long, device=dev)
        self.lengths = torch.zeros((batch,), dtype=torch.long, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            engine._decode_eager(cls, self.tok, self.slot_ids, self.lengths)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.keys: List = []
        self.graph = torch.cuda.CUDAGraph()
        with account_dispatches(lambda key, operands, out: self.keys.append(key)), \
                torch.cuda.graph(self.graph, pool=pool):
            self.out = engine._decode_eager(cls, self.tok, self.slot_ids, self.lengths)

    def replay(self, tok, slot_ids, lengths) -> torch.Tensor:
        self.tok.copy_(tok)
        self.slot_ids.copy_(slot_ids)
        self.lengths.copy_(lengths)
        self.graph.replay()
        account_replayed(self.keys)
        return self.out


class ServeEngine:
    """Request-queue engine: continuous batching over a paged KV cache.

    ``policies`` maps request classes to ``SelectionPolicy`` instances
    (``None``: the caller's scope).  ``budget_tokens`` caps the sum of
    ``prompt_len + max_new`` over admitted requests (default:
    ``n_slots * max_seq``); admission is strictly FCFS.  ``max_queue``
    bounds the waiting queue (default ``8 * n_slots``).  ``params`` must
    lie on ``device``; asking for CUDA without a card raises
    ``RuntimeError``.  ``decode_graphs`` replays the decode steps as CUDA
    graphs (the module docstring).
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
        mesh=None,
        decode_graphs: bool = False,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if decode_graphs and self.mesh is not None:
            raise ValueError("decode_graphs is not served on a mesh")
        self.decode_graphs = bool(decode_graphs) and self.device.type == "cuda"
        self._graphs: Dict[tuple, "_DecodeGraph"] = {}  # (class, batch bucket) -> graph
        if cfg.input_mode != "tokens":
            raise ValueError(
                f"ServeEngine serves token LMs; arch {cfg.name!r} has "
                f"input_mode={cfg.input_mode!r}"
            )
        self.cfg = cfg
        if self.mesh is not None:
            params = shard(params, param_specs(params, self.mesh), self.mesh)
        self.params = params
        self.max_seq = int(max_seq)
        self.policies = dict(policies or {"interactive": None, "bulk": None})
        self.cache_dtype = cache_dtype
        self.kv = PagedKVCache(cfg, n_slots, max_seq, dtype=cache_dtype, device=self.device,
                               mesh=self.mesh)
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
        # SSM state is cumulative over the padded tail, so padded prefill is
        # attention-only; SSM archs prefill at exact lengths
        self.exact_prefill = any(b.mixer == "mamba" for _, blocks in cfg.segments
                                 for b in blocks)
        self.budget_tokens = int(budget_tokens) if budget_tokens else n_slots * self.max_seq
        self.max_queue = int(max_queue) if max_queue else 8 * n_slots
        # graceful-degradation counters (health())
        self.crashed_steps = 0
        self.deadline_evictions = 0
        self.rejected_submits = 0
        self.run_seconds = 0.0  # wall time spent in run()
        # each class policy's n_measured when warmup ended (cold_misses)
        self._measured_at_warmup: Dict[str, int] = {}
        # admission state is the submit/step contention surface
        self._lock = threading.Lock()
        self.queue: deque = deque()  # guarded-by: _lock
        self.requests: Dict[int, Request] = {}
        self.clock = 0  # engine iterations
        self._next_rid = 0
        self._reserved = 0  # guarded-by: _lock

    # -- steps (run under the class's policy scope) --------------------------

    def _decode_step(self, cls: str, tok, slot_ids, lengths) -> torch.Tensor:
        """Decode one bucketed batch (its class's graph at its bucket if
        ``warmup`` captured one, else ``_decode_eager``): the batch's next
        greedy tokens."""
        graph = self._graphs.get((cls, int(tok.shape[0])))
        if graph is not None:
            return graph.replay(tok, slot_ids, lengths)
        return self._decode_eager(cls, tok, slot_ids, lengths)

    def _decode_eager(self, cls: str, tok, slot_ids, lengths) -> torch.Tensor:
        """Decode one bucketed batch: gather its slots' cache rows, run
        ``lm_decode`` (which writes each row's new K/V in place), and copy
        the rows back into the pool in place.  Padding rows all target
        the null slot, so duplicate copies land only there."""
        with _policy_scope(self.policies[cls]), mesh_scope(self.mesh):
            gathered = [
                tuple({k: leaf.index_select(1, slot_ids) for k, leaf in slot.items()}
                      for slot in seg)
                for seg in self.kv.data
            ]
            logits, new = lm.lm_decode(
                self.params, self.cfg, {"segments": gathered, "pos": lengths},
                {"tokens": tok}, cache_specs=self.kv.specs,
            )
            for big, rows in zip(self.kv.leaves(), self.kv.leaves(new["segments"])):
                big.index_copy_(1, slot_ids, rows)
            logits = lm.gather_logits(self.cfg, logits)
            return torch.argmax(logits[:, -1, : self.cfg.vocab], dim=-1)

    def _prefill_step(self, cls: str, tokens, true_len: int):
        with _policy_scope(self.policies[cls]), mesh_scope(self.mesh):
            logits, cache = lm.lm_prefill(
                self.params, self.cfg, {"tokens": tokens}, max_seq=self.max_seq,
                cache_dtype=self.cache_dtype, true_len=true_len,
            )
            logits = lm.gather_logits(self.cfg, logits)
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
        if not self.exact_prefill:
            self.buckets.bucket_len(tokens.size)  # fail fast on oversize
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {deadline_s}")
        if deadline_s is not None and self.mesh is not None:
            raise ValueError("deadlines are not served on a mesh: each rank's wall clock "
                             "would expire requests at different steps")
        req = Request(
            rid=self._next_rid, tokens=tokens, max_new=int(max_new), cls=cls,
            deadline_s=deadline_s, submit_step=self.clock,
            submit_time=time.perf_counter(),
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
        now = time.perf_counter()
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
            Lb = P if self.exact_prefill else self.buckets.bucket_len(P)
            try:
                with spans.span("repro_torch.engine.prefill", rid=req.rid, bucket=Lb,
                                prompt_len=P) as rec:
                    if rec is not None:  # the wait in the queue ends where prefill starts
                        spans.record("repro_torch.engine.queued",
                                     int(req.submit_time * 1e9), rec.start_ns,
                                     rid=req.rid, cls=req.cls)
                    padded = np.zeros((1, Lb), np.int64)
                    padded[0, :P] = req.tokens
                    t0 = time.perf_counter()
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
        with spans.span("repro_torch.engine.decode", cls=cls, rows=len(reqs), bucket=Bb):
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
        with spans.span("repro_torch.engine.step", clock=self.clock):
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
        every prefill-length bucket (none under ``exact_prefill``, whose
        prompt lengths are not known ahead).  This builds the kernels and
        warms the libraries, so no request pays for it, and an autotune
        class measures its keys here: each class's ``n_measured`` is
        recorded for ``cold_misses``.  With ``decode_graphs`` it then
        captures every decode step (the module docstring)."""
        n_shapes = 0
        for cls in sorted(self.policies):
            for Bb in self.buckets.decode_batches:
                null = torch.full((Bb,), self.kv.null_slot, dtype=torch.long,
                                  device=self.device)
                zeros = torch.zeros((Bb,), dtype=torch.long, device=self.device)
                self._decode_step(cls, zeros[:, None], null, zeros)
                n_shapes += 1
            for Lb in () if self.exact_prefill else self.buckets.prefill_lens:
                tokens = torch.zeros((1, Lb), dtype=torch.long, device=self.device)
                self._prefill_step(cls, tokens, Lb)
                n_shapes += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.decode_graphs and not self._graphs:
            torch.cuda.empty_cache()  # the eager steps' blocks, for the graphs' pool
            pool = torch.cuda.graph_pool_handle()
            for cls in sorted(self.policies):
                for Bb in sorted(self.buckets.decode_batches, reverse=True):
                    self._graphs[(cls, Bb)] = _DecodeGraph(self, cls, Bb, pool)
            torch.cuda.synchronize(self.device)
        self.kv.lengths[:] = 0  # warmup scribbled on the null row only
        for cls, policy in self.policies.items():
            self._measured_at_warmup[cls] = getattr(policy, "n_measured", 0)
        return {"shapes_run": n_shapes}

    def cold_misses(self) -> Dict[str, int]:
        """Per-class autotune measurements made *after* warmup -- the
        bucketed serve loop must keep these at zero."""
        return {cls: getattr(policy, "n_measured", 0) - self._measured_at_warmup.get(cls, 0)
                for cls, policy in self.policies.items()}

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
