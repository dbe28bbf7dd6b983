"""Selection policies + context-scoped dispatch.

Which implementation runs an op is a pluggable policy, scoped with a
``contextvars.ContextVar`` so nested ``with`` blocks restore the outer
policy and concurrent threads see their own:

    with use_policy(FixedPolicy("PALLAS_TNN")):
        logits, cache = lm.lm_prefill(params, cfg, batch, max_seq=64)

Every policy's ``select`` takes an ``OpKey`` (``core/opkey.py``) and
returns a ``Decision(name, config)``.  The policy zoo, as in the JAX
package:

  ModelPolicy     the paper's learned selector (GBDT binary or k-way)
  FixedPolicy     force one candidate per op -- baselines and A/B arms
  AnalyticPolicy  argmin of the analytic cost model (``core/simulate.py``)
  CascadePolicy   ordered preference list with OOM + distributed fallback
  AutotunePolicy  argmin of measurements on the device
                  (``core/measure.py``), measuring cold keys

Outside any ``use_policy`` scope, ``current_policy()`` is
``default_policy()``: the default learned selector.  A gradient is
selected under the scope in which the backward runs: wrap the forward and
``backward()`` in one ``use_policy`` block (``resume_scope`` says how the
autograd engine's device threads find it).  A backward whose forward's
block has closed raises; the default policy never stands in for it.

A decision's config reaches the kernel (``kernels/tiling.py``): the
learned policy attaches its artifact's tuned tile for the shape
(``MTNNSelector.tile_config_for``), the autotune policy the measured
fastest config, a fixed or cascade entry its ``@tile``.  The analytic
policy attaches ``config=None``: the wrappers' own cost models are the
port's analytic tile choice.

PyTorch runs eagerly, so a policy selects on every call (JAX selects
once per key at trace time).  The learned, analytic and autotune policies
memoise their decision per ``OpKey``, and drop their memos when the
quarantine ledger changes (``faults.quarantine_epoch``), so a memo never
brings back an arm that failed at dispatch; ``stats`` counts every call.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import (
    Dict,
    Iterator,
    NamedTuple,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    runtime_checkable,
)

from . import faults
from .candidates import (
    CANDIDATES,
    DEFAULT_BY_OP,
    Candidate,
    candidate_allowed,
    candidate_fits_memory,
    get_candidate,
)
from .hardware import H100, HardwareSpec
from .opkey import OPS, OpKey, check_op, coerce_key

__all__ = [
    "OpKey",
    "OPS",
    "Decision",
    "SelectorStats",
    "SelectionPolicy",
    "PolicyBase",
    "ModelPolicy",
    "FixedPolicy",
    "AnalyticPolicy",
    "CascadePolicy",
    "AutotunePolicy",
    "PolicyScope",
    "use_policy",
    "current_policy",
    "default_policy",
    "current_scope",
    "resume_scope",
]


class Decision(NamedTuple):
    """One dispatch decision: the candidate to run and the tile config to
    run it at (``None``: the candidate's default)."""

    name: str
    config: Optional[Tuple[int, ...]] = None

    def label(self) -> str:
        """Report form: ``NAME`` or ``NAME@BMxBNxBK``."""
        if self.config is None:
            return self.name
        from repro_torch.kernels.common import config_key

        return f"{self.name}@{config_key(self.config)}"


@dataclass
class SelectorStats:
    """Per-candidate, per-(candidate, tile-config) and per-op decision
    counts, one per dispatched call."""

    calls: int = 0
    by_candidate: Dict[str, int] = field(default_factory=dict)
    by_decision: Dict[str, int] = field(default_factory=dict)
    by_op: Dict[str, Dict[str, int]] = field(default_factory=dict)

    def record(self, name: str, config=None, op: str = "NT") -> None:
        self.calls += 1
        self.by_candidate[name] = self.by_candidate.get(name, 0) + 1
        label = Decision(name, config).label()
        self.by_decision[label] = self.by_decision.get(label, 0) + 1
        per_op = self.by_op.setdefault(op, {})
        per_op[label] = per_op.get(label, 0) + 1

    def reset(self) -> None:
        self.calls = 0
        self.by_candidate = {}
        self.by_decision = {}
        self.by_op = {}


@runtime_checkable
class SelectionPolicy(Protocol):
    """Anything that picks a (candidate, tile config) for an ``OpKey`` and
    exposes ``stats`` (``calls``, ``by_candidate``, ``by_op``)."""

    stats: "object"

    def select(self, key: "OpKey") -> "Decision":
        ...


class PolicyBase:
    """Shared guards of the policy zoo -- the paper's OOM check, the
    distributed-safety and op-support filters -- and the decision
    counters.  ``hardware`` (default ``H100``) sets the memory budget."""

    def __init__(
        self,
        hardware: Optional[HardwareSpec] = None,
        distributed: bool = False,
        mem_budget_frac: float = 0.9,
    ):
        self.hardware = hardware or H100
        self.distributed = distributed
        self.mem_budget_frac = mem_budget_frac
        self.stats = SelectorStats()
        # the memoising policies drop their memo when the quarantine ledger
        # moved: a memo hit must never bring back an arm that has since been
        # quarantined (or keep avoiding one that was cleared)
        self._q_watch = faults.QuarantineWatch()

    def _admissible(self, cand: Candidate, key: OpKey, config=None) -> bool:
        return candidate_fits_memory(
            cand, key.m, key.n, key.k, key.dsize,
            self.hardware.mem_gib, self.mem_budget_frac, op=key.op, g=key.g,
        ) and candidate_allowed(cand, self.distributed, op=key.op, config=config)

    def select(self, key: OpKey) -> Decision:
        raise NotImplementedError


class FixedPolicy(PolicyBase):
    """Always run one candidate per op -- baselines and forced A/B arms.

    Single-name form: ``FixedPolicy("PALLAS_NT")`` forces that candidate
    for the op kinds it implements; other ops run the op's reference
    (``DEFAULT_BY_OP``).  An optional ``config`` forces one tile too
    (tunable candidates only).

    Op-qualified form: ``FixedPolicy(by_op={"NT": "XLA_NT", "ATTN":
    ("FUSED_ATTN", (64, 64))})`` forces a (candidate, tile) per op -- the
    ``fixed:nt=...,attn=...`` spec grammar builds this.
    """

    def __init__(
        self,
        name: Optional[str] = None,
        config: Optional[Tuple[int, ...]] = None,
        by_op: Optional[Dict[str, object]] = None,
    ):
        super().__init__()
        if name is None and not by_op:
            raise ValueError("FixedPolicy needs a candidate name or a by_op table")
        if name is None and config is not None:
            raise ValueError("FixedPolicy(config=...) needs a candidate name")
        self.by_op: Dict[str, Tuple[str, Optional[Tuple[int, ...]]]] = {}
        for op, entry in (by_op or {}).items():
            check_op(op)
            cand_name, cfg = entry if isinstance(entry, tuple) else (entry, None)
            self.by_op[op] = (cand_name, self._validate(cand_name, cfg, op=op))
        self.name = name
        self.config = None
        if name is not None:
            self.config = self._validate(name, config)
            for op in get_candidate(name).ops:
                self.by_op.setdefault(op, (name, self.config))

    @staticmethod
    def _validate(name, config, op: Optional[str] = None):
        cand = get_candidate(name)  # fail fast on unknown names
        if op is not None and op not in cand.ops:
            raise ValueError(
                f"candidate {name!r} does not implement op {op!r} "
                f"(implements {cand.ops})"
            )
        if config is not None:
            from repro_torch.kernels.common import validate_config

            config = validate_config(config, arity=cand.config_arity)
            if not cand.tunable:
                raise ValueError(
                    f"candidate {name!r} is not tunable; it cannot take a "
                    f"forced tile config {config}"
                )
        return config

    def select(self, key: OpKey) -> Decision:
        key = coerce_key(key)
        entry = self.by_op.get(key.op)
        if entry is None:
            # op not forced: run the op's reference instead of mis-dispatching
            entry = (DEFAULT_BY_OP[key.op], None)
        decision = Decision(*entry)
        self.stats.record(decision.name, decision.config, op=key.op)
        return decision

    def __repr__(self):
        if self.name is not None and self.config is not None:
            return f"FixedPolicy({self.name!r}, config={self.config})"
        if self.name is not None:
            return f"FixedPolicy({self.name!r})"
        table = {op: Decision(*entry).label() for op, entry in self.by_op.items()}
        return f"FixedPolicy(by_op={table})"


class ModelPolicy:
    """The paper's learned selector as a policy.

    Thin adapter over ``MTNNSelector`` (which implements the GBDT / k-way
    decision, its per-key memo, the OOM guard and the distributed
    filter); stats are the selector's own, so a report covers dispatches
    made through either API.  A decision carries the artifact's tuned tile
    for its shape (``tile_config_for``), memoised per (candidate,
    ``OpKey``)."""

    def __init__(self, selector=None):
        if selector is None:
            from .selector import default_selector

            selector = default_selector()
        self.selector = selector
        self._configs: Dict[Tuple[str, OpKey], Optional[Tuple[int, ...]]] = {}

    @classmethod
    def from_artifact(cls, path: str, **kw) -> "ModelPolicy":
        from .selector import MTNNSelector

        return cls(MTNNSelector.load(path, **kw))

    @property
    def stats(self):
        return self.selector.stats

    def select(self, key: OpKey) -> Decision:
        key = coerce_key(key)
        name = self.selector.select(key)
        memo = (name, key)
        if memo not in self._configs:
            self._configs[memo] = self.selector.tile_config_for(
                name, key.dsize, op=key.op, mnk=key.mnk(), g=key.g)
        return Decision(name, self._configs[memo])

    def __repr__(self):
        return f"ModelPolicy(mode={self.selector.mode!r}, hw={self.selector.hardware.name!r})"


class AnalyticPolicy(PolicyBase):
    """Roofline argmin: pick the candidate whose analytic-cost-model arm
    (``core/simulate.py``, datasheet peaks of ``hardware``) predicts the
    lowest time.  Needs no training data -- the zero-shot answer for a
    device with no measured dataset, and the autotune fallback.  The
    decision is memoised per ``OpKey``."""

    def __init__(
        self,
        hardware: Optional[HardwareSpec] = None,
        candidates: Optional[Sequence[str]] = None,
        sigma: float = 0.0,  # deterministic by default: no modelled noise
        **kw,
    ):
        super().__init__(hardware=hardware, **kw)
        self.candidates = tuple(candidates or CANDIDATES)
        for name in self.candidates:
            get_candidate(name)
        self.sigma = sigma
        self._cache: Dict[OpKey, Decision] = {}

    def select(self, key: OpKey) -> Decision:
        from .simulate import simulate_time

        key = coerce_key(key)
        if self._q_watch.moved():
            self._cache.clear()
        decision = self._cache.get(key)
        if decision is None:
            best_t, name = None, None
            for cand_name in self.candidates:
                cand = get_candidate(cand_name)
                if not self._admissible(cand, key):
                    continue
                t = simulate_time(
                    self.hardware, cand.sim_algo, key.m, key.n, key.k,
                    key.dsize, sigma=self.sigma, g=key.g,
                )
                if best_t is None or t < best_t:
                    best_t, name = t, cand_name
            # nothing admissible: the op's reference
            decision = Decision(name or DEFAULT_BY_OP[key.op], None)
            self._cache[key] = decision
        self.stats.record(decision.name, decision.config, op=key.op)
        return decision

    def __repr__(self):
        return f"AnalyticPolicy(hw={self.hardware.name!r}, candidates={self.candidates})"


class CascadePolicy(PolicyBase):
    """Ordered preference list: first admissible candidate wins.

    Admissibility honours the paper's OOM guard (extra-memory candidates
    must fit the budget) and the distributed-safety filter.  An entry may
    carry a tile, ``NAME@BMxBNxBK``: it is admissible only at shapes where
    its kernel has that plan, and its decision carries the tile.  The
    *last* entry is the unconditional fallback -- it is returned even when
    its own guards fail, so the cascade always produces a runnable
    candidate (mirror of the paper's "if B^T does not fit, use NT").
    """

    def __init__(self, names: Sequence[str], **kw):
        super().__init__(**kw)
        from repro_torch.kernels.tiling import parse_config_key

        entries = []
        for entry in names:
            name, _, cfg = str(entry).partition("@")
            cand = get_candidate(name)
            config = parse_config_key(cfg, arity=cand.config_arity) if cfg else None
            if config is not None and not cand.tunable:
                raise ValueError(f"candidate {name!r} is not tunable; it cannot take {cfg!r}")
            entries.append((name, config))
        if not entries:
            raise ValueError("CascadePolicy needs at least one candidate name")
        self.entries = tuple(entries)
        self.names = tuple(name for name, _ in entries)

    def select(self, key: OpKey) -> Decision:
        key = coerce_key(key)
        shape = (key.g, key.m, key.n, key.k, key.dsize)
        chosen = None
        for name, config in self.entries:
            cand = get_candidate(name)
            if self._admissible(cand, key, config) and (
                    config is None or cand.supports(op=key.op, config=config, shape=shape)):
                chosen = Decision(name, config)
                break
        if chosen is None:
            # unconditional fallback: the last entry when it can run this op
            # at all, else the op's reference (a cascade written for the
            # forward op must not mis-dispatch a backward GEMM)
            last = self.entries[-1]
            chosen = (Decision(*last) if key.op in get_candidate(last[0]).ops
                      else Decision(DEFAULT_BY_OP[key.op], None))
        self.stats.record(chosen.name, chosen.config, op=key.op)
        return chosen

    def __repr__(self):
        return f"CascadePolicy({[Decision(*e).label() for e in self.entries]!r})"


class AutotunePolicy(PolicyBase):
    """Measurement-backed selection: argmin of timings on ``device``.

    ``select`` answers from a persistent ``MeasurementCache`` (warm hit);
    on a cold key it measures every admissible candidate right there
    (``measure.measure_candidates``: each under ``"default"`` and a
    tunable one at up to ``max_tile_configs`` configs of its shortlist,
    in device time on the card, so that host noise picks no tile), stores
    the result and persists the cache, and dispatches the fastest
    (candidate, config) pair; ``n_measured`` counts the cold keys.  When
    measurement is disabled -- ``measure=False``, ``distributed=True``, a
    dtype width with no measurable dtype, or a key over
    ``max_measure_flops`` -- it answers with ``AnalyticPolicy``.  A
    (candidate, config) pair hit by an injected fault while it is
    measured is retried with backoff and, if it keeps failing, dropped
    from the measurement (``failures`` keeps its error); the try counts
    persist beside the cache entry (``MeasurementCache.get_attempts``).
    Any other error of a candidate raises out of ``select``.

    ``device`` is where measurements run (default ``cuda``; resolved at
    the first measurement, so building the policy needs no card).  Cache
    keys carry the platform (``gpu``/``cpu``) and the hardware name, so one
    file can hold measurements of several devices without cross-talk.
    """

    def __init__(
        self,
        cache=None,
        cache_path: Optional[str] = None,
        hardware: Optional[HardwareSpec] = None,
        candidates: Optional[Sequence[str]] = None,
        measure: bool = True,
        warmup: int = 1,
        reps: int = 3,
        max_measure_flops: float = 1e11,
        device="cuda",
        max_tile_configs: int = 4,
        **kw,
    ):
        import torch

        from .hardware import device_spec
        from .measure import MeasurementCache

        self.device = torch.device(device)
        if hardware is None and (self.device.type != "cuda" or torch.cuda.is_available()):
            hardware = device_spec(self.device)
        super().__init__(hardware=hardware, **kw)
        if cache is None:
            # recover=True: a corrupt/truncated cache file is moved aside
            # and rebuilt empty -- autotune re-measures instead of crashing
            cache = (
                MeasurementCache.load(cache_path, recover=True)
                if cache_path
                else MeasurementCache()
            )
        elif cache_path is not None:
            # a caller handing both means "use this cache, persist it here"
            cache.path = cache_path
        self.cache = cache
        self.candidates = tuple(candidates or CANDIDATES)
        for name in self.candidates:
            get_candidate(name)
        self.measure = measure
        self.warmup = warmup
        self.reps = reps
        self.max_measure_flops = max_measure_flops
        self.max_tile_configs = max_tile_configs
        # the fallback honours the same candidate restriction, so a policy
        # scoped to a subset can never dispatch outside it via the fallback
        self.fallback = AnalyticPolicy(
            hardware=self.hardware,
            candidates=self.candidates,
            distributed=self.distributed,
            mem_budget_frac=self.mem_budget_frac,
        )
        # observability: cold keys measured / warm hits / analytic fallbacks,
        # and the (candidate, config) pairs a measurement dropped
        self.failures: Dict[str, Dict[str, str]] = {}
        self.n_measured = 0
        self.n_cache_hits = 0
        self.n_fallbacks = 0
        self._decisions: Dict[OpKey, Decision] = {}

    def _can_measure(self, dtype: Optional[str], flops: float) -> bool:
        return (
            self.measure
            and not self.distributed
            and dtype is not None
            and flops <= self.max_measure_flops
        )

    def select(self, key: OpKey) -> Decision:
        from .measure import DTYPE_BY_DSIZE, measure_candidates

        key = coerce_key(key)
        if self._q_watch.moved():
            self._decisions.clear()
        hit = self._decisions.get(key)
        if hit is not None:
            self.n_cache_hits += 1
            self.stats.record(hit.name, hit.config, op=key.op)
            return hit
        dtype = DTYPE_BY_DSIZE.get(key.dsize)
        cache_key = (
            "gpu" if self.device.type == "cuda" else self.device.type,
            self.hardware.name,
            dtype or f"{8 * key.dsize}-bit",
            key.op,
            key.g,
            key.m,
            key.n,
            key.k,
        )
        times = self.cache.get(cache_key)
        if times is not None:
            self.n_cache_hits += 1
        elif self._can_measure(dtype, 2.0 * key.g * key.m * key.n * key.k):
            attempts: Dict[str, Dict[str, int]] = {}
            times = measure_candidates(
                key.m, key.n, key.k,
                dtype=dtype,
                op=key.op,
                g=key.g,
                candidates=self.candidates,
                hardware=self.hardware,
                distributed=self.distributed,
                mem_budget_frac=self.mem_budget_frac,
                warmup=self.warmup,
                reps=self.reps,
                device=self.device,
                max_tile_configs=self.max_tile_configs,
                queued=True,
                attempts=attempts,
                failures=self.failures,
            )
            self.n_measured += 1
            if times:
                self.cache.put(cache_key, times, attempts=attempts)
                if self.cache.path:
                    self.cache.save()
        decision = None
        if times:
            # re-filter at use time: cached entries may predate a registry /
            # distributed-mode / candidate-restriction change, and a config
            # the candidate's kernel has no plan for at this shape (a
            # foreign or corrupt key) never dispatches
            from repro_torch.kernels.tiling import parse_config_key

            best = None
            shape = (key.g, key.m, key.n, key.k, key.dsize)
            for cand_name, cfgs in times.items():
                if cand_name not in self.candidates or cand_name not in CANDIDATES:
                    continue
                cand = get_candidate(cand_name)
                if not self._admissible(cand, key):
                    continue
                for cfg_key, t in cfgs.items():
                    try:
                        cfg = parse_config_key(cfg_key, arity=cand.config_arity)
                    except ValueError:
                        continue
                    if cfg is not None and not (cand.supports(config=cfg, shape=shape)
                                                and self._admissible(cand, key, cfg)):
                        continue
                    if best is None or t < best:
                        best, decision = t, Decision(cand_name, cfg)
        if decision is None:
            self.n_fallbacks += 1
            decision = self.fallback.select(key)
        self._decisions[key] = decision
        self.stats.record(decision.name, decision.config, op=key.op)
        return decision

    def __repr__(self):
        return (
            f"AutotunePolicy(hw={self.hardware.name!r}, "
            f"cache={len(self.cache)} shapes, path={self.cache.path!r}, "
            f"measure={self.measure}, device={str(self.device)!r})"
        )


# -- context scoping ----------------------------------------------------------


class PolicyScope:
    """One ``use_policy`` block: its policy, and whether it is still open.
    The backward of a dispatched op and the recompute of a checkpointed
    unit keep the scope their forward ran under (``resume_scope``)."""

    __slots__ = ("policy", "open")

    def __init__(self, policy: SelectionPolicy):
        self.policy = policy
        self.open = True


_SCOPE: contextvars.ContextVar[Optional[PolicyScope]] = contextvars.ContextVar(
    "repro_torch_policy_scope", default=None
)


def current_scope() -> Optional[PolicyScope]:
    """The innermost open ``use_policy`` block of this thread, or None."""
    return _SCOPE.get()


# Default-policy cache: one ModelPolicy per default MTNNSelector instance,
# so `set_default_selector` swaps are honoured without rebuilding stats.
_default_pair: Tuple[Optional[object], Optional[ModelPolicy]] = (None, None)


def default_policy() -> SelectionPolicy:
    """The ambient policy: the default learned selector (trained at first
    use on the analytic H100 dataset), distributed-safe -- what dispatch
    uses outside any ``use_policy`` scope."""
    global _default_pair
    from .selector import default_selector

    sel = default_selector()
    cached_sel, cached_pol = _default_pair
    if cached_sel is not sel:
        cached_pol = ModelPolicy(sel)
        _default_pair = (sel, cached_pol)
    return cached_pol


def current_policy() -> SelectionPolicy:
    """The policy in scope: the innermost ``use_policy``, else
    ``default_policy()``."""
    scope = _SCOPE.get()
    return scope.policy if scope is not None else default_policy()


@contextlib.contextmanager
def use_policy(policy) -> Iterator[SelectionPolicy]:
    """Scope ``policy`` over a ``with`` block.  Accepts a
    ``SelectionPolicy`` or a bare candidate name (sugar for
    ``FixedPolicy``).  Nesting restores the outer policy on exit."""
    if isinstance(policy, str):
        policy = FixedPolicy(policy)
    scope = PolicyScope(policy)
    token = _SCOPE.set(scope)
    try:
        yield policy
    finally:
        scope.open = False
        _SCOPE.reset(token)


@contextlib.contextmanager
def resume_scope(scope: Optional[PolicyScope]) -> Iterator[None]:
    """Run a backward (or a checkpoint's recompute) under the policy in
    scope in this thread, as the JAX package selects under the scope that
    wraps ``value_and_grad``.  A thread with no policy in scope -- the
    autograd engine runs the backward of CUDA tensors on a device thread
    of its own, which does not see the caller's context variables --
    re-enters ``scope``, the block the forward ran under, if that block is
    still open.  If that block has closed, this raises: the default
    policy never stands in for the scope a forward was selected under.
    A forward that ran with no scope (``scope`` None) has its backward
    selected by whatever this thread has in scope, the default included."""
    if _SCOPE.get() is None and scope is not None:
        if not scope.open:
            raise RuntimeError(
                "no dispatch policy in scope for this backward: the "
                "use_policy block its forward ran under has closed, and the "
                "default policy does not stand in for it -- run the forward "
                "and backward() in one use_policy block"
            )
        token = _SCOPE.set(scope)
        try:
            yield
        finally:
            _SCOPE.reset(token)
    else:
        yield
