"""Selection policies + context-scoped dispatch.

Which implementation runs an op is a pluggable policy, scoped with a
``contextvars.ContextVar`` so nested ``with`` blocks restore the outer
policy and concurrent threads see their own:

    with use_policy(FixedPolicy("PALLAS_TNN")):
        logits, cache = lm.lm_prefill(params, cfg, batch, max_seq=64)

Every policy's ``select`` takes an ``OpKey`` (``core/opkey.py``) and
returns a ``Decision(name, config)``.  This slice ports ``FixedPolicy``
(single-name and op-qualified forms).  The learned, analytic, cascade
and autotune policies are ROADMAP queue A, "The selector stack"; so is
the ambient default policy: outside any ``use_policy`` scope,
``current_policy()`` raises.

PyTorch runs eagerly, so a policy selects on every call (JAX selects
once per key at trace time).  ``stats`` counts every call.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Dict, Iterator, NamedTuple, Optional, Protocol, Tuple, runtime_checkable

from .candidates import DEFAULT_BY_OP, get_candidate
from .opkey import OPS, OpKey, check_op, coerce_key

__all__ = [
    "OpKey",
    "OPS",
    "Decision",
    "SelectorStats",
    "SelectionPolicy",
    "PolicyBase",
    "FixedPolicy",
    "use_policy",
    "current_policy",
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
    """Shared state of the policy zoo: the decision counters."""

    def __init__(self):
        self.stats = SelectorStats()

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


# -- context scoping ----------------------------------------------------------

_POLICY: contextvars.ContextVar[Optional[SelectionPolicy]] = contextvars.ContextVar(
    "repro_torch_selection_policy", default=None
)


def current_policy() -> SelectionPolicy:
    """The policy in scope: the innermost ``use_policy``.  There is no
    ambient default in this slice (the learned default policy is ROADMAP
    queue A, "The selector stack"), so no scope is an error."""
    pol = _POLICY.get()
    if pol is None:
        raise RuntimeError(
            "no dispatch policy in scope: wrap the call in "
            "use_policy(FixedPolicy(...)) or use_policy(policy_from_spec("
            "'fixed:...')); the default learned policy is not ported yet "
            "(ROADMAP.md queue A, 'The selector stack')"
        )
    return pol


@contextlib.contextmanager
def use_policy(policy) -> Iterator[SelectionPolicy]:
    """Scope ``policy`` over a ``with`` block.  Accepts a
    ``SelectionPolicy`` or a bare candidate name (sugar for
    ``FixedPolicy``).  Nesting restores the outer policy on exit."""
    if isinstance(policy, str):
        policy = FixedPolicy(policy)
    token = _POLICY.set(policy)
    try:
        yield policy
    finally:
        _POLICY.reset(token)
