"""Fault injection and runtime health: the chaos harness + quarantine ledger.

The paper's guarantee is *selection never does worse than the library
default*.  This module is the robustness half of that guarantee: the
machinery that lets the engine keep dispatching when a selected candidate
fails at run time, and the test/CLI harness that proves it.

Two halves, deliberately stdlib-only (``candidates.py`` and ``policy.py``
import this module, so it must sit below everything that imports torch).
It is the JAX package's module, kept as a copy of its own: the grammar,
the error text and the ledger's semantics are the same.

**Fault injection** — ``inject_faults(spec)`` scopes a set of
deterministic ``FaultRule``s over a ``with`` block (contextvar-scoped, so
tests and concurrent serve threads never leak faults into each other).
Rules are written in the ``--chaos`` spec grammar::

    MODE:TARGET[:opt=val]*  [; MODE:TARGET...]

    MODE    raise | hang | delay | oom | timeout | corrupt
    TARGET  a candidate-name glob, optionally op-qualified with a second
            glob (``PALLAS_*``, ``PALLAS_BNT.BNT``) — or one of the
            artifact planes ``cache`` | ``artifact`` | ``measure``
    opts    p=<prob>      fire with probability p (seeded, default 1)
            times=<n>     fire at most n times (default unlimited)
            after=<n>     skip the first n matching calls (default 0)
            s=<seconds>   delay/hang duration (default 0.05 / 30)
            seed=<n>      RNG seed for p= (default 0)
            cand=<glob>   for ``measure``: restrict to matching candidates

``raise``/``oom``/``timeout`` raise ``InjectedFault``/``InjectedOOM``/
``InjectedTimeout`` from the candidate's run path; ``delay``/``hang``
sleep (hang is a bounded stand-in for a stuck kernel — we never wedge the
host); ``corrupt`` flips and truncates bytes handed to
``corrupt_on_read`` by the cache/artifact loaders.

**Quarantine ledger** — process-global, thread-safe record of
(candidate, op, config) arms that failed at dispatch.  The engine writes
it on failure (``quarantine``), every policy's admissible set reads it
(``candidates.candidate_allowed`` checks ``is_quarantined``), and memoised
policies watch ``quarantine_epoch()`` to drop stale cached decisions.
``engine.health_report()`` renders it.

What the port's engine degrades through is narrower than what the JAX
engine catches: an injected fault, and a tile that is not a plan of its
route (shed for the same candidate's own plan, no further).  Everything
else raises through the chain with nothing quarantined -- a kernel that
does not build or launch (``kernels/_build.py``), a device allocation
failure, a bug -- so a fault on the card never hides behind the library
arm.

A healthy dispatch takes no lock: ``is_quarantined`` answers from an
empty ledger and ``quarantine_epoch``/``QuarantineWatch`` read one int.
"""

from __future__ import annotations

import contextlib
import contextvars
import fnmatch
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

__all__ = [
    "CHAOS_SPEC_HELP",
    "FAULT_MODES",
    "FAULT_PLANES",
    "InjectedFault",
    "InjectedOOM",
    "InjectedTimeout",
    "FaultRule",
    "parse_chaos_spec",
    "inject_faults",
    "active_faults",
    "check_candidate_fault",
    "check_measure_fault",
    "corrupt_on_read",
    "QuarantineEntry",
    "quarantine",
    "is_quarantined",
    "quarantine_entries",
    "clear_quarantine",
    "quarantine_epoch",
    "QuarantineWatch",
    "record_fallback",
    "fallback_counts",
    "add_chaos_argument",
    "chaos_scope",
]

CHAOS_SPEC_HELP = (
    "chaos spec: MODE:TARGET[:opt=val]* clauses joined by ';' — MODE in "
    "raise|hang|delay|oom|timeout|corrupt; TARGET a candidate glob with "
    "an optional .OP glob (PALLAS_*, PALLAS_BNT.BNT) or a plane "
    "cache|artifact|measure; opts p=<prob> times=<n> after=<n> "
    "s=<seconds> seed=<n> cand=<glob>  (e.g. 'raise:PALLAS_*' or "
    "'corrupt:cache;delay:XLA_NT:s=0.01')"
)

FAULT_MODES: Tuple[str, ...] = (
    "raise", "hang", "delay", "oom", "timeout", "corrupt"
)
# non-candidate targets: the artifact/measurement planes
FAULT_PLANES: Tuple[str, ...] = ("cache", "artifact", "measure")

# hang is a *bounded* stand-in for a stuck kernel: long enough that any
# deadline/timeout machinery under test trips, short enough that a
# forgotten rule cannot wedge a CI host forever
HANG_SECONDS = 30.0
DELAY_SECONDS = 0.05


class InjectedFault(RuntimeError):
    """A deliberately injected candidate/plane failure (chaos testing)."""


class InjectedOOM(InjectedFault):
    """Injected stand-in for a device allocation failure."""


class InjectedTimeout(InjectedFault):
    """Injected stand-in for a measurement/kernel timeout."""


_EXC_BY_MODE = {
    "raise": InjectedFault,
    "oom": InjectedOOM,
    "timeout": InjectedTimeout,
}


@dataclass
class FaultRule:
    """One armed fault.  Mutable counters make firing deterministic:
    the Nth matching call behaves the same on every run (``p=`` draws
    come from a rule-local seeded RNG, not global randomness)."""

    mode: str
    target: str  # candidate-name glob, or a FAULT_PLANES member
    op: str = "*"  # op glob (candidate targets only)
    p: float = 1.0
    times: Optional[int] = None  # max firings (None = unlimited)
    after: int = 0  # skip the first `after` matching calls
    seconds: Optional[float] = None  # delay/hang duration override
    seed: int = 0
    cand: str = "*"  # for plane "measure": candidate restriction
    _matched: int = field(default=0, repr=False)
    _fired: int = field(default=0, repr=False)
    _rng: Optional[random.Random] = field(default=None, repr=False)

    def __post_init__(self):
        if self.mode not in FAULT_MODES:
            raise ValueError(
                f"unknown fault mode {self.mode!r} ({CHAOS_SPEC_HELP})"
            )
        if not self.target:
            raise ValueError(f"fault rule needs a target ({CHAOS_SPEC_HELP})")
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"fault probability p={self.p} outside [0, 1]")
        self._rng = random.Random(self.seed)

    @property
    def is_plane(self) -> bool:
        return self.target in FAULT_PLANES

    def matches(self, name: str, op: str = "*") -> bool:
        return (
            not self.is_plane
            and fnmatch.fnmatchcase(name, self.target)
            and fnmatch.fnmatchcase(op, self.op)
        )

    def should_fire(self) -> bool:
        """Advance the match counter and decide.  Call once per match."""
        self._matched += 1
        if self._matched <= self.after:
            return False
        if self.times is not None and self._fired >= self.times:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self._fired += 1
        return True

    def describe(self) -> str:
        tgt = self.target if self.is_plane else f"{self.target}.{self.op}"
        extras = []
        if self.p < 1.0:
            extras.append(f"p={self.p}")
        if self.times is not None:
            extras.append(f"times={self.times}")
        if self.after:
            extras.append(f"after={self.after}")
        suffix = (":" + ":".join(extras)) if extras else ""
        return f"{self.mode}:{tgt}{suffix} (fired {self._fired}x)"

    def sleep_seconds(self) -> float:
        if self.seconds is not None:
            return self.seconds
        return HANG_SECONDS if self.mode == "hang" else DELAY_SECONDS


def parse_chaos_spec(spec: str) -> Tuple[FaultRule, ...]:
    """Parse a ``--chaos`` spec string into rules.  Raises ``ValueError``
    with the grammar on anything malformed."""
    rules: List[FaultRule] = []
    for clause in str(spec).split(";"):
        clause = clause.strip()
        if not clause:
            continue
        parts = [p.strip() for p in clause.split(":")]
        if len(parts) < 2 or not parts[0] or not parts[1]:
            raise ValueError(
                f"malformed chaos clause {clause!r} ({CHAOS_SPEC_HELP})"
            )
        mode, target = parts[0], parts[1]
        op = "*"
        if target not in FAULT_PLANES and "." in target:
            target, _, op = target.partition(".")
            if not target or not op:
                raise ValueError(
                    f"malformed chaos target in {clause!r} ({CHAOS_SPEC_HELP})"
                )
        kw: Dict[str, object] = {}
        for opt in parts[2:]:
            key, eq, val = opt.partition("=")
            key, val = key.strip(), val.strip()
            if not eq or not val:
                raise ValueError(
                    f"malformed chaos option {opt!r} in {clause!r} "
                    f"({CHAOS_SPEC_HELP})"
                )
            try:
                if key == "p":
                    kw["p"] = float(val)
                elif key == "times":
                    kw["times"] = int(val)
                elif key == "after":
                    kw["after"] = int(val)
                elif key == "s":
                    kw["seconds"] = float(val)
                elif key == "seed":
                    kw["seed"] = int(val)
                elif key == "cand":
                    kw["cand"] = val
                else:
                    raise ValueError(
                        f"unknown chaos option {key!r} in {clause!r} "
                        f"({CHAOS_SPEC_HELP})"
                    )
            except ValueError as e:
                if "chaos" in str(e):
                    raise
                raise ValueError(
                    f"malformed chaos option value {opt!r} in {clause!r} "
                    f"({CHAOS_SPEC_HELP})"
                ) from None
        rules.append(FaultRule(mode=mode, target=target, op=op, **kw))
    if not rules:
        raise ValueError(f"empty chaos spec ({CHAOS_SPEC_HELP})")
    return tuple(rules)


# -- scoping ------------------------------------------------------------------

_RULES: contextvars.ContextVar[Tuple[FaultRule, ...]] = contextvars.ContextVar(
    "repro_torch_fault_rules", default=()
)


@contextlib.contextmanager
def inject_faults(
    spec: Union[str, FaultRule, Sequence[FaultRule]],
) -> Iterator[Tuple[FaultRule, ...]]:
    """Arm fault rules over a ``with`` block (nestable; rules compose with
    any outer scope's).  Accepts a spec string, one rule, or a sequence."""
    if isinstance(spec, str):
        rules = parse_chaos_spec(spec)
    elif isinstance(spec, FaultRule):
        rules = (spec,)
    else:
        rules = tuple(spec)
        for r in rules:
            if not isinstance(r, FaultRule):
                raise TypeError(f"expected FaultRule, got {r!r}")
    token = _RULES.set(_RULES.get() + rules)
    try:
        yield rules
    finally:
        _RULES.reset(token)


def active_faults() -> Tuple[FaultRule, ...]:
    """The rules armed in the current context (outermost first)."""
    return _RULES.get()


def _fire(rule: FaultRule, what: str) -> None:
    if rule.mode in _EXC_BY_MODE:
        raise _EXC_BY_MODE[rule.mode](
            f"injected {rule.mode} fault: {what}"
        )
    if rule.mode in ("delay", "hang"):
        time.sleep(rule.sleep_seconds())


def check_candidate_fault(name: str, op: str) -> None:
    """Fault hook on the candidate run path (``engine.run_decision``).
    Raises/sleeps per any armed rule matching this (candidate, op)."""
    for rule in _RULES.get():
        if rule.mode == "corrupt" or rule.is_plane:
            continue
        if rule.matches(name, op) and rule.should_fire():
            _fire(rule, f"candidate {name} on op {op}")


def check_measure_fault(name: str, op: str) -> None:
    """Fault hook on the measurement path (``measure.measure_candidates``):
    rules targeting the ``measure`` plane, optionally restricted to a
    candidate glob via ``cand=``."""
    for rule in _RULES.get():
        if rule.target != "measure" or rule.mode == "corrupt":
            continue
        if fnmatch.fnmatchcase(name, rule.cand) and rule.should_fire():
            _fire(rule, f"measurement of {name} on op {op}")


def corrupt_on_read(kind: str, data: bytes) -> bytes:
    """Byte-corruption hook on artifact loads.  ``kind`` is ``"cache"`` or
    ``"artifact"``; armed ``corrupt`` rules for that plane truncate the
    payload and flip a byte — deterministically unparseable JSON."""
    for rule in _RULES.get():
        if rule.mode != "corrupt" or rule.target != kind:
            continue
        if rule.should_fire():
            cut = data[: max(1, len(data) // 2)]
            return cut[:-1] + bytes([cut[-1] ^ 0xFF]) if cut else b"\xff"
    return data


# -- quarantine ledger --------------------------------------------------------


@dataclass
class QuarantineEntry:
    """One quarantined (candidate, op, config) arm and its failure record."""

    name: str
    op: str
    config_key: Optional[str]  # None = the candidate's default tiling
    error: str  # "ExcType: message" of the first failure
    count: int = 1
    first_ts: float = 0.0
    last_ts: float = 0.0

    def label(self) -> str:
        if self.config_key is None:
            return self.name
        return f"{self.name}@{self.config_key}"


_LOCK = threading.Lock()
_QUARANTINE: Dict[Tuple[str, str, Optional[str]], QuarantineEntry] = {}  # guarded-by: _LOCK
_FALLBACKS: Dict[Tuple[str, str, str], int] = {}  # (op, from, to) -> n; guarded-by: _LOCK
_EPOCH = 0  # guarded-by: _LOCK


def _config_key(config) -> Optional[str]:
    # local stdlib mirror of kernels.tiling.config_key (None = default)
    if config is None:
        return None
    return "x".join(str(int(c)) for c in tuple(config))


def quarantine(name: str, op: str, config, error: BaseException) -> QuarantineEntry:
    """Record a dispatch-time failure of (name, op, config) and bar the arm
    from selection for the rest of the process.  Bumps the epoch so
    memoised policies drop cached decisions."""
    global _EPOCH
    key = (str(name), str(op), _config_key(config))
    now = time.time()
    with _LOCK:
        entry = _QUARANTINE.get(key)
        if entry is None:
            entry = QuarantineEntry(
                name=key[0], op=key[1], config_key=key[2],
                error=f"{type(error).__name__}: {error}",
                first_ts=now, last_ts=now,
            )
            _QUARANTINE[key] = entry
            _EPOCH += 1
        else:
            entry.count += 1
            entry.last_ts = now
        return entry


def is_quarantined(name: str, op: str, config=None) -> bool:
    """Whether this arm is barred.  A default-tiling failure quarantines
    the candidate for the op outright (the default tile is the terminal
    degraded form — if it cannot run, no tile of the kernel is trusted);
    an explicit-tile failure bars only that tile."""
    if not _QUARANTINE:  # the healthy path: no entry, no lock
        return False
    ck = _config_key(config)
    with _LOCK:
        if (name, op, None) in _QUARANTINE:
            return True
        return ck is not None and (name, op, ck) in _QUARANTINE


def quarantine_entries() -> Tuple[QuarantineEntry, ...]:
    """Current ledger, sorted (op, name, config) for stable rendering."""
    with _LOCK:
        return tuple(
            _QUARANTINE[k]
            for k in sorted(
                _QUARANTINE, key=lambda k: (k[1], k[0], k[2] or "")
            )
        )


def clear_quarantine() -> None:
    """Drop all health state (tests / operator reset).  Bumps the epoch so
    memoised policies re-admit previously barred arms."""
    global _EPOCH
    with _LOCK:
        if _QUARANTINE or _FALLBACKS:
            _EPOCH += 1
        _QUARANTINE.clear()
        _FALLBACKS.clear()


def quarantine_epoch() -> int:
    """Monotonic ledger-change counter.  Policies that memoise decisions
    compare this against the epoch they cached under and invalidate on
    mismatch — one int read on the hot path, without the lock (the
    writers bump it under ``_LOCK``; a read of one int is atomic)."""
    return _EPOCH


class QuarantineWatch:
    """The ledger epoch a memo was filled under.  ``moved()`` says whether
    the ledger changed since (and takes the new epoch), so the owner drops
    memoised decisions that could name a now-quarantined arm, or keep
    avoiding a cleared one."""

    __slots__ = ("epoch",)

    def __init__(self):
        self.epoch = _EPOCH

    def moved(self) -> bool:
        if _EPOCH == self.epoch:
            return False
        self.epoch = _EPOCH
        return True


def record_fallback(op: str, selected: str, executed: str) -> None:
    """Count one dispatch that degraded from the selected arm to a
    fallback-chain arm (``selected``/``executed`` are decision labels)."""
    key = (str(op), str(selected), str(executed))
    with _LOCK:
        _FALLBACKS[key] = _FALLBACKS.get(key, 0) + 1


def fallback_counts() -> Dict[Tuple[str, str, str], int]:
    """Snapshot of (op, selected, executed) -> count."""
    with _LOCK:
        return dict(_FALLBACKS)


# -- CLI wiring ---------------------------------------------------------------


def add_chaos_argument(parser) -> None:
    """Attach the shared ``--chaos`` option to an argparse parser."""
    parser.add_argument(
        "--chaos", default=None, metavar="SPEC",
        help=f"inject faults for this run; {CHAOS_SPEC_HELP}",
    )


def chaos_scope(spec: Optional[str]):
    """Context manager for launcher mains: arms ``--chaos SPEC`` when
    given, a no-op otherwise."""
    if not spec:
        return contextlib.nullcontext(())
    return inject_faults(spec)
