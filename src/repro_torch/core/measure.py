"""On-device measurement — the measuring end of the paper's loop.

The paper's pipeline is *measure NT vs TNN on real hardware -> train a
selector -> dispatch*.  This module times every admissible candidate for
one (op, g, m, n, k) key on a torch device (``measure_candidates``), and
keeps the timings in a persistent, versioned JSON cache keyed by
``(platform, hardware, dtype, op, g, m, n, k)`` (``MeasurementCache``,
file-compatible with the JAX package's v5 caches; platform ``gpu`` or
``cpu``).  ``dataset_from_measurements`` (core/dataset.py) turns a filled
cache into a ``SelectionDataset`` for the GBDT, and ``AutotunePolicy``
(core/policy.py) answers ``select()`` from it, measuring cold keys.

A tunable candidate is timed under ``"default"`` (its wrapper's own
plan) and, with ``tune=True``, at each config of its roofline-ranked
shortlist (``Candidate.config_space``); the rest once, under
``"default"``.  ``top_configs_by_candidate`` and ``tile_tables_from_cache``
fold a filled cache into the per-shape tile tables of a selector
artifact; ``measure_transpose_configs`` tunes the transpose kernel's
instances on their own.  A candidate that raises while it is measured
raises out of the measurement: nothing retries it, and nothing drops it
from the result behind the caller's back.  The OOM guard skips a pair
before it is launched.

``bench_fn`` times with CUDA events after a synchronize on the card and
with ``time.perf_counter`` on the CPU.  Event time includes the host's
launch cost wherever the host is slower than the card, which below about
2^11 per side is most shapes.  ``queued=True`` measures device time
instead: a sleep kernel holds the stream while every timed call and its
events are enqueued, so the events time the calls back to back on the
device, and host noise does not pick a tile.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import tempfile
import threading
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

from repro_torch.kernels.tiling import DEFAULT_CONFIG_KEY, config_key

from .candidates import (
    CANDIDATES,
    candidate_allowed,
    candidate_fits_memory,
    current_platform,
    get_candidate,
)
from .hardware import HardwareSpec, device_spec
from .opkey import check_op, shape_key

__all__ = [
    "MEASURE_SCHEMA_VERSION",
    "MeasurementKey",
    "MeasurementCache",
    "bench_fn",
    "operand_shapes",
    "measure_candidates",
    "default_cache_path",
    "best_times",
    "top_configs_by_candidate",
    "tile_tables_from_cache",
    "measure_transpose_configs",
    "best_transpose_config",
    "DTYPE_BY_DSIZE",
]

# Cache schema history:
#   v1: {"schema_version": 1, "entries": {"plat|hw|dtype|m|n|k": {name: s}}}
#   v2: entry values gain a tile-config level:
#       {"plat|hw|dtype|m|n|k": {name: {"default"|"BMxBNxBK": s}}}
#       v1 records migrate on load as {name: {"default": s}}.
#   v3: keys gain the op kind ("plat|hw|dtype|op|m|n|k") so the cache
#       spans the whole (op x shape x candidate x config) selection space.
#       v1/v2 keys — which could only describe the forward op — migrate on
#       load with op="NT".
#   v4: keys gain the batch extent ("plat|hw|dtype|op|g|m|n|k") so the
#       batched attention contractions (BNT/BNN) are first-class entries.
#       v3 keys — necessarily unbatched — migrate on load with g=1.
#       v4 files may additionally carry a top-level "attempts" map
#       ({key: {name: {config_key: n}}} — how many bench tries each
#       measurement took).  Optional and schema-neutral: the port never
#       retries, writes no such map and ignores one it reads.
#   v5: the attention subgraph op — the key grammar is unchanged but the
#       op slot admits "ATTN" (paired fused-vs-unfused rows keyed on the
#       whole subgraph: m queries, n keys, k head-dim per slice) and
#       entry values may carry 2-part "BQxBK" config keys for the fused
#       kernel's (bq, bk) space.  v4 files load unchanged (their op slots
#       simply never say ATTN); files newer than v5 are rejected.
MEASURE_SCHEMA_VERSION = 5

# select() receives an element size, not a dtype; measurement needs a real
# dtype to build operands.  Sizes outside this map are not measurable (the
# policy falls back to the analytic model for them).
DTYPE_BY_DSIZE: Dict[int, str] = {2: "bfloat16", 4: "float32"}

# (platform, hardware, dtype, op, g, m, n, k)
MeasurementKey = Tuple[str, str, str, str, int, int, int, int]


def default_cache_path() -> str:
    """Where ``--policy autotune`` persists measurements by default
    (``$REPRO_AUTOTUNE_CACHE`` overrides it)."""
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "autotune_cache.json"
    )


def _normalize_mkey(key) -> MeasurementKey:
    """Canonical 8-tuple key.  Legacy 6-tuples (no op component — the
    pre-op-space cache API) mean the forward NT op; legacy 7-tuples (no
    batch component) mean g=1 — both keep working at ``get``/``put``."""
    key = tuple(key)
    if len(key) == 6:
        platform, hw, dtype, m, n, k = key
        op, g = "NT", 1
    elif len(key) == 7:
        platform, hw, dtype, op, m, n, k = key
        g = 1
    elif len(key) == 8:
        platform, hw, dtype, op, g, m, n, k = key
    else:
        raise ValueError(
            f"measurement key {key!r} must be (platform, hardware, dtype, "
            "op, g, m, n, k)"
        )
    return (
        str(platform), str(hw), str(dtype), check_op(op),
        int(g), int(m), int(n), int(k),
    )


def _key_str(key: MeasurementKey) -> str:
    return "|".join(str(p) for p in key)


def _file_sig(path: str) -> Optional[Tuple[int, int]]:
    """(mtime_ns, size) change signature, or None when unreadable/absent."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


@contextlib.contextmanager
def _file_lock(path: str):
    """Advisory lock serialising read-merge-replace across processes.

    Uses flock on a sibling ``.lock`` file (the data file itself is
    replaced atomically, so it cannot hold the lock).  On platforms
    without fcntl this degrades to unlocked atomic-replace semantics.
    """
    try:
        import fcntl
    except ImportError:
        yield
        return
    lock_path = path + ".lock"
    with open(lock_path, "a") as fh:
        fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh.fileno(), fcntl.LOCK_UN)


def _parse_key(s: str, version: int = MEASURE_SCHEMA_VERSION) -> MeasurementKey:
    # split from both ends: hardware names may themselves contain '|';
    # platform, dtype, op and the ints never do
    if version >= 4:
        head, op, g, m, n, k = s.rsplit("|", 5)
    elif version == 3:  # v3 keys carry no batch component: g=1
        head, op, m, n, k = s.rsplit("|", 4)
        g = 1
    else:  # v1/v2 keys carry no op component: they meant the forward op
        head, m, n, k = s.rsplit("|", 3)
        op, g = "NT", 1
    platform, rest = head.split("|", 1)
    hardware, dtype = rest.rsplit("|", 1)
    return (
        platform, hardware, dtype, check_op(op), int(g), int(m), int(n), int(k)
    )


def _normalize_times(times: Dict) -> Dict[str, Dict[str, float]]:
    """Canonical nested form ``{name: {config_key: seconds}}``.

    Accepts the v1 flat form ``{name: seconds}`` (migrated under the
    ``"default"`` config key) so old files and hand-built dicts keep
    working.
    """
    out: Dict[str, Dict[str, float]] = {}
    for name, val in times.items():
        if isinstance(val, dict):
            out[str(name)] = {str(c): float(t) for c, t in val.items()}
        else:
            out[str(name)] = {DEFAULT_CONFIG_KEY: float(val)}
    return out


def best_times(times: Dict[str, Dict[str, float]]) -> Dict[str, Tuple[str, float]]:
    """Per candidate, the winning ``(config_key, seconds)`` — the top-config
    fold used by selection and by ``dataset_from_measurements``."""
    out: Dict[str, Tuple[str, float]] = {}
    for name, cfgs in times.items():
        if cfgs:
            ck = min(cfgs, key=cfgs.get)
            out[name] = (ck, cfgs[ck])
    return out


class MeasurementCache:
    """Persistent ``(platform, hardware, dtype, op, g, m, n, k) ->
    {candidate: {config_key: seconds}}``.

    Versioned like selector artifacts: v1 files (flat per-candidate
    timings), v2 files (op-less keys — migrated as the forward NT op) and
    v3 files (batch-less keys — migrated with g=1) migrate on load; files
    newer than ``MEASURE_SCHEMA_VERSION`` are rejected rather than
    misread.  Legacy op-less 6-tuple and batch-less 7-tuple keys are
    accepted by ``get``/``put`` and normalised the same way.  ``save``
    writes atomically (tmp + rename) so a crash mid-write cannot corrupt a
    warm cache.

    ``load(..., recover=True)`` is the production posture (AutotunePolicy
    uses it): a corrupt/truncated/newer-schema file is moved aside to
    ``<path>.corrupt`` with a warning and the cache rebuilds empty, and a
    malformed individual entry is skipped — intact entries survive.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        # in-process counterpart of the cross-process _file_lock: policies
        # share one cache across serving threads
        self._lock = threading.Lock()
        self._entries: Dict[MeasurementKey, Dict[str, Dict[str, float]]] = {}  # guarded-by: _lock
        # (mtime_ns, size) of the file state we last loaded/wrote
        self._synced_sig: Optional[Tuple[int, int]] = None

    @classmethod
    def load(
        cls, path: str, missing_ok: bool = True, recover: bool = False
    ) -> "MeasurementCache":
        cache = cls(path)
        if not os.path.exists(path):
            if missing_ok:
                return cache  # cold cache: starts empty, persists to `path`
            raise FileNotFoundError(f"measurement cache {path!r} does not exist")
        try:
            with open(path, "rb") as fh:
                payload = json.loads(fh.read().decode("utf-8"))
            if not isinstance(payload, dict):
                raise ValueError(
                    f"measurement cache {path!r} is not a JSON object"
                )
            version = payload.get("schema_version", 0)
            if version > MEASURE_SCHEMA_VERSION:
                raise ValueError(
                    f"measurement cache schema v{version} is newer than "
                    f"supported v{MEASURE_SCHEMA_VERSION}; upgrade the code "
                    "or re-measure"
                )
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            if not recover:
                raise
            _move_aside_cache(path, e)
            return cache  # rebuilt empty; next save repopulates the path
        cache._synced_sig = _file_sig(path)
        # v1 (and unversioned v0-era) entries hold flat {name: seconds}
        # values; _normalize_times folds them under the "default" config
        # key — a v1 cache keeps answering warm hits after the upgrade.
        # Pre-v3 keys carry no op component and migrate as op="NT";
        # pre-v4 keys carry no batch component and migrate as g=1.
        n_bad = 0
        for ks, times in payload.get("entries", {}).items():
            try:
                cache._entries[_parse_key(ks, version)] = _normalize_times(
                    times
                )
            except (ValueError, TypeError, AttributeError):
                # recover: one rotten entry must not void the warm ones
                if not recover:
                    raise
                n_bad += 1
        if n_bad:
            import warnings

            warnings.warn(
                f"measurement cache {path!r}: skipped {n_bad} malformed "
                f"entr{'y' if n_bad == 1 else 'ies'}; "
                f"{len(cache._entries)} intact entries loaded",
                UserWarning,
                stacklevel=2,
            )
        return cache

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.path
        if path is None:
            raise ValueError("MeasurementCache has no path to save to")
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # merge-on-save under an advisory lock: concurrent processes sharing
        # one cache file each loaded their own snapshot — fold in shapes
        # others persisted since (ours win on conflict) and publish
        # atomically, so no writer clobbers another's measurements.  The
        # re-read is skipped when the file is still at the (mtime_ns, size)
        # state we last loaded/wrote — single-writer runs stay O(1) reads.
        with _file_lock(path):
            disk_sig = _file_sig(path)
            with self._lock:
                if disk_sig is not None and disk_sig != (
                    self._synced_sig if path == self.path else None
                ):
                    try:
                        on_disk = MeasurementCache.load(path)
                    except (ValueError, OSError, json.JSONDecodeError):
                        on_disk = None  # unreadable/foreign file: overwrite
                    if on_disk is not None:
                        for k, v in on_disk._entries.items():
                            self._entries.setdefault(k, v)
                payload = {
                    "schema_version": MEASURE_SCHEMA_VERSION,
                    "entries": {
                        _key_str(k): times
                        for k, times in sorted(self._entries.items())
                    },
                }
            # unique tmp per writer: a fixed sibling name would let two
            # unlocked writers truncate each other's half-written file
            fd, tmp = tempfile.mkstemp(
                prefix=os.path.basename(path) + ".", dir=parent or "."
            )
            try:
                with os.fdopen(fd, "w") as fh:
                    json.dump(payload, fh)
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            if path == self.path:
                self._synced_sig = _file_sig(path)

    def get(self, key) -> Optional[Dict[str, Dict[str, float]]]:
        return self._entries.get(_normalize_mkey(key))

    def put(self, key, times: Dict) -> None:
        """Store timings for one (op, shape).  Accepts the canonical nested
        times form or the flat v1 form (normalised under ``"default"``),
        and legacy op-less 6-tuple keys (normalised to op="NT")."""
        mkey = _normalize_mkey(key)
        with self._lock:
            self._entries[mkey] = _normalize_times(times)

    def records(
        self,
    ) -> Iterator[Tuple[MeasurementKey, Dict[str, Dict[str, float]]]]:
        """All (key, times) pairs, sorted for deterministic iteration."""
        return iter(sorted(self._entries.items()))

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return _normalize_mkey(key) in self._entries

    def __repr__(self):
        return f"MeasurementCache({len(self)} shapes, path={self.path!r})"


def _move_aside_cache(path: str, reason: BaseException) -> None:
    """Quarantine a corrupt cache file as ``<path>.corrupt`` (warns; a
    rename failure is itself only warned — recovery must not raise)."""
    import warnings

    corrupt = path + ".corrupt"
    try:
        os.replace(path, corrupt)
        moved = f"moved aside to {corrupt!r}"
    except OSError as e:
        moved = f"could not be moved aside ({e})"
    warnings.warn(
        f"measurement cache {path!r} is unreadable "
        f"({type(reason).__name__}: {reason}); {moved} — rebuilding empty",
        UserWarning,
        stacklevel=3,
    )


def _sync(operands) -> None:
    import torch

    if operands and operands[0].device.type == "cuda":
        torch.cuda.synchronize(operands[0].device)


# The rate the hold's length is reckoned at: at least an H100's top clock,
# so that the sleep kernel's cycles last at least the time asked for.
_HOLD_CLOCK_HZ = 2.0e9


def _queued(fn, operands, reps: int, tries: int = 4):
    """Device seconds of ``reps`` calls of ``fn`` run back to back: a sleep
    kernel holds the stream while the calls and the events between them
    are enqueued, so that none starts before the host is done.  The hold
    is sized at twice one call's host time per call; where the host took
    longer than the hold lasted on the device (a collection, a cold path)
    the gaps could hold host time, so it is measured again with a hold
    four times as long, and after ``tries`` holds that all ran out it
    raises."""
    import torch

    dev = operands[0].device
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn(*operands)
    hold = 2.0 * (time.perf_counter() - t0) * reps + 50e-6
    torch.cuda.synchronize(dev)
    for _ in range(tries):
        held = torch.cuda.Event(enable_timing=True)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        t0 = time.perf_counter()
        held.record()
        torch.cuda._sleep(int(hold * _HOLD_CLOCK_HZ))
        events[0].record()
        for ev in events[1:]:
            fn(*operands)
            ev.record()
        enqueue = time.perf_counter() - t0
        events[-1].synchronize()
        if held.elapsed_time(events[0]) / 1e3 > enqueue:
            return [a.elapsed_time(b) / 1e3 for a, b in zip(events, events[1:])]
        hold = 4.0 * max(hold, enqueue)
    raise RuntimeError(f"queued timing: the host took longer to enqueue {reps} calls than "
                       f"a {hold / 4.0 * 1e3:.3f} ms hold lasted, {tries} times")


def bench_fn(
    fn, *operands, reps: int = 3, warmup: int = 1, stat: str = "median",
    queued: bool = False,
) -> float:
    """Warmup then ``stat`` (``"median"`` or ``"min"``) of ``reps`` timed
    runs of ``fn(*operands)``, in seconds -- two operands for the GEMM ops,
    three (q, k, v) for the attention subgraph op.

    On CUDA operands each run is bracketed by CUDA events after a
    synchronize, so it times the work ``fn`` enqueues from an idle device
    (including the host's launch cost where the host is the slower one);
    with ``queued`` the runs are timed back to back on the device with
    the host's cost left out (``_queued``).  On CPU operands
    ``time.perf_counter`` times each run (``queued`` changes nothing).
    ``measure_candidates`` uses the median, ``dataset.collect_measured``
    the min (paper-style best-case)."""
    import torch

    for _ in range(max(1, warmup)):
        fn(*operands)
    _sync(operands)
    on_card = bool(operands) and operands[0].device.type == "cuda"
    ts = []
    if on_card and queued:
        ts = _queued(fn, operands, reps)
    for _ in range(0 if ts else reps):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*operands)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*operands)
            ts.append(time.perf_counter() - t0)
    return float(statistics.median(ts) if stat == "median" else min(ts))


def operand_shapes(op: str, m: int, n: int, k: int, g: int = 1):
    """Storage-layout operand shapes of one op (``core/opkey.py``).
    Batched ops get 3-D shapes with the leading batch extent ``g``; the
    attention subgraph op gets three (q, k, v) shapes with the OpKey's
    extents read as (m queries, n keys, k head-dim) per slice."""
    check_op(op)
    if op == "ATTN":
        return (g, m, k), (g, n, k), (g, n, k)
    if op == "BNT":
        return (g, m, k), (g, n, k)
    if op == "BNN":
        return (g, m, k), (g, k, n)
    if op == "NT":
        return (m, k), (n, k)
    if op == "NN":
        return (m, k), (k, n)
    return (k, m), (k, n)  # TN


def measure_candidates(
    m: int,
    n: int,
    k: int,
    dtype: str = "float32",
    op: str = "NT",
    g: int = 1,
    candidates: Optional[Sequence[str]] = None,
    hardware: Optional[HardwareSpec] = None,
    distributed: bool = False,
    mem_budget_frac: float = 0.9,
    warmup: int = 1,
    reps: int = 3,
    seed: int = 0,
    device="cuda",
    tune: bool = True,
    max_tile_configs: int = 4,
    queued: bool = False,
) -> Dict[str, Dict[str, float]]:
    """Time every admissible (candidate, tile config) for one (op, g,
    shape) on ``device``; returns ``{name: {config_key: seconds}}``.

    Operands are built on the device in ``op``'s storage layout from a
    seeded generator, and only candidates implementing the op are
    considered.  Every candidate is timed under ``"default"``; with
    ``tune`` a tunable one also at each config of its shortlist
    (``Candidate.config_space``, at most ``max_tile_configs``, ranked on
    ``hardware``).  ``queued`` times device time (``bench_fn``).
    Admissibility is the shared guard set of ``candidates.py`` -- the
    paper's OOM check (extra-memory candidates must fit ``hardware``'s
    memory budget, default the device's own) and the distributed/platform
    filter -- so a measurement never launches a pair the policies would
    refuse; such a pair is skipped before it runs.  A candidate that
    raises propagates its exception: a kernel fault on the card fails the
    measurement."""
    import torch

    from repro_torch import resolve_device

    dev = resolve_device(device)
    hw = hardware or device_spec(dev)
    names = tuple(candidates or CANDIDATES)
    dt = getattr(torch, dtype)
    dsize = torch.finfo(dt).bits // 8
    gen = torch.Generator(device=dev).manual_seed(seed)
    operands = tuple(
        torch.randn(s, generator=gen, device=dev, dtype=dt)
        for s in operand_shapes(op, m, n, k, g)
    )
    platform = current_platform(operands[0])
    times: Dict[str, Dict[str, float]] = {}
    with torch.no_grad():
        for name in names:
            cand = get_candidate(name)
            if not candidate_fits_memory(
                cand, m, n, k, dsize, hw.mem_gib, mem_budget_frac, op=op, g=g
            ):
                continue  # OOM guard: never materialise an over-budget transpose
            if not candidate_allowed(cand, distributed, op=op, platform=platform):
                continue
            sweep = [None]
            if tune:
                sweep += list(cand.config_space(m, n, k, dsize, max_configs=max_tile_configs,
                                                hardware=hw, g=g))
            times[name] = {
                config_key(cfg): bench_fn(lambda *x, _c=cfg: cand.run(*x, config=_c),
                                          *operands, reps=reps, warmup=warmup, queued=queued)
                for cfg in sweep
            }
    return times


def top_configs_by_candidate(
    cache: MeasurementCache,
    dtype: Optional[str] = None,
    platform: Optional[str] = None,
    op: Optional[str] = None,
) -> Dict[str, str]:
    """Per candidate, the *modal* winning config key across all matching
    cache records -- the shape-independent tile summary (the ``"modal"``
    fallback of an artifact's per-shape tables).  Only explicit tiles
    count: candidates whose wins are all at ``"default"`` carry no entry,
    so an artifact lists learned tiles, not the default plan."""
    wins: Dict[str, Dict[str, int]] = {}
    for (rec_platform, _hw, rec_dtype, rec_op, *_mnk), times in cache.records():
        if platform is not None and rec_platform != platform:
            continue
        if dtype is not None and rec_dtype != dtype:
            continue
        if op is not None and rec_op != op:
            continue
        for name, (ck, _t) in best_times(times).items():
            if ck == DEFAULT_CONFIG_KEY:
                continue
            wins.setdefault(name, {})
            wins[name][ck] = wins[name].get(ck, 0) + 1
    # deterministic tie-break: highest count, then lexicographic key
    return {
        name: min(counts, key=lambda ck: (-counts[ck], ck))
        for name, counts in wins.items()
    }


def tile_tables_from_cache(
    cache: MeasurementCache,
    dtype: Optional[str] = None,
    platform: Optional[str] = None,
) -> Dict[str, Dict[str, Dict]]:
    """Per-op, per-candidate tile tables for a selector artifact:
    ``{op: {name: {"modal": key, "by_shape": {"MxNxK": key}}}}``.

    ``by_shape`` holds each measured shape's winning explicit tile (a
    ``ModelPolicy`` dispatches it on that shape, and the nearest recorded
    shape's elsewhere); ``"modal"`` is the shape-independent summary
    (``top_configs_by_candidate``), the terminal fallback.  Shapes whose
    winner is ``"default"`` are left out, as in the modal summary."""
    tables: Dict[str, Dict[str, Dict]] = {}
    wins: Dict[Tuple[str, str], Dict[str, int]] = {}
    for (rec_platform, _hw, rec_dtype, rec_op, _g, m, n, k), times in cache.records():
        if platform is not None and rec_platform != platform:
            continue
        if dtype is not None and rec_dtype != dtype:
            continue
        for name, (ck, _t) in best_times(times).items():
            if ck == DEFAULT_CONFIG_KEY:
                continue
            entry = tables.setdefault(rec_op, {}).setdefault(
                name, {"modal": None, "by_shape": {}}
            )
            entry["by_shape"][shape_key((m, n, k))] = ck
            counts = wins.setdefault((rec_op, name), {})
            counts[ck] = counts.get(ck, 0) + 1
    for (op, name), counts in wins.items():
        tables[op][name]["modal"] = min(counts, key=lambda ck: (-counts[ck], ck))
    return tables


def measure_transpose_configs(
    rows: int,
    cols: int,
    dtype: str = "float32",
    reps: int = 3,
    warmup: int = 1,
    max_configs: int = 4,
    hardware: Optional[HardwareSpec] = None,
    seed: int = 0,
    device="cuda",
    queued: bool = False,
) -> Dict[str, float]:
    """Tune the transpose kernel's (b_rows, b_cols) instances for one
    (rows, cols) operand on ``device``: the default 32x32 kernel under
    ``"default"`` and each instance of ``transpose_config_space`` (at
    most ``max_configs``); returns ``{config_key: seconds}``.  A tuned
    instance feeds ``ops.matmul_tnn`` / ``ops.matmul_tn`` as ``tblock``.
    An instance that raises fails the measurement."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiling import transpose_config_space

    dev = resolve_device(device)
    hw = hardware or device_spec(dev)
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    b = torch.randn((rows, cols), generator=gen, device=dev, dtype=dt)
    sweep = [None] + list(transpose_config_space(rows, cols, b.element_size(),
                                                 max_configs=max_configs, hardware=hw))
    return {
        config_key(cfg): bench_fn(lambda x, _c=cfg: ops.transpose(x, block=_c), b,
                                  reps=reps, warmup=warmup, queued=queued)
        for cfg in sweep
    }


def best_transpose_config(rows: int, cols: int, **kw) -> Optional[Tuple[int, int]]:
    """The measured-fastest transpose instance for this operand, or None
    when the default kernel wins."""
    from repro_torch.kernels.tiling import parse_config_key

    times = measure_transpose_configs(rows, cols, **kw)
    ck = min(times, key=times.get)
    return parse_config_key(ck, arity=2)
