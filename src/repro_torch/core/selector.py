"""The MTNN selector — the paper's Algorithm 2, as a dispatch-time
selector.

Differences from the paper's runtime flow (and why):
  * PyTorch dispatches eagerly, so ``select`` runs on every dispatched
    call; the decision is memoised per ``OpKey``, so the predictor runs
    once per distinct (op, shape) and a repeat costs one dict lookup.
  * The paper's OOM guard ("if B^T does not fit, use NT") is preserved: the
    selector refuses extra-memory candidates when the estimated resident
    bytes would exceed the memory budget.
  * Binary (paper-faithful) and k-way (beyond-paper) modes share this API.
  * The selection space is the full *op space* (``core/opkey.py``): the
    forward NT plus the backward NN/TN gradient GEMMs and the batched
    attention ops, each with its own binary pair.

Artifacts are the JAX package's (schema 5, older files migrate on load),
so one artifact loads in both packages and gives the same decisions.  An
artifact's per-op, per-shape tile tables (``measure.tile_tables_from_cache``)
choose the tile a tunable candidate runs at (``tile_config_for``: the exact
shape, else the nearest recorded one in log space, else the modal entry),
where the port's wrapper has that plan at the dispatched shape.

No artifact ships with the port: the default selector (``DefaultSelector``)
is trained at first use on the analytic datasets of the port's chips (the
H100 roofline): its GEMM decisions on the paper grid (``collect_analytic``),
as the reference's default, and its attention decision on ATTN rows
(``collect_attn_analytic``).
"""

from __future__ import annotations

import functools
import json
import math
import os
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.kernels.attention_fused import DH_MAX

from . import faults
from .candidates import (
    BINARY_PAIRS_BY_OP,
    CANDIDATES,
    DEFAULT_BY_OP,
    PAPER_PAIR,
    candidate_allowed,
    candidate_fits_memory,
)
from .features import make_attn_features, make_features
from .gbdt import GBDTClassifier
from .hardware import H100, HardwareSpec, known_specs
from .opkey import OpKey, check_op, coerce_key, parse_shape_key, shape_key
from .policy import SelectorStats
from .train_model import KWayModel

__all__ = [
    "MTNNSelector",
    "DefaultSelector",
    "SelectorStats",
    "default_selector",
    "set_default_selector",
    "SCHEMA_VERSION",
]

# Artifact schema history:
#   v0 (unversioned): {mode, binary_pair, hardware, model}
#   v1: + schema_version; otherwise identical payload layout.
#   v2: + tile_configs — per-candidate learned tile config ("BMxBNxBK"
#       strings, from autotune-cache training).
#   v3: op-space — binary_pair becomes per-op ``binary_pairs`` and the
#       modal tile_configs table becomes per-op, *per-shape* ``tile_tables``
#       ({op: {candidate: {"modal": key, "by_shape": {"MxNxK": key}}}}
#       with nearest-shape fallback at lookup).  v2 artifacts migrate with
#       their modal table under op "NT"; v0/v1 with empty tables.
#   v4: batched op space — binary_pairs gain the BNT/BNN attention
#       contractions and the batch extent ``g`` enters the feature vector
#       as the 10th column.  v3 artifacts migrate with the standard
#       batched pairs; models trained on the 8-dim paper layout or the
#       9-dim op-space layout keep predicting (appended columns are
#       invisible to trees trained without them).
#   v5: the attention *subgraph* op — binary_pairs gain the ATTN
#       fused-vs-unfused pair (UNFUSED_ATTN, FUSED_ATTN) and tile_tables
#       may carry 2-part "BQxBK" config keys for the fused kernel's
#       (bq, bk) space alongside the 3-part GEMM keys.  v4 artifacts
#       migrate with the standard ATTN pair and an empty ATTN tile
#       table — exactly how a v4 build would dispatch once the subgraph
#       op entered the space.
SCHEMA_VERSION = 5


def _nearest_shape_key(by_shape: Dict[str, str], mnk) -> Optional[str]:
    """The tile-table entry of the recorded shape nearest to ``mnk`` in log
    space (GEMM cost scales multiplicatively).  Returns the config key, or
    None on an empty or corrupt table."""
    best_d, best_ck = None, None
    for sk, ck in by_shape.items():
        try:
            m2, n2, k2 = parse_shape_key(sk)
        except ValueError:
            continue
        d = sum(abs(math.log(max(a, 1) / max(b, 1))) for a, b in zip(mnk, (m2, n2, k2)))
        if best_d is None or d < best_d:
            best_d, best_ck = d, ck
    return best_ck


class MTNNSelector:
    """Selects one candidate implementation per ``OpKey`` — forward NT and
    backward NN/TN GEMMs alike."""

    def __init__(
        self,
        model,
        hardware: Optional[HardwareSpec] = None,
        mode: str = "binary",
        binary_pair: Tuple[str, str] = PAPER_PAIR,
        binary_pairs: Optional[Dict[str, Tuple[str, str]]] = None,
        distributed: bool = False,
        mem_budget_frac: float = 0.9,
        tile_tables: Optional[Dict[str, Dict[str, Dict]]] = None,
    ):
        self.model = model
        self.hardware = hardware or H100
        self.mode = mode
        # per-op binary pairs; `binary_pair` keeps naming the NT pair (the
        # paper's setting and the pre-op-space API)
        self.binary_pairs: Dict[str, Tuple[str, str]] = dict(BINARY_PAIRS_BY_OP)
        self.binary_pairs["NT"] = tuple(binary_pair)
        for op, pair in (binary_pairs or {}).items():
            self.binary_pairs[check_op(op)] = tuple(pair)
        self.distributed = distributed
        self.mem_budget_frac = mem_budget_frac
        # per-op, per-candidate learned tile tables: {"modal": "BMxBNxBK",
        # "by_shape": {"MxNxK": "BMxBNxBK"}} -- per-shape entries win (with
        # nearest-shape fallback), the modal key is the summary
        self.tile_tables: Dict[str, Dict[str, Dict]] = {}
        for op, table in (tile_tables or {}).items():
            check_op(op)
            self.tile_tables[op] = {
                name: {
                    "modal": entry.get("modal"),
                    "by_shape": dict(entry.get("by_shape") or {}),
                }
                for name, entry in table.items()
            }
        self.stats = SelectorStats()
        # decision memo per OpKey: every port candidate runs on both
        # platforms, so admissibility does not depend on the operands'
        self._cache: Dict[OpKey, str] = {}
        self._q_watch = faults.QuarantineWatch()

    def tile_config_for(
        self,
        name: str,
        dsize: int = 4,
        op: str = "NT",
        mnk: Optional[Tuple[int, int, int]] = None,
        g: int = 1,
    ) -> Optional[Tuple[int, ...]]:
        """The learned tile for a candidate at one dispatch: the per-shape
        entry for ``mnk`` (exact, else the nearest recorded shape in log
        space), else the modal summary, parsed and checked against the
        port's plans.  None -- the wrapper's own plan -- when the artifact
        carries nothing usable, the entry is malformed, the candidate is
        not tunable, or its kernel has no such plan at this (g, mnk,
        dsize): a split measured at another k, say."""
        entry = self.tile_tables.get(op, {}).get(name)
        if not entry:
            return None
        cand = CANDIDATES.get(name)
        if cand is None or not cand.tunable:
            return None
        from repro_torch.kernels.tiling import parse_config_key

        key = None
        by_shape = entry.get("by_shape") or {}
        if mnk is not None and by_shape:
            key = by_shape.get(shape_key(mnk)) or _nearest_shape_key(by_shape, mnk)
        if key is None:
            key = entry.get("modal")
        if not key:
            return None
        try:
            config = parse_config_key(key, arity=cand.config_arity)
        except ValueError:
            return None
        if config is None:
            return None
        shape = None if mnk is None else (g, *mnk, dsize)
        return config if cand.supports(config=config, shape=shape) else None

    # -- decision ----------------------------------------------------------
    def _fits(self, cand, key: OpKey) -> bool:
        return candidate_fits_memory(
            cand, key.m, key.n, key.k, key.dsize,
            self.hardware.mem_gib, self.mem_budget_frac, op=key.op,
        )

    def _allowed(self, name: str, op: str) -> bool:
        return candidate_allowed(CANDIDATES[name], self.distributed, op=op)

    def _admissible(self, name: str, key: OpKey) -> bool:
        cand = CANDIDATES.get(name)
        if cand is None:
            return False
        return self._fits(cand, key) and self._allowed(name, key.op)

    def pair_for(self, op: str) -> Tuple[str, str]:
        return self.binary_pairs.get(op) or BINARY_PAIRS_BY_OP[op]

    def _fallback_candidate(self, key: OpKey) -> str:
        """The paper's NT fallback, hardened and op-aware: prefer the op
        pair's direct arm when it is itself admissible, else the first
        admissible registered candidate for the op, else the op's XLA
        reference as the terminal answer so dispatch always yields
        *something* runnable."""
        direct = self.pair_for(key.op)[0]
        if self._admissible(direct, key):
            return direct
        for cand_name, cand in CANDIDATES.items():
            if key.op in cand.ops and self._admissible(cand_name, key):
                return cand_name
        return DEFAULT_BY_OP[key.op]

    def select(self, key: OpKey) -> str:
        """Candidate name for an ``OpKey``.  O(1) features,
        O(trees*depth) walk on the first call per key; one dict lookup
        after that."""
        key = coerce_key(key)
        # memoised decisions must not outlive a quarantine-ledger change
        if self._q_watch.moved():
            self._cache.clear()
        hit = self._cache.get(key)
        if hit is not None:
            self.stats.record(hit, None, op=key.op)
            return hit
        name = self._decide(key)
        self._cache[key] = name
        self.stats.record(name, None, op=key.op)
        return name

    def _decide(self, key: OpKey) -> str:
        """The decision at a key not in the memo."""
        x = make_features(
            self.hardware, key.m, key.n, key.k, op=key.op, g=key.g
        )[None, :]
        if self.mode == "binary":
            direct_name, alt_name = self.pair_for(key.op)
            label = int(self.model.predict(x)[0])
            name = direct_name if label == 1 else alt_name
            if not self._admissible(name, key):
                name = self._fallback_candidate(key)
        else:  # k-way
            order = np.argsort(self.model.predict_times(x)[0])
            name = None
            for i in order:
                cand_name = self.model.candidates[i]
                mapped = _sim_to_candidate(cand_name)
                if mapped is None:
                    continue
                if key.op not in CANDIDATES[mapped].ops:
                    continue
                if self._admissible(mapped, key):
                    name = mapped
                    break
            if name is None:
                name = self._fallback_candidate(key)
        return name

    def reset_stats(self) -> None:
        self.stats.reset()

    # -- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        """Write the artifact atomically (unique tmp + rename): a crash
        mid-write leaves the previous artifact intact, never a truncated
        JSON that would poison the next load."""
        import tempfile

        parent = os.path.dirname(path)
        if parent:  # bare filenames have no directory to create
            os.makedirs(parent, exist_ok=True)
        payload = {
            "schema_version": SCHEMA_VERSION,
            "mode": self.mode,
            "binary_pairs": {
                op: list(pair) for op, pair in self.binary_pairs.items()
            },
            "hardware": self.hardware.name,
            "model": self.model.to_dict(),
            "tile_tables": {
                op: {
                    name: {
                        "modal": entry.get("modal"),
                        "by_shape": dict(entry.get("by_shape") or {}),
                    }
                    for name, entry in table.items()
                }
                for op, table in self.tile_tables.items()
            },
        }
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

    @staticmethod
    def load(
        path: str,
        hardware: Optional[HardwareSpec] = None,
        distributed: bool = False,
        recover: bool = False,
    ) -> "MTNNSelector":
        """Load an artifact.  Strict by default: corrupt/truncated JSON or
        an unsupported schema raises.  ``recover=True`` is the production
        posture (``ModelPolicy`` via ``policy_from_spec`` uses it): an
        unreadable artifact is moved aside to ``<path>.corrupt`` with a
        warning and a freshly trained analytic-dataset selector is
        returned, so serving never dies on a bad file.  A hardware name
        with no descriptor here resolves to ``H100`` unless ``hardware=``
        is given."""
        try:
            with open(path, "rb") as fh:
                raw = faults.corrupt_on_read("artifact", fh.read())
            payload = json.loads(raw.decode("utf-8"))
            if not isinstance(payload, dict):
                raise ValueError(
                    f"selector artifact {path!r} is not a JSON object"
                )
            payload = _migrate_payload(payload)
            model_d = payload["model"]
            if model_d.get("kind") == "kway":
                model = KWayModel.from_dict(model_d)
            else:
                model = GBDTClassifier.from_dict(model_d)
        except (KeyboardInterrupt, SystemExit):
            raise
        except FileNotFoundError:
            raise  # a missing file is a caller error, not corruption
        except Exception as e:
            if not recover:
                raise
            _move_aside(path, e)
            return _fresh_fallback_selector(
                hardware=hardware, distributed=distributed
            )
        # a name this build has no descriptor for (e.g. an artifact saved by
        # the JAX package for a TPU) falls back to the port's default spec
        hw = hardware or known_specs().get(payload.get("hardware", ""), H100)
        # tolerate hand-authored v3 payloads omitting the field: the
        # standard per-op pairs are the documented default
        pairs = {
            op: tuple(pair)
            for op, pair in payload.get("binary_pairs", {}).items()
        }
        return MTNNSelector(
            model,
            hardware=hw,
            mode=payload.get("mode", "binary"),
            binary_pair=pairs.get("NT", PAPER_PAIR),
            binary_pairs=pairs,
            distributed=distributed,
            tile_tables=payload.get("tile_tables", {}),
        )


class DefaultSelector(MTNNSelector):
    """The port's builtin default: two decisions on separate paths.

    Every GEMM op (NT, NN, TN, BNT, BNN) is decided as the reference's
    default decides it: the paper's NT model over distributed-safe
    candidates only, so NN, TN and the batched ops stay on cuBLAS.

    ATTN is decided by ``attn_model``, a model of its own trained on ATTN
    rows (``dataset.collect_attn_analytic``, ``make_attn_features``): the
    NT model was never fit on an ATTN row.  The fused kernel is admitted
    wherever it has a route for the key (d_head up to ``DH_MAX``, either
    dtype; above it the kernel raises, so the unfused plan runs) and is
    not quarantined, as a local program: each rank of the port runs one.
    The reference's default never admits its fused kernel, which cannot
    run in a partitioned program.

    ``save`` writes the GEMM model alone, as an artifact of the reference's
    schema."""

    def __init__(self, model, attn_model, hardware: Optional[HardwareSpec] = None):
        super().__init__(model, hardware=hardware, distributed=True)
        self.attn_model = attn_model

    def _decide(self, key: OpKey) -> str:
        if key.op != "ATTN":
            return super()._decide(key)
        unfused, fused = BINARY_PAIRS_BY_OP["ATTN"]
        if key.k > DH_MAX or not candidate_allowed(CANDIDATES[fused], distributed=False,
                                                   op="ATTN"):
            return unfused
        x = make_attn_features(self.hardware, key.m, key.n, key.k, key.dsize, key.g)[None, :]
        return unfused if int(self.attn_model.predict(x)[0]) == 1 else fused


def _move_aside(path: str, reason: BaseException) -> None:
    """Quarantine a corrupt artifact file as ``<path>.corrupt`` (warns; a
    failure to rename is itself only warned — recovery must not raise)."""
    import warnings

    corrupt = path + ".corrupt"
    try:
        os.replace(path, corrupt)
        moved = f"moved aside to {corrupt!r}"
    except OSError as e:
        moved = f"could not be moved aside ({e})"
    warnings.warn(
        f"selector artifact {path!r} is unreadable "
        f"({type(reason).__name__}: {reason}); {moved} — recovering with a "
        "freshly trained fallback selector",
        UserWarning,
        stacklevel=3,
    )


def _fresh_fallback_selector(
    hardware: Optional[HardwareSpec] = None, distributed: bool = False
) -> "MTNNSelector":
    """Train a small selector on the analytic dataset of the port's chips
    (the H100 roofline) — the default selector, and what a corrupt
    artifact recovers to.  A standalone helper (not
    ``default_selector()``) so recovery cannot recurse through the
    lru-cached default."""
    from .dataset import collect_analytic
    from .train_model import train_paper_model

    ds = collect_analytic(lo=7, hi=13)  # the port's SIMULATED_CHIPS
    clf, _ = train_paper_model(ds)
    return MTNNSelector(
        clf, hardware=hardware, distributed=distributed
    )


def _migrate_payload(payload: Dict) -> Dict:
    """Bring an artifact payload up to the current schema.

    v0 artifacts predate the ``schema_version`` field; their layout is
    otherwise the v1 layout, so migration stamps the version (and fills the
    fields v0 writers were allowed to omit).  v1 artifacts predate the
    tile-config label space; they gain an empty tile table.  v2 artifacts
    predate the op space: their single ``binary_pair`` becomes the NT entry
    of ``binary_pairs`` (backward ops get the standard per-op pairs) and
    their modal ``tile_configs`` become modal-only NT ``tile_tables`` —
    exactly how a v2 build dispatched, with backward ops at the kernel
    default.  v3 artifacts predate the batched op space and gain the
    standard BNT/BNN pairs.  Unknown *newer* versions are rejected rather
    than misread.
    """
    version = payload.get("schema_version", 0)
    if version > SCHEMA_VERSION:
        raise ValueError(
            f"selector artifact schema v{version} is newer than supported "
            f"v{SCHEMA_VERSION}; upgrade the code or rebuild the artifact"
        )
    if version < 1:
        payload = dict(payload)
        payload.setdefault("mode", "binary")
        payload.setdefault("binary_pair", list(PAPER_PAIR))
        payload["schema_version"] = 1
    if payload["schema_version"] < 2:
        payload = dict(payload)
        payload.setdefault("tile_configs", {})
        payload["schema_version"] = 2
    if payload["schema_version"] < 3:
        payload = dict(payload)
        pairs = dict(BINARY_PAIRS_BY_OP)
        pairs["NT"] = tuple(payload.get("binary_pair", PAPER_PAIR))
        payload["binary_pairs"] = {op: list(p) for op, p in pairs.items()}
        payload["tile_tables"] = {
            "NT": {
                name: {"modal": ck, "by_shape": {}}
                for name, ck in payload.get("tile_configs", {}).items()
            }
        }
        payload["schema_version"] = 3
    if payload["schema_version"] < 4:
        # v3 artifacts predate the batched op space: their pairs cover
        # NT/NN/TN only, so the standard batched pairs fill in — exactly
        # how a v3 build would dispatch once attention entered the space.
        payload = dict(payload)
        payload["binary_pairs"] = dict(payload.get("binary_pairs", {}))
        for op in ("BNT", "BNN"):
            payload["binary_pairs"].setdefault(
                op, list(BINARY_PAIRS_BY_OP[op])
            )
        payload["schema_version"] = 4
    if payload["schema_version"] < 5:
        # v4 artifacts predate the attention subgraph op: the standard
        # fused-vs-unfused pair fills in (tile tables stay empty for ATTN
        # — the fused kernel runs its clamped default until retrained).
        payload = dict(payload)
        payload["binary_pairs"] = dict(payload.get("binary_pairs", {}))
        payload["binary_pairs"].setdefault(
            "ATTN", list(BINARY_PAIRS_BY_OP["ATTN"])
        )
        payload["schema_version"] = 5
    return payload


def _sim_to_candidate(sim_name: str) -> Optional[str]:
    """Map analytic-model arm names to registered candidate names."""
    table = {
        "NT_DIRECT": "XLA_NT",
        "TNN": "XLA_TNN",
        "TNN_FUSED": "PALLAS_TNN_FUSED",
        "XLA_DOT": "XLA_NT",
        "NN_DIRECT": "XLA_NN",
        "TN_DIRECT": "XLA_TN",
        "TN_VIA_NN": "PALLAS_TN",
        "BNT_DIRECT": "XLA_BNT",
        "BNN_DIRECT": "XLA_BNN",
        "ATTN_FUSED": "FUSED_ATTN",
        "ATTN_UNFUSED": "UNFUSED_ATTN",
        # already-candidate names pass through
        **{n: n for n in CANDIDATES},
    }
    return table.get(sim_name)


# -- module-level default selector ------------------------------------------

_DEFAULT: Optional[MTNNSelector] = None


def set_default_selector(sel: Optional[MTNNSelector]) -> None:
    global _DEFAULT
    _DEFAULT = sel


@functools.lru_cache(maxsize=1)
def _builtin_selector() -> MTNNSelector:
    # no artifact ships: train small models on the analytic datasets here
    from .dataset import collect_attn_analytic
    from .train_model import train_paper_model

    gemm = _fresh_fallback_selector(distributed=True)
    attn, _ = train_paper_model(collect_attn_analytic(gemm.hardware))
    return DefaultSelector(gemm.model, attn, hardware=gemm.hardware)


def default_selector() -> MTNNSelector:
    return _DEFAULT if _DEFAULT is not None else _builtin_selector()
