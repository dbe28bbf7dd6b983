"""Dataset construction for the selection problem (paper §V-A).

Two data sources (kept separate, labelled in every report):

  * ``collect_analytic``  — the analytic cost model (``core/simulate.py``,
    datasheet peaks) over the paper's grid S = {2^7 .. 2^16}^3 for the
    port's chips.  Samples whose working set (incl. B^T) does not fit
    device memory are dropped, mirroring the paper's OOM filter.

  * ``collect_attn_analytic`` — the same cost model's two attention arms
    (fused kernel, unfused plan) over ATTN rows of the port's own shapes:
    decode, GQA-folded prefill and training chunks, the port's flash head
    dims, both dtypes.  The default selector's ATTN decision learns from
    it (``selector.DefaultSelector``).

  * measurements on a torch device — ``collect_measured`` times one NT
    pair directly; ``dataset_from_measurements`` converts a
    ``MeasurementCache`` filled by ``measure.measure_candidates`` (every
    op, every candidate) into records.

Record format (paper, plus the op-kind and batch columns): (gm, sm, cc,
mbw, l2c, m, n, k, op, g) -> label, label = +1 if P_direct >= P_alt
(choose the op pair's direct arm — NT for the forward op) else -1.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device

from . import simulate
from .candidates import BINARY_PAIRS_BY_OP, CANDIDATES, PAPER_PAIR, current_platform
from .features import make_attn_features, make_features
from .hardware import H100, SIMULATED_CHIPS, HardwareSpec, device_spec, known_specs

__all__ = [
    "SelectionDataset",
    "collect_analytic",
    "collect_attn_analytic",
    "collect_measured",
    "dataset_from_measurements",
    "paper_grid",
]


def paper_grid(lo: int = 7, hi: int = 16) -> List[Tuple[int, int, int]]:
    """The paper's S = {2^i | i = 7..16}^3 grid (1000 combinations)."""
    sizes = [2**i for i in range(lo, hi + 1)]
    return [(m, n, k) for m in sizes for n in sizes for k in sizes]


@dataclass
class SelectionDataset:
    """Samples + per-candidate times.

    X:      (N, 10) feature matrix (paper's 8-dim layout + op/batch cols)
    y:      (N,) labels in {-1, +1}   (+1 => NT faster-or-equal, choose NT)
    times:  algo-name -> (N,) seconds; always includes the paper pair
            'NT' and 'TNN'; may include more candidates (beyond-paper).
    mnk:    (N, 3) matrix sizes
    hw:     (N,) hardware name per sample
    source: 'analytic' | 'measured-gpu' | 'measured-cpu' | 'autotune-measured'
    """

    X: np.ndarray
    y: np.ndarray
    times: Dict[str, np.ndarray]
    mnk: np.ndarray
    hw: np.ndarray
    source: str

    def __len__(self) -> int:
        return len(self.y)

    def class_counts(self) -> Dict[int, int]:
        return {-1: int((self.y == -1).sum()), 1: int((self.y == 1).sum())}

    def subset(self, idx: np.ndarray) -> "SelectionDataset":
        return SelectionDataset(
            X=self.X[idx],
            y=self.y[idx],
            times={k: v[idx] for k, v in self.times.items()},
            mnk=self.mnk[idx],
            hw=self.hw[idx],
            source=self.source,
        )

    @staticmethod
    def concat(parts: Sequence["SelectionDataset"]) -> "SelectionDataset":
        keys = set(parts[0].times)
        for p in parts:
            keys &= set(p.times)
        return SelectionDataset(
            X=np.concatenate([p.X for p in parts]),
            y=np.concatenate([p.y for p in parts]),
            times={k: np.concatenate([p.times[k] for p in parts]) for k in keys},
            mnk=np.concatenate([p.mnk for p in parts]),
            hw=np.concatenate([p.hw for p in parts]),
            source="+".join(dict.fromkeys(p.source for p in parts)),
        )

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            X=self.X,
            y=self.y,
            mnk=self.mnk,
            hw=self.hw,
            source=np.array(self.source),
            time_keys=np.array(sorted(self.times)),
            **{f"time_{k}": v for k, v in self.times.items()},
        )

    @staticmethod
    def load(path: str) -> "SelectionDataset":
        z = np.load(path, allow_pickle=False)
        keys = [str(k) for k in z["time_keys"]]
        return SelectionDataset(
            X=z["X"],
            y=z["y"],
            times={k: z[f"time_{k}"] for k in keys},
            mnk=z["mnk"],
            hw=z["hw"],
            source=str(z["source"]),
        )


def collect_analytic(
    chips: Optional[Sequence[HardwareSpec]] = None,
    lo: int = 7,
    hi: int = 16,
    dsize: int = 2,
    sigma: float = 0.03,
    algos: Sequence[str] = simulate.SIM_ALGOS,
) -> SelectionDataset:
    """Build the analytic dataset over the paper grid (default: the
    port's ``SIMULATED_CHIPS``)."""
    chips = list(SIMULATED_CHIPS.values()) if chips is None else list(chips)
    rows_X, rows_y, rows_mnk, rows_hw = [], [], [], []
    times: Dict[str, List[float]] = {a: [] for a in algos}
    for hw in chips:
        for (m, n, k) in paper_grid(lo, hi):
            # paper's OOM filter: TNN needs room for B^T
            if not simulate.fits_memory(hw, m, n, k, dsize, tnn=True):
                continue
            t = {a: simulate.simulate_time(hw, a, m, n, k, dsize, sigma) for a in algos}
            p_nt = simulate.matmul_flops(m, n, k) / t["NT_DIRECT"]
            p_tnn = simulate.matmul_flops(m, n, k) / t["TNN"]
            label = 1 if p_nt >= p_tnn else -1
            rows_X.append(make_features(hw, m, n, k))
            rows_y.append(label)
            rows_mnk.append((m, n, k))
            rows_hw.append(hw.name)
            for a in algos:
                times[a].append(t[a])
    ds = SelectionDataset(
        X=np.array(rows_X),
        y=np.array(rows_y),
        times={a: np.array(v) for a, v in times.items()},
        mnk=np.array(rows_mnk),
        hw=np.array(rows_hw),
        source="analytic",
    )
    # canonical aliases for the paper pair
    ds.times["NT"] = ds.times["NT_DIRECT"]
    ds.times["TNN"] = ds.times["TNN"]
    return ds


# ATTN rows at per-slice extents: m query rows (decode's GQA group of 1-16
# rows; prefill and training chunks fold the group into up to 16384 rows),
# n keys, the port's flash head dims, both dtypes, g slices (a batch times
# its kv heads: one prompt's 8 to a full decode slot pool's 256).
ATTN_MS = (1, 2, 4, 8, 16, 64, 256, 1024, 4096, 16384)
ATTN_NS = (128, 512, 1024, 2048, 4096, 8192, 16384)
ATTN_DHS = (64, 112, 120, 128, 256)
ATTN_DSIZES = (2, 4)
ATTN_GS = (1, 8, 64, 256)


def collect_attn_analytic(hw: HardwareSpec = H100) -> SelectionDataset:
    """ATTN rows labelled by the analytic model of the attention subgraph:
    +1 where the op pair's direct arm (the unfused plan, ``ATTN_UNFUSED``)
    is no slower than the fused kernel (``ATTN_FUSED``), else -1.  ``X``
    holds ``make_attn_features`` rows; ``mnk`` is (m, n, dh); ``times``
    carries both arms and, as every dataset does, the direct and
    alternative arm under 'NT' and 'TNN'."""
    rows_X, rows_y, rows_mnk = [], [], []
    t_unfused, t_fused = [], []
    for m, n, dh, dsize, g in itertools.product(ATTN_MS, ATTN_NS, ATTN_DHS, ATTN_DSIZES,
                                                ATTN_GS):
        tu = simulate.simulate_time(hw, "ATTN_UNFUSED", m, n, dh, dsize, g=g)
        tf = simulate.simulate_time(hw, "ATTN_FUSED", m, n, dh, dsize, g=g)
        rows_X.append(make_attn_features(hw, m, n, dh, dsize, g))
        rows_y.append(1 if tu <= tf else -1)
        rows_mnk.append((m, n, dh))
        t_unfused.append(tu)
        t_fused.append(tf)
    times = {"ATTN_UNFUSED": np.array(t_unfused), "ATTN_FUSED": np.array(t_fused)}
    times["NT"], times["TNN"] = times["ATTN_UNFUSED"], times["ATTN_FUSED"]
    return SelectionDataset(
        X=np.array(rows_X),
        y=np.array(rows_y),
        times=times,
        mnk=np.array(rows_mnk),
        hw=np.array([hw.name] * len(rows_y)),
        source="analytic-attn",
    )


def collect_measured(
    sizes: Optional[Sequence[int]] = None,
    reps: int = 3,
    dtype: str = "float32",
    candidates: Tuple[str, str] = ("XLA_NT", "XLA_TNN"),
    max_flops: float = 5e10,
    verbose: bool = False,
    device="cuda",
    seed: int = 0,
) -> SelectionDataset:
    """Measured dataset of one NT candidate pair on a torch ``device``
    (the card unless the caller asks for the CPU): the best of ``reps``
    timings of each arm (``measure.bench_fn``) over the cube of ``sizes``,
    labelled +1 where the first arm is no slower."""
    import torch

    from .measure import bench_fn

    sizes = [2**i for i in range(5, 11)] if sizes is None else list(sizes)
    dev = resolve_device(device)
    hw = device_spec(dev)
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(seed)
    first, second = (CANDIDATES[name] for name in candidates)
    rows_X, rows_y, rows_mnk, rows_hw = [], [], [], []
    t_nt_all, t_tnn_all = [], []
    for m in sizes:
        for n in sizes:
            for k in sizes:
                if simulate.matmul_flops(m, n, k) > max_flops:
                    continue
                a = torch.randn((m, k), generator=gen).to(device=dev, dtype=dt)
                b = torch.randn((n, k), generator=gen).to(device=dev, dtype=dt)
                t_nt = bench_fn(first.run, a, b, reps=reps, warmup=1, stat="min")
                t_tnn = bench_fn(second.run, a, b, reps=reps, warmup=1, stat="min")
                label = 1 if t_nt <= t_tnn else -1
                rows_X.append(make_features(hw, m, n, k))
                rows_y.append(label)
                rows_mnk.append((m, n, k))
                rows_hw.append(hw.name)
                t_nt_all.append(t_nt)
                t_tnn_all.append(t_tnn)
                if verbose:
                    print(f"  m={m} n={n} k={k} NT={t_nt*1e3:.3f}ms "
                          f"TNN={t_tnn*1e3:.3f}ms -> {label}")
    return SelectionDataset(
        X=np.array(rows_X),
        y=np.array(rows_y),
        times={"NT": np.array(t_nt_all), "TNN": np.array(t_tnn_all)},
        mnk=np.array(rows_mnk),
        hw=np.array(rows_hw),
        source=f"measured-{current_platform(a)}",
    )


def dataset_from_measurements(
    cache,
    pair: Tuple[str, str] = PAPER_PAIR,
    pairs: Optional[Dict[str, Tuple[str, str]]] = None,
    dtype: Optional[str] = "float32",
    platform: Optional[str] = None,
) -> SelectionDataset:
    """Convert a ``MeasurementCache`` into a ``SelectionDataset``.

    This closes the paper's loop from measurements: (op, shape) keys that
    ``measure_candidates`` (or an ``AutotunePolicy``) timed become training
    records for the GBDT (measure -> train -> ``ModelPolicy``).  Each
    record is labelled against its *op's* binary pair (``pair`` names the
    NT pair; ``pairs`` overrides the per-op table, default
    ``candidates.BINARY_PAIRS_BY_OP``) with the same rule as
    ``collect_measured``: +1 (choose the direct arm) iff t_direct <= t_alt.
    The op kind enters the feature vector as the 9th column, so one model
    learns the whole op space.  Each candidate enters at its best config's
    time (``best_times``); the port's candidates have one config each.

    ``dtype`` selects which cache records to use: the feature vector has no
    dtype component, so mixing e.g. bfloat16 and float32 timings of one
    shape would feed the learner identical features with contradictory
    labels.  Pass ``dtype=None`` only when the cache is known to be
    dtype-homogeneous.  The ``platform`` (``gpu``/``cpu``) is the same kind
    of hidden dimension — a cache populated on two platforms with the same
    hardware descriptor is ambiguous, so that case raises and asks for an
    explicit ``platform=`` filter.  A record's hardware name resolves
    through ``hardware.known_specs()``: the analytic chips, this host and
    the current card.

    Records lacking a timing for either member of their op's pair are
    skipped (the OOM guard excludes transpose-materialising arms on shapes
    where the transpose does not fit, exactly like the paper's dataset
    filter).  ``times`` carries the canonical 'NT'/'TNN' columns — the
    direct/alternative arm of each record's op pair — plus every candidate
    timed in *all* kept records.
    """
    from .measure import best_times

    op_pairs = dict(BINARY_PAIRS_BY_OP)
    op_pairs["NT"] = tuple(pair)
    for op, p in (pairs or {}).items():
        op_pairs[op] = tuple(p)
    specs = known_specs()
    kept: List[Tuple[HardwareSpec, str, int, int, int, Dict[str, float]]] = []
    unknown_hw: Dict[str, int] = {}
    other_dtypes: Dict[str, int] = {}
    seen_platform: Dict[Tuple, str] = {}
    for (rec_platform, hw_name, rec_dtype, op, g, m, n, k), nested in cache.records():
        if platform is not None and rec_platform != platform:
            continue
        if dtype is not None and rec_dtype != dtype:
            other_dtypes[rec_dtype] = other_dtypes.get(rec_dtype, 0) + 1
            continue
        direct_name, alt_name = op_pairs[op]
        # each candidate enters at its best config's time
        times = {name: t for name, (_ck, t) in best_times(nested).items()}
        if direct_name not in times or alt_name not in times:
            continue
        hw = specs.get(hw_name)
        if hw is None:
            # measured on hardware this build has no descriptor for — the
            # 5 hardware feature dims cannot be rebuilt, so the record is
            # unusable (counted so an empty result names the real cause)
            unknown_hw[hw_name] = unknown_hw.get(hw_name, 0) + 1
            continue
        sk = (hw_name, rec_dtype, op, g, m, n, k)
        prev = seen_platform.get(sk)
        if prev is not None and prev != rec_platform:
            raise ValueError(
                f"measurement cache holds records for hw={hw_name!r} "
                f"dtype={rec_dtype!r} op={op} shape=({m}, {n}, {k}) under "
                f"multiple platforms ({prev!r}, {rec_platform!r}) — "
                "identical features with possibly contradictory labels; "
                "pass platform= to pick one"
            )
        seen_platform[sk] = rec_platform
        kept.append((hw, op, g, m, n, k, times))
    if not kept:
        if unknown_hw:
            why = (
                "all matching records were measured on hardware with no "
                f"registered descriptor: {sorted(unknown_hw)}"
            )
        elif other_dtypes:
            why = (
                f"the cache only holds {sorted(other_dtypes)} records — pass "
                "dtype= to convert them"
            )
        else:
            why = (
                "fill it with measure.measure_candidates (or --policy "
                "autotune) first"
            )
        raise ValueError(
            f"measurement cache has no usable{f' {dtype}' if dtype else ''} "
            f"records timing both members of an op's binary pair "
            f"(e.g. {op_pairs['NT']!r} for NT); {why}"
        )
    common = set(kept[0][6])
    for *_, times in kept:
        common &= set(times)
    rows_X, rows_y, rows_mnk, rows_hw = [], [], [], []
    t_direct, t_alt = [], []
    t_cols: Dict[str, List[float]] = {c: [] for c in sorted(common)}
    for hw, op, g, m, n, k, times in kept:
        direct_name, alt_name = op_pairs[op]
        rows_X.append(make_features(hw, m, n, k, op=op, g=g))
        rows_y.append(1 if times[direct_name] <= times[alt_name] else -1)
        rows_mnk.append((m, n, k))
        rows_hw.append(hw.name)
        t_direct.append(times[direct_name])
        t_alt.append(times[alt_name])
        for c in t_cols:
            t_cols[c].append(times[c])
    out_times = {c: np.array(v) for c, v in t_cols.items()}
    out_times["NT"] = np.array(t_direct)
    out_times["TNN"] = np.array(t_alt)
    return SelectionDataset(
        X=np.array(rows_X),
        y=np.array(rows_y),
        times=out_times,
        mnk=np.array(rows_mnk),
        hw=np.array(rows_hw),
        source="autotune-measured",
    )
