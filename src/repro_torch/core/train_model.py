"""Training / evaluation pipeline for the MTNN predictor (paper §V-B, §VI).

Implements, exactly as in the paper:
  * 80/20 stratified-by-hardware split
  * 5-fold cross-validation with per-class (negative/positive) accuracy
  * accuracy-vs-training-set-size curve (Fig. 4: x = 10..100 step 5,
    training on x% and *testing on the full set*, as the paper does)
  * final model trained on 100% of the data
  * selection metrics: MTNN-vs-NT, MTNN-vs-TNN, GOW (gain over worst),
    LUB (loss under best) — Eqs. 6, 7 and Tables VII/VIII

and, beyond the paper, a k-way regression selector over the full candidate
set (argmin of predicted log-time).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dataset import SelectionDataset
from .features import normalize01
from .gbdt import DecisionTreeClassifier, GBDTClassifier, GBDTRegressor
from .svm import SVMClassifier

__all__ = [
    "train_test_split",
    "kfold_cv",
    "accuracy_report",
    "selection_metrics",
    "accuracy_vs_train_size",
    "train_paper_model",
    "train_kway_model",
    "KWayModel",
]


def _rng(seed: int) -> np.random.RandomState:
    return np.random.RandomState(seed)


def train_test_split(
    ds: SelectionDataset, train_frac: float = 0.8, seed: int = 0
) -> Tuple[SelectionDataset, SelectionDataset]:
    """80/20 split, stratified per hardware platform (paper §V-B)."""
    rng = _rng(seed)
    train_idx: List[int] = []
    test_idx: List[int] = []
    for hw in np.unique(ds.hw):
        idx = np.where(ds.hw == hw)[0]
        rng.shuffle(idx)
        cut = int(round(train_frac * len(idx)))
        train_idx.extend(idx[:cut])
        test_idx.extend(idx[cut:])
    return ds.subset(np.array(train_idx)), ds.subset(np.array(test_idx))


def accuracy_report(y_true: np.ndarray, y_pred: np.ndarray) -> Dict[str, float]:
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    neg = y_true == -1
    pos = y_true == 1
    out = {"total": float((y_true == y_pred).mean())}
    out["negative"] = float((y_pred[neg] == -1).mean()) if neg.any() else float("nan")
    out["positive"] = float((y_pred[pos] == 1).mean()) if pos.any() else float("nan")
    return out


def _make_classifier(kind: str, **kw):
    if kind == "gbdt":
        return GBDTClassifier(
            n_estimators=kw.get("n_estimators", 8),
            max_depth=kw.get("max_depth", 8),
            eta=kw.get("eta", 1.0),
            gamma=kw.get("gamma", 0.0),
        )
    if kind == "dt":
        return DecisionTreeClassifier(max_depth=kw.get("max_depth", 8))
    if kind == "svm-rbf":
        return SVMClassifier(C=kw.get("C", 1000.0), kernel="rbf", gamma=kw.get("svm_gamma", 0.01))
    if kind == "svm-poly":
        return SVMClassifier(C=kw.get("C", 1000.0), kernel="poly", gamma=kw.get("svm_gamma", 0.01))
    raise ValueError(f"unknown classifier kind {kind!r}")


def _needs_norm(kind: str) -> bool:
    return kind.startswith("svm")


def kfold_cv(
    ds: SelectionDataset, kind: str = "gbdt", k: int = 5, seed: int = 0, **kw
) -> Dict[str, Dict[str, float]]:
    """5-fold CV with min/max/avg per-class accuracy (paper Table IV)."""
    rng = _rng(seed)
    idx = np.arange(len(ds))
    rng.shuffle(idx)
    folds = np.array_split(idx, k)
    reports = []
    for i in range(k):
        test = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        Xtr, Xte = ds.X[train], ds.X[test]
        if _needs_norm(kind):
            Xtr, lo, hi = normalize01(Xtr)
            Xte, _, _ = normalize01(Xte, lo, hi)
        clf = _make_classifier(kind, **kw).fit(Xtr, ds.y[train])
        reports.append(accuracy_report(ds.y[test], clf.predict(Xte)))
    out: Dict[str, Dict[str, float]] = {}
    for cls in ("negative", "positive", "total"):
        vals = np.array([r[cls] for r in reports])
        vals = vals[~np.isnan(vals)]
        if not len(vals):  # the class occurs in no test fold (one-class data)
            out[cls] = {"min": float("nan"), "max": float("nan"), "avg": float("nan")}
            continue
        out[cls] = {
            "min": float(vals.min()),
            "max": float(vals.max()),
            "avg": float(vals.mean()),
        }
    return out


def accuracy_vs_train_size(
    ds: SelectionDataset,
    fracs: Sequence[float] = tuple(x / 100 for x in range(10, 101, 5)),
    kind: str = "gbdt",
    seed: int = 0,
    **kw,
) -> List[Tuple[float, float]]:
    """Paper Fig. 4: train on x%, test on the WHOLE dataset."""
    rng = _rng(seed)
    out = []
    for frac in fracs:
        idx = np.arange(len(ds))
        rng.shuffle(idx)
        cut = max(2, int(round(frac * len(ds))))
        sub = idx[:cut]
        Xtr, Xall = ds.X[sub], ds.X
        if _needs_norm(kind):
            Xtr, lo, hi = normalize01(Xtr)
            Xall, _, _ = normalize01(Xall, lo, hi)
        clf = _make_classifier(kind, **kw).fit(Xtr, ds.y[sub])
        acc = accuracy_report(ds.y, clf.predict(Xall))["total"]
        out.append((float(frac), float(acc)))
    return out


def selection_metrics(
    ds: SelectionDataset,
    y_pred: np.ndarray,
    nt_key: str = "NT",
    tnn_key: str = "TNN",
) -> Dict[str, float]:
    """Paper Tables VII/VIII: MTNN-vs-NT, MTNN-vs-TNN, GOW, LUB.

    P_MTNN(sample) = performance of the algorithm the predictor chose.
    Performances are 1/time (GFLOPS factor cancels inside the ratios).
    """
    t_nt = ds.times[nt_key]
    t_tnn = ds.times[tnn_key]
    p_nt, p_tnn = 1.0 / t_nt, 1.0 / t_tnn
    p_sel = np.where(np.asarray(y_pred) == 1, p_nt, p_tnn)
    p_best = np.maximum(p_nt, p_tnn)
    p_worst = np.minimum(p_nt, p_tnn)
    gow = (p_sel - p_worst) / p_worst
    lub = (p_sel - p_best) / p_best
    return {
        "mtnn_vs_nt": float(((p_sel - p_nt) / p_nt).mean() * 100),
        "mtnn_vs_tnn": float(((p_sel - p_tnn) / p_tnn).mean() * 100),
        "gow_avg": float(gow.mean() * 100),
        "gow_max": float(gow.max() * 100),
        "lub_avg": float(lub.mean() * 100),
        "lub_min": float(lub.min() * 100),
    }


def train_paper_model(ds: SelectionDataset, **kw) -> Tuple[GBDTClassifier, Dict]:
    """The paper's final model: GBDT trained on 100% of the data."""
    clf = _make_classifier("gbdt", **kw).fit(ds.X, ds.y)
    pred = clf.predict(ds.X)
    report = {
        "full_data_accuracy": accuracy_report(ds.y, pred),
        "selection": selection_metrics(ds, pred),
        "class_counts": ds.class_counts(),
        "source": ds.source,
    }
    return clf, report


# -- beyond paper: k-way regression selector --------------------------------


@dataclass
class KWayModel:
    """Per-candidate log-time regressors; selection = argmin prediction."""

    candidates: Tuple[str, ...]
    regressors: Dict[str, GBDTRegressor] = field(default_factory=dict)

    def predict_times(self, X: np.ndarray) -> np.ndarray:
        """(N, n_candidates) predicted seconds."""
        cols = [np.exp(self.regressors[c].predict(X)) for c in self.candidates]
        return np.stack(cols, axis=1)

    def select(self, X: np.ndarray) -> np.ndarray:
        """(N,) index into self.candidates."""
        return np.argmin(self.predict_times(X), axis=1)

    def to_dict(self) -> Dict:
        return {
            "kind": "kway",
            "candidates": list(self.candidates),
            "regressors": {c: r.to_dict() for c, r in self.regressors.items()},
        }

    @staticmethod
    def from_dict(d: Dict) -> "KWayModel":
        m = KWayModel(candidates=tuple(d["candidates"]))
        m.regressors = {
            c: GBDTRegressor.from_dict(rd) for c, rd in d["regressors"].items()
        }
        return m


def train_kway_model(
    ds: SelectionDataset, candidates: Optional[Sequence[str]] = None, **kw
) -> Tuple[KWayModel, Dict]:
    cands = tuple(candidates or [c for c in ds.times if c not in ("NT",)])
    model = KWayModel(candidates=cands)
    for c in cands:
        model.regressors[c] = GBDTRegressor(**kw).fit(ds.X, np.log(ds.times[c]))
    sel = model.select(ds.X)
    t_all = np.stack([ds.times[c] for c in cands], axis=1)
    t_sel = t_all[np.arange(len(ds)), sel]
    t_best = t_all.min(axis=1)
    t_worst = t_all.max(axis=1)
    report = {
        "oracle_match": float((t_sel == t_best).mean()),
        "mean_slowdown_vs_oracle": float((t_sel / t_best).mean()),
        "mean_speedup_vs_worst": float((t_worst / t_sel).mean()),
        "mean_speedup_vs_xla": (
            float((ds.times["XLA_DOT"] / t_sel).mean()) if "XLA_DOT" in ds.times else None
        ),
        "candidates": list(cands),
        "source": ds.source,
    }
    return model, report
