"""Paper reproduction benchmarks on the card -- Tables IV/VI/VIII and
Fig. 4, on the measured dataset (cuBLAS NT against the paper's TNN, the
NT records of ``common.card_cache``).

Table IV:   5-fold CV per-class accuracy (GBDT)
Table VI:   GBDT vs SVM-RBF vs SVM-Poly vs DT (accuracy, train/predict time)
Fig 4:      accuracy vs training-set size (10 %..100 % step 5)
Table VIII: MTNN-vs-NT / MTNN-vs-TNN / GOW / LUB, and Fig. 6

The paper's own numbers (GTX 1080 and Titan X, f32, Caffe) are printed
beside each result, labelled as the paper's.

  PYTHONPATH=src python -m repro_torch.benchmarks.run --only table4,table6,fig4,table8
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.features import normalize01
from repro_torch.core.train_model import (
    _make_classifier,
    accuracy_vs_train_size,
    kfold_cv,
    selection_metrics,
    train_paper_model,
    train_test_split,
)

from .common import card_cache, device_label, hist, op_dataset, print_hist, save_json, section

__all__ = ["table4_cv", "table6_classifiers", "fig4_train_size", "table8_selection",
           "table8_rows", "PAPER"]

# The paper's numbers (GTX 1080 / Titan X), for printing beside the card's.
PAPER = {
    "table4": {"negative": 92.05, "positive": 88.39, "total": 90.51},
    "table6": {"gbdt": 90.51, "svm-rbf": 81.66, "svm-poly": 77.68, "dt": 87.84},
    "fig4_full_data_accuracy": 96.39,
    "table8": {"mtnn_vs_nt": 54.03, "mtnn_vs_tnn": 21.92, "gow_avg": 76.23,
               "gow_max": 1439.39, "lub_avg": -0.28, "lub_min": -71.62},
}


def _dataset(full, device, dtype, cache, hi):
    dev = resolve_device(device)
    return op_dataset(card_cache(dtype, dev, full, hi, cache), "NT", dtype), dev


def table4_cv(full: bool = False, device="cuda", dtype: str = "float32",
              cache: Optional[str] = None, hi: Optional[int] = None):
    section("Table IV -- 5-fold cross-validation accuracies (GBDT, measured)")
    ds, dev = _dataset(full, device, dtype, cache, hi)
    cv = kfold_cv(ds, "gbdt")
    print(f"  {'class':<10s} {'min':>8s} {'max':>8s} {'avg':>8s}   (paper avg)")
    for cls in ("negative", "positive", "total"):
        d = cv[cls]
        print(f"  {cls:<10s} {d['min'] * 100:7.2f}% {d['max'] * 100:7.2f}% "
              f"{d['avg'] * 100:7.2f}%   ({PAPER['table4'][cls]:.2f}%)")
    out = {**cv, "class_counts": ds.class_counts(), "source": "measured", "dtype": dtype,
           **device_label(dev)}
    save_json(f"table4_{dtype}", out)
    return out


def table6_classifiers(full: bool = False, device="cuda", dtype: str = "float32",
                       cache: Optional[str] = None, hi: Optional[int] = None):
    section("Table VI -- classifier comparison (accuracy, train/predict time; measured)")
    ds, dev = _dataset(full, device, dtype, cache, hi)
    idx = np.random.RandomState(0).permutation(len(ds))[: min(len(ds), 1200)]
    tr, te = train_test_split(ds.subset(idx), 0.8)
    rows = {}
    print(f"  {'classifier':<10s} {'acc':>7s} {'train ms':>9s} {'pred ms':>8s}  (paper acc)")
    for kind in ("gbdt", "dt", "svm-rbf", "svm-poly"):
        Xtr, Xte = tr.X, te.X
        if kind.startswith("svm"):
            Xtr, lo, hi_ = normalize01(Xtr)
            Xte, _, _ = normalize01(Xte, lo, hi_)
        clf = _make_classifier(kind, svm_gamma=0.01)
        t0 = time.perf_counter()
        clf.fit(Xtr, tr.y)
        t_fit = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        pred = clf.predict(Xte)
        t_pred = (time.perf_counter() - t0) * 1e3 / max(len(te), 1)
        acc = float((pred == te.y).mean())
        rows[kind] = {"accuracy": acc, "train_ms": t_fit, "predict_ms_per_sample": t_pred}
        print(f"  {kind:<10s} {acc * 100:6.2f}% {t_fit:9.1f} {t_pred:8.4f}  "
              f"({PAPER['table6'][kind]:.2f}%)")
    out = {**rows, "_meta": {"source": "measured", "dtype": dtype, "train": len(tr),
                             "test": len(te), "host_times": "train/predict ms on the host CPU",
                             **device_label(dev)}}
    save_json(f"table6_{dtype}", out)
    return out


def fig4_train_size(full: bool = False, device="cuda", dtype: str = "float32",
                    cache: Optional[str] = None, hi: Optional[int] = None):
    section("Fig.4 -- accuracy vs training-set size (train x%, test on ALL; measured)")
    ds, dev = _dataset(full, device, dtype, cache, hi)
    curve = accuracy_vs_train_size(ds, fracs=tuple(x / 100 for x in range(10, 101, 5)))
    for f, a in curve:
        print(f"  {int(f * 100):3d}%  {a * 100:6.2f}%  {'#' * int((a - 0.8) * 250) if a > 0.8 else ''}")
    final = curve[-1][1]
    print(f"  full-data accuracy: {final * 100:.2f}% "
          f"(paper: {PAPER['fig4_full_data_accuracy']}%)")
    out = {"curve": curve, "full_data_accuracy": final, "source": "measured", "dtype": dtype,
           **device_label(dev)}
    save_json(f"fig4_{dtype}", out)
    return out


def table8_rows(ds):
    """Table VIII and Fig. 6 of one dataset (the JAX package's
    ``table8_selection`` body): the paper's metrics in total and per
    hardware name, and the share of shapes where MTNN beats NT."""
    clf, report = train_paper_model(ds)
    out = {"total": report["selection"]}
    pred = clf.predict(ds.X)
    for hw in np.unique(ds.hw):
        sel = ds.hw == hw
        out[str(hw)] = selection_metrics(ds.subset(np.where(sel)[0]), pred[sel])
    p_sel = np.where(pred == 1, 1.0 / ds.times["NT"], 1.0 / ds.times["TNN"])
    r = p_sel * ds.times["NT"]
    out["fig6_hist"] = hist(np.asarray(r))
    out["fig6_frac_mtnn_wins"] = float((r > 1.0).mean())
    out["fig6_max_regret"] = float((1 / r).max())
    return out


def table8_selection(full: bool = False, device="cuda", dtype: str = "float32",
                     cache: Optional[str] = None, hi: Optional[int] = None):
    section("Table VIII + Figs.5/6 -- MTNN selection performance (measured)")
    ds, dev = _dataset(full, device, dtype, cache, hi)
    out = table8_rows(ds)
    cols = [k for k in out if not k.startswith("fig6")]
    print(f"  {'metric':<14s}" + "".join(f"{h[:14]:>15s}" for h in cols) + f"{'(paper tot)':>12s}")
    for metric in PAPER["table8"]:
        print(f"  {metric:<14s}" + "".join(f"{out[h][metric]:15.2f}" for h in cols)
              + f"{PAPER['table8'][metric]:12.2f}")
    print_hist("Fig.6: P_MTNN/P_NT", out["fig6_hist"])
    print(f"  MTNN beats NT in {out['fig6_frac_mtnn_wins'] * 100:.1f}% of cases "
          f"(paper: 47.8%/43.4%); max P_NT/P_MTNN = {out['fig6_max_regret']:.2f} (paper: ~1.6)")
    out.update(source="measured", dtype=dtype, **device_label(dev))
    save_json(f"table8_{dtype}", out)
    return out
