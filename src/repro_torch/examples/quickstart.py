"""Quickstart: the paper's pipeline on one device.

  1. the selection dataset (the analytic H100 roofline, a reduced grid)
  2. the GBDT predictor (paper hyper-parameters: 8 trees, depth 8, eta 1)
  3. 5-fold CV and selection metrics (paper Tables IV / VIII)
  4. real GEMMs dispatched through the selector, forward and backward

  PYTHONPATH=src python -m repro_torch.examples.quickstart            # on the card
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import (
    FixedPolicy,
    ModelPolicy,
    MTNNSelector,
    OpKey,
    collect_analytic,
    dispatch,
    dispatch_report,
    kfold_cv,
    train_paper_model,
    use_policy,
)

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== 1. dataset (analytic H100 roofline, grid 2^7..2^12) ==")
    ds = collect_analytic(lo=7, hi=12)
    print(f"   {len(ds)} samples, classes {ds.class_counts()} "
          "(label +1 => NT fastest, -1 => TNN)")

    print("\n== 2. train GBDT (paper: n_estimators=8, max_depth=8, eta=1) ==")
    clf, report = train_paper_model(ds)
    print(f"   full-data accuracy {report['full_data_accuracy']['total'] * 100:.2f}% "
          "(paper: 96.39%)")

    print("\n== 3. evaluation ==")
    cv = kfold_cv(ds, "gbdt")
    m = report["selection"]
    print(f"   5-fold CV avg {cv['total']['avg'] * 100:.2f}% (paper: 90.51%)")
    print(f"   MTNN vs always-NT: +{m['mtnn_vs_nt']:.1f}%  vs always-TNN: "
          f"+{m['mtnn_vs_tnn']:.1f}%")
    print(f"   GOW avg {m['gow_avg']:.1f}%  LUB avg {m['lub_avg']:.2f}% "
          "(paper: 76.23% / -0.28%)")

    print(f"\n== 4. dispatch on {dev} (op-space policy API) ==")
    policy = ModelPolicy(MTNNSelector(clf))
    for m_, n_, k_ in ((128, 128, 128), (8192, 8192, 8192), (512, 65536, 256)):
        choice = policy.select(OpKey("NT", m_, n_, k_))
        print(f"   C[{m_},{n_}] = A[{m_},{k_}] @ B[{n_},{k_}]^T -> {choice.label()}")
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(64, 32).astype(np.float32)).to(dev).requires_grad_()
    b = torch.from_numpy(rng.randn(16, 32).astype(np.float32)).to(dev)
    with use_policy(policy):  # every GEMM in scope, backward included
        out = dispatch("NT", a, b)
        (out ** 2).sum().backward()
    with torch.no_grad():
        err = float((out - a @ b.t()).abs().max())
        err_g = float((a.grad - 2.0 * (a @ b.t()) @ b).abs().max())
    print(f"   dispatch('NT') correctness: max|err| = {err:.2e} (grad: {err_g:.2e})")
    with use_policy(FixedPolicy("PALLAS_TNN")):  # the paper's TNN arm, forced
        out_tnn = dispatch("NT", a.detach(), b)
    print(f"   forced PALLAS_TNN agrees: {bool(torch.allclose(out, out_tnn, atol=1e-4))}")
    print("\n" + dispatch_report(policy))
    print("\nDone.  python -m repro_torch.examples.collect_and_train_selector builds an "
          "artifact from this device's measurements, tile tables included.")
    return {"cv": cv, "selection": m, "err": err, "grad_err": err_g}


if __name__ == "__main__":
    main()
