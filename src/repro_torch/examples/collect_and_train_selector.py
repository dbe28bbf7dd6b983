"""Build a selector artifact from this device's measurements: the paper's
loop with the tile dimension.

  1. measure every NT/NN/TN candidate over the paper grid {2^7..2^hi}^3 on
     ``--device`` with ``tune=True``: each kernel candidate's own plan and
     its shortlisted tile configs (``--from-cache`` reads a measurement
     cache instead -- the file ``--policy autotune`` fills);
  2. fold the cache into per-op, per-shape tile tables
     (``tile_tables_from_cache``) and the selection dataset;
  3. cross-validate and train the paper's GBDT, and save the artifact
     (schema 5, loadable by both packages) with its tile tables.

  PYTHONPATH=src python -m repro_torch.examples.collect_and_train_selector --hi 10
  PYTHONPATH=src python -m repro_torch.examples.collect_and_train_selector --device cpu --hi 8
  PYTHONPATH=src python -m repro_torch.examples.collect_and_train_selector \\
      --from-cache ~/.cache/repro_torch/autotune_cache.json --out selector.json

It writes ``build/selector_<dtype>_tuned.json`` unless ``--out`` names
another path; no artifact is committed.  ``--policy model:PATH`` on the
launchers then dispatches the learned candidate at its learned tile.
"""

from __future__ import annotations

import argparse
import os

from repro_torch import resolve_device
from repro_torch.core import (
    MeasurementCache,
    MTNNSelector,
    OpKey,
    dataset_from_measurements,
    device_spec,
    kfold_cv,
    train_paper_model,
)
from repro_torch.core.measure import tile_tables_from_cache

from ..benchmarks.common import CARD_PAIR, measure_grid

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--hi", type=int, default=10, help="measure {2^7..2^HI}^3")
    ap.add_argument("--from-cache", default=None, metavar="CACHE_JSON",
                    help="train from a measurement cache instead of measuring")
    ap.add_argument("--cache-out", default=None,
                    help="where the measurement is saved (default build/measured_<dtype>_tuned_cache.json)")
    ap.add_argument("--out", default=None,
                    help="artifact path (default build/selector_<dtype>_tuned.json)")
    args = ap.parse_args(argv)
    short = {"bfloat16": "bf16", "float32": "f32"}[args.dtype]
    out = args.out or os.path.join("build", f"selector_{short}_tuned.json")

    if args.from_cache:
        print(f"[1/3] loading measurement cache {args.from_cache}")
        cache = MeasurementCache.load(args.from_cache, missing_ok=False)
        hw = None
    else:
        dev = resolve_device(args.device)
        hw = device_spec(dev)
        path = args.cache_out or os.path.join("build", f"measured_{short}_tuned_cache.json")
        print(f"[1/3] measuring NT/NN/TN over {{2^7..2^{args.hi}}}^3 in {args.dtype} on "
              f"{hw.name}, tile configs included -> {path}")
        cache = measure_grid(MeasurementCache(path), args.dtype, hi=args.hi, device=dev,
                             tune=True, queued=True)
        cache.save()
    tables = tile_tables_from_cache(cache, dtype=args.dtype)
    for op, table in sorted(tables.items()):
        for name, entry in sorted(table.items()):
            print(f"      {op} {name}: modal {entry['modal']}, "
                  f"{len(entry['by_shape'])} shapes won by a tuned tile")

    ds = dataset_from_measurements(cache, pair=CARD_PAIR, dtype=args.dtype)
    print(f"[2/3] train on {len(ds)} samples, classes {ds.class_counts()}")
    if len(ds) >= 25:
        cv = kfold_cv(ds, "gbdt")
        print(f"      5-fold CV: {cv['total']['avg'] * 100:.2f}%")
    clf, report = train_paper_model(ds)
    print(f"      full-data accuracy {report['full_data_accuracy']['total'] * 100:.2f}%")

    sel = MTNNSelector(clf, hardware=hw, binary_pair=CARD_PAIR, tile_tables=tables)
    sel.save(out)
    again = MTNNSelector.load(out, hardware=hw)
    probe = OpKey("NT", 1024, 1024, 1024, 2 if args.dtype == "bfloat16" else 4)
    assert again.select(probe) == sel.select(probe) and again.tile_tables == sel.tile_tables
    print(f"[3/3] saved {out} (reload check OK); --policy model:{out} dispatches it")
    return {"artifact": out, "tables": tables, "records": len(ds), "cache": cache}


if __name__ == "__main__":
    main()
