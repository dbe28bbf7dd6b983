"""The roofline table of the dry run's records.

Reads the records ``python -m repro_torch.launch.dryrun --all`` wrote
under ``build/dryrun/`` for one mesh, prints one row per (arch x shape):
the three roofline terms in seconds, the bottleneck, ``useful_ratio`` and
the per-device memory (arguments plus the step's peak temporaries)
against the H100's 80 GB, and writes the rows to
``build/bench/roofline_<mesh>.json``; ``--variant optimized`` reads the
records of ``dryrun --variant optimized`` and writes
``roofline_<mesh>_optimized.json``.  Every number is meta-tensor
accounting with the H100 80GB HBM3's datasheet peaks
(``launch/roofline.py``), not a chip measurement.

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline_table [--mesh 16x16]
      [--variant optimized]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import OUT_DIR, VARIANTS

from .common import save_json, section

__all__ = ["load_records", "roofline_table", "main"]


def _suffix(mesh: str, variant: str) -> str:
    return mesh if variant == "baseline" else f"{mesh}_{variant}"


def load_records(mesh: str = "16x16", directory: str = OUT_DIR, variant: str = "baseline"):
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, f"*_{_suffix(mesh, variant)}.json"))):
        with open(path) as fh:
            recs.append(json.load(fh))
    return recs


def roofline_table(mesh: str = "16x16", directory: str = OUT_DIR, variant: str = "baseline"):
    section(f"Roofline per (arch x shape) on the {mesh} mesh, {variant} (dry run: meta-tensor "
            "accounting, H100 datasheet peaks)")
    recs = load_records(mesh, directory, variant)
    if not recs:
        print("  (no dry-run records: run `python -m repro_torch.launch.dryrun --all`)")
        return {"rows": []}
    print(f"  {'arch':<18s} {'shape':<12s} {'comp(s)':>9s} {'mem(s)':>9s} "
          f"{'coll(s)':>9s} {'bound':>10s} {'useful':>7s} {'fit(GB)':>8s}")
    rows = []
    for r in recs:
        if r.get("status") == "skip":
            print(f"  {r['arch']:<18s} {r['shape']:<12s} {r['why']}")
            rows.append({k: r.get(k) for k in ("arch", "shape", "status", "why")})
            continue
        if r.get("status") != "ok":
            print(f"  {r['arch']:<18s} {r['shape']:<12s} ERROR {r.get('error', '')[:70]}")
            rows.append({k: r.get(k) for k in ("arch", "shape", "status", "error")})
            continue
        rf, mem = r["roofline"], r["memory"]
        print(f"  {r['arch']:<18s} {r['shape']:<12s} {rf['t_compute_s']:9.4f} "
              f"{rf['t_memory_s']:9.4f} {rf['t_collective_s']:9.4f} "
              f"{rf['bottleneck']:>10s} {rf['useful_ratio'] * 100:6.1f}% "
              f"{mem['fit_gb']:8.2f}")
        rows.append({"arch": r["arch"], "shape": r["shape"], "status": "ok",
                     **{k: rf[k] for k in ("t_compute_s", "t_memory_s", "t_collective_s",
                                           "bottleneck", "useful_ratio")},
                     "fit_gb": mem["fit_gb"], "fits_80gb": mem["fits_80gb"]})
    n_ok = sum(1 for r in rows if r.get("status") == "ok")
    print(f"\n  {n_ok} ok / {len(rows)} cells")
    save_json(f"roofline_{_suffix(mesh, variant)}", {"rows": rows, "variant": variant,
                                                     "source": "meta-tensor accounting"})
    return {"rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    args = ap.parse_args(argv)
    return roofline_table(args.mesh, args.dir, args.variant)


if __name__ == "__main__":
    main()
