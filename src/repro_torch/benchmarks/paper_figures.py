"""Paper reproduction benchmarks on the card -- Figs. 1/2/3 (the
motivation data), measured beside the analytic H100 roofline.

Fig 1: distribution of P_NN / P_NT          (is cuBLAS NT really slower than NN?)
Fig 2: per-(M,N,K) winner map NT vs TNN     (cuBLAS NT against the paper's TNN)
Fig 3: distribution of P_TNN / P_NT

The measured arm times the card's grid (``common.card_cache``: measured
once per process, or read from a cache a caller already filled, such as
``chip_smoke.py``'s ``build/measured_f32.json``) in the paper's dtype,
f32, by default.  The analytic arm is the H100 datasheet roofline
(``core/simulate.py``).  Every result says which it is.

  PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig1,fig2,fig3
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import simulate
from repro_torch.core.dataset import collect_analytic, paper_grid
from repro_torch.core.hardware import SIMULATED_CHIPS

from .common import card_cache, device_label, hist, op_dataset, print_hist, save_json, section

__all__ = ["fig1_nn_vs_nt", "fig2_winner_map", "fig3_tnn_vs_nt", "fig2_rows", "fig3_rows"]


def _analytic(full: bool):
    return collect_analytic(lo=7, hi=16 if full else 12)


def fig1_nn_vs_nt(full: bool = False, device="cuda", dtype: str = "float32",
                  cache: Optional[str] = None, hi: Optional[int] = None):
    """P_NN / P_NT = t_NT / t_NN per shape.  Paper: P_NN > P_NT in 71 % /
    62 % of cases (GTX 1080 / Titan X); about 20 % of cases >= 2.0."""
    section("Fig.1 -- frequency of P_NN / P_NT")
    out = {}
    for chip in SIMULATED_CHIPS.values():
        ratios = []
        for m, n, k in paper_grid(7, 16 if full else 12):
            if not simulate.fits_memory(chip, m, n, k, 2, tnn=False):
                continue
            t_nt = simulate.simulate_time(chip, "NT_DIRECT", m, n, k)
            t_nn = simulate._matmul_time(chip, m, n, k, 2)
            ratios.append(t_nt / t_nn)  # P_NN/P_NT == t_NT/t_NN
        r = np.array(ratios)
        out[chip.name] = {"hist": hist(r), "frac_nn_wins": float((r > 1.0).mean()),
                          "frac_ge2": float((r >= 2.0).mean()), "source": "analytic"}
        print(f"[analytic {chip.name}] P_NN>P_NT in {out[chip.name]['frac_nn_wins'] * 100:.0f}% "
              f"of {len(r)} cases; >=2.0 in {out[chip.name]['frac_ge2'] * 100:.0f}%")
        print_hist(f"P_NN/P_NT on {chip.name} (analytic)", out[chip.name]["hist"])
    dev = resolve_device(device)
    mc = card_cache(dtype, dev, full, hi, cache)
    by_op = {}
    for (_p, _hw, rec_dtype, op, g, m, n, k), times in mc.records():
        if rec_dtype == dtype and g == 1 and op in ("NT", "NN"):
            name = "XLA_NT" if op == "NT" else "XLA_NN"
            if name in times:
                by_op.setdefault((m, n, k), {})[op] = min(times[name].values())
    r = np.array([t["NT"] / t["NN"] for t in by_op.values() if len(t) == 2])
    out["measured"] = {"hist": hist(r), "frac_nn_wins": float((r > 1.0).mean()),
                       "frac_ge2": float((r >= 2.0).mean()), "n": int(len(r)),
                       "source": "measured", "library": "cuBLAS (torch.matmul)",
                       "dtype": dtype, **device_label(dev)}
    print(f"[measured {out['measured']['name']}] cuBLAS P_NN>P_NT in "
          f"{out['measured']['frac_nn_wins'] * 100:.1f}% of {len(r)} shapes; >=2.0 in "
          f"{out['measured']['frac_ge2'] * 100:.1f}% (paper: 71%/62%, ~20%)")
    print_hist("P_NN/P_NT, cuBLAS (measured)", out["measured"]["hist"])
    ds = op_dataset(mc, "NT", dtype)
    out["measured_nt_over_tnn"] = {"hist": hist(ds.times["NT"] / np.maximum(ds.times["TNN"],
                                                                            1e-12)),
                                   "source": "measured"}
    save_json(f"fig1_{dtype}", out)
    return out


def fig2_rows(ds):
    """Fig. 2 of one dataset: NT and TNN wins per K, and the largest
    speedups either way (the JAX package's ``fig2_winner_map`` body)."""
    rows = []
    for k in np.unique(ds.mnk[:, 2]):
        sel = ds.mnk[:, 2] == k
        rows.append({"k": int(k), "nt_wins": int((ds.y[sel] == 1).sum()),
                     "tnn_wins": int((ds.y[sel] == -1).sum())})
    return {"rows": rows,
            "max_speedup_tnn_over_nt": float((ds.times["NT"] / ds.times["TNN"]).max()),
            "max_speedup_nt_over_tnn": float((ds.times["TNN"] / ds.times["NT"]).max())}


def fig2_winner_map(full: bool = False, device="cuda", dtype: str = "float32",
                    cache: Optional[str] = None, hi: Optional[int] = None):
    """Winner (cuBLAS NT vs the paper's TNN) per (M, N, K), as counts by
    K; the top level is the measured map, ``"analytic"`` the roofline's."""
    section("Fig.2 -- NT vs TNN winner map (measured; analytic beside it)")
    dev = resolve_device(device)
    ds = op_dataset(card_cache(dtype, dev, full, hi, cache), "NT", dtype)
    out = {**fig2_rows(ds), "source": "measured", "dtype": dtype, **device_label(dev),
           "analytic": {**fig2_rows(_analytic(full)), "source": "analytic"}}
    print("      K    NT-wins   TNN-wins   (measured)")
    for row in out["rows"]:
        print(f"  {row['k']:>7d} {row['nt_wins']:8d} {row['tnn_wins']:10d}")
    for arm in (out, out["analytic"]):
        print(f"  [{arm['source']}] max speedup TNN over NT: "
              f"{arm['max_speedup_tnn_over_nt']:.2f}x (paper: 4.7x); NT over TNN: "
              f"{arm['max_speedup_nt_over_tnn']:.2f}x (paper: 15.39x)")
    save_json(f"fig2_{dtype}", out)
    return out


def fig3_rows(ds):
    """Fig. 3 of one dataset, per hardware name: the P_TNN/P_NT histogram
    and the share of cases where TNN is slower (the JAX package's body)."""
    out = {}
    for hw in np.unique(ds.hw):
        sel = ds.hw == hw
        r = np.asarray(ds.times["NT"][sel]) / np.asarray(ds.times["TNN"][sel])
        out[str(hw)] = {"hist": hist(r), "frac_tnn_loses": float((r < 1.0).mean())}
    return out


def fig3_tnn_vs_nt(full: bool = False, device="cuda", dtype: str = "float32",
                   cache: Optional[str] = None, hi: Optional[int] = None):
    """P_TNN/P_NT.  Paper: 41.5 % / 43 % of cases < 1.0 (TNN slower)."""
    section("Fig.3 -- frequency of P_TNN / P_NT")
    dev = resolve_device(device)
    ds = op_dataset(card_cache(dtype, dev, full, hi, cache), "NT", dtype)
    out = {hw: {**row, "source": "measured", "dtype": dtype, **device_label(dev)}
           for hw, row in fig3_rows(ds).items()}
    out.update({hw: {**row, "source": "analytic"}
                for hw, row in fig3_rows(_analytic(full)).items() if hw not in out})
    for hw, row in out.items():
        print(f"[{row['source']} {hw}] P_TNN/P_NT < 1.0 in {row['frac_tnn_loses'] * 100:.1f}% "
              f"of cases (paper: 41.5%/43%)")
        print_hist(f"P_TNN/P_NT on {hw}", row["hist"])
    save_json(f"fig3_{dtype}", out)
    return out
