"""Dry run: one rank's step of every (arch x shape) cell on the
production mesh, on meta tensors -- nothing is allocated, nothing runs on
a card.

Per cell this script:
  1. builds the full ArchConfig, the production mesh (abstract: 16 x 16,
     or 2 x 16 x 16 with ``--multi-pod``) and rank 0's pieces of the
     state, cache and batch under the sharding rules,
  2. runs the rank's train, prefill or decode step on meta tensors
     (``launch/accounting.py``): FLOPs, bytes and collective bytes per
     device, and the peak of the bytes the step allocates,
  3. records the per-device argument bytes (exact from the specs) plus
     that peak against the H100's 80 GB, the three roofline terms
     (``launch/roofline.py``, datasheet peaks) and ``useful_ratio``, and
     writes one JSON record per cell under ``build/dryrun/``.

Every architecture's cells run, the MoE ones with their experts split
over ``model`` and gathered over the data axes (FSDP) and the Mamba
blocks split by head; the collective bytes include the FSDP gathers and
reduce-scatters and the expert-parallel reduces, which the wrappers
record as they run.  A cell that raises records ``status: "error"`` with
the error's text, as the JAX package records a failing cell.

``--variant optimized`` is the JAX package's beyond-paper variant: it
sets ``sharding.MIN_MODEL_DIM`` to 1024 for the cell (thin projections
stay whole; put back when the cell ends, where the JAX package leaves
it set), turns on sequence-parallel attention where the heads do not
divide ``model`` (``ArchConfig.sp_attention``) and takes the sharded
gradient accumulators for train cells (``zero1_grads``); its records
carry ``variant: "optimized"`` and their files the suffix
``_optimized``.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]
                                      [--variant optimized]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import SHAPES, cell_applicable, get_config, list_archs
from repro_torch.core.engine import add_policy_argument, policy_from_spec
from repro_torch.distributed.sharding import P, data_axes, min_model_dim
from repro_torch.launch.accounting import account_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import (
    HW_H100,
    link_gbps,
    model_flops_for_cell,
    roofline_from_costs,
)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")

HBM_BYTES = 80e9  # an H100 80GB's device memory

__all__ = ["lower_cell", "run_cell", "main", "OUT_DIR", "VARIANTS"]


def _accum_for(cfg, shape, mesh) -> int:
    """Microbatching policy: 1-sample microbatches per data replica, as in
    the JAX package."""
    dp = 1
    for a in ("pod", "data"):
        if a in mesh.shape:
            dp *= mesh.shape[a]
    per_replica = max(1, shape.global_batch // dp)
    return per_replica


def _logits_spec(cfg, mesh, batch: int):
    daxes = data_axes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= mesh.shape[a]
    b_axis = ((daxes if len(daxes) > 1 else daxes[0])
              if batch % dsize == 0 and batch >= dsize else None)
    v_axis = "model" if cfg.vocab_padded % mesh.shape["model"] == 0 else None
    return P(b_axis, None, v_axis)


VARIANTS = ("baseline", "optimized")


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False, policy=None, mesh=None,
               cfg=None, accum=None, variant: str = "baseline"):
    """The record of one cell (``status`` ok, skip or, raised, error).
    ``mesh`` and ``cfg`` default to the production mesh and the arch's
    full config, ``accum`` (train cells) to ``_accum_for``'s; ``variant``
    is ``baseline`` or ``optimized`` (the module docstring), whose
    ``MIN_MODEL_DIM`` holds for this cell only."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; have {VARIANTS}")
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "status": "skip", "why": why}
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    optimized = variant == "optimized"
    if optimized and cfg.n_heads and cfg.n_heads % mesh.shape["model"] != 0:
        cfg = cfg.replace(sp_attention=True)
    if not optimized:
        return _lower(arch, cfg, shape, mesh, policy, accum, variant)
    with min_model_dim(1024):
        return _lower(arch, cfg, shape, mesh, policy, accum, variant)


def _lower(arch, cfg, shape, mesh, policy, accum, variant):
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": "x".join(str(s) for s in mesh.devices_shape),
        "kind": shape.kind,
        "variant": variant,
        "status": "ok",
    }
    t0 = time.time()
    accum = (accum or _accum_for(cfg, shape, mesh)) if shape.kind == "train" else 1
    if shape.kind == "train":
        record["accum"] = accum
    else:
        record["logits_spec"] = list(_logits_spec(cfg, mesh, shape.global_batch))
    costs = account_cell(cfg, shape, mesh, accum=accum, policy=policy,
                         zero1_grads=variant == "optimized" and shape.kind == "train")
    record["run_s"] = round(time.time() - t0, 1)
    arg, peak = costs["argument_bytes"], costs["peak_temp_bytes"]
    memory = {k: v for k, v in costs.items() if k.endswith("_bytes") and k != "coll_bytes"}
    memory.update(total_bytes=arg + peak, fit_gb=(arg + peak) / 1e9,
                  fits_80gb=arg + peak <= HBM_BYTES)
    record["memory"] = memory
    record["dispatches"] = costs["dispatches"]
    hw = dict(HW_H100, link_gbps=link_gbps(mesh))
    rep = roofline_from_costs(costs, mesh.size, model_flops_global=model_flops_for_cell(cfg, shape),
                              hw=hw, memory_stats=memory)
    record["roofline"] = rep.to_dict()
    record["hw"] = hw
    return record


def run_cell(arch, shape_name, multi_pod=False, verbose=True, policy=None, variant="baseline"):
    record = lower_cell(arch, shape_name, multi_pod, policy=policy, variant=variant)
    if verbose and record["status"] == "ok":
        r, m = record["roofline"], record["memory"]
        print(f"--- {arch} x {shape_name} ({record['mesh']}, {variant}) ---")
        print(f"memory: arguments {m['argument_bytes'] / 1e9:.3f} GB + peak temporaries "
              f"{m['peak_temp_bytes'] / 1e9:.3f} GB = {m['fit_gb']:.3f} GB of 80 "
              f"({'fits' if m['fits_80gb'] else 'does NOT fit'})")
        print("costs: flops=%.3e bytes=%.3e collective=%.3e"
              % (r["flops_per_device"], r["bytes_per_device"], r["collective_bytes"]))
        print("roofline: compute=%.4fs memory=%.4fs collective=%.4fs -> %s (useful %.2f%%)"
              % (r["t_compute_s"], r["t_memory_s"], r["t_collective_s"], r["bottleneck"],
                 100 * r["useful_ratio"]))
    elif verbose:
        print(f"--- {arch} x {shape_name}: {record['status']} ({record.get('why', '')})")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=VARIANTS)
    add_policy_argument(ap)
    args = ap.parse_args(argv)
    # each rank runs a local program: the kernels stay candidates
    # (launch/common.py), and selection on meta tensors measures nothing
    policy = policy_from_spec(args.policy, distributed=False, device="cpu")

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    results = []
    for arch in archs:
        for shape_name in shapes:
            tag = f"{arch}_{shape_name}_{'2x16x16' if args.multi_pod else '16x16'}"
            if args.variant != "baseline":
                tag += f"_{args.variant}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"skip existing {tag}")
                continue
            try:
                record = run_cell(arch, shape_name, args.multi_pod, policy=policy,
                                  variant=args.variant)
            except Exception as e:
                record = {
                    "arch": arch,
                    "shape": shape_name,
                    "status": "error",
                    "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:],
                }
                print(f"!!! {arch} x {shape_name} FAILED: {e}")
            results.append(record)
            with open(path, "w") as fh:
                json.dump(record, fh, indent=1)

    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skip")
    n_err = sum(1 for r in results if r["status"] == "error")
    print(f"\n== dry-run summary: {n_ok} ok, {n_skip} skip, {n_err} error ==")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
