"""Two gloo ranks sharing one card: the seconds of each collective
through gloo's own staging (host and TCP) and through the route of ranks
on one card (CUDA IPC, ``distributed/collectives.py::_on_card``), on the
same operands, with the two results compared.

The default cases are the large collectives of grok-1's 2x1 training in
``chip_smoke.py`` phase 17 (one layer at full width): the all-gather of
one expert weight's FSDP piece (0.8 G bf16 elements a rank), the
reduce-scatter of its gradient (1.6 G bf16) and the all-reduce of an
embedding's f32 gradient (0.8 G).  ``--elements N`` runs every case at N
elements instead; on the CPU (``--device cpu``) both routes are gloo's.
The ranks keep the default CUDA allocator: a block in an expandable
segment cannot be opened through CUDA IPC on a host without
``pidfd_open``.

  PYTHONPATH=src python -m repro_torch.benchmarks.collectives_on_card
  PYTHONPATH=src python -m repro_torch.benchmarks.collectives_on_card --device cpu --elements 4096

Prints one JSON object: per case, each rep's seconds by route (rank 0's
clock, between barriers), the collectives that went through the card
route, and whether the routes' results are equal bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

# (wrapper, dtype, elements of a rank's operand)
CASES = (("all_gather", "bfloat16", 805306368),
         ("reduce_scatter", "bfloat16", 1610612736),
         ("all_reduce", "float32", 805306368))
WORLD = 2


def _call(C, name, x, group, rank):
    if name == "all_gather":
        return C.all_gather_in(x, group, WORLD, 0)
    if name == "reduce_scatter":
        return C.reduce_scatter_in(x, group, WORLD, rank, 0)
    return C.all_reduce_in(x, group)


def _rank(rank, tmp, device, cases, reps):
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import collectives as C

    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=WORLD)
    group = dist.group.WORLD
    threshold, rows = C.CARD_IPC_MIN_BYTES, []

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    for name, dtype, n in cases:
        gen = torch.Generator(device=device).manual_seed(rank)
        x = torch.randn(n, generator=gen, device=device).to(getattr(torch, dtype))
        row, results = {"collective": name, "dtype": dtype, "elements": n}, {}
        for route, bound in (("gloo", 1 << 62), ("card", threshold)):
            C.CARD_IPC_MIN_BYTES = bound
            before, times = C.ON_CARD["calls"], []
            for _ in range(reps):
                results.pop(route, None)
                dist.barrier()
                sync()
                t0 = time.perf_counter()
                results[route] = _call(C, name, x, group, rank)
                sync()
                times.append(time.perf_counter() - t0)
            row[f"{route}_s"] = times
            row[f"{route}_on_card_calls"] = C.ON_CARD["calls"] - before
        C.CARD_IPC_MIN_BYTES = threshold
        row["equal"] = bool(torch.equal(results["gloo"], results["card"]))
        rows.append(row)
        del x, results
        if device == "cuda":
            torch.cuda.empty_cache()
    dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(tmp, "rows.json"), "w") as fh:
            json.dump(rows, fh)


def run(device="cuda", elements=None, reps=2):
    """Each case's row (the module docstring), from two spawned ranks."""
    import torch.multiprocessing as mp

    cases = [(name, dtype, elements or n) for name, dtype, n in CASES]
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(tmp, device, cases, reps), nprocs=WORLD,
                           start_method="spawn")
        with open(os.path.join(tmp, "rows.json")) as fh:
            return json.load(fh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--elements", type=int, default=None,
                    help="every case at this many elements a rank")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    card = None
    if args.device == "cuda":  # the card's name and power limit beside its times
        import subprocess

        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    rows = run(args.device, args.elements, args.reps)
    print(json.dumps({"world": WORLD, "device": args.device, "card": card, "cases": rows}))
    return rows


if __name__ == "__main__":
    main()
