"""Restartable training launcher of the port, on one device.

  * auto-resume: picks up the newest valid checkpoint in --ckpt-dir; the
    deterministic data pipeline continues byte-identically.
  * async checkpointing every --ckpt-every steps (atomic, keep-N).
  * failure injection: --fail-at N raises before step N runs, to exercise
    the restart path.
  * straggler watchdog: steps slower than --straggler-factor x the running
    median are logged with the step index.

Example (CPU, reduced config):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --device cpu --steps 3 --batch 4 --seq 32 \\
      --policy fixed:nt=PALLAS_TNN_FUSED,nn=PALLAS_NN,tn=PALLAS_TN,bnt=PALLAS_BNT,bnn=PALLAS_BNN,attn=fused

``--arch`` takes every architecture of the port, the ``frames``
(musicgen-large) and ``vlm`` (paligemma-3b, whose ``--seq`` counts its
patch prefix) ones included; each trains with the optimizer its config
names (Adafactor for grok-1-314b and kimi-k2-1t-a32b, else AdamW).  The JAX launcher's flags, except that
``--mesh`` takes ``1x1`` only.  ``--chaos SPEC`` arms fault injection
for the run (``core/faults.py``), and ``health_report()`` is printed at
the end.  ``--device`` defaults to ``cuda`` and raises
when there is no card; ``--layers`` cuts the depth and ``--dtype`` sets
the parameter dtype; weights are random from ``--seed``.  The default
``--policy model`` is the default learned selector; ``--policy autotune``
measures on ``--device``.  ``main`` returns a ``TrainRun``: the final
state, the per-step metrics and wall times.
"""

from __future__ import annotations

import argparse
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.engine import (
    add_policy_argument,
    dispatch_report,
    health_report,
    policy_from_spec,
)
from repro_torch.core.faults import add_chaos_argument, chaos_scope
from repro_torch.data import make_train_batch
from repro_torch.launch.serve import config_from_args
from repro_torch.launch.steps import TrainStepConfig, init_train_state, make_train_step
from repro_torch.models import lm
from repro_torch.optim import tree_leaves

__all__ = ["TrainRun", "main"]


@dataclass
class TrainRun:
    """What ``main`` returns: the final state, one metrics dict (floats) and
    one wall time in seconds per step run, the policy and the config."""

    state: Dict[str, Any]
    policy: Any
    cfg: Any
    metrics: List[Dict[str, float]] = field(default_factory=list)
    times: List[float] = field(default_factory=list)


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut every segment to this many repeats (default: full depth)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="parameter dtype (default: the config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--fail-at", type=int,
                    default=int(os.environ.get("REPRO_FAIL_AT_STEP", -1)))
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="1x1", choices=("1x1",),
                    help="device mesh (this slice trains on one device)")
    add_policy_argument(ap)
    add_chaos_argument(ap)
    return ap


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    """Integer entries (tokens, labels) as int64; float entries (frames,
    patches) keep their f32, which the model casts to the param dtype."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(device=device, dtype=t.dtype if t.is_floating_point() else torch.long)
    return out


def main(argv=None) -> TrainRun:
    ap = _build_parser()
    args = ap.parse_args(argv)
    with chaos_scope(args.chaos):
        return _run(args, ap)


def _run(args, ap) -> TrainRun:
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    try:
        policy = policy_from_spec(args.policy, device=args.device)
    except (ValueError, KeyError) as e:
        ap.error(str(e))
    step_fn = make_train_step(
        cfg, TrainStepConfig(accum=args.accum, lr=args.lr, total_steps=args.steps),
        policy=policy,
    )

    ckpt = CheckpointManager(args.ckpt_dir, keep=args.keep) if args.ckpt_dir else None
    state = init_train_state(cfg, lm.init_lm(args.seed, cfg, device=device))
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(state)
        print(f"[train] resumed from step {start_step}")
    else:
        n_params = sum(p.numel() for p in tree_leaves(state["params"]))
        print(f"[train] fresh init ({cfg.name}, {n_params / 1e6:.1f}M params) on {device}")

    run = TrainRun(state=state, policy=policy, cfg=cfg)
    for step in range(start_step, args.steps):
        if args.fail_at == step:
            raise RuntimeError(f"[train] injected failure at step {step}")
        batch = _to_device(make_train_batch(cfg, args.seq, args.batch, step, seed=args.seed),
                           device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
        dt = time.perf_counter() - t0
        run.metrics.append(metrics)
        run.times.append(dt)
        if len(run.times) > 5:
            med = statistics.median(run.times[-50:])
            if dt > args.straggler_factor * med:
                print(f"[straggler] step {step}: {dt:.3f}s vs median {med:.3f}s")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={metrics['loss']:.4f} "
                  f"gnorm={metrics['grad_norm']:.3f} lr={metrics['lr']:.2e} "
                  f"({dt * 1e3:.0f} ms)")
        if ckpt is not None and (step + 1) % args.ckpt_every == 0:
            ckpt.save_async(step + 1, state)
    if ckpt is not None:
        ckpt.wait()
        ckpt.save(args.steps, state)
    if run.times:
        print(f"[train] done: {len(run.times)} steps, "
              f"median {statistics.median(run.times) * 1e3:.0f} ms/step")
    print(dispatch_report(policy))
    print(health_report())
    run.state = state
    return run


if __name__ == "__main__":
    main()
