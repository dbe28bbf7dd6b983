"""End-to-end run: train a ~100M-parameter fully connected network with
MTNN-dispatched layers (the paper's §VI-C experiment, as a real training
run with AdamW, LR schedule, grad clipping and checkpointing).

Defaults: 100M params (4096-4096x5-4096), synthetic regression-to-
classification data, 200 steps, on the card.

  PYTHONPATH=src python -m repro_torch.examples.train_fcn [--steps 200] [--tiny]
  PYTHONPATH=src python -m repro_torch.examples.train_fcn --device cpu --smoke
  PYTHONPATH=src python -m repro_torch.examples.train_fcn --smoke --policy autotune

With no ``--policy`` and no ``--always-nt``, a selector is trained on the
spot from NT-vs-TNN timings measured on ``--device`` (the paper's
per-device model).  ``--ckpt-dir`` saves a checkpoint every 100 steps.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import (
    FixedPolicy,
    ModelPolicy,
    MTNNSelector,
    collect_measured,
    device_spec,
    train_paper_model,
)
from repro_torch.core import spans
from repro_torch.core.engine import POLICY_SPEC_HELP, dispatch_report, policy_from_spec
from repro_torch.models.fcn import FCNConfig, fcn_loss_and_grads, init_fcn
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, warmup_cosine

__all__ = ["make_fcn_step", "synthetic_batch", "main"]


def make_fcn_step(policy, sched, max_grad_norm: float = 1.0):
    """``step(params, opt, step, batch) -> (params, opt, loss, grad_norm)``:
    loss and gradients under ``policy``, clipping, one AdamW update (the
    last two the span ``repro_torch.optim.update``)."""

    def step_fn(params, opt, step, batch):
        loss, grads = fcn_loss_and_grads(params, batch, policy)
        with torch.no_grad(), spans.span("repro_torch.optim.update", device=loss.device,
                                         step=step):
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            params, opt = adamw_update(grads, opt, params, sched(step))
        return params, opt, loss, gnorm

    return step_fn


def synthetic_batch(rng: np.random.RandomState, cfg: FCNConfig, batch: int,
                    w_true: np.ndarray, device):
    """One batch of the learnable synthetic task: x ~ N(0, 1), label the
    argmax of a fixed random projection of x, modulo the class count."""
    x = rng.randn(batch, cfg.input_dim).astype(np.float32)
    labels = (x @ w_true).argmax(-1) % cfg.output_dim
    return {"x": torch.from_numpy(x).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def _policy(args, device):
    """An explicit spec, the forced-NT baseline, or one learned on
    measured data of ``device`` right here."""
    if args.policy:
        policy = policy_from_spec(args.policy, device=device)
        print(f"[fcn] policy: {policy!r}")
    elif args.always_nt:
        policy = FixedPolicy("XLA_NT")
        print("[fcn] MTNN disabled (always XLA_NT)")
    else:
        ds = collect_measured(sizes=[64, 256, 1024], reps=2, device=device)
        clf, _ = train_paper_model(ds)
        policy = ModelPolicy(MTNNSelector(clf, hardware=device_spec(device)))
        print(f"[fcn] selector trained on {len(ds)} samples measured on {device}")
    return policy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--tiny", action="store_true", help="1M-param variant")
    ap.add_argument("--smoke", action="store_true",
                    help="CI smoke: tiny model, few steps")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save a checkpoint here every 100 steps (default: none)")
    ap.add_argument("--always-nt", action="store_true",
                    help="disable MTNN (the CaffeNT baseline)")
    ap.add_argument("--policy", default=None,
                    help=f"override the trained-here selector; {POLICY_SPEC_HELP}")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.smoke:
        args.steps = min(args.steps, 5)
    if args.tiny or args.smoke:
        cfg = FCNConfig("fcn-1m", 256, 64, (512, 512, 512))
    else:
        cfg = FCNConfig("fcn-100m", 4096, 4096, (4096,) * 5)
    n_params = sum((cfg.dims[i] + 1) * cfg.dims[i + 1] for i in range(len(cfg.dims) - 1))
    print(f"[fcn] {cfg.name}: dims {cfg.dims}, {n_params/1e6:.1f}M params on {device}")

    policy = _policy(args, device)
    params = init_fcn(0, cfg, device=device)
    opt = adamw_init(params)
    step_fn = make_fcn_step(policy, warmup_cosine(args.lr, warmup=20, total=args.steps))
    ckpt = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None

    rng = np.random.RandomState(0)
    w_true = rng.randn(cfg.input_dim, 8).astype(np.float32)
    t_hist, losses = [], []
    for step in range(args.steps):
        batch = synthetic_batch(rng, cfg, args.batch, w_true, device)
        t0 = time.perf_counter()
        params, opt, loss, gnorm = step_fn(params, opt, step, batch)
        losses.append(float(loss))  # waits for the device
        t_hist.append(time.perf_counter() - t0)
        if step % 20 == 0 or step == args.steps - 1:
            print(f"  step {step:4d} loss={losses[-1]:.4f} "
                  f"gnorm={float(gnorm):.3f} ({t_hist[-1]*1e3:.0f} ms)")
        if ckpt is not None and (step + 1) % 100 == 0:
            ckpt.save_async(step + 1, {"params": params, "opt": opt})
    if ckpt is not None:
        ckpt.wait()
    med = statistics.median(t_hist[2:] or t_hist)
    print(f"[fcn] done; median {med*1e3:.0f} ms/step "
          f"({2*3*args.batch*n_params/med/1e9:.1f} GFLOP/s effective)")
    print(dispatch_report(policy))
    return losses


if __name__ == "__main__":
    main()
