"""Tour of all ten architectures: build each one's smoke config, run one
loss evaluation and one decode step, and report the full config's
parameter count, the smoke loss and the decode logits' shape.

  PYTHONPATH=src python -m repro_torch.examples.arch_tour --device cpu
  PYTHONPATH=src python -m repro_torch.examples.arch_tour            # the card
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.models import lm
from repro_torch.optim import tree_leaves


def param_count(cfg) -> int:
    """Parameters of ``cfg``, counted on the meta device (nothing drawn)."""
    return sum(p.numel() for p in tree_leaves(lm.init_lm(0, cfg, device="meta")))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S = 2, 32
    print(f"{'arch':<20s} {'family':<7s} {'full params':>12s} {'smoke loss':>11s} "
          f"{'decode':>13s} {'ms':>6s}")
    rows = {}
    for name in sorted(ARCHS):
        cfg = smoke_config(name)
        params = lm.init_lm(0, cfg, device=dev)
        if cfg.input_mode == "tokens":
            batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)}
        elif cfg.input_mode == "frames":
            batch = {"frames": torch.randn((B, S, cfg.d_model), generator=gen, device=dev)}
        else:
            batch = {
                "patches": torch.randn((B, cfg.prefix_len, cfg.d_model), generator=gen,
                                       device=dev),
                "tokens": torch.randint(0, cfg.vocab, (B, S - cfg.prefix_len), generator=gen,
                                        device=dev),
            }
        text = S - (cfg.prefix_len if cfg.input_mode == "vlm" else 0)
        labels = torch.randint(0, cfg.vocab, (B, text), generator=gen, device=dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            loss, _ = lm.lm_loss(params, cfg, {**batch, "labels": labels})
            cache = lm.init_lm_cache(cfg, B, max_seq=16, device=dev)
            step = ({"frames": batch["frames"][:, :1]} if cfg.input_mode == "frames"
                    else {"tokens": torch.ones((B, 1), dtype=torch.long, device=dev)})
            logits, cache = lm.lm_decode(params, cfg, cache, step)
        ms = (time.perf_counter() - t0) * 1e3
        full = get_config(name)
        n = param_count(full)
        rows[name] = {"family": full.family, "params": n, "loss": float(loss),
                      "decode_shape": tuple(logits.shape)}
        print(f"{name:<20s} {full.family:<7s} {n / 1e9:11.2f}B {float(loss):11.4f} "
              f"{str(tuple(logits.shape)):>13s} {ms:6.0f}")
    return rows


if __name__ == "__main__":
    main()
