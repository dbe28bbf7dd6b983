"""Serving driver: a thin client of the port's continuous-batching engine.

Builds a ``ServeEngine`` on one device, submits a seeded batch of
mixed-length requests across the request classes, runs the warmup pass
over every decode/prefill bucket, drains the queue, and prints
throughput, latency, health and per-class dispatch reports:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --requests 8 --prompt-len 64 --gen 16 --slots 4 \\
      --class-policy interactive=fixed:nt=PALLAS_TNN,attn=fused \\
      --class-policy bulk=fixed:nt=PALLAS_NT,attn=fused

``--arch`` takes every token architecture of the port (``smollm-135m``,
``gemma3-4b``, ``gemma2-27b``, ``h2o-danube-3-4b``, ``grok-1-314b``,
``kimi-k2-1t-a32b``, ``mamba2-2.7b``, ``zamba2-7b``); the engine rejects
the ``frames`` and ``vlm`` ones, as the JAX engine does.  A windowed
architecture's prompts bucket to multiples of its window (1024 for
gemma3-4b), so ``--max-seq`` must hold one such bucket plus ``--gen``;
the Mamba ones (mamba2, zamba2) prefill each prompt at its exact length.
Only the JAX launcher's engine mode is ported: there is no ``--legacy``
or ``--chaos``, and ``--mesh`` takes ``1x1`` only.  ``--device`` defaults
to ``cuda`` and raises when there is no card.  ``--layers`` cuts the
depth and ``--dtype`` sets the parameter dtype; weights are random from
``--seed``.  The default ``--policy model`` is the default learned
selector; ``--policy autotune`` measures on ``--device``.
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.engine import POLICY_SPEC_HELP, add_policy_argument, policy_from_spec
from repro_torch.models import lm

DEFAULT_CLASSES = ("interactive", "bulk")


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut every segment to this many repeats (default: full depth)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="parameter dtype (default: the config's)")
    ap.add_argument("--requests", type=int, default=8,
                    help="number of synthetic requests to submit")
    ap.add_argument("--slots", type=int, default=4,
                    help="KV cache slots (max concurrent requests)")
    ap.add_argument("--max-seq", type=int, default=0,
                    help="cache extent per slot (default: prompt-len + gen)")
    ap.add_argument("--budget-tokens", type=int, default=0,
                    help="max-tokens admission budget (default: slots * max-seq)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="admission queue bound (default: 8 * slots)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request deadline in seconds")
    ap.add_argument("--class-policy", action="append", default=[], metavar="CLS=SPEC",
                    help=f"per-class policy override; SPEC is {POLICY_SPEC_HELP}")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="longest prompt (prompts are 1..prompt-len tokens)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="1x1", choices=("1x1",),
                    help="device mesh (this slice serves on one device)")
    add_policy_argument(ap)
    return ap


def _class_policies(args, parser):
    """One fresh policy instance per request class (stats must not mix
    across classes), honouring ``--class-policy CLS=SPEC`` overrides."""
    specs = {cls: args.policy for cls in DEFAULT_CLASSES}
    for entry in args.class_policy:
        cls, eq, spec = entry.partition("=")
        cls, spec = cls.strip(), spec.strip()
        if not eq or not cls or not spec:
            parser.error(f"malformed --class-policy {entry!r}; expected CLS=SPEC")
        specs[cls] = spec
    try:
        return {cls: policy_from_spec(spec, device=args.device) for cls, spec in specs.items()}
    except (ValueError, KeyError) as e:
        parser.error(str(e))


def config_from_args(args):
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(segments=tuple(
            (min(count, args.layers), blocks) for count, blocks in cfg.segments
        ))
    if args.dtype:
        cfg = cfg.replace(param_dtype=args.dtype)
    return cfg


def _engine_main(args, parser):
    from repro_torch.serving import QueueFullError, ServeEngine

    device = resolve_device(args.device)
    cfg = config_from_args(args)
    policies = _class_policies(args, parser)
    max_seq = args.max_seq or (args.prompt_len + args.gen)
    params = lm.init_lm(args.seed, cfg, device=device)
    engine = ServeEngine(
        cfg, params, n_slots=args.slots, max_seq=max_seq, policies=policies,
        budget_tokens=args.budget_tokens or None, max_queue=args.max_queue or None,
        cache_dtype=getattr(torch, cfg.param_dtype), device=device,
    )
    warm = engine.warmup()
    print(f"[serve] warmup: {warm['shapes_run']} bucketed shapes — buckets "
          f"batch={engine.buckets.decode_batches} len_step={engine.buckets.len_step}")

    rng = np.random.RandomState(args.seed)
    classes = sorted(policies)
    for i in range(args.requests):
        p_len = int(rng.randint(1, args.prompt_len + 1))
        prompt = rng.randint(0, cfg.vocab, (p_len,)).astype(np.int32)
        try:
            engine.submit(prompt, max_new=args.gen, cls=classes[i % len(classes)],
                          deadline_s=args.deadline_s)
        except QueueFullError:
            print(f"[serve] request {i} rejected: admission queue full "
                  f"(max_queue={engine.max_queue})")
    engine.run()

    lats = [t for r in engine.requests.values() for t in r.token_lat[1:]]
    n_tok = sum(len(r.generated) for r in engine.requests.values())
    print(f"[serve] {args.requests} requests, {n_tok} tokens in "
          f"{engine.run_seconds:.2f}s ({n_tok / max(engine.run_seconds, 1e-9):.1f} tok/s) "
          f"on {device}")
    if lats:
        print(f"[serve] per-token decode latency: p50 {statistics.median(lats) * 1e3:.2f} ms, "
              f"max {max(lats) * 1e3:.2f} ms")
    print(f"[serve] post-warmup cold-miss measurements: {engine.cold_misses()}")
    health = engine.health()
    print(f"[serve] health: finished={health['finished']} "
          f"deadline_exceeded={health['deadline_exceeded']} evicted={health['evicted']} "
          f"crashed_steps={health['crashed_steps']} "
          f"rejected_submits={health['rejected_submits']}")
    for cls, report in sorted(engine.class_reports().items()):
        print(f"[serve] class {cls!r}:")
        print(report)
    return engine


def main(argv=None):
    parser = _build_parser()
    args = parser.parse_args(argv)
    return _engine_main(args, parser)


if __name__ == "__main__":
    main()
