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
``--mesh DxM`` serves one rank's program per process under ``python -m
torch.distributed.run --nproc-per-node D*M`` (``ServeEngine(mesh=)``;
the legacy demo too): tensor parallelism over M (expert parallelism for
the MoE ones where their experts divide M; the Mamba blocks by head),
and the D data replicas serve the same requests, gathering the weights
the rules split over the data axes (the MoE experts' FSDP dim) a layer
at a time.  ``--device`` defaults
to ``cuda`` and raises when there is no card.  ``--layers`` cuts the
depth and ``--dtype`` sets the parameter dtype; weights are random from
``--seed``.  The default ``--policy model`` is the default learned
selector; ``--policy autotune`` measures on ``--device``.

``--legacy`` runs the JAX launcher's fixed-batch demo instead: a prefill
of ``--batch`` prompts of exactly ``--prompt-len`` tokens into a bf16
cache (``--cache-dtype``), then ``--gen`` greedy decode steps, under
``--policy``; ``main`` returns the generated tokens, (batch, gen).
``--chaos SPEC`` arms fault injection for the run (``core/faults.py``):
a faulted arm is quarantined and dispatch degrades down its fallback
chain; both modes print ``health_report()`` at the end.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --device cpu --legacy --batch 2 --prompt-len 8 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --device cpu --requests 4 --gen 4 --policy fixed:PALLAS_NT \\
      --chaos "raise:PALLAS_NT.NT"
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.engine import (
    POLICY_SPEC_HELP,
    add_policy_argument,
    dispatch_report,
    health_report,
    policy_from_spec,
)
from repro_torch.core.faults import add_chaos_argument, chaos_scope
from repro_torch.distributed.sharding import param_specs, shard
from repro_torch.launch.common import (
    add_mesh_argument,
    parse_mesh,
    setup_distributed,
)
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.serving.kv_cache import pool_specs
from repro_torch.models import lm

DEFAULT_CLASSES = ("interactive", "bulk")


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--legacy", action="store_true",
                    help="fixed-batch prefill/decode demo (the pre-engine path)")
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
    ap.add_argument("--batch", type=int, default=4, help="legacy batch size")
    ap.add_argument("--cache-dtype", choices=("bfloat16", "float32"), default=None,
                    help="legacy KV cache dtype (default bfloat16, the JAX launcher's); "
                         "the engine caches in the parameter dtype")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="prompt length (legacy: exact; engine: prompts are "
                         "1..prompt-len tokens)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    add_mesh_argument(ap)
    add_policy_argument(ap)
    add_chaos_argument(ap)
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


def _mesh(args, parser):
    """The ``--mesh`` of this run (None for one rank): malformed specs exit
    through ``parser.error``."""
    try:
        mesh = parse_mesh(args.mesh)
    except ValueError as e:
        parser.error(str(e))
    return mesh if mesh.size > 1 else None


def config_from_args(args):
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(segments=tuple(
            (min(count, args.layers), blocks) for count, blocks in cfg.segments
        ))
    if args.dtype:
        cfg = cfg.replace(param_dtype=args.dtype)
    return cfg


def _engine_main(args, parser, device):
    from repro_torch.serving import QueueFullError, ServeEngine

    cfg = config_from_args(args)
    mesh = _mesh(args, parser)
    policies = _class_policies(args, parser)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    max_seq = args.max_seq or (args.prompt_len + args.gen)
    params = lm.init_lm(args.seed, cfg, device=device)
    engine = ServeEngine(
        cfg, params, n_slots=args.slots, max_seq=max_seq, policies=policies,
        budget_tokens=args.budget_tokens or None, max_queue=args.max_queue or None,
        cache_dtype=getattr(torch, cfg.param_dtype), device=device, mesh=mesh,
    )
    warm = engine.warmup()
    say(f"[serve] warmup: {warm['shapes_run']} bucketed shapes — buckets "
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
            say(f"[serve] request {i} rejected: admission queue full "
                  f"(max_queue={engine.max_queue})")
    engine.run()

    lats = [t for r in engine.requests.values() for t in r.token_lat[1:]]
    n_tok = sum(len(r.generated) for r in engine.requests.values())
    say(f"[serve] {args.requests} requests, {n_tok} tokens in "
          f"{engine.run_seconds:.2f}s ({n_tok / max(engine.run_seconds, 1e-9):.1f} tok/s) "
          f"on {device}")
    if lats:
        say(f"[serve] per-token decode latency: p50 {statistics.median(lats) * 1e3:.2f} ms, "
              f"max {max(lats) * 1e3:.2f} ms")
    say(f"[serve] post-warmup cold-miss measurements: {engine.cold_misses()}")
    health = engine.health()
    say(f"[serve] health: finished={health['finished']} "
          f"deadline_exceeded={health['deadline_exceeded']} evicted={health['evicted']} "
          f"crashed_steps={health['crashed_steps']} "
          f"rejected_submits={health['rejected_submits']}")
    for cls, report in sorted(engine.class_reports().items()):
        say(f"[serve] class {cls!r}:")
        say(report)
    say(health_report())
    return engine


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _legacy_main(args, parser, device):
    """The fixed-batch demo: one prefill of ``--batch`` prompts, then
    ``--gen`` greedy decode steps; returns the (batch, gen) tokens."""
    cfg = config_from_args(args)
    mesh = _mesh(args, parser)
    try:
        policy = policy_from_spec(args.policy, device=args.device)
    except (ValueError, KeyError) as e:
        parser.error(str(e))
    max_seq = args.prompt_len + args.gen
    rng = np.random.RandomState(args.seed)
    B = args.batch
    params = lm.init_lm(args.seed, cfg, device=device)
    if mesh is not None:
        params = shard(params, param_specs(params, mesh), mesh)
    if cfg.input_mode == "frames":
        prompt = {"frames": torch.from_numpy(
            rng.randn(B, args.prompt_len, cfg.d_model).astype(np.float32) * 0.02).to(device)}
    else:
        prompt = {"tokens": torch.from_numpy(
            rng.randint(0, cfg.vocab, (B, args.prompt_len))).long().to(device)}
    prefill = make_prefill_step(cfg, max_seq=max_seq, policy=policy,
                                cache_dtype=getattr(torch, args.cache_dtype or "bfloat16"),
                                mesh=mesh)
    serve = make_serve_step(cfg, policy=policy, mesh=mesh,
                            cache_specs=pool_specs(cfg, B, max_seq, mesh) if mesh else None)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    outs = []
    tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(args.gen):
        outs.append(tok.cpu().numpy())
        if cfg.input_mode == "frames":
            step_in = {"frames": torch.zeros((B, 1, cfg.d_model), device=device)}
        else:
            step_in = {"tokens": tok}
        logits, cache = serve(params, cache, step_in)
        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
    _sync(device)
    t_decode = time.perf_counter() - t0
    gen = np.concatenate(outs, axis=1)
    print(f"[serve] prefill {args.prompt_len} tok x {B}: {t_prefill * 1e3:.1f} ms on {device}")
    print(f"[serve] decode {args.gen} steps: {t_decode * 1e3:.1f} ms "
          f"({t_decode / max(args.gen, 1) * 1e3:.2f} ms/tok)")
    print("[serve] sample generations:", gen[:2, :8].tolist())
    print(dispatch_report(policy))
    print(health_report())
    return gen


def main(argv=None):
    parser = _build_parser()
    args = parser.parse_args(argv)
    device, owned = setup_distributed(args)
    try:
        with chaos_scope(args.chaos):
            if args.legacy:
                return _legacy_main(args, parser, device)
            return _engine_main(args, parser, device)
    finally:
        if owned:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
