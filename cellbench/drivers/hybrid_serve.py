"""Serving granite-4.0-h-small (``granitemoehybrid``: Mamba-2 and NoPE
attention layers, each with a dropless MoE and a shared expert) through
the port's ``ServeEngine`` under the default policy, fed an open-loop
schedule (``traffic.arrivals``) on the host's clock.

The window is ``lm_serve``'s: every request due is submitted before each
engine step; a request's time to first token runs from when it was due
to the end of the engine step that produced its first token; tokens per
second count the prompt tokens prefilled and the tokens generated in
the engine steps that started in the window.  The engine prefills every
prompt at its exact length (its Mamba layers' state sums over every
position), into one cache slot of ``prompt_bucket + output max``
positions; the cache (attention K/V, Mamba conv and SSM state) is held
in the configuration's dtype.  Each decode step at each batch bucket
runs as a CUDA graph (``ServeEngine(decode_graphs=True)``), traced or
not.  Set-up warms every decode batch bucket, captures the graphs and
runs a prefill at the shortest and the longest prompt.  The model FLOPs are this model's own
(``flops/granite.py``).  A traced window also attributes the kernels to
the port's spans (``span_kernels.SpanTracer``).

``correct``: ``lm_serve``'s ``logit_gap`` over a sample of the finished
requests drawn from the seed, the longest among them: each prompt with
its served tokens run once through the reference's full forward
(``reference/granite_hybrid.py``, on weights drawn again from the seed).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from cellbench import flops, granite, traffic
from cellbench.flops import granite as gflops
from cellbench.harness import Context, Outcome
from cellbench.reference import granite_hybrid as ref_granite
from cellbench.reference import numerics
from cellbench.span_kernels import SpanTracer

from . import lm_serve
from .common import dispatch_counter, free_device, memory_peak, sync
from .lm_serve import FIRST_TOKEN_WAIT_S, _sample

__all__ = ["run", "engine", "serve_window", "reference"]


def engine(ctx: Context, params):
    from repro_torch.serving import BucketSpec, ServeEngine

    mix = ctx.mix
    slots, bucket = int(mix["slots"]), int(mix["prompt_bucket"])
    batches, b = [], 1
    while b < slots:
        batches.append(b)
        b *= 2
    batches.append(slots)
    return ServeEngine(
        granite.arch_config(ctx.cfg), params, n_slots=slots,
        max_seq=bucket + int(mix["output"]["max"]), policies={"serve": None},
        bucket_spec=BucketSpec(tuple(batches), bucket, bucket),
        max_queue=mix.get("max_queue"), cache_dtype=getattr(torch, ctx.cfg["torch_dtype"]),
        device=ctx.device, decode_graphs=True)


def warmup(ctx: Context, eng) -> None:
    """Every decode batch bucket, and a prefill at the mix's shortest and
    longest prompt (the engine's own warm-up runs no prefill for an
    exact-length model)."""
    eng.warmup()
    p = ctx.mix["prompt"]
    for n in (int(p["min"]), int(p["max"])):
        eng._prefill_step("serve", torch.zeros((1, n), dtype=torch.long, device=ctx.device), n)
    sync(ctx.device)


class _Loop(lm_serve._Loop):
    """``lm_serve``'s bookkeeping around ``engine.step``, with this model's
    FLOPs."""

    def step(self, counting: bool) -> None:
        eng, cfg = self.engine, self.ctx.cfg
        reqs = eng.requests
        before = {rid: len(reqs[rid].generated) for rid in self.live}
        clock = eng.clock
        with self.ctx.tracer.span("engine_step"):
            emitted = eng.step()
        end = time.perf_counter()
        prompt, rows, dt, work = 0, 0, None, 0.0
        for rid in list(self.live):
            r = reqs[rid]
            n = len(r.generated)
            inc = n - before[rid]
            if r.admit_step == clock and inc > 0:
                prompt += r.prompt_len
                work += gflops.prefill_flops(cfg, r.prompt_len)
                inc -= 1
            if inc > 0:
                rows += 1
                dt = r.token_lat[-1]
                work += gflops.decode_token_flops(cfg, r.prompt_len + n - 1)
            if n and rid not in self.first:
                self.first[rid] = end
            if r.state in self.terminal:
                self.live.discard(rid)
        if counting:
            self.tokens += prompt + emitted
            self.model_flops += work
            if rows:
                self.decode_s.append(dt)
                self.decode_rows.append(rows)


def serve_window(ctx: Context, eng, mix: Dict):
    """``lm_serve.serve_window`` with this model's FLOPs: (loop, window
    seconds, time to first token of every request answered or failed,
    failed requests, requests sent)."""
    from repro_torch.serving import RequestState

    loop = _Loop(ctx, eng)
    schedule = traffic.arrivals(mix, ctx.seed)
    nxt = next(schedule)
    with ctx.tracer.window(ctx.device):
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter()
            if now - t0 >= ctx.seconds:
                break
            while t0 + nxt.due_s <= now:
                loop.submit(nxt, t0 + nxt.due_s)
                nxt = next(schedule)
            if loop.idle():
                time.sleep(max(0.0, min(t0 + nxt.due_s, t0 + ctx.seconds) - now))
                continue
            loop.step(counting=True)
        window_s = time.perf_counter() - t0
    wait = float(mix.get("first_token_wait_s", FIRST_TOKEN_WAIT_S))
    give_up = time.perf_counter() + wait
    while (wait and any(rid not in loop.first for rid in loop.live)
           and time.perf_counter() < give_up):
        loop.step(counting=False)
    sync(ctx.device)
    end = time.perf_counter()
    ttft, failed = [], len(loop.refused)
    for rid, due in loop.due.items():
        r = eng.requests[rid]
        if rid in loop.first and r.state in (RequestState.FINISHED, RequestState.ACTIVE):
            ttft.append(loop.first[rid] - due)
        elif not wait and r.state not in loop.terminal:
            continue  # still waiting at the close of a run that does not wait: unanswered
        else:
            failed += 1
            ttft.append(end - due)  # it waited at least this long
    ttft += [end - due for due in loop.refused]
    return loop, window_s, ttft, failed, len(loop.due) + len(loop.refused)


def run(ctx: Context) -> Outcome:
    ctx.tracer = SpanTracer(ctx.tracer.enabled)  # the kernels under the port's spans too
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    params = granite.params(cfg, ctx.seed, dev)
    sync(dev)
    ctx.note("weights")
    eng = engine(ctx, params)
    ctx.note("engine")
    warmup(ctx, eng)
    ctx.note("warmup")
    ctx.mark_setup()

    with dispatch_counter(ctx.trace) as gemms:
        loop, window_s, ttft, failed, sent = serve_window(ctx, eng, mix)
    peak = memory_peak(dev)
    crashed = int(eng.health()["crashed_steps"])
    if ttft:
        ctx.log("ttft ms p50 %.1f p90 %.1f over %d of %d requests; decode step ms p50 %.1f"
                % (1e3 * float(np.percentile(ttft, 50)), 1e3 * float(np.percentile(ttft, 90)),
                   len(ttft), sent,
                   1e3 * float(np.median(loop.decode_s)) if loop.decode_s else float("nan")))
    sample = _sample(eng, ctx.seed, int(mix["sample"]["requests"]))
    e2e = {"serve_tokens_per_s": loop.tokens / window_s}
    counters = {"window_s": window_s, "model_flops": loop.model_flops,
                "peak_flops": flops.peak_flops(cfg["torch_dtype"]) * int(ctx.cell["chips"]),
                "gemms": gemms, "decode_step_s": loop.decode_s,
                "decode_rows": loop.decode_rows, "slots": int(mix["slots"]),
                "requests": sent, "crashed_steps": crashed}
    del eng, params, loop  # the loop holds the engine, which holds the weights and the cache
    free_device(dev)

    numbers, control = reference(ctx, sample)
    return Outcome(e2e=e2e, counters=counters, numbers=numbers, control_numbers=control,
                   attempted=sent, failed=failed + crashed, memory_peak_bytes=peak)


def reference(ctx: Context, sample):
    """Each sampled prompt with its served tokens through the reference:
    the widest gap below the best logit of a served token, in units of
    the spread (standard deviation) of the reference's logits at its
    position, and with ``ctx.control`` the same of the token the control
    puts first."""
    numerics.set_f32_math()
    if not sample:
        return {"logit_gap": float("inf")}, {}
    tree = granite.params(ctx.cfg, ctx.seed, ctx.device)
    params = granite.reference_params(tree, ctx.cfg)
    vocab = int(ctx.cfg["vocab_size"])
    gap, control_gap = 0.0, 0.0
    with torch.no_grad():
        for prompt, served in sample:
            seq = np.concatenate([prompt, served[:-1]])
            tokens = torch.as_tensor(seq, device=ctx.device)
            at = torch.arange(len(prompt) - 1, len(seq), device=ctx.device)
            logits = ref_granite.forward(params, ctx.cfg, tokens, "f32", at=at)[:, :vocab]
            best, spread = logits.max(dim=-1).values, logits.std(dim=-1)

            def widest(picked):
                return float(((best - logits.gather(1, picked[:, None])[:, 0]) / spread).max())

            gap = max(gap, widest(torch.as_tensor(served, device=ctx.device)))
            if ctx.control:
                low = ref_granite.forward(params, ctx.cfg, tokens, ctx.control, at=at)[:, :vocab]
                control_gap = max(control_gap, widest(low.argmax(dim=-1)))
            del logits
    del params, tree
    free_device(ctx.device)
    return {"logit_gap": gap}, ({"logit_gap": control_gap} if ctx.control else {})
