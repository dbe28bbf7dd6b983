"""Serving a dense decoder LM through the port's ``ServeEngine``
(``submit``/``step``: bucketed prefill into the paged cache, bucketed
decode, greedy tokens) under the default policy, fed an open-loop
schedule (``traffic.arrivals``) on the host's clock.

One engine class, one prompt bucket (the traffic's ``prompt_bucket``)
and the decode-batch buckets up to the slots: warm-up runs exactly the
shapes this traffic uses.  In the window, every request due is
submitted before each engine step; a request's time to first token runs
from when it was due to the end of the engine step that produced its
first token (when a streaming server could send it).  After the window
no request is sent; the run steps on until every request sent has its
first token (the mix's ``first_token_wait_s``, a minute by default),
and a request that never gets one, is evicted or is refused by a full
queue has failed.  A mix offered above the knee waits 0 seconds: what
is still queued at the close is unanswered, not failed, and no time to
first token is taken.

Tokens per second count, over the window, the real prompt tokens
prefilled (not the padding) and the tokens generated, in the engine
steps that started in it; the window runs from its start to the end of
the last of them.

``correct``: a sample of the finished requests drawn from the seed, the
longest among them, each prompt with its served tokens run once through
the reference; ``logit_gap`` is the widest gap by which a served
token's logit lies below the reference's best at its position, in units
of the spread of the reference's logits there (so that it reads alike
at any width).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from cellbench import flops, program, traffic, weights
from cellbench.harness import Context, Outcome
from cellbench.reference import decoder as ref_decoder
from cellbench.reference import numerics

from .common import dispatch_counter, free_device, memory_peak, sync

FIRST_TOKEN_WAIT_S = 60.0


def _engine(ctx: Context, params):
    from repro_torch.serving import BucketSpec, ServeEngine

    mix = ctx.mix
    slots, bucket = int(mix["slots"]), int(mix["prompt_bucket"])
    batches, b = [], 1
    while b < slots:
        batches.append(b)
        b *= 2
    batches.append(slots)
    return ServeEngine(
        program.arch_config(ctx.cfg), params, n_slots=slots,
        max_seq=bucket + int(mix["output"]["max"]), policies={"serve": None},
        bucket_spec=BucketSpec(tuple(batches), bucket, bucket),
        max_queue=mix.get("max_queue"), device=ctx.device)


class _Loop:
    """The serving loop's bookkeeping around ``engine.step``."""

    def __init__(self, ctx: Context, engine):
        from repro_torch.serving import RequestState

        self.ctx, self.engine = ctx, engine
        self.terminal = (RequestState.FINISHED, RequestState.EVICTED,
                         RequestState.DEADLINE_EXCEEDED)
        self.vocab = int(ctx.cfg["vocab_size"])
        self.due: Dict[int, float] = {}  # rid -> when it was due
        self.first: Dict[int, float] = {}  # rid -> end of the step of its first token
        self.live: set = set()
        self.refused: List[float] = []  # due times of submits a full queue refused
        self.tokens = 0  # prompt tokens prefilled + tokens generated, in the window
        self.model_flops = 0.0
        self.decode_s: List[float] = []
        self.decode_rows: List[int] = []

    def submit(self, a, due: float) -> None:
        from repro_torch.serving import QueueFullError

        toks = traffic.prompt_tokens(self.ctx.seed, a.index, a.prompt_len, self.vocab)
        try:
            req = self.engine.submit(toks, a.max_new, cls="serve")
        except QueueFullError:
            self.refused.append(due)
            return
        self.due[req.rid] = due
        self.live.add(req.rid)

    def step(self, counting: bool) -> None:
        eng, cfg = self.engine, self.ctx.cfg
        reqs = eng.requests
        before = {rid: len(reqs[rid].generated) for rid in self.live}
        clock = eng.clock
        with self.ctx.tracer.span("engine_step"):
            emitted = eng.step()
        end = time.perf_counter()
        prompt, rows, dt = 0, 0, None
        flops_ = 0.0
        for rid in list(self.live):
            r = reqs[rid]
            n = len(r.generated)
            inc = n - before[rid]
            if r.admit_step == clock and inc > 0:
                prompt += r.prompt_len
                flops_ += flops.lm_prefill_flops(cfg, r.prompt_len)
                inc -= 1
            if inc > 0:
                rows += 1
                dt = r.token_lat[-1]
                flops_ += flops.lm_decode_token_flops(cfg, r.prompt_len + n - 1)
            if n and rid not in self.first:
                self.first[rid] = end
            if r.state in self.terminal:
                self.live.discard(rid)
        if counting:
            self.tokens += prompt + emitted
            self.model_flops += flops_
            if rows:
                self.decode_s.append(dt)
                self.decode_rows.append(rows)

    def idle(self) -> bool:
        return not self.engine.queue and not self.engine.kv.owner


def serve_window(ctx: Context, engine, mix: Dict):
    """One window of ``mix``'s open-loop schedule on ``engine``, then the
    wait for every first token: (loop, window seconds, time to first token
    of every request answered or failed, failed requests, requests sent)."""
    from repro_torch.serving import RequestState

    loop = _Loop(ctx, engine)
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
        r = engine.requests[rid]
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
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    params = program.lm_params(cfg, ctx.seed, dev)
    sync(dev)
    ctx.note("weights")
    engine = _engine(ctx, params)
    ctx.note("engine")
    engine.warmup()
    sync(dev)
    ctx.note("warmup")
    ctx.mark_setup()

    with dispatch_counter(ctx.trace) as gemms:
        loop, window_s, ttft, failed, sent = serve_window(ctx, engine, mix)
    peak = memory_peak(dev)
    crashed = int(engine.health()["crashed_steps"])
    if ttft:
        ctx.log("ttft ms p50 %.1f p75 %.1f p90 %.1f p95 %.1f mean %.1f over %d of %d requests"
                % tuple([1e3 * float(np.percentile(ttft, q)) for q in (50, 75, 90, 95)]
                        + [1e3 * float(np.mean(ttft)), len(ttft), sent]))
    sample = _sample(engine, ctx.seed, int(mix["sample"]["requests"]))
    del engine
    free_device(dev)

    numbers, control = _reference(ctx, sample)
    return Outcome(
        e2e={"serve_tokens_per_s": loop.tokens / window_s,
             "serve_ttft_p90_ms": 1e3 * float(np.percentile(ttft, 90)) if ttft else 0.0},
        counters={"window_s": window_s, "model_flops": loop.model_flops,
                  "peak_flops": flops.peak_flops(cfg["torch_dtype"]) * int(ctx.cell["chips"]),
                  "gemms": gemms, "decode_step_s": loop.decode_s,
                  "decode_rows": loop.decode_rows, "slots": int(mix["slots"]),
                  "requests": sent, "crashed_steps": crashed},
        numbers=numbers, control_numbers=control, attempted=sent,
        failed=failed + crashed, memory_peak_bytes=peak,
    )


def _sample(engine, seed: int, n: int):
    """Up to ``n`` finished requests, drawn from the seed, the longest
    (prompt and served tokens) among them: (prompt, served) arrays."""
    from repro_torch.serving import RequestState

    done = sorted((r for r in engine.requests.values() if r.state is RequestState.FINISHED),
                  key=lambda r: r.rid)
    if not done:
        return []
    longest = max(done, key=lambda r: (r.prompt_len + len(r.generated), -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(traffic.derive(seed, "sample"))
    pick = [longest] + [rest[i] for i in rng.permutation(len(rest))[:n - 1]]
    return [(np.asarray(r.tokens, np.int64), np.asarray(r.generated, np.int64)) for r in pick]


def _reference(ctx: Context, sample):
    """Each sampled prompt with its served tokens through the reference:
    the widest gap below the best logit of a served token, in units of
    the spread (standard deviation) of the reference's logits at its
    position, and with ``ctx.control`` the same of the token the control
    puts first."""
    numerics.set_f32_math()
    if not sample:
        return {"logit_gap": float("inf")}, {}
    params = weights.reference_copy(program.lm_params(ctx.cfg, ctx.seed, ctx.device))
    free_device(ctx.device)
    vocab = int(ctx.cfg["vocab_size"])
    gap, control_gap = 0.0, 0.0
    with torch.no_grad():
        for prompt, served in sample:
            seq = np.concatenate([prompt, served[:-1]])
            tokens = torch.as_tensor(seq, device=ctx.device)[None]
            at = torch.arange(len(prompt) - 1, len(seq), device=ctx.device)
            logits = ref_decoder.forward(params, ctx.cfg, tokens, "f32", at=at)[0, :, :vocab]
            best, spread = logits.max(dim=-1).values, logits.std(dim=-1)

            def widest(picked):
                return float(((best - logits.gather(1, picked[:, None])[:, 0]) / spread).max())

            gap = max(gap, widest(torch.as_tensor(served, device=ctx.device)))
            if ctx.control:
                low = ref_decoder.forward(params, ctx.cfg, tokens, ctx.control, at=at)[0, :, :vocab]
                control_gap = max(control_gap, widest(low.argmax(dim=-1)))
            del logits
    del params
    free_device(ctx.device)
    return {"logit_gap": gap}, ({"logit_gap": control_gap} if ctx.control else {})
