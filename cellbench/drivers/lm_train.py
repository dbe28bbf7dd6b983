"""Training a dense decoder LM through the port's
``launch/steps.make_train_step`` (forward with the configuration's
remat, the attention plan forward and backward, loss, global-norm
clipping, the one-rank AdamW update) under the default policy.

Set-up builds one train state from the seed and runs its first
``checked_steps`` through the step and the feed the window uses,
reading what ``correct`` is decided from; the window trains on from
that state.  After the window the state is freed and the reference
trains the same weights on the same rows, one sequence at a time.
"""

from __future__ import annotations

from typing import Dict

from cellbench import checks, flops, program, traffic, weights
from cellbench.harness import Context, Outcome
from cellbench.reference import decoder as ref_decoder
from cellbench.reference import numerics, train as ref_train

from .common import (change_norms, dispatch_counter, first_grad_norms, free_device, memory_peak,
                     sync, train_window)


def run(ctx: Context) -> Outcome:
    from repro_torch.launch import steps as lsteps

    cfg, mix, dev, seed = ctx.cfg, ctx.mix, ctx.device, ctx.seed
    arch = program.arch_config(cfg)
    batch, seq, k = int(mix["batch"]), int(mix["seq"]), int(mix["checked_steps"])
    vocab = int(cfg["vocab_size"])

    def feed(i):
        return traffic.lm_batch(seed, i, vocab, batch, seq, dev)

    sc = lsteps.TrainStepConfig(accum=1, lr=mix["lr"], warmup=mix["warmup"],
                                total_steps=mix["total_steps"],
                                max_grad_norm=mix["max_grad_norm"],
                                weight_decay=mix["weight_decay"])
    step_fn = lsteps.make_train_step(arch, sc, policy=None)
    state = lsteps.init_train_state(arch, program.lm_params(cfg, seed, dev))
    sync(dev)
    ctx.note("weights")
    prog: Dict = {"losses": []}
    for i in range(k):
        state, metrics = step_fn(state, feed(i))
        prog["losses"].append(float(metrics["loss"]))
        if i == 0:
            prog["grad_norm"] = float(metrics["grad_norm"])
            prog["first_grad"] = first_grad_norms(state["opt"]["m"])
            ctx.note("first step")
    prog["change"] = change_norms(state["params"], program.lm_params(cfg, seed, dev))
    del metrics
    box = {"state": state}
    del state
    free_device(dev)
    sync(dev)
    ctx.mark_setup()

    def step(i):
        box["state"], _ = step_fn(box["state"], feed(i))

    with dispatch_counter(ctx.trace) as gemms:
        steps, window_s = train_window(ctx, step, k)
    peak = memory_peak(dev)
    del box
    free_device(dev)

    numbers, control = _reference(ctx, feed, prog)
    step_flops = flops.lm_train_step_flops(cfg, batch, seq)
    return Outcome(
        e2e={"lm_train_tokens_per_s": steps * batch * seq * int(ctx.cell["chips"]) / window_s},
        counters={"window_s": window_s, "steps": steps, "model_flops": steps * step_flops,
                  "peak_flops": flops.peak_flops(cfg["torch_dtype"]) * int(ctx.cell["chips"]),
                  "gemms": gemms},
        numbers=numbers, control_numbers=control, attempted=steps, failed=0,
        memory_peak_bytes=peak,
    )


def _reference(ctx: Context, feed, prog: Dict):
    """The reference's steps on the same weights and rows, one sequence a
    microbatch, and with ``ctx.control`` the control's too."""
    numerics.set_f32_math()
    k = int(ctx.mix["checked_steps"])

    def reference(mode: str) -> Dict:
        precision, rows = numerics.mode(mode)

        def microbatches(i):
            b = feed(i)
            n = int(b["tokens"].shape[0] * rows)
            return [({"tokens": b["tokens"][j:j + 1], "labels": b["labels"][j:j + 1]}, 1.0 / n)
                    for j in range(n)]

        params = weights.reference_copy(program.lm_params(ctx.cfg, ctx.seed, ctx.device))
        free_device(ctx.device)
        out = ref_train.train_steps(
            params, lambda p, b: ref_decoder.loss(p, ctx.cfg, b, precision),
            microbatches, ctx.mix, k)
        del params
        free_device(ctx.device)
        return out

    ref = reference("f32")
    numbers = checks.train_numbers(prog, ref)
    control = checks.train_numbers(reference(ctx.control), ref) if ctx.control else {}
    return numbers, control
