"""Training the paper's fully connected network through the port's
``examples/train_fcn.make_fcn_step`` (dispatched NT forward, NN/TN
backward, global-norm clipping, AdamW) under the default policy.

Set-up builds one parameter and optimizer state from the seed and runs
the first ``checked_steps`` through the step function and the feed the
window uses, reading what ``correct`` is decided from; the window then
trains on from that same state.  After the window the state is freed and
the reference trains the same weights on the same rows.
"""

from __future__ import annotations

from typing import Dict

from cellbench import checks, flops, program, traffic, weights
from cellbench.harness import Context, Outcome
from cellbench.reference import fcn as ref_fcn
from cellbench.reference import numerics, train as ref_train

from .common import (change_norms, dispatch_counter, first_grad_norms, free_device, memory_peak,
                     sync, train_window)


def _sched(mix: Dict):
    from repro_torch import optim

    if mix.get("schedule", "constant") == "constant":
        return optim.constant(mix["lr"])
    return optim.warmup_cosine(mix["lr"], mix["warmup"], mix["total_steps"])


def run(ctx: Context) -> Outcome:
    from repro_torch.core.policy import default_policy
    from repro_torch.examples import train_fcn
    from repro_torch.optim import adamw_init

    cfg, mix, dev, seed = ctx.cfg, ctx.mix, ctx.device, ctx.seed
    dims = program.fcn_config(cfg).dims
    batch = int(mix["batch"])
    k = int(mix["checked_steps"])

    def feed(i):
        return traffic.fcn_batch(seed, i, dims, batch, dev)

    params = program.fcn_params(cfg, seed, dev)
    opt = adamw_init(params)
    sync(dev)
    ctx.note("weights")
    step_fn = train_fcn.make_fcn_step(None, _sched(mix), max_grad_norm=mix["max_grad_norm"])
    losses = []
    prog: Dict = {}
    for i in range(k):
        params, opt, loss, gnorm = step_fn(params, opt, i, feed(i))
        losses.append(float(loss))
        if i == 0:
            prog["grad_norm"] = float(gnorm)
            prog["first_grad"] = first_grad_norms(opt["m"])
            ctx.note("first step")
    prog["change"] = change_norms(params, program.fcn_params(cfg, seed, dev))
    prog["losses"] = losses
    state = {"params": params, "opt": opt}
    sync(dev)
    ctx.mark_setup()

    stats = default_policy().stats
    stats.reset()

    def step(i):
        state["params"], state["opt"], _, _ = step_fn(state["params"], state["opt"], i, feed(i))

    with dispatch_counter(ctx.trace) as gemms:
        steps, window_s = train_window(ctx, step, k)
    peak = memory_peak(dev)
    nt = dict(stats.by_op.get("NT", {}))
    del state, params, opt
    free_device(dev)

    numbers, control = _reference(ctx, dims, batch, feed, prog)
    step_flops = flops.fcn_train_step_flops(dims, batch)
    return Outcome(
        e2e={"fcn_train_samples_per_s": steps * batch / window_s},
        counters={"window_s": window_s, "steps": steps, "model_flops": steps * step_flops,
                  "peak_flops": flops.peak_flops(cfg["torch_dtype"]) * int(ctx.cell["chips"]),
                  "gemms": gemms, "nt_decisions": nt},
        numbers=numbers, control_numbers=control, attempted=steps, failed=0,
        memory_peak_bytes=peak,
    )


def _reference(ctx: Context, dims, batch: int, feed, prog: Dict):
    """The reference's steps on the same weights and rows, and with
    ``ctx.control`` the control's too: (numbers, control numbers)."""
    numerics.set_f32_math()
    k = int(ctx.mix["checked_steps"])

    def reference(mode: str) -> Dict:
        precision, rows = numerics.mode(mode)
        params = weights.reference_copy(program.fcn_params(ctx.cfg, ctx.seed, ctx.device))
        out = ref_train.train_steps(
            params, lambda p, b: ref_fcn.loss(p, b, precision),
            lambda i: [({n: v[:int(batch * rows)] for n, v in feed(i).items()}, 1.0)],
            ctx.mix, k)
        del params
        free_device(ctx.device)
        return out

    ref = reference("f32")
    numbers = checks.train_numbers(prog, ref)
    control = checks.train_numbers(reference(ctx.control), ref) if ctx.control else {}
    return numbers, control
