"""Training a dense decoder LM data-parallel over the cell's cards: one
rank a card (rank 0 this process, the others spawned), a ``data`` x 1
mesh over a process group on ``localhost``, the port's
``launch/steps.make_train_step`` with that mesh (forward with the
configuration's remat, the attention plan forward and backward, loss,
the gradients' mean over the ranks and the ZeRO-1 AdamW update, whose
moments each rank holds a quarter of) under the default policy.

Each step's rows are the traffic's ``batch`` sequences a rank, drawn
for all ranks at once (``traffic.lm_batch``) and cut to this rank's by
the mesh's batch specs.  Set-up runs the first ``checked_steps`` and
reads what ``correct`` is decided from; from the last of them it takes
the step's time, and every rank then trains the same number of steps,
the most any rank needs to fill ``--seconds`` (so that the ranks'
collectives pair up without a per-step agreement).  The window runs
from the first of those steps to the device's end of the last on every
rank; tokens per second count every rank's tokens.

Counters: the window's collective bytes per rank, in the port's ring
conventions (``distributed/collectives.STATS``), and its steps.

``correct``: ``checks.train_numbers`` against the reference's steps on
the same weights and rows, in float32 over the same ranks
(``reference/data_parallel.py``: each rank's rows one sequence a
microbatch, the gradients summed over the ranks), once the program's
state is freed.
"""

from __future__ import annotations

import socket
import time
from typing import Dict

import torch
import torch.distributed as dist

from cellbench import checks, flops, program, traffic, weights
from cellbench.harness import Context, Outcome
from cellbench.reference import data_parallel, numerics
from cellbench.trace import Tracer

from .common import B1, change_norms, dispatch_counter, free_device, memory_peak, sync

__all__ = ["run"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(ctx: Context) -> Outcome:
    world = int(ctx.cell["chips"])
    port = _free_port()
    procs = []
    if world > 1:
        import torch.multiprocessing as mp

        spawn = mp.get_context("spawn")
        shared = dict(cfg=ctx.cfg, mix=ctx.mix, limits=ctx.limits, seed=ctx.seed,
                      seconds=ctx.seconds, cell=ctx.cell, spec=ctx.spec, control=ctx.control,
                      device=str(torch.device(ctx.device).type))
        procs = [spawn.Process(target=_rank_main, args=(r, world, port, shared), daemon=True)
                 for r in range(1, world)]
        for p in procs:
            p.start()
    try:
        out = _rank(ctx, 0, world, port)
    finally:
        for p in procs:
            p.join(timeout=600)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank exited with {bad}")
    return out


def _rank_main(rank: int, world: int, port: int, shared: Dict) -> None:
    """A spawned rank: the same program with no tracer and no result."""
    from cellbench import harness

    harness.prepare_environment()
    dev = torch.device("cuda", rank) if shared["device"] == "cuda" else torch.device("cpu")
    if dev.type == "cpu":
        torch.set_num_threads(1)  # ranks sharing the host's cores
    ctx = harness.Context(seed=shared["seed"], seconds=shared["seconds"], trace=False,
                          device=dev, t_start=time.perf_counter(), tracer=Tracer(False),
                          control=shared["control"], cell=shared["cell"], cfg=shared["cfg"],
                          mix=shared["mix"], limits=shared["limits"], spec=shared["spec"],
                          log=lambda msg: None)
    _rank(ctx, rank, world, port)


def _norms_over_ranks(pieces: Dict[str, torch.Tensor], shapes: Dict[str, torch.Size]
                      ) -> Dict[str, float]:
    """Each leaf's norm from this rank's piece: squares summed over the
    ranks where the piece is a cut of the leaf (its shape differs from
    the whole leaf's), else the piece's own."""
    names = sorted(pieces)
    sq = torch.stack([pieces[k].float().pow(2).sum() for k in names]).double()
    cut = torch.tensor([pieces[k].shape != shapes[k] for k in names], device=sq.device)
    summed = sq.clone()
    dist.all_reduce(summed)
    sq = torch.where(cut, summed, sq)
    return {k: float(v) for k, v in zip(names, sq.sqrt().tolist())}


def _rank(ctx: Context, rank: int, world: int, port: int) -> Outcome:
    cuda = torch.device(ctx.device).type == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        return _train(ctx, rank, world, dev)
    finally:
        dist.destroy_process_group()


def _train(ctx: Context, rank: int, world: int, dev) -> Outcome:
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import batch_specs, param_specs, shard
    from repro_torch.launch import steps as lsteps
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(world, 1)
    cfg, mix, seed = ctx.cfg, ctx.mix, ctx.seed
    arch = program.arch_config(cfg)
    batch, seq, k = int(mix["batch"]), int(mix["seq"]), int(mix["checked_steps"])
    vocab = int(cfg["vocab_size"])

    def feed(i):
        b = traffic.lm_batch(seed, i, vocab, batch * world, seq, dev)
        return shard(b, batch_specs(b, mesh), mesh)

    sc = lsteps.TrainStepConfig(accum=1, lr=mix["lr"], warmup=mix["warmup"],
                                total_steps=mix["total_steps"],
                                max_grad_norm=mix["max_grad_norm"],
                                weight_decay=mix["weight_decay"])
    step_fn = lsteps.make_train_step(arch, sc, policy=None, mesh=mesh)
    params = program.lm_params(cfg, seed, dev)
    shapes = {n: t.shape for n, t in weights.named(params).items()}
    params = shard(params, param_specs(params, mesh), mesh)
    state = lsteps.init_train_state(arch, params, mesh)
    del params
    sync(dev)
    ctx.note("weights")
    prog: Dict = {"losses": []}
    for i in range(k):
        sync(dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, feed(i))
        prog["losses"].append(float(metrics["loss"]))
        step_s = time.perf_counter() - t0
        if i == 0:
            prog["grad_norm"] = float(metrics["grad_norm"])
            m = _norms_over_ranks(weights.named(state["opt"]["m"]), shapes)
            prog["first_grad"] = {n: v / (1 - B1) for n, v in m.items()}
            ctx.note("first step")
    prog["change"] = change_norms(state["params"], program.lm_params(cfg, seed, dev))
    del metrics
    # every rank trains the steps the slowest needs to fill the window
    n = torch.tensor([max(1, int(ctx.seconds / max(step_s, 1e-6)) + 1)], device=dev)
    dist.all_reduce(n, op=dist.ReduceOp.MAX)
    n = int(n)
    box = {"state": state}
    del state
    free_device(dev)
    sync(dev)
    ctx.mark_setup()

    collectives.reset_stats()
    with dispatch_counter(ctx.trace) as gemms:
        dist.barrier()
        with ctx.tracer.window(dev):
            t0 = time.perf_counter()
            for i in range(k, k + n):
                with ctx.tracer.span("train_step"):
                    box["state"], _ = step_fn(box["state"], feed(i))
            sync(dev)
            dist.barrier()
            window_s = time.perf_counter() - t0
    wire = collectives.STATS.effective_bytes
    peak = torch.tensor([memory_peak(dev)], device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    del box
    free_device(dev)

    numbers, control = _reference(ctx, rank, world, dev, prog)
    step_flops = flops.lm_train_step_flops(cfg, batch * world, seq)
    return Outcome(
        e2e={"lm_train_tokens_per_s": n * batch * world * seq / window_s},
        counters={"window_s": window_s, "steps": n, "model_flops": n * step_flops,
                  "peak_flops": flops.peak_flops(cfg["torch_dtype"]) * world,
                  "gemms": gemms, "collective_bytes": wire},
        numbers=numbers, control_numbers=control, attempted=n, failed=0,
        memory_peak_bytes=int(peak),
    )


def _reference(ctx: Context, rank: int, world: int, dev, prog: Dict):
    """The reference's steps on the same weights and rows over the same
    ranks, one sequence a microbatch, and with ``ctx.control`` the
    control's too."""
    numerics.set_f32_math()
    cfg, mix = ctx.cfg, ctx.mix
    k, batch = int(mix["checked_steps"]), int(mix["batch"])

    def reference(mode: str) -> Dict:
        precision, rows = numerics.mode(mode)

        def microbatches(i):
            b = traffic.lm_batch(ctx.seed, i, int(cfg["vocab_size"]), batch * world,
                                 int(mix["seq"]), dev)
            n = int(batch * rows)
            total = n * world
            return [({"tokens": b["tokens"][j:j + 1], "labels": b["labels"][j:j + 1]},
                     1.0 / total) for j in range(rank * batch, rank * batch + n)]

        params = weights.reference_copy(program.lm_params(cfg, ctx.seed, dev))
        free_device(dev)
        out = data_parallel.train_steps(
            params, lambda p, b: data_parallel.decoder_loss(p, cfg, b, precision),
            microbatches, mix, k)
        del params
        free_device(dev)
        return out

    ref = reference("f32")
    numbers = checks.train_numbers(prog, ref)
    control = checks.train_numbers(reference(ctx.control), ref) if ctx.control else {}
    return numbers, control
