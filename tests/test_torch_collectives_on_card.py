"""The collectives' route for gloo ranks that share one card
(``repro_torch.distributed.collectives._on_card``): every wrapper's
result through it equals gloo's own on the same operands.

On the CPU three gloo ranks run the route's combination with their
operands gathered by gloo in place of CUDA IPC, and a route whose ranks
do not share a card falls back to gloo; on the card two ranks share
``cuda:0`` and read each other's operands through CUDA IPC.  The
operands are integers small enough that every order of summing them is
exact, so "equal" is bit for bit.  ``benchmarks/collectives_on_card.py``
times both routes; here it runs at a small size on the CPU."""
import os
import pickle

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402


def _collectives(C, x, world, rank):
    g = dist.group.WORLD
    out = {"sum": C.all_reduce_in(x, g), "max": C.all_reduce_in(x, g, "max"),
           "gather": C.all_gather_in(x, g, world, 1),
           "scatter": C.reduce_scatter_in(x, g, world, rank, 1),
           "scatter_last_dim": C.reduce_scatter_in(x.transpose(1, 2), g, world, rank, 2),
           "broadcast": C.broadcast_in(x, g, world - 1)}
    xb = x.bfloat16()
    out.update({"bf16_sum": C.all_reduce_in(xb, g), "bf16_gather": C.all_gather_in(xb, g, world, 0),
                "bf16_scatter": C.reduce_scatter_in(xb, g, world, rank, 1)})
    return {k: v.cpu() for k, v in out.items()}


def _ranks(rank, world, tmp, mode):
    from repro_torch.distributed import collectives as C

    torch.set_num_threads(1)  # the ranks share this machine's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    device = "cuda" if mode == "card" else "cpu"
    cols = 64
    if mode == "card":  # (6, 4 * world, cols) of bf16 reach CARD_IPC_MIN_BYTES
        torch.cuda.set_device(0)
        cols = -(-C.CARD_IPC_MIN_BYTES // (6 * 4 * world * 2))
    gen = torch.Generator().manual_seed(rank)
    x = torch.randint(-64, 64, (6, 4 * world, cols), generator=gen).float().to(device)
    peers, calls = C._peers, []

    def gathered(xc, group):
        """The route's operands, gathered by gloo (the CPU has no IPC)."""
        calls.append(True)
        parts = [torch.empty_like(xc) for _ in range(world)]
        dist.all_gather(parts, xc, group=group)
        return parts

    def counted(xc, group):
        parts = peers(xc, group)
        calls.append(parts is not None)
        return parts

    if mode == "cpu":
        C._card_sized = lambda t, group: True
        C._peers = gathered
    elif mode == "cpu_other_cards":
        C._card_sized = lambda t, group: True
        C._peers = lambda xc, group: calls.append(False)
    else:
        C._peers = counted
    route = _collectives(C, x, world, rank)
    C._card_sized = lambda t, group: False
    gloo = _collectives(C, x, world, rank)
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump({"route": route, "gloo": gloo, "calls": calls}, fh)


def _run(tmp_path, world, mode):
    mp.start_processes(_ranks, args=(world, str(tmp_path), mode), nprocs=world,
                       start_method="spawn")
    return [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes()) for r in range(world)]


def _check(ranks, routed):
    for r in ranks:
        assert r["calls"] == [routed] * 9
        for k, want in r["gloo"].items():
            got = r["route"][k]
            assert got.dtype == want.dtype and torch.equal(got, want), k
    for k in ("sum", "max", "gather", "broadcast", "bf16_sum", "bf16_gather"):
        assert all(torch.equal(r["route"][k], ranks[0]["route"][k]) for r in ranks), k


def test_the_routes_combination_equals_gloos_on_three_ranks(tmp_path):
    _check(_run(tmp_path, 3, "cpu"), True)


def test_ranks_on_other_cards_fall_back_to_gloo(tmp_path):
    _check(_run(tmp_path, 2, "cpu_other_cards"), False)


@pytest.mark.gpu
def test_two_ranks_sharing_the_card_read_each_other_through_cuda_ipc(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    _check(_run(tmp_path, 2, "card"), True)


def test_the_benchmark_runs_both_routes_on_two_cpu_ranks():
    from repro_torch.benchmarks import collectives_on_card as bench

    rows = bench.run("cpu", elements=4096, reps=1)
    assert [(r["collective"], r["elements"]) for r in rows] == [
        (name, 4096) for name, _, _ in bench.CASES]
    for r in rows:
        assert r["equal"] and len(r["gloo_s"]) == len(r["card_s"]) == 1
        assert r["gloo_on_card_calls"] == r["card_on_card_calls"] == 0  # no card here
