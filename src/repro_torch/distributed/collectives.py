"""Every collective the port issues, over the axes of a mesh.

``all_reduce``, ``all_gather``, ``reduce_scatter`` and ``broadcast`` run
one ``torch.distributed`` collective over the process group of ``axes``
(``context.axis_group``) and record its effective wire bytes per device
in ``STATS``, with the JAX package's ring conventions
(``repro/launch/roofline.py``), S the group's size and "result" the bytes
of what this rank gets back:

  all-reduce        2 * (S-1)/S * result
  all-gather        (S-1)/S * result
  reduce-scatter    (S-1) * result         (the operand is S * result)
  broadcast         result                 (the root's tensor reaches each
                                            rank once, as a permute would)

A group of one rank is the identity and records nothing.  The
collective itself, over a given process group and unrecorded, is
``all_reduce_in``, ``all_gather_in``, ``reduce_scatter_in`` and
``broadcast_in``: the wrappers call them, and a check can run them on a
group of one.  Given a meta
tensor, a wrapper records the collective and returns a meta result of
the right shape without a process group: that is how the dry run
(``launch/dryrun.py``) counts the collectives of one rank's program.

Backends: NCCL when each rank has its own card; gloo on the CPU and, for
two ranks sharing one card, on CUDA tensors (NCCL refuses two ranks on
one device).  gloo has no reduce-scatter: there ``reduce_scatter`` is an
all-reduce followed by this rank's slice, still recorded as the
reduce-scatter the program asks for.  gloo stages CUDA tensors through
the host and over TCP, which takes seconds a GB, so a gloo collective
of at least ``CARD_IPC_MIN_BYTES`` whose ranks all hold the same card
runs on the card instead (``_on_card``): each rank's operand is read in
place through CUDA IPC, and each rank combines the operands itself,
summing in the group's rank order (so every rank's all-reduce is the
same bits).  The gloo group carries only the handles and a barrier.
Where a rank cannot open a peer's handle (a block of an expandable
segment, on an OS kernel without ``pidfd_open``), every rank falls back
to gloo; ``ON_CARD`` counts both outcomes.

``copy_to_group``, ``reduce_from_group``, ``gather_from_group`` and
``scatter_to_group`` are the four differentiable collectives of tensor
parallelism (each one's backward is the other's forward); their
backward re-enters the forward's policy scope, as every backward of the
port does (``core/policy.py::resume_scope``).  ``gather_params`` is the
fifth, FSDP's: a weight split over the data axes is all-gathered whole
for one use, and its gradient -- each rank's from its own tokens -- is
reduce-scattered (summed) back to this rank's piece.  Under
``remat="full"`` the recompute calls it again, so every rank replays the
forward's gathers in the backward, in the forward's order.
``gather_seq`` is the same pair over ``model`` along the sequence, for
sequence-parallel attention (``models/attention.py``): each rank's key
and value rows are gathered whole, and since each rank's queries use
every key differently, the keys' gradients differ from rank to rank and
are reduce-scattered (summed) back to this rank's rows -- not sliced, as
``gather_from_group``'s backward slices a gradient every rank holds
alike.

``agree`` and ``barrier`` are the host-side agreements of the whole
mesh (the checkpoint step every rank restores, a save every rank waits
for); they move a few bytes and are not recorded.

``compressed_psum`` / ``compressed_mean`` are the JAX package's int8
chunk-quantized gradient all-reduce: each rank quantizes its tensor to
int8 with one f32 scale per chunk of 2048, the payload is summed as
int32, the scales are reduced with MAX, and the sum is dequantized with
the max scale.
"""

from __future__ import annotations

import functools
from typing import Tuple, Union

import torch

from repro_torch.core.policy import current_scope, resume_scope
from repro_torch.launch.roofline import CollectiveStats

from .context import axis_group, current_mesh
from .sharding import spec_axes

__all__ = [
    "STATS",
    "reset_stats",
    "effective_bytes",
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "broadcast",
    "all_reduce_in",
    "all_gather_in",
    "reduce_scatter_in",
    "broadcast_in",
    "agree",
    "barrier",
    "copy_to_group",
    "reduce_from_group",
    "gather_from_group",
    "scatter_to_group",
    "gather_params",
    "gather_seq",
    "quantize_int8",
    "dequantize_int8",
    "compressed_psum",
    "compressed_mean",
]

Axes = Union[str, Tuple[str, ...]]

# the collectives issued since the last reset_stats()
STATS = CollectiveStats()


def reset_stats() -> None:
    global STATS
    STATS.__init__()


def effective_bytes(kind: str, result_bytes: float, S: int) -> float:
    """Wire bytes per device of one collective (the module docstring's
    conventions)."""
    S = max(int(S), 2)
    frac = (S - 1) / S
    if kind == "all-reduce":
        return 2.0 * frac * result_bytes
    if kind == "all-gather":
        return frac * result_bytes
    if kind == "reduce-scatter":
        return (S - 1) * result_bytes
    if kind == "broadcast":
        return float(result_bytes)
    raise ValueError(f"unknown collective {kind!r}")


def _record(kind: str, result_numel: int, dtype: torch.dtype, S: int) -> None:
    rb = float(result_numel * torch.empty((), dtype=dtype).element_size())
    eff = effective_bytes(kind, rb, S)
    STATS.effective_bytes += eff
    STATS.result_bytes += rb
    STATS.count += 1
    STATS.by_kind[kind] = STATS.by_kind.get(kind, 0.0) + eff
    STATS.count_by_kind[kind] = STATS.count_by_kind.get(kind, 0) + 1


def _resolve(axes: Axes, mesh):
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        raise RuntimeError("a collective needs a mesh: pass mesh= or enter use_mesh")
    wanted = spec_axes(axes)
    missing = [a for a in wanted if a not in mesh.shape]
    if missing:
        raise ValueError(f"{mesh!r} has no axis {missing}")
    axes = tuple(a for a in mesh.axis_names if a in wanted)
    return mesh, axes, mesh.axis_size(axes)


def _is_nccl(group) -> bool:
    import torch.distributed as dist

    return dist.get_backend(group) == "nccl"


# A gloo collective of CUDA tensors of at least this many bytes goes
# through ``_on_card`` when its ranks share one card; below it, gloo's
# staging costs about as much as the handles' exchange, their opening and
# the barrier (``benchmarks/collectives_on_card.py`` times both routes).
CARD_IPC_MIN_BYTES = 16 << 20
# the collectives that went through ``_on_card`` ("calls") and those whose
# ranks shared a card but could not open each other's handles ("gloo")
ON_CARD = {"calls": 0, "gloo": 0}


def _card_sized(x: torch.Tensor, group) -> bool:
    """Whether ``x`` is a CUDA tensor large enough for ``_on_card`` on a
    gloo ``group`` (the same answer on every rank: the ranks' operands
    have one shape)."""
    import torch.distributed as dist

    return (x.is_cuda and x.numel() * x.element_size() >= CARD_IPC_MIN_BYTES
            and not _is_nccl(group) and dist.get_world_size(group) > 1)


def _peers(x: torch.Tensor, group):
    """Every rank's contiguous ``x`` of ``group`` in its rank order, each
    read in place on this rank's card through CUDA IPC, or None on every
    rank if the ranks do not all hold the same card or one of them cannot
    open the others' handles.  ``x``'s writes have finished when the
    handles leave, and the caller keeps ``x`` alive and unwritten until
    every rank has read it (``_on_card``'s barrier)."""
    import torch.distributed as dist
    from torch.multiprocessing.reductions import reduce_tensor

    card = str(torch.cuda.get_device_properties(x.device).uuid)
    torch.cuda.current_stream(x.device).synchronize()
    shared = [None] * dist.get_world_size(group)
    dist.all_gather_object(shared, (card, reduce_tensor(x.detach())), group=group)
    if any(c != card for c, _ in shared):
        return None
    me = dist.get_rank(group)
    try:
        parts = [x if r == me else rebuild(*args)
                 for r, (_, (rebuild, args)) in enumerate(shared)]
    except RuntimeError:  # e.g. a peer's block in an expandable segment
        parts = None
    opened = torch.tensor([parts is not None], dtype=torch.int32)
    dist.all_reduce(opened, op=dist.ReduceOp.MIN, group=group)
    if not opened.item():
        ON_CARD["gloo"] += 1
        return None
    ON_CARD["calls"] += 1
    return parts


def _on_card(x: torch.Tensor, group, combine):
    """``combine`` of every rank's ``x`` (a list in the group's rank
    order; ``combine`` returns a new tensor) when the ranks of the gloo
    ``group`` share one card, else None on every rank.  No rank returns
    before every rank has read the others' operands, so each may then
    free or overwrite its own."""
    import torch.distributed as dist

    xc = x.contiguous()
    parts = _peers(xc, group)
    if parts is None:
        return None
    out = combine(parts)
    if xc.is_cuda:  # read before the barrier lets the peers go on
        torch.cuda.current_stream(xc.device).synchronize()
    del parts
    dist.barrier(group=group)
    return out


def _op(op: str):
    import torch.distributed as dist

    return {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]


def all_reduce(x: torch.Tensor, axes: Axes, op: str = "sum", mesh=None) -> torch.Tensor:
    """The ``op`` ("sum" or "max") of ``x`` over the group of ``axes``, as
    a new tensor."""
    mesh, axes, S = _resolve(axes, mesh)
    if S == 1:
        return x
    _record("all-reduce", x.numel(), x.dtype, S)
    if x.is_meta:
        return torch.empty_like(x)
    return all_reduce_in(x, axis_group(axes, mesh), op)


def all_reduce_in(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``all_reduce``'s collective over the process group ``group``,
    unrecorded."""
    import torch.distributed as dist

    if _card_sized(x, group):
        fn = {"sum": torch.add, "max": torch.maximum}[op]
        y = _on_card(x, group, lambda parts: functools.reduce(fn, parts))
        if y is not None:
            return y
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=_op(op), group=group)
    return y


def all_gather(x: torch.Tensor, axes: Axes, dim: int = 0, mesh=None) -> torch.Tensor:
    """The group's pieces of ``x`` concatenated along ``dim``, in the order
    of their index along ``axes``."""
    mesh, axes, S = _resolve(axes, mesh)
    if S == 1:
        return x
    dim = dim % x.ndim
    shape = list(x.shape)
    shape[dim] *= S
    _record("all-gather", x.numel() * S, x.dtype, S)
    if x.is_meta:
        return x.new_empty(shape)
    return all_gather_in(x, axis_group(axes, mesh), S, dim)


def all_gather_in(x: torch.Tensor, group, S: int, dim: int) -> torch.Tensor:
    """``all_gather``'s collective over the ``S`` ranks of ``group``,
    unrecorded."""
    import torch.distributed as dist

    if _card_sized(x, group):
        y = _on_card(x, group, lambda parts: torch.cat(parts, dim=dim))
        if y is not None:
            return y
    xc = x.contiguous()
    parts = [torch.empty_like(xc) for _ in range(S)]
    dist.all_gather(parts, xc, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, axes: Axes, dim: int = 0, mesh=None) -> torch.Tensor:
    """This rank's piece along ``dim`` of the sum of ``x`` over the group
    of ``axes``."""
    mesh, axes, S = _resolve(axes, mesh)
    if S == 1:
        return x
    dim = dim % x.ndim
    if x.shape[dim] % S:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} does not divide by {S}")
    part = x.shape[dim] // S
    _record("reduce-scatter", x.numel() // S, x.dtype, S)
    if x.is_meta:
        return x.new_empty(x.shape[:dim] + (part,) + x.shape[dim + 1:])
    return reduce_scatter_in(x, axis_group(axes, mesh), S, mesh.axis_index(axes), dim)


def reduce_scatter_in(x: torch.Tensor, group, S: int, idx: int, dim: int) -> torch.Tensor:
    """``reduce_scatter``'s collective over the ``S`` ranks of ``group``,
    this rank at index ``idx`` of it, unrecorded."""
    import torch.distributed as dist

    part = x.shape[dim] // S
    if _is_nccl(group):
        xm = x.movedim(dim, 0).contiguous()
        out = xm.new_empty((part,) + tuple(xm.shape[1:]))
        dist.reduce_scatter_tensor(out, xm, group=group)
        return out.movedim(0, dim).contiguous()
    if _card_sized(x, group):
        y = _on_card(x, group, lambda parts: functools.reduce(
            torch.add, [p.narrow(dim, idx * part, part) for p in parts]).contiguous())
        if y is not None:
            return y
    # gloo: all-reduce, then this rank's slice
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y.narrow(dim, idx * part, part).contiguous()


def broadcast(x: torch.Tensor, axes: Axes, src: int = 0, mesh=None) -> torch.Tensor:
    """The tensor of the group member at index ``src`` along ``axes``."""
    mesh, axes, S = _resolve(axes, mesh)
    if S == 1:
        return x
    _record("broadcast", x.numel(), x.dtype, S)
    if x.is_meta:
        return torch.empty_like(x)
    ranks = next(g for g in mesh.group_ranks(axes) if mesh.rank in g)
    return broadcast_in(x, axis_group(axes, mesh), ranks[src])


def broadcast_in(x: torch.Tensor, group, src_rank: int) -> torch.Tensor:
    """``broadcast``'s collective over ``group`` from global rank
    ``src_rank``, unrecorded."""
    import torch.distributed as dist

    if _card_sized(x, group):
        src = dist.get_group_rank(group, src_rank)
        y = _on_card(x, group, lambda parts: parts[src].clone())
        if y is not None:
            return y
    y = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(y, src=src_rank, group=group)
    return y


def agree(value, mesh=None):
    """Rank 0's ``value`` (any picklable object) on every rank of the
    mesh's process group."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or mesh.size == 1:
        return value
    import torch.distributed as dist

    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(mesh=None) -> None:
    """Wait until every rank of the mesh's process group is here."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        dist.barrier()


def _local_slice(x: torch.Tensor, axes, dim: int) -> torch.Tensor:
    mesh, axes, S = _resolve(axes, None)
    part = x.shape[dim] // S
    return x.narrow(dim, mesh.axis_index(axes) * part, part).contiguous()


# -- the differentiable collectives of tensor parallelism -------------------------


class _CopyToGroup(torch.autograd.Function):
    """Forward: identity (the input enters every rank's shard of a
    projection); backward: the input gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes, ctx.scope = axes, current_scope()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with resume_scope(ctx.scope):
            return all_reduce(g, ctx.axes), None


class _ReduceFromGroup(torch.autograd.Function):
    """Forward: the partial sums of the group's ranks added up; backward:
    identity (every rank continues with the same gradient)."""

    @staticmethod
    def forward(ctx, x, axes):
        return all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """Forward: the group's pieces concatenated along ``dim``; backward:
    this rank's piece of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim, ctx.scope = axes, dim % x.ndim, current_scope()
        return all_gather(x, axes, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        with resume_scope(ctx.scope):
            return _local_slice(g, ctx.axes, ctx.dim), None, None


class _ScatterToGroup(torch.autograd.Function):
    """Forward: this rank's piece along ``dim`` of a replicated tensor;
    backward: the pieces' gradients gathered back."""

    @staticmethod
    def forward(ctx, x, axes, dim):
        ctx.axes, ctx.dim, ctx.scope = axes, dim % x.ndim, current_scope()
        return _local_slice(x, axes, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        with resume_scope(ctx.scope):
            return all_gather(g.contiguous(), ctx.axes, ctx.dim), None, None


class _GatherParams(torch.autograd.Function):
    """Forward: the pieces over ``axes`` (a weight's, or a sequence's rows)
    concatenated along ``dim``; backward: the whole tensor's gradient,
    which differs from rank to rank (each rank's own tokens or queries),
    summed over the group, and this rank's piece of the sum (a
    reduce-scatter in the gradient's dtype, as the JAX package's
    partitioner reduces a bf16 weight's gradient)."""

    @staticmethod
    def forward(ctx, w, axes, dim):
        ctx.axes, ctx.dim, ctx.scope = axes, dim % w.ndim, current_scope()
        return all_gather(w, axes, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        with resume_scope(ctx.scope):
            return reduce_scatter(g.contiguous(), ctx.axes, ctx.dim), None, None


def copy_to_group(x: torch.Tensor, axes: Axes = "model") -> torch.Tensor:
    return _CopyToGroup.apply(x, axes)


def reduce_from_group(x: torch.Tensor, axes: Axes = "model") -> torch.Tensor:
    return _ReduceFromGroup.apply(x, axes)


def gather_from_group(x: torch.Tensor, axes: Axes = "model", dim: int = -1) -> torch.Tensor:
    return _GatherFromGroup.apply(x, axes, dim)


def scatter_to_group(x: torch.Tensor, axes: Axes = "model", dim: int = -1) -> torch.Tensor:
    return _ScatterToGroup.apply(x, axes, dim)


def gather_params(w: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
    return _GatherParams.apply(w, axes, dim)


def gather_seq(x: torch.Tensor, axes: Axes = "model", dim: int = 1) -> torch.Tensor:
    return _GatherParams.apply(x, axes, dim)


# -- int8-compressed all-reduce -----------------------------------------------------

_CHUNK = 2048


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 -> (int8 payload (chunks, 2048), per-chunk f32 scales
    (chunks, 1)); the tail chunk is zero-padded."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % _CHUNK
    flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(-1, _CHUNK)
    scale = torch.amax(torch.abs(chunks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(chunks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def _psum_quantized(g: torch.Tensor, axes, mesh) -> torch.Tensor:
    """Quantize -> all-reduce the int32 accumulators and the MAX of the
    scales -> dequantize (no overflow for up to 2^23 ranks)."""
    q, scale = quantize_int8(g.to(torch.float32))
    q32 = all_reduce(q.to(torch.int32), axes, mesh=mesh)
    smax = all_reduce(scale, axes, op="max", mesh=mesh)
    return dequantize_int8(q32, smax, g.shape, g.dtype)


def compressed_psum(grads, mesh, axes: Tuple[str, ...]):
    """All-reduce a gradient tree over ``axes`` with int8 compression."""
    from repro_torch.optim import tree_map

    return tree_map(lambda g: _psum_quantized(g, axes, mesh), grads)


def compressed_mean(grads, mesh, axes: Tuple[str, ...]):
    from repro_torch.optim import tree_map

    n = mesh.axis_size(axes)
    return tree_map(lambda g: g / n, compressed_psum(grads, mesh, axes))
