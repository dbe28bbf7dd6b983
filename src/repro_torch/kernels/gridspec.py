"""Declared grid schedules of the port's CUDA kernels.

Every CUDA launch of the port is described by a ``KernelGridSpec``: the
grid it runs, one ``BlockMap`` per operand and for the output -- the
block shape, the index map from a grid point to the block it reads or
writes, and the extent of the array the map indexes into -- and the
``launch``, the ``dim3`` the wrapper passes to its C entry point.  The C
entry points compute no grid of their own: they launch what they are
given.  So the spec is the one source of the kernel's schedule, and the
coverage pass (``repro_torch.analysis.coverage``, rules KC310-KC315)
proves what the card runs: it evaluates these maps over the whole grid
and shows that every output block is written exactly once, that every
block starts inside its operand, and that the grid matches its output
and CUDA's limits, for every (candidate, op) pair and every plan.

Two kinds of spec:

  * a dense one (``programs`` None): one CUDA block per grid point; the
    grid is the launch, in CUDA's axis order (x, y, z), and the maps take
    (x, y, z);
  * a persistent one (``programs`` an int): the grid is the kernel's
    grid of units, numbered row-major (the last axis fastest) in the
    order the kernel decodes them; ``programs`` blocks are launched along
    x, and program ``p`` walks the units ``p, p + programs, ...``.

A kernel block loops over k (or over the keys) inside itself, so no
grid axis of a CUDA spec is sequential: ``sequential`` stays for the JAX
package's specs, which the coverage pass also takes.

``GRID_SPEC_BUILDERS`` maps each tunable candidate to a function that
returns the spec(s) its dispatch launches at a shape, resolving the plan
with the wrapper's own ``*_plans`` and ``pick_plan``: two for the
two-kernel plans (transpose then NN; a split kernel then its reduce or
combine).  Registering a tunable candidate without an entry fails the
coverage pass (KC315).

The index maps are plain Python callables over ints; they also take
numpy integer arrays, which the coverage pass uses to evaluate a whole
grid at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

__all__ = [
    "BlockMap",
    "KernelGridSpec",
    "GRID_LIMITS",
    "MAX_GRID_Y",
    "MAX_GRID_Z",
    "MAX_UNITS",
    "dense_spec",
    "persistent_spec",
    "launch_error",
    "check_launch",
    "GRID_SPEC_BUILDERS",
    "candidate_grid_specs",
]

IndexMap = Callable[..., Tuple[int, ...]]

# CUDA's limits on a launch's gridDim (x, y, z), and on the units a
# persistent kernel numbers with an int.
GRID_LIMITS: Tuple[int, int, int] = (2**31 - 1, 65535, 65535)
_, MAX_GRID_Y, MAX_GRID_Z = GRID_LIMITS
MAX_UNITS = 2**31 - 1


@dataclass(frozen=True)
class BlockMap:
    """One operand's (or the output's) blocking: the block shape, its
    index map, and the extent of the array it indexes into."""

    block: Tuple[int, ...]
    index_map: IndexMap
    extent: Tuple[int, ...]


@dataclass(frozen=True)
class KernelGridSpec:
    """One launch's schedule: grid, operand maps, output map, and the
    ``dim3`` the wrapper passes (``launch``, None for a spec that no
    launch takes, as the JAX package's).  ``programs`` is None for one
    block per grid point, or the programs of a persistent grid."""

    name: str
    grid: Tuple[int, ...]
    in_specs: Tuple[BlockMap, ...]
    out_spec: BlockMap
    sequential: Tuple[int, ...] = ()
    programs: Optional[int] = None
    launch: Optional[Tuple[int, int, int]] = None

    @property
    def units(self) -> int:
        total = 1
        for e in self.grid:
            total *= int(e)
        return total


def dense_spec(name: str, launch: Sequence[int], in_specs: Sequence[BlockMap],
               out_spec: BlockMap) -> KernelGridSpec:
    """A spec of one block per grid point: the grid is the launch (x, y,
    z)."""
    launch = tuple(int(e) for e in launch) + (1,) * (3 - len(launch))
    return KernelGridSpec(name=name, grid=launch, in_specs=tuple(in_specs),
                          out_spec=out_spec, launch=launch)


def persistent_spec(name: str, grid: Sequence[int], programs: int,
                    in_specs: Sequence[BlockMap], out_spec: BlockMap) -> KernelGridSpec:
    """A persistent spec: ``programs`` blocks along x walk the units of
    ``grid``."""
    return KernelGridSpec(name=name, grid=tuple(int(e) for e in grid), in_specs=tuple(in_specs),
                          out_spec=out_spec, programs=int(programs),
                          launch=(int(programs), 1, 1))


def launch_error(spec: KernelGridSpec) -> Optional[str]:
    """Why CUDA cannot take ``spec``'s launch (an extent below 1 or over
    ``GRID_LIMITS``, or a persistent grid of more units than an int
    numbers), or None."""
    if spec.launch is None:
        return None
    for axis, (e, top) in enumerate(zip(spec.launch, GRID_LIMITS)):
        if not 1 <= e <= top:
            return f"gridDim.{'xyz'[axis]} = {e} outside [1, {top}]"
    if spec.programs is not None and spec.units > MAX_UNITS:
        return f"{spec.units} units, over the {MAX_UNITS} an int numbers"
    return None


def check_launch(specs: Sequence[KernelGridSpec], message: str) -> None:
    """Raise ``ValueError(message)`` before any launch when a spec's
    launch is over CUDA's limits.  A zero extent is an empty output's,
    which the wrappers do not launch."""
    for s in specs:
        over = any(e > top for e, top in zip(s.launch, GRID_LIMITS))
        if over or (s.programs is not None and s.units > MAX_UNITS):
            raise ValueError(message)


# -- candidate name -> grid-spec function -------------------------------------
#
# An entry has signature (op, m, n, k, g, block, dsize, aligned, sms) ->
# Tuple[KernelGridSpec, ...], with (m, n, k, g) the logical extents in the
# op's output coordinates (for ATTN: queries, keys, head dim, slices),
# ``block`` the tile config a Candidate.run forwards (None: the wrapper's
# own plan), ``dsize`` the element size, ``aligned`` whether the operands
# are 16-byte aligned and ``sms`` the card's SM count.  The two-kernel TNN
# and TN arms also take ``tblock``, the transpose's own instance.

_DTYPES = {2: "bfloat16", 4: "float32"}


def _dtype(dsize: int):
    import torch

    return getattr(torch, _DTYPES[int(dsize)])


def _nt_specs(op, m, n, k, g, block, dsize, aligned, sms):
    from . import matmul_nt
    from .common import pick_plan

    plan = pick_plan(matmul_nt.nt_plans(m, n, k, _dtype(dsize), aligned, sms), block,
                     f"NT kernel at ({m}, {n}, {k})")
    return matmul_nt.nt_grid_specs(m, n, k, plan)


def _nn_specs(op, m, n, k, g, block, dsize, aligned, sms):
    from . import matmul_nn
    from .common import pick_plan

    plan = pick_plan(matmul_nn.nn_plans(m, n, k, _dtype(dsize), aligned, sms), block,
                     f"NN kernel at ({m}, {n}, {k})")
    return matmul_nn.nn_grid_specs(m, n, k, plan, sms)


def _tnn_fused_specs(op, m, n, k, g, block, dsize, aligned, sms):
    from . import matmul_tnn_fused
    from .common import pick_plan

    plan = pick_plan(matmul_tnn_fused.tnn_fused_plans(m, n, k, _dtype(dsize), aligned, sms),
                     block, f"fused TNN kernel at ({m}, {n}, {k})")
    return matmul_tnn_fused.tnn_fused_grid_specs(m, n, k, plan, sms)


def _tnn_specs(op, m, n, k, g, block, dsize, aligned, sms, tblock=None):
    # ops.matmul_tnn: transpose B:(n, k) -> (k, n) at its own instance,
    # then NN
    from .transpose import transpose_grid_spec

    return ((transpose_grid_spec(n, k, tblock),)
            + _nn_specs(op, m, n, k, g, block, dsize, aligned, sms))


def _tn_specs(op, m, n, k, g, block, dsize, aligned, sms, tblock=None):
    # ops.matmul_tn: transpose A:(k, m) -> (m, k), then NN
    from .transpose import transpose_grid_spec

    return ((transpose_grid_spec(k, m, tblock),)
            + _nn_specs(op, m, n, k, g, block, dsize, aligned, sms))


def _batched_specs(nt):
    def build(op, m, n, k, g, block, dsize, aligned, sms):
        from . import matmul_batched

        plan = matmul_batched.batched_plan(_dtype(dsize), g, m, n, k, nt, 0 if aligned else 1,
                                           0 if aligned else 1, sms, block)
        return matmul_batched.batched_grid_specs(g, m, n, k, nt, plan)

    return build


def _fused_attn_specs(op, m, n, k, g, block, dsize, aligned, sms, mask=None):
    # ATTN extents: m queries, n keys, k the head dim, g slices
    from . import attention_fused
    from .common import pick_plan

    plan = pick_plan(attention_fused.attention_plans(_dtype(dsize), g, m, n, k, aligned, sms),
                     block, f"attention kernel at g={g} m={m} n={n} dh={k}")
    return attention_fused.attention_grid_specs(
        g, m, n, k, plan, mask if mask is not None else attention_fused.MaskParams())


GRID_SPEC_BUILDERS: Dict[str, Callable] = {
    "PALLAS_NT": _nt_specs,
    "PALLAS_NN": _nn_specs,
    "PALLAS_TNN": _tnn_specs,
    "PALLAS_TNN_FUSED": _tnn_fused_specs,
    "PALLAS_TN": _tn_specs,
    "PALLAS_BNT": _batched_specs(True),
    "PALLAS_BNN": _batched_specs(False),
    "FUSED_ATTN": _fused_attn_specs,
}


def candidate_grid_specs(
    name: str,
    op: str,
    m: int,
    n: int,
    k: int,
    g: int = 1,
    block: Optional[Tuple[int, ...]] = None,
    dsize: int = 4,
    aligned: bool = True,
    sms: Optional[int] = None,
    **extra,
) -> Tuple[KernelGridSpec, ...]:
    """The schedule(s) candidate ``name`` launches for one dispatch of
    ``op`` at the logical shape -- the verifier's input.  ``sms`` None is
    an H100's 132.  ``extra`` goes to the entries that take more (``tblock``
    for the two-kernel arms, ``mask`` for the attention kernel).  Raises
    ``KeyError`` for candidates with no registered entry."""
    try:
        make = GRID_SPEC_BUILDERS[name]
    except KeyError:
        raise KeyError(
            f"candidate {name!r} has no registered grid-spec function; "
            "tunable candidates must describe their schedule in "
            "kernels/gridspec.py so the coverage pass can verify it (KC315)"
        ) from None
    if sms is None:
        from .common import H100_SMS

        sms = H100_SMS
    return tuple(make(op, m, n, k, g, block, dsize, aligned, sms, **extra))
