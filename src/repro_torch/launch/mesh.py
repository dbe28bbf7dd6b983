"""Mesh construction.  A ``Mesh`` is abstract: named axes, their sizes and
the map between ranks and coordinates.  It needs no process group and no
device, so the dry run builds the production meshes in one process and
runs one rank's program against them on meta tensors.

Ranks are laid out rank-major over the axes in order, the last axis
(``model``) fastest: on a ``("data", "model")`` mesh of 2 x 4, rank 5 is
data 1, model 1.  A group along some axes is the ranks that share every
other coordinate, in ascending rank order (the order ``torch.distributed``
numbers a group's members in).

``make_local_mesh`` builds a mesh over the initialised process group and
makes each axis' process groups once (``distributed/context.py``);
``make_production_mesh`` gives the JAX package's 16 x 16 and 2 x 16 x 16
meshes, abstract.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple, Union

__all__ = ["Mesh", "make_production_mesh", "make_local_mesh"]

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """Named axes of sizes ``shape`` over ``prod(shape)`` ranks; ``rank`` is
    the rank this process plays (0 for an abstract mesh)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], rank: int = 0):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axis_names)} differ")
        if any(int(s) < 1 for s in shape):
            raise ValueError(f"mesh axes must be positive, got {tuple(shape)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(s) for a, s in zip(axis_names, shape)}
        self.size = math.prod(self.shape.values())
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside a mesh of {self.size}")
        self.rank = int(rank)
        self.groups: Dict[Tuple[str, ...], object] = {}  # axes -> process group

    @property
    def devices_shape(self) -> Tuple[int, ...]:
        return tuple(self.shape[a] for a in self.axis_names)

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def coords(self, rank: int = None) -> Dict[str, int]:
        """The coordinates of ``rank`` (default: this process's)."""
        r = self.rank if rank is None else int(rank)
        out = {}
        for a in reversed(self.axis_names):
            r, out[a] = divmod(r, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + int(coords.get(a, 0))
        return r

    def axis_index(self, axes: Axes, rank: int = None) -> int:
        """This rank's index along ``axes`` jointly, the first axis major
        (how a ``("pod", "data")`` spec entry splits a dimension)."""
        c = self.coords(rank)
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    def group_ranks(self, axes: Axes) -> List[List[int]]:
        """Every group along ``axes``: one per coordinate of the other
        axes, each in ascending rank order."""
        axes = _axes(axes)
        groups: Dict[Tuple[int, ...], List[int]] = {}
        for r in range(self.size):
            c = self.coords(r)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            groups.setdefault(key, []).append(r)
        return [groups[k] for k in sorted(groups)]

    def __repr__(self):
        dims = "x".join(str(s) for s in self.devices_shape)
        return f"Mesh({dims}, axes={self.axis_names}, rank={self.rank})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 ``("data", "model")``; 2x16x16 ``("pod", "data", "model")``
    multi-pod: the JAX package's production meshes, abstract."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``("data", "model")`` mesh over the initialised process group
    (one rank without one), with each axis' process groups made once.
    Every rank of the group must be in the mesh."""
    import torch.distributed as dist

    from repro_torch.distributed.context import make_groups

    world = dist.get_world_size() if dist.is_initialized() else 1
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks; the process "
                         f"group has {world}")
    mesh = Mesh((data, model), ("data", "model"),
                rank=dist.get_rank() if dist.is_initialized() else 0)
    make_groups(mesh)
    return mesh
