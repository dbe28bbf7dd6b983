"""Current-mesh context: deep model code reads the mesh it runs on
without threading it through every call signature, and the collectives
find the process group of each mesh axis here.

``make_groups(mesh)`` makes, once, the process group of every set of
axes the port reduces or gathers over -- each axis alone, the data axes
together and all axes -- one subgroup per coordinate of the other axes.
``torch.distributed.new_group`` is collective over the whole process
group, so every rank makes every group, in the same order, and keeps the
one it belongs to.  A group of one rank is never made: a collective over
it is the identity.

The JAX package's ``constrain`` (a sharding constraint inside a jitted
program, which XLA meets by moving rows between layouts) has no
counterpart here: a per-rank program moves data only by the collectives
it calls.  Its one use, sequence-parallel attention, is expressed as
explicit collectives in ``models/attention.py`` and nowhere else: each
rank cuts its query rows (``scatter_to_group``), gathers the keys and
values whole (``gather_seq``) and gathers the attention output back
(``gather_from_group``).
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Iterator, Tuple

__all__ = ["set_current_mesh", "current_mesh", "use_mesh", "mesh_scope", "dp_axes",
           "make_groups",
           "axis_group", "model_size"]

_MESH = None


def set_current_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def current_mesh():
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[object]:
    global _MESH
    prev = _MESH
    _MESH = mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def mesh_scope(mesh):
    """``use_mesh(mesh)``, or no change of the current mesh for None."""
    return use_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def dp_axes() -> tuple:
    if _MESH is None:
        return ()
    return tuple(a for a in _MESH.axis_names if a in ("pod", "data"))


def model_size(mesh=None) -> int:
    """The ``model`` axis' size of ``mesh`` (default: the current one);
    1 without a mesh."""
    mesh = _MESH if mesh is None else mesh
    return mesh.shape.get("model", 1) if mesh is not None else 1


def _axis_sets(mesh):
    names = mesh.axis_names
    daxes = tuple(a for a in names if a in ("pod", "data"))
    sets = [(a,) for a in names]
    if len(daxes) > 1:
        sets.append(daxes)
    for n in range(2, len(names) + 1):
        sets.extend(c for c in itertools.combinations(names, n) if c not in sets)
    return sets


def make_groups(mesh) -> None:
    """Make the process groups of ``mesh``'s axis sets (see the module
    docstring); a no-op without an initialised process group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    for axes in _axis_sets(mesh):
        if mesh.axis_size(axes) == 1:
            continue
        if mesh.axis_size(axes) == mesh.size:
            mesh.groups[axes] = dist.group.WORLD
            continue
        for ranks in mesh.group_ranks(axes):
            g = dist.new_group(ranks)
            if mesh.rank in ranks:
                mesh.groups[axes] = g


def axis_group(axes: Tuple[str, ...], mesh=None):
    """The process group of this rank along ``axes`` of ``mesh`` (default:
    the current one); raises if the mesh has none (an abstract mesh, whose
    collectives only run on meta tensors)."""
    mesh = _MESH if mesh is None else mesh
    axes = tuple(a for a in mesh.axis_names if a in axes)  # mesh order
    try:
        return mesh.groups[axes]
    except KeyError:
        raise RuntimeError(
            f"{mesh!r} has no process group along {axes}: build the mesh with "
            "make_local_mesh over an initialised process group (an abstract mesh "
            "runs collectives on meta tensors only)"
        ) from None
