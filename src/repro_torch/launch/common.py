"""Shared launcher CLI setup: mesh-spec parsing + policy wiring.

``parse_mesh`` validates a ``--mesh`` spec and raises a clean, actionable
``ValueError`` (the JAX package's texts; "present" counts the ranks of
the process group, one without one); ``resolve_mesh_and_policy`` turns
that into ``parser.error`` (usage + exit 2) when called from a CLI.
Every architecture shards on every mesh the rules admit.

Policy under a mesh: the JAX package passes ``distributed=True`` to the
policy of any mesh larger than one device, which limits dispatch to the
library candidates (its Pallas kernels cannot run inside a partitioned
program).  Each rank of the port runs a local program on its own pieces,
so its launchers pass ``distributed=False`` and the CUDA kernels run on
every rank.
"""

from __future__ import annotations

import os

from repro_torch.core.engine import policy_from_spec
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh

__all__ = [
    "MESH_SPEC_HELP",
    "parse_mesh",
    "add_mesh_argument",
    "setup_distributed",
    "resolve_mesh_and_policy",
]

MESH_SPEC_HELP = (
    "mesh spec: DATAxMODEL with two positive integers (e.g. 1x1, 2x4) "
    "or 'production'"
)


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def parse_mesh(spec: str):
    """Build a mesh from a CLI spec.  Raises ``ValueError`` with the spec
    grammar on anything malformed -- never a bare ``int()`` traceback."""
    spec = str(spec).strip()
    if not spec:
        raise ValueError(f"empty mesh spec ({MESH_SPEC_HELP})")
    if spec == "production":
        shape = make_production_mesh().devices_shape
        spec = "x".join(map(str, shape))
    parts = spec.lower().split("x")
    if len(parts) != 2 or not all(p.strip().isdigit() for p in parts):
        raise ValueError(f"malformed mesh spec {spec!r} ({MESH_SPEC_HELP})")
    data, model = (int(p) for p in parts)
    if data < 1 or model < 1:
        raise ValueError(
            f"mesh axes must be positive, got {data}x{model} "
            f"({MESH_SPEC_HELP})"
        )
    n = _world_size()
    if data * model > n:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices; "
            f"{n} present ({MESH_SPEC_HELP})"
        )
    return make_local_mesh(data, model)


def add_mesh_argument(parser) -> None:
    """Attach the shared ``--mesh`` and ``--dist-backend`` options to an
    argparse parser."""
    parser.add_argument("--mesh", default="1x1", help=MESH_SPEC_HELP)
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                        help="process-group backend under torch.distributed.run (default: "
                             "nccl on cuda, gloo on cpu); gloo lets ranks share a card")


def setup_distributed(args):
    """(device, owned): the device this rank runs on, and whether this call
    initialised the process group (the caller then destroys it).

    Under ``python -m torch.distributed.run`` (``WORLD_SIZE`` > 1 in the
    environment) this initialises the process group from the environment;
    a caller that initialised one already keeps it.  Each rank takes
    ``cuda:LOCAL_RANK``; when a node's ranks outnumber its cards this
    raises, unless the backend is gloo and named (``--dist-backend
    gloo``, or a gloo group the caller made): then ranks share cards,
    round robin.  NCCL refuses two ranks on one card."""
    import torch
    import torch.distributed as dist

    from repro_torch import resolve_device

    dev = resolve_device(args.device)
    owned = not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1
    if not (owned or dist.is_initialized()):
        return dev, False
    named = getattr(args, "dist_backend", None)
    if owned:
        backend = named or ("nccl" if dev.type == "cuda" else "gloo")
    else:
        backend = dist.get_backend()
        named = named or (backend if backend == "gloo" else None)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         dist.get_world_size() if dist.is_initialized()
                                         else os.environ["WORLD_SIZE"]))
        if local_world > cards and not (backend == "gloo" and named == "gloo"):
            raise ValueError(
                f"{local_world} ranks on a node with {cards} CUDA card(s): each rank needs a "
                "card of its own, or name the gloo backend (--dist-backend gloo) to let "
                "ranks share cards")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    if owned:
        dist.init_process_group(backend, init_method="env://")
    return dev, owned


def resolve_mesh_and_policy(args, parser=None):
    """(mesh, policy) from parsed ``--mesh``/``--policy`` args.  With a
    ``parser``, malformed specs exit via ``parser.error`` (clean usage
    message) instead of a traceback."""
    try:
        mesh = parse_mesh(args.mesh)
        policy = policy_from_spec(args.policy, distributed=False,
                                  device=getattr(args, "device", "cuda"))
    except (ValueError, KeyError) as e:
        if parser is not None:
            parser.error(str(e))
        raise
    return mesh, policy
