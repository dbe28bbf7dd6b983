"""Distribution layer: sharding rules, the mesh context and every
collective the port issues, on ``torch.distributed``."""

from .collectives import (
    all_gather,
    all_reduce,
    broadcast,
    compressed_mean,
    compressed_psum,
    dequantize_int8,
    quantize_int8,
    reduce_scatter,
)
from .context import current_mesh, dp_axes, set_current_mesh, use_mesh
from .sharding import (
    P,
    PartitionSpec,
    batch_specs,
    cache_specs_tree,
    data_axes,
    opt_state_specs,
    param_specs,
    shard,
    unshard,
)

__all__ = [
    "param_specs",
    "opt_state_specs",
    "batch_specs",
    "cache_specs_tree",
    "data_axes",
    "shard",
    "unshard",
    "P",
    "PartitionSpec",
    "quantize_int8",
    "dequantize_int8",
    "compressed_psum",
    "compressed_mean",
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "broadcast",
    "set_current_mesh",
    "current_mesh",
    "use_mesh",
    "dp_axes",
]
