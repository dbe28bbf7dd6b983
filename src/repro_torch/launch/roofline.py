"""Roofline analysis from the dry run's per-rank costs.

Three terms, in seconds, per (arch x shape x mesh):

  compute    = FLOPs_per_device / peak_FLOP/s
  memory     = bytes_per_device / HBM_bw
  collective = effective_collective_bytes_per_device / link_bw

The per-device totals come from ``launch/accounting.py``, which runs one
rank's step on meta tensors; the collective bytes are what the wrappers
of ``distributed/collectives.py`` record, with the JAX package's ring
conventions (all-reduce 2(S-1)/S x result, all-gather (S-1)/S x result,
reduce-scatter (S-1) x result, S the group's size).  The JAX package's
``roofline(compiled)`` and ``parse_collectives`` read XLA artefacts and
have no counterpart here.

Hardware constants, ``HW_H100``: an NVIDIA H100 80GB HBM3 (SXM) from its
datasheet, not measured -- dense bf16 989 TFLOP/s and HBM3 3.35 TB/s
(``core/hardware.py::H100``).  The link rate is the slowest hop a mesh's
groups cross: NVLink 4 gives 450 GB/s per direction between the 8 cards
of one node (900 GB/s bidirectional), and across nodes each card has one
400 Gb/s NDR InfiniBand adapter, 50 GB/s per direction.  The 16 x 16
mesh's ``model`` axis spans two 8-card nodes, so its collectives are
costed at 50 GB/s; a mesh of at most 8 ranks stays inside a node.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core.hardware import H100

__all__ = ["HW_H100", "NVLINK_GBPS", "IB_GBPS", "NODE_CARDS", "link_gbps", "CollectiveStats",
           "RooflineReport", "roofline_from_costs", "model_flops_for_cell"]

NODE_CARDS = 8  # H100 SXM cards joined by NVLink in one node
NVLINK_GBPS = 450e9  # NVLink 4, bytes/s per direction
IB_GBPS = 50e9  # one 400 Gb/s NDR adapter per card, bytes/s per direction

HW_H100 = {
    "peak_flops_bf16": H100.peak_tflops_bf16 * 1e12,
    "hbm_gbps": H100.mem_bw_gbps * 1e9,
    "link_gbps": IB_GBPS,
}


def link_gbps(mesh) -> float:
    """The slowest hop the mesh's groups cross: NVLink inside one node,
    the InfiniBand adapter once the mesh spans nodes (ranks are laid out
    model-fastest, so any axis of a mesh of more than 8 ranks crosses a
    node boundary, or shares a node with one that does)."""
    return NVLINK_GBPS if mesh.size <= NODE_CARDS else IB_GBPS


@dataclass
class CollectiveStats:
    effective_bytes: float = 0.0
    result_bytes: float = 0.0
    count: int = 0
    by_kind: Dict[str, float] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)


@dataclass
class RooflineReport:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    collectives: Optional[CollectiveStats] = None
    memory_stats: Optional[Dict[str, float]] = None

    def to_dict(self) -> Dict:
        d = {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes": self.collective_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
        }
        if self.collectives:
            d["collective_by_kind"] = self.collectives.by_kind
            d["collective_counts"] = self.collectives.count_by_kind
        if self.memory_stats:
            d["memory"] = self.memory_stats
        return d


def roofline_from_costs(
    costs: Dict[str, float],
    n_chips: int,
    model_flops_global: float = 0.0,
    hw: Dict[str, float] = HW_H100,
    memory_stats: Optional[Dict[str, float]] = None,
) -> RooflineReport:
    """Three terms from per-device totals (``accounting.py``)."""
    flops = costs.get("flops", 0.0)
    byts = costs.get("bytes", 0.0)
    coll = costs.get("coll_bytes", 0.0)
    t_c = flops / hw["peak_flops_bf16"]
    t_m = byts / hw["hbm_gbps"]
    t_x = coll / hw["link_gbps"]
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    useful = (
        model_flops_global / (flops * n_chips) if model_flops_global and flops else 0.0
    )
    cs = CollectiveStats(
        effective_bytes=coll,
        by_kind={
            k[len("coll_"):]: v
            for k, v in costs.items()
            if k.startswith("coll_") and k != "coll_bytes"
        },
    )
    return RooflineReport(
        flops_per_device=flops,
        bytes_per_device=byts,
        collective_bytes=coll,
        t_compute=t_c,
        t_memory=t_m,
        t_collective=t_x,
        bottleneck=bottleneck,
        model_flops=model_flops_global,
        useful_ratio=useful,
        collectives=cs,
        memory_stats=memory_stats,
    )


def model_flops_for_cell(cfg, shape) -> float:
    """MODEL_FLOPS: 6*N*D for train (N=active params, D=tokens);
    2*N*D for inference forward passes."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
