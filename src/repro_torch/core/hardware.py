"""Hardware descriptors — the paper's Table III, for the port's devices.

The paper's 5 GPU features ``(gm, sm, cc, mbw, l2c)`` map to:

  gm  -> mem_gib       device memory (HBM / host RAM), GiB
  sm  -> num_cores     streaming multiprocessors (host cores on the CPU)
  cc  -> clock_mhz     core clock
  mbw -> mem_bw_gbps   memory bandwidth, GB/s  (paper used bus width; the
                       bandwidth is the architecture-portable equivalent)
  l2c -> sram_kib      L2 cache, KiB

``peak_tflops``/``ici_gbps`` are *not* features (the paper uses exactly 5
hardware dims); they feed the analytic cost model (``core/simulate.py``).

``H100`` holds datasheet values.  ``device_spec(device)`` describes the
card a program actually runs on: memory, SM count, clock and L2 size come
from ``torch.cuda.get_device_properties``, the peaks from the datasheet.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Tuple

__all__ = [
    "HardwareSpec",
    "H100",
    "SIMULATED_CHIPS",
    "host_spec",
    "device_spec",
    "known_specs",
]


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    mem_gib: float
    num_cores: int
    clock_mhz: float
    mem_bw_gbps: float
    sram_kib: float
    # cost-model-only attributes (not classifier features):
    peak_tflops_bf16: float
    peak_tflops_f32: float
    ici_gbps: float = 50.0
    launch_overhead_us: float = 2.0
    transpose_bw_frac: float = 0.80  # paper [20]: out-of-place hits ~80% peak

    def features(self) -> Tuple[float, float, float, float, float]:
        """The paper's 5 hardware feature dims."""
        return (
            self.mem_gib,
            float(self.num_cores),
            self.clock_mhz,
            self.mem_bw_gbps,
            self.sram_kib,
        )


# Datasheet values of an NVIDIA H100 80GB HBM3 (SXM), 700 W: 80 GB of HBM3
# at 3350 GB/s, 132 SMs, 1980 MHz boost clock, 50 MB of L2, bf16 dense
# 989 TFLOP/s on the tensor cores, f32 67 TFLOP/s outside them, NVLink
# 900 GB/s.  None of these was measured.
H100 = HardwareSpec(
    name="h100",
    mem_gib=80.0,
    num_cores=132,
    clock_mhz=1980.0,
    mem_bw_gbps=3350.0,
    sram_kib=50 * 1024,
    peak_tflops_bf16=989.0,
    peak_tflops_f32=67.0,
    ici_gbps=900.0,
)

# The analytic dataset's devices (the paper used two GPUs).
SIMULATED_CHIPS: Dict[str, HardwareSpec] = {c.name: c for c in (H100,)}


def host_spec() -> HardwareSpec:
    """Best-effort descriptor of the *current* host (for measured-CPU data)."""
    ncpu = os.cpu_count() or 1
    mem_gib = 16.0
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemTotal"):
                    mem_gib = float(line.split()[1]) / (1024**2)
                    break
    except OSError:
        pass
    clock = 2000.0
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if "cpu MHz" in line:
                    clock = float(line.split(":")[1])
                    break
    except OSError:
        pass
    return HardwareSpec(
        name="host_cpu",
        mem_gib=round(mem_gib, 1),
        num_cores=ncpu,
        clock_mhz=clock,
        mem_bw_gbps=50.0,
        sram_kib=1024.0,
        peak_tflops_bf16=ncpu * 0.05,
        peak_tflops_f32=ncpu * 0.05,
        ici_gbps=10.0,
    )


def device_spec(device="cuda") -> HardwareSpec:
    """Descriptor of the device a tensor on ``device`` lives on: the host's
    for a CPU device; for a CUDA device, the card's memory, SM count,
    clock and L2 size as ``torch.cuda.get_device_properties`` reports them
    (a property this torch build lacks keeps the H100 datasheet value) and
    the H100 datasheet's peaks.  The name is the card's, e.g.
    ``cuda_nvidia_h100_80gb_hbm3``."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return host_spec()
    props = torch.cuda.get_device_properties(dev)
    clock_khz = getattr(props, "clock_rate", 0)
    mem_khz = getattr(props, "memory_clock_rate", 0)
    bus_bits = getattr(props, "memory_bus_width", 0)
    l2 = getattr(props, "L2_cache_size", 0)
    return HardwareSpec(
        name="cuda_" + re.sub(r"[^a-z0-9]+", "_", props.name.lower()).strip("_"),
        mem_gib=round(props.total_memory / 2**30, 1),
        num_cores=props.multi_processor_count,
        clock_mhz=clock_khz / 1e3 if clock_khz else H100.clock_mhz,
        # double data rate: two transfers per memory clock
        mem_bw_gbps=(2.0 * mem_khz * 1e3 * bus_bits / 8 / 1e9
                     if mem_khz and bus_bits else H100.mem_bw_gbps),
        sram_kib=l2 / 1024 if l2 else H100.sram_kib,
        peak_tflops_bf16=H100.peak_tflops_bf16,
        peak_tflops_f32=H100.peak_tflops_f32,
        ici_gbps=H100.ici_gbps,
    )


def known_specs() -> Dict[str, HardwareSpec]:
    """Every descriptor a stored name can resolve to: the analytic chips,
    this host, and the current CUDA card when there is one."""
    import torch

    specs = dict(SIMULATED_CHIPS)
    host = host_spec()
    specs[host.name] = host
    if torch.cuda.is_available():
        card = device_spec("cuda")
        specs[card.name] = card
    return specs
