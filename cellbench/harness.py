"""The harness: finds a cell and everything it names by name, prepares the
environment, runs the cell's driver, and assembles the result line.

Files, by name:
  BENCHMARK.json               cells, configurations, metrics, bounds
  cellbench/configs/<c>.json   a configuration (its ``file`` in BENCHMARK.json)
  cellbench/traffic/<t>.json   a traffic mix; its ``driver`` names the driver
  cellbench/limits/<cell>.json the limits of the numbers ``correct`` is decided from
  cellbench/metrics/<m>.py     a per-layer metric's reader: ``read(r)``
  cellbench/drivers/<d>.py     a driver: ``run(ctx) -> Outcome``
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

__all__ = ["ROOT", "Context", "Outcome", "load_cell", "prepare_environment", "cell_metrics",
           "read_per_layer", "forbidden_loaded", "process_start"]


def process_start() -> float:
    """``time.perf_counter()``'s reading at this process's start (from
    /proc; the interpreter's own start-up counts as set-up)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


@dataclass
class Outcome:
    """What a driver hands back."""

    e2e: Dict[str, float]
    counters: Dict[str, Any]
    numbers: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    control_numbers: Dict[str, float] = field(default_factory=dict)


@dataclass
class Context:
    spec: Dict
    cell: Dict
    cfg: Dict
    mix: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float
    tracer: Any = None
    setup_s: Optional[float] = None
    control: Optional[str] = None  # a control read as well: a precision or a planted fault
    log: Callable[[str], None] = lambda msg: print(msg, file=sys.stderr, flush=True)
    phases: List = field(default_factory=list)

    def note(self, phase: str) -> None:
        """A part of set-up ends here (logged with ``setup_s``)."""
        self.phases.append((phase, time.perf_counter()))

    def mark_setup(self) -> None:
        """Set-up ends here: the next thing is the first timed step.
        Logs where set-up went, from the process's start."""
        now = time.perf_counter()
        self.setup_s = now - self.t_start
        parts, last = [], self.t_start
        for phase, at in self.phases + [("rest", now)]:
            parts.append(f"{phase} {at - last:.2f}")
            last = at
        self.log(f"setup_s {self.setup_s:.2f}: " + ", ".join(parts))


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Dict:
    """The cell ``name`` with its configuration, traffic and limits."""
    spec = _load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = _load_json(root / configs[cell["config"]]["file"])
    mix = _load_json(root / "cellbench" / "traffic" / f"{cell['traffic']}.json")
    limits = _load_json(root / "cellbench" / "limits" / f"{name}.json")
    return {"spec": spec, "cell": cell, "cfg": cfg, "mix": mix, "limits": limits}


def prepare_environment(root: Path = ROOT) -> None:
    """Fixed build and kernel-cache directories inside the checkout (so
    only a checkout's first run builds), the port's sources on the path,
    and no JAX pulled in by a library."""
    build = root / "build"
    for var, sub in (("REPRO_TORCH_BUILD_DIR", "repro_torch"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(build / "cellbench" / "autotune.json")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def driver_module(mix: Dict):
    return importlib.import_module(f"cellbench.drivers.{mix['driver']}")


def cell_metrics(spec: Dict, cell: str, group: str) -> List[Dict]:
    """The metrics of ``group`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports."""
    return [m for m in spec[group] if cell in m.get("workloads", [cell])]


def _reader(name: str, root: Path):
    path = root / "cellbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("cellbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_per_layer(ctx: Context, outcome: Outcome, trace, root: Path = ROOT) -> Dict[str, Dict]:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing to read returns None and the metric is left out."""
    r = SimpleNamespace(cell=ctx.cell["name"], cfg=ctx.cfg, mix=ctx.mix,
                        counters=outcome.counters, trace=trace)
    out = {}
    for m in cell_metrics(ctx.spec, ctx.cell["name"], "per_layer"):
        value = _reader(m["name"], root).read(r)
        if value is None:
            continue
        if m["unit"] == "%" and value > 105.0:
            raise ValueError(f"{m['name']} read {value:.2f} %: the work is counted too high "
                             "or the time leaves part of it out")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_loaded() -> List[str]:
    """Modules of JAX, Flax or the JAX package in this process."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)
