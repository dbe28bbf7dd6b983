"""Tiny stand-ins of the cells' configurations and traffic, for running the
harness on the CPU: the same drivers, files and checks, at sizes a test
run holds.  ``CHECK_SIZES`` are wider serving sizes at which the
served-token check separates the control and the faults from sound runs
under the cell's own limit (logits grow with the width)."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

from cellbench import harness
from cellbench.trace import Tracer

ROOT = Path(__file__).resolve().parents[2]

TINY_CFG = {
    "fcn-synthetic-3h": {"input_dim": 48, "hidden": [32, 32, 32], "output_dim": 40},
    "h2o-danube3-4b-12L": {"hidden_size": 64, "num_attention_heads": 4,
                           "num_key_value_heads": 2, "head_dim": 16,
                           "intermediate_size": 96, "vocab_size": 256,
                           "num_hidden_layers": 2, "sliding_window": 24,
                           "torch_dtype": "float32"},
    "h2o-danube3-4b": {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
                       "head_dim": 16, "intermediate_size": 96, "vocab_size": 256,
                       "num_hidden_layers": 2, "torch_dtype": "float32"},
}
TINY_MIX = {
    "fcn-train-b4096": {"batch": 16},
    "lm-train-8x2048": {"batch": 2, "seq": 16},
    "docqa-open": {"slots": 4, "prompt_bucket": 24, "rate_per_s": 40.0, "block": 20,
                   "prompt": {"median": 10, "sigma": 0.6, "min": 3, "max": 20},
                   "output": {"min": 2, "max": 4}, "sample": {"requests": 3}},
    "docqa-bursty-over": {"slots": 4, "prompt_bucket": 24, "rate_per_s": 400.0, "block": 8,
                          "max_queue": 4000,
                          "prompt": {"median": 10, "sigma": 0.6, "min": 3, "max": 20},
                          "output": {"min": 2, "max": 4}, "sample": {"requests": 3}},
}
CHECK_SIZES = {
    "cfg": {"hidden_size": 1024, "num_attention_heads": 8, "num_key_value_heads": 2,
            "head_dim": 128, "intermediate_size": 2048, "vocab_size": 1024,
            "num_hidden_layers": 2, "torch_dtype": "float32"},
    "mix": {"slots": 4, "prompt_bucket": 64, "rate_per_s": 20.0, "block": 20,
            "prompt": {"median": 30, "sigma": 0.6, "min": 8, "max": 60},
            "output": {"min": 4, "max": 32}, "sample": {"requests": 12}},
}
# short answers, so that requests finish inside a short window on a busy CPU
CHECK_SIZES["short_mix"] = dict(CHECK_SIZES["mix"], output={"min": 4, "max": 8})


def tiny_context(cell: str, seed: int = 7, seconds: float = 0.5, trace: bool = False,
                 control=None, cfg=None, mix=None, root: Path = ROOT) -> harness.Context:
    """A CPU context for ``cell`` of ``root``'s BENCHMARK.json at tiny sizes
    (or at ``cfg`` and ``mix`` over the cell's own files)."""
    found = copy.deepcopy(harness.load_cell(cell, root))
    found["cfg"].update(cfg if cfg is not None else TINY_CFG[found["cell"]["config"]])
    found["mix"].update(mix if mix is not None else TINY_MIX[found["cell"]["traffic"]])
    return harness.Context(seed=seed, seconds=seconds, trace=trace, device="cpu",
                           t_start=time.perf_counter(), tracer=Tracer(trace), control=control,
                           **found)


def run_tiny(ctx: harness.Context, root: Path = ROOT) -> dict:
    """The driver's run and the result line it prints, as JSON carries it."""
    from cellbench import run

    outcome = harness.driver_module(ctx.mix).run(ctx)
    line = json.loads(json.dumps(run.result(ctx, outcome, "cpu", root)))
    return {"outcome": outcome, "line": line}
