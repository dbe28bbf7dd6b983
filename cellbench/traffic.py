"""The general traffic generator.  A traffic mix is a JSON file of
parameters under ``traffic/``; everything here draws from ``--seed``.

Training feeds: step ``i``'s rows are drawn on the device from a
generator seeded by (seed, i), so every step's rows differ and the
reference can draw any step again.

Serving: requests come in blocks of ``block``.  A block is one draw of
that many requests, each drawn alone: a prompt length from the clipped
log-normal, an output length uniform over its range, and a gap before
it from the mix's arrival process (``poisson``: exponential gaps;
``gamma``: gamma gaps of the given shape, burstier than Poisson below
shape 1), the gaps scaled so that the block lasts ``block / rate``
seconds.  The draw comes from the mix's own ``pool_seed``, so every run
offers the same requests at the same times: the arrivals, bursts and
all, are one fixed trace.  The run's seed orders the block's prompt
lengths and output lengths, each apart, anew in every block, and draws
the prompts' tokens, uniform over the vocabulary.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

__all__ = ["derive", "fcn_batch", "lm_batch", "Arrival", "arrivals", "prompt_tokens"]


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose, from the run's seed (any integer)."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _gen(device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *parts))


def fcn_batch(seed: int, step: int, dims, batch: int, device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s rows of the synthetic FCN task: inputs N(0, 1) and
    labels uniform over the classes."""
    g = _gen(device, seed, "fcn", step)
    x = torch.randn(batch, dims[0], generator=g, device=device, dtype=torch.float32)
    labels = torch.randint(0, dims[-1], (batch,), generator=g, device=device)
    return {"x": x, "labels": labels}


def lm_batch(seed: int, step: int, vocab: int, batch: int, seq: int, device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s ``batch`` packed sequences of ``seq`` tokens and their
    next-token labels, tokens uniform over the vocabulary."""
    g = _gen(device, seed, "lm", step)
    t = torch.randint(0, vocab, (batch, seq + 1), generator=g, device=device)
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


@dataclass(frozen=True)
class Arrival:
    index: int
    due_s: float  # offset from the window's start
    prompt_len: int
    max_new: int


def _block(mix: Dict) -> Tuple[List[int], List[int], List[float]]:
    """The prompt lengths, output lengths and gaps of ``mix``'s block."""
    n = int(mix["block"])
    p, o, a = mix["prompt"], mix["output"], mix["arrivals"]
    rng = np.random.default_rng(int(mix["pool_seed"]))
    prompts = np.clip(np.rint(rng.lognormal(math.log(p["median"]), p["sigma"], n)),
                      p["min"], p["max"]).astype(int)
    outs = rng.integers(o["min"], o["max"] + 1, n)
    if a["process"] == "poisson":
        gaps = rng.exponential(1.0, n)
    elif a["process"] == "gamma":
        gaps = rng.gamma(float(a["shape"]), 1.0, n)
    else:
        raise ValueError(f"unknown arrival process {a['process']!r}")
    gaps *= n / float(mix["rate_per_s"]) / gaps.sum()
    return [int(x) for x in prompts], [int(x) for x in outs], [float(x) for x in gaps]


def arrivals(mix: Dict, seed: int) -> Iterator[Arrival]:
    """The open-loop schedule of ``mix``, endless: each block's gaps in
    the order drawn, its prompt lengths and output lengths ordered apart
    by the seed."""
    prompts, outs, gaps = _block(mix)
    n = len(prompts)
    t, i, blk = 0.0, 0, 0
    while True:
        rng = np.random.default_rng(derive(seed, "block", blk))
        pp, oo = rng.permutation(n), rng.permutation(n)
        for j in range(n):
            t += gaps[j]
            yield Arrival(i, t, prompts[pp[j]], outs[oo[j]])
            i += 1
        blk += 1


def prompt_tokens(seed: int, index: int, length: int, vocab: int) -> np.ndarray:
    rng = np.random.default_rng(derive(seed, "prompt", index))
    return rng.integers(0, vocab, size=length, dtype=np.int64).astype(np.int32)
