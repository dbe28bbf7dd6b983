"""Deterministic synthetic data pipelines, sharded by host -- numpy only, a
copy of the JAX package's, so that both packages see the same batches.

Restart-safety is the point: batch content is a pure function of
``(arch, step, host)`` — after a failure/restart (or an *elastic resize*,
where host count changes), the stream continues byte-identically from the
restored step with no data-order drift, so a resumed run ends where an
uninterrupted one does (tests/test_torch_train.py).

Token streams are a structured Markov-ish mixture (not iid uniform) so
losses move during the example runs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "make_train_batch"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """next-token stream with learnable structure (bigram-ish)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.RandomState(cfg.seed)
        self._perm = base.permutation(cfg.vocab)

    def _rng(self, step: int) -> np.random.RandomState:
        # keyed on (seed, step, host): deterministic, restart/elastic-safe
        return np.random.RandomState(
            (self.cfg.seed * 1_000_003 + step * 9_176 + self.cfg.host_id) % (2**31)
        )

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        B, S, V = cfg.host_batch, cfg.seq_len, cfg.vocab
        # structured stream: x_{t+1} = perm[x_t] with prob .7, else noise
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.randint(0, V, B)
        flips = rng.rand(B, S) < 0.3
        noise = rng.randint(0, V, (B, S))
        for t in range(S):
            follow = self._perm[toks[:, t]]
            toks[:, t + 1] = np.where(flips[:, t], noise[:, t], follow)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_train_batch(
    arch_cfg, seq_len: int, global_batch: int, step: int,
    n_hosts: int = 1, host_id: int = 0, seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Modality-aware synthetic batch for one host: the same arrays the JAX
    package's ``make_train_batch`` gives.  ``tokens``: tokens and labels;
    ``frames``: f32 frame embeddings (B, S, d_model) and labels; ``vlm``:
    f32 patch embeddings (B, prefix_len, d_model) and S - prefix_len text
    tokens and labels."""
    dcfg = DataConfig(arch_cfg.vocab, seq_len, global_batch, n_hosts, host_id, seed)
    rng = np.random.RandomState((seed * 7 + step * 13 + host_id) % (2**31))
    B = dcfg.host_batch
    if arch_cfg.input_mode == "tokens":
        return SyntheticLM(dcfg).batch(step)
    if arch_cfg.input_mode == "frames":
        lm = SyntheticLM(dcfg).batch(step)
        frames = rng.randn(B, seq_len, arch_cfg.d_model).astype(np.float32) * 0.02
        return {"frames": frames, "labels": lm["labels"]}
    if arch_cfg.input_mode != "vlm":
        raise ValueError(f"unknown input_mode {arch_cfg.input_mode!r}")
    st = seq_len - arch_cfg.prefix_len
    lm = SyntheticLM(
        DataConfig(arch_cfg.vocab, st, global_batch, n_hosts, host_id, seed)
    ).batch(step)
    patches = rng.randn(B, arch_cfg.prefix_len, arch_cfg.d_model).astype(np.float32) * 0.02
    return {"patches": patches, "tokens": lm["tokens"], "labels": lm["labels"]}
