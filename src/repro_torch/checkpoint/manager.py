"""Fault-tolerant checkpointing: atomic, keep-N, async.

  * atomic: write to ``step_N.tmp`` then ``os.replace`` -- a crash
    mid-save never corrupts the latest checkpoint.
  * keep-N: older checkpoints are removed after each save.
  * async: ``save_async`` copies the state to host memory synchronously
    and writes it on a background thread, overlapping training.
  * restore places every tensor on the device and dtype of the matching
    leaf of the state it restores into.

A checkpoint is a directory ``step_N`` with ``tensors.pt`` (``torch.save``
of a flat ``{"path/to/leaf": CPU tensor}`` dict) and ``meta.json``; it is
valid iff ``meta.json`` exists and its leaf count matches.  ``restore``
scans newest to oldest and skips invalid ones (torn writes at a crash).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _items(tree, prefix: str = ""):
    """(path, leaf) pairs of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _flatten(tree) -> Dict[str, torch.Tensor]:
    """A host copy of every leaf, keyed by its path."""
    return {path: torch.as_tensor(leaf).detach().to("cpu", copy=True)
            for path, leaf in _items(tree)}


def _unflatten_into(tree_like, flat: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree_like, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/") for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten_into(v, flat, f"{prefix}{i}/")
                               for i, v in enumerate(tree_like))
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    ref = torch.as_tensor(tree_like)
    arr = flat[key]
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"shape mismatch for {key!r}: ckpt {tuple(arr.shape)} vs "
                         f"model {tuple(ref.shape)}")
    return arr.to(device=ref.device, dtype=ref.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save -------------------------------------------------------------
    def _write(self, step: int, flat: Dict[str, torch.Tensor], meta: Dict) -> None:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        torch.save(flat, os.path.join(tmp, "tensors.pt"))
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        if os.path.isdir(final):  # a second save of the same step
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _snapshot(self, step: int, state, extra_meta: Optional[Dict]):
        flat = _flatten(state)
        meta = {"step": step, "n_leaves": len(flat), "time": time.time()}
        meta.update(extra_meta or {})
        return flat, meta

    def save(self, step: int, state, extra_meta: Optional[Dict] = None) -> None:
        self._write(step, *self._snapshot(step, state, extra_meta))

    def save_async(self, step: int, state, extra_meta: Optional[Dict] = None) -> None:
        self.wait()  # one save in flight at a time
        flat, meta = self._snapshot(step, state, extra_meta)  # synchronous copy
        self._thread = threading.Thread(target=self._write, args=(step, flat, meta))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore ----------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None) -> Tuple[Any, int]:
        """Restore into the structure, devices and dtypes of ``state_like``;
        returns (state, step)."""
        candidates = self.steps()
        if step is not None:
            candidates = [s for s in candidates if s == step]
        if not candidates:
            raise FileNotFoundError(f"no valid checkpoint in {self.dir}")
        for s in reversed(candidates):
            path = os.path.join(self.dir, f"step_{s}")
            try:
                with open(os.path.join(path, "meta.json")) as fh:
                    meta = json.load(fh)
                flat = torch.load(os.path.join(path, "tensors.pt"), weights_only=True)
                if len(flat) != meta["n_leaves"]:
                    raise ValueError("leaf count mismatch")
                return _unflatten_into(state_like, flat), s
            except Exception as e:  # torn or invalid: try an older one
                print(f"[ckpt] skipping invalid step_{s}: {e}")
        raise FileNotFoundError(f"no restorable checkpoint in {self.dir}")

    # -- gc ---------------------------------------------------------------
    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)
