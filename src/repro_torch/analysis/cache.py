"""Shared parsed-source cache for the AST lint passes.

The AST passes (dispatch bypass, concurrency) walk overlapping file
sets.  One ``SourceCache`` is created per lint invocation and threaded
through every pass, so each file is read and ``ast.parse``d once per run,
and the hit/miss counters feed the ``--stats`` line.

Thread-safe: the lint CLI runs the AST passes on worker threads beside the
registry pass, so two passes may request the same file concurrently (the
loser of the race re-parses; the dict stays consistent).
"""

from __future__ import annotations

import ast
import threading
from typing import Dict, Tuple

__all__ = ["SourceCache"]


class SourceCache:
    """``path -> (source, ast)`` memo shared across lint passes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._parsed: Dict[str, Tuple[str, ast.AST]] = {}  # guarded-by: _lock
        self.hits = 0
        self.misses = 0

    def parse(self, path: str) -> Tuple[str, ast.AST]:
        with self._lock:
            cached = self._parsed.get(path)
            if cached is not None:
                self.hits += 1
                return cached
        with open(path) as fh:
            source = fh.read()
        tree = ast.parse(source, filename=path)
        with self._lock:
            self.misses += 1
            self._parsed[path] = (source, tree)
        return source, tree

    def stats(self) -> str:
        return (
            f"{self.misses} file(s) parsed once, "
            f"{self.hits} re-parse(s) avoided"
        )
