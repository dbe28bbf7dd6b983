"""Dispatch-bypass detector: the AST pass that keeps the op space closed.

Every GEMM-shaped contraction in the port's model and launch layers must
route through ``core.dispatch`` / ``core.dispatch_attention`` so the
selection policy governs it.  This pass walks the AST of those trees
(pure stdlib -- no torch import, no code execution) and flags the calls a
bypass would use:

  * ``torch.einsum`` (any call named ``einsum``) whose spec is
    GEMM-shaped (``DL001``): two or more operands with at least one
    genuinely *contracted* index -- an index appearing in more than one
    operand but not in the output.  Elementwise/broadcast einsums (no
    contracted index) and single-operand reductions are not matmuls and
    pass.
  * ``torch.matmul``, ``torch.mm``, ``torch.bmm``, ``torch.tensordot``,
    ``torch.addmm``, ``torch.baddbmm``, ``F.linear`` (any call of those
    names, methods too) and the ``@`` operator (``DL002``).

A dynamic (non-literal) einsum spec is flagged conservatively: the
linter cannot prove it is not a GEMM.

The finding's fingerprint context is the einsum spec (or call name), not
the line number, so a baseline entry survives edits elsewhere in the
file.  Known-accepted bypasses -- the MoE and Mamba SSD einsums, which
the JAX package leaves to ``jnp.einsum`` and whose contractions have no
dispatch op -- live in the committed baseline with a justification
each.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, List, Optional, Sequence, Tuple

from .findings import Finding

__all__ = [
    "DEFAULT_ROOTS",
    "einsum_is_gemm_shaped",
    "lint_file",
    "lint_paths",
    "run",
]

# Trees whose GEMMs must dispatch.  core/ and kernels/ are exempt by
# construction: they *implement* the candidates the policy selects over.
DEFAULT_ROOTS: Tuple[str, ...] = (
    os.path.join("src", "repro_torch", "models"),
    os.path.join("src", "repro_torch", "launch"),
)

# call names that are matmul primitives wherever they come from
_MATMUL_CALLS = ("matmul", "mm", "bmm", "tensordot", "addmm", "baddbmm", "linear")


def einsum_is_gemm_shaped(spec: str) -> bool:
    """True when an einsum spec performs a matmul-like contraction:
    >= 2 operands and at least one index contracted away (present in
    more than one operand, absent from the output)."""
    spec = spec.replace(" ", "")
    if "->" in spec:
        lhs, out = spec.split("->", 1)
    else:
        lhs, out = spec, None
    operands = lhs.split(",")
    if len(operands) < 2:
        return False
    if any("." in op for op in operands):  # ellipsis: batch dims only
        operands = [op.replace("...", "") for op in operands]
        out = out.replace("...", "") if out is not None else None
    if out is None:
        # implicit output: indices appearing exactly once, alphabetical
        from collections import Counter

        counts = Counter(i for op in operands for i in op)
        out = "".join(sorted(i for i, c in counts.items() if c == 1))
    shared = set()
    seen = set()
    for op in operands:
        shared |= seen & set(op)
        seen |= set(op)
    contracted = shared - set(out)
    return bool(contracted)


def _attr_name(func: ast.expr) -> str:
    """Trailing attribute/function name of a call target."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


class _BypassVisitor(ast.NodeVisitor):
    def __init__(self, relpath: str):
        self.relpath = relpath
        self.findings: List[Finding] = []

    def _add(self, rule: str, line: int, message: str, context: str) -> None:
        self.findings.append(
            Finding(
                rule=rule,
                path=self.relpath,
                line=line,
                message=message,
                context=context,
            )
        )

    def visit_Call(self, node: ast.Call) -> None:
        name = _attr_name(node.func)
        if name == "einsum":
            spec_node = node.args[0] if node.args else None
            if isinstance(spec_node, ast.Constant) and isinstance(
                spec_node.value, str
            ):
                spec = spec_node.value
                if einsum_is_gemm_shaped(spec):
                    self._add(
                        "DL001",
                        node.lineno,
                        f"GEMM-shaped einsum {spec!r} bypasses the dispatch "
                        "engine; route it through core.dispatch/"
                        "dispatch_attention or baseline it with a "
                        "justification",
                        f"einsum:{spec.replace(' ', '')}",
                    )
            else:
                self._add(
                    "DL001",
                    node.lineno,
                    "einsum with a dynamic spec cannot be proven "
                    "dispatch-free; route it through core.dispatch or "
                    "baseline it",
                    "einsum:<dynamic>",
                )
        elif name in _MATMUL_CALLS:
            self._add(
                "DL002",
                node.lineno,
                f"{name}() bypasses the dispatch engine; route it through "
                "core.dispatch/dispatch_attention or baseline it",
                f"call:{name}",
            )
        self.generic_visit(node)

    def visit_BinOp(self, node: ast.BinOp) -> None:
        if isinstance(node.op, ast.MatMult):
            self._add(
                "DL002",
                node.lineno,
                "the @ operator bypasses the dispatch engine; route it "
                "through core.dispatch/dispatch_attention or baseline it",
                "call:matmul-op",
            )
        self.generic_visit(node)


def lint_file(
    path: str, relpath: Optional[str] = None, cache=None
) -> List[Finding]:
    """All dispatch-bypass findings in one python file."""
    if cache is not None:
        _source, tree = cache.parse(path)
    else:
        with open(path) as fh:
            source = fh.read()
        tree = ast.parse(source, filename=path)
    visitor = _BypassVisitor((relpath or path).replace(os.sep, "/"))
    visitor.visit(tree)
    return visitor.findings


def lint_paths(
    roots: Iterable[str], repo_root: Optional[str] = None, cache=None
) -> List[Finding]:
    """Findings across every ``*.py`` under ``roots`` (files accepted
    too); paths in findings are relative to ``repo_root``."""
    findings: List[Finding] = []
    for root in roots:
        base = (
            os.path.join(repo_root, root)
            if repo_root and not os.path.isabs(root)
            else root
        )
        if os.path.isfile(base):
            files = [base]
        else:
            files = sorted(
                os.path.join(dirpath, fn)
                for dirpath, _, fns in os.walk(base)
                for fn in fns
                if fn.endswith(".py")
            )
        for fp in files:
            rel = os.path.relpath(fp, repo_root) if repo_root else fp
            findings.extend(lint_file(fp, rel, cache))
    return findings


def run(
    repo_root: str, roots: Sequence[str] = DEFAULT_ROOTS, cache=None
) -> List[Finding]:
    """The pass entry point the lint CLI calls."""
    return lint_paths(roots, repo_root=repo_root, cache=cache)
