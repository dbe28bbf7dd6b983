"""Concurrency/lock-discipline pass (CC501–CC505), stdlib-AST only.

The serving engine, its KV-cache pool, the measurement cache, the fault
ledger and the lint's own parse cache share mutable state across
threads.  The locking convention is declared in the
source itself: a ``# guarded-by: <lock>`` comment on the line that
declares an attribute (module global or ``self.attr`` in ``__init__``)
promises every mutation happens inside ``with <that lock>``.  This pass
makes the promise checkable:

  CC501  a guarded attribute is mutated (assignment, augmented
         assignment, item store, ``del``, or a mutating method call like
         ``append``/``pop``/``update``) outside a ``with <lock>`` block.
         Declaration sites are exempt, as is ``__init__`` for instance
         attributes (construction happens-before publication) and module
         top level for globals (import lock).
  CC502  a guarded-by annotation names a lock that is never defined in
         the scope it guards
  CC503  ``ContextVar.set`` without a matching ``reset`` in a
         ``finally`` block in the same function (or with the token
         discarded) -- the scoped-policy/fault machinery relies on
         set/reset pairing to stay re-entrant
  CC504  a ``threading.Thread`` is spawned in a module that never joins
         any thread
  CC505  a bare ``lock.acquire()`` call -- an exception between acquire
         and release deadlocks the process; use ``with lock:``

Deliberately depth-1: only ``self.attr`` and module-global names are
tracked.  ``other_obj.attr`` mutations (a cache populated by its
classmethod constructor before publication, ``self.kv.lengths`` resets
during single-threaded warmup) are out of scope by design.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .findings import Finding

__all__ = ["check_file", "lint_paths", "run", "DEFAULT_ROOTS"]

DEFAULT_ROOTS = ("src/repro_torch",)

_GUARD_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")

# method names that mutate their receiver in place
_MUTATORS = frozenset(
    {
        "append", "appendleft", "extend", "insert", "remove", "pop",
        "popleft", "popitem", "clear", "update", "setdefault", "add",
        "discard", "sort", "reverse",
    }
)


def _self_attr(node) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _guard_lines(source: str) -> Dict[int, str]:
    lines = {}
    for i, line in enumerate(source.splitlines(), start=1):
        match = _GUARD_RE.search(line)
        if match:
            lines[i] = match.group(1)
    return lines


class _Scope:
    """Everything declared guarded within one scope ('' = module, else a
    class name): attr -> (lock name, declaration line)."""

    def __init__(self):
        self.guards: Dict[str, Tuple[str, int]] = {}
        self.decl_lines: set = set()


def _collect_guards(tree, guard_lines) -> Tuple[Dict[str, _Scope], set, Dict[str, set]]:
    """Map scope -> _Scope, plus (module names, class -> self attrs) for
    CC502 lock-existence checks."""
    scopes: Dict[str, _Scope] = {"": _Scope()}
    module_names: set = set()
    class_attrs: Dict[str, set] = {}

    def targets_of(stmt):
        if isinstance(stmt, ast.Assign):
            return stmt.targets
        if isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            return [stmt.target]
        return []

    for stmt in tree.body:
        for tgt in targets_of(stmt):
            if isinstance(tgt, ast.Name):
                module_names.add(tgt.id)
                lock = guard_lines.get(stmt.lineno)
                if lock:
                    scopes[""].guards[tgt.id] = (lock, stmt.lineno)
                    scopes[""].decl_lines.add(stmt.lineno)

    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        scope = scopes.setdefault(node.name, _Scope())
        attrs = class_attrs.setdefault(node.name, set())
        for sub in ast.walk(node):
            for tgt in targets_of(sub) if isinstance(
                sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)
            ) else []:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                attrs.add(attr)
                lock = guard_lines.get(sub.lineno)
                if lock:
                    scope.guards[attr] = (lock, sub.lineno)
                    scope.decl_lines.add(sub.lineno)
    return scopes, module_names, class_attrs


def _with_item_names(node: ast.With) -> List[str]:
    out = []
    for item in node.items:
        expr = item.context_expr
        # unwrap lock-factory calls like `with lock_for(key):`
        out.append(ast.unparse(expr))
    return out


def _lock_held(with_stack: Sequence[List[str]], lock: str, in_class: bool) -> bool:
    wanted = {lock, f"self.{lock}"} if in_class else {lock}
    for frame in with_stack:
        for name in frame:
            if name in wanted:
                return True
    return False


def check_file(
    path: str,
    relpath: str,
    tree: Optional[ast.AST] = None,
    source: Optional[str] = None,
) -> List[Finding]:
    if source is None:
        with open(path) as fh:
            source = fh.read()
    if tree is None:
        tree = ast.parse(source, filename=path)

    guard_lines = _guard_lines(source)
    scopes, module_names, class_attrs = _collect_guards(tree, guard_lines)
    findings: List[Finding] = []

    # CC502: annotated locks must exist in their scope
    for scope_name, scope in scopes.items():
        for attr, (lock, line) in scope.guards.items():
            if scope_name == "":
                defined = lock in module_names
            else:
                defined = lock in class_attrs.get(scope_name, set()) or (
                    lock in module_names
                )
            if not defined:
                findings.append(
                    Finding(
                        rule="CC502",
                        path=relpath,
                        line=line,
                        message=(
                            f"'# guarded-by: {lock}' on "
                            f"{scope_name or '<module>'}.{attr}: no such "
                            "lock is defined in that scope"
                        ),
                        context=f"cc502:{scope_name}.{attr}:{lock}",
                    )
                )

    # module-level ContextVars for CC503
    ctxvars: set = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            fn = stmt.value.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", ""
            )
            if fname == "ContextVar":
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        ctxvars.add(tgt.id)

    has_join = any(
        isinstance(n, ast.Call)
        and isinstance(n.func, ast.Attribute)
        and n.func.attr == "join"
        for n in ast.walk(tree)
    )

    def resolve(expr, class_name) -> Optional[Tuple[str, str]]:
        """Mutated expression -> (scope, attr) if it's a guarded target."""
        if isinstance(expr, ast.Subscript):
            return resolve(expr.value, class_name)
        if isinstance(expr, ast.Name) and expr.id in scopes[""].guards:
            return ("", expr.id)
        attr = _self_attr(expr)
        if (
            attr is not None
            and class_name
            and class_name in scopes
            and attr in scopes[class_name].guards
        ):
            return (class_name, attr)
        return None

    def report_cc501(node, scope_name, attr, lock, func_name):
        findings.append(
            Finding(
                rule="CC501",
                path=relpath,
                line=node.lineno,
                message=(
                    f"{'self.' if scope_name else ''}{attr} is declared "
                    f"'# guarded-by: {lock}' but is mutated here outside "
                    f"'with {lock}'"
                ),
                context=f"cc501:{func_name}:{scope_name}.{attr}",
            )
        )

    def check_mutation(node, expr, class_name, func_name, with_stack, in_init):
        key = resolve(expr, class_name)
        if key is None:
            return
        scope_name, attr = key
        lock, _decl = scopes[scope_name].guards[attr]
        if node.lineno in scopes[scope_name].decl_lines:
            return
        if func_name is None and scope_name == "":
            return  # module top level: import-lock serialised
        if in_init and scope_name != "":
            return  # __init__ happens-before publication
        if _lock_held(with_stack, lock, in_class=bool(scope_name)):
            return
        report_cc501(node, scope_name, attr, lock, func_name or "<module>")

    def walk(node, class_name, func_name, with_stack, in_init):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name, func_name, with_stack, False)
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                init = class_name != "" and child.name == "__init__"
                _check_function(child, class_name, child.name, init)
                walk(child, class_name, child.name, [], init)
                continue
            if isinstance(child, (ast.With, ast.AsyncWith)):
                frame = _with_item_names(child)
                walk(child, class_name, func_name, list(with_stack) + [frame],
                     in_init)
                continue
            if isinstance(child, ast.Assign):
                for tgt in child.targets:
                    check_mutation(child, tgt, class_name, func_name,
                                   with_stack, in_init)
            elif isinstance(child, (ast.AugAssign, ast.AnnAssign)):
                check_mutation(child, child.target, class_name, func_name,
                               with_stack, in_init)
            elif isinstance(child, ast.Delete):
                for tgt in child.targets:
                    check_mutation(child, tgt, class_name, func_name,
                                   with_stack, in_init)
            elif isinstance(child, ast.Call) and isinstance(
                child.func, ast.Attribute
            ):
                # mutator calls in any position, statement or expression
                # (`self.queue.append(r)`, `req = self.queue.popleft()`)
                if child.func.attr in _MUTATORS:
                    check_mutation(child, child.func.value, class_name,
                                   func_name, with_stack, in_init)
            walk(child, class_name, func_name, with_stack, in_init)

    def _check_function(fn_node, class_name, func_name, in_init):
        # CC503: ContextVar set/reset pairing
        sets_of: Dict[str, ast.Call] = {}
        discarded: Dict[str, ast.Call] = {}
        resets: set = set()
        finally_resets: set = set()
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                base = node.func.value
                if isinstance(base, ast.Name) and base.id in ctxvars:
                    if node.func.attr == "set":
                        sets_of.setdefault(base.id, node)
                    elif node.func.attr == "reset":
                        resets.add(base.id)
            if isinstance(node, ast.Expr) and isinstance(
                node.value, ast.Call
            ):
                call = node.value
                if (
                    isinstance(call.func, ast.Attribute)
                    and call.func.attr == "set"
                    and isinstance(call.func.value, ast.Name)
                    and call.func.value.id in ctxvars
                ):
                    discarded.setdefault(call.func.value.id, call)
            if isinstance(node, ast.Try) and node.finalbody:
                for sub in node.finalbody:
                    for inner in ast.walk(sub):
                        if (
                            isinstance(inner, ast.Call)
                            and isinstance(inner.func, ast.Attribute)
                            and inner.func.attr == "reset"
                            and isinstance(inner.func.value, ast.Name)
                        ):
                            finally_resets.add(inner.func.value.id)
        for var, call in sets_of.items():
            if var in discarded:
                findings.append(
                    Finding(
                        rule="CC503",
                        path=relpath,
                        line=call.lineno,
                        message=(
                            f"{var}.set(...) discards its token in "
                            f"{func_name}; the scope can never be reset"
                        ),
                        context=f"cc503:{func_name}:{var}",
                    )
                )
            elif var not in finally_resets:
                findings.append(
                    Finding(
                        rule="CC503",
                        path=relpath,
                        line=call.lineno,
                        message=(
                            f"{var}.set(...) in {func_name} has no "
                            f"{var}.reset(token) in a finally block"
                        ),
                        context=f"cc503:{func_name}:{var}",
                    )
                )
        # CC504 / CC505
        for node in ast.walk(fn_node):
            if not isinstance(node, ast.Call):
                continue
            fname = (
                node.func.attr
                if isinstance(node.func, ast.Attribute)
                else getattr(node.func, "id", "")
            )
            if fname == "Thread" and not has_join:
                findings.append(
                    Finding(
                        rule="CC504",
                        path=relpath,
                        line=node.lineno,
                        message=(
                            f"thread spawned in {func_name} but this "
                            "module never joins any thread (leak on "
                            "shutdown)"
                        ),
                        context=f"cc504:{func_name}",
                    )
                )
            elif fname == "acquire" and isinstance(node.func, ast.Attribute):
                findings.append(
                    Finding(
                        rule="CC505",
                        path=relpath,
                        line=node.lineno,
                        message=(
                            f"bare {ast.unparse(node.func.value)}.acquire() "
                            f"in {func_name}; use the 'with' form so "
                            "exceptions release the lock"
                        ),
                        context=f"cc505:{func_name}",
                    )
                )

    walk(tree, "", None, [], False)
    return findings


def lint_paths(
    roots: Sequence[str] = DEFAULT_ROOTS,
    repo_root: Optional[str] = None,
    cache=None,
) -> List[Finding]:
    if repo_root is None:
        from .lint import _repo_root

        repo_root = _repo_root()
    findings: List[Finding] = []
    for root in roots:
        absroot = os.path.join(repo_root, root)
        if not os.path.isdir(absroot):
            continue
        for dirpath, _dirnames, filenames in os.walk(absroot):
            for fname in sorted(filenames):
                if not fname.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fname)
                relpath = os.path.relpath(path, repo_root).replace(
                    os.sep, "/"
                )
                if cache is not None:
                    source, tree = cache.parse(path)
                else:
                    source, tree = None, None
                findings.extend(check_file(path, relpath, tree, source))
    return findings


def run(repo_root: Optional[str] = None, cache=None) -> List[Finding]:
    return lint_paths(DEFAULT_ROOTS, repo_root, cache)
