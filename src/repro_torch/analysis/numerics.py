"""Numerics-accumulation pass: bf16 inputs must accumulate in f32.

The cuDNN low-precision lesson (PAPER.md / PAPERS.md): a half-precision
GEMM is only convergence-safe if the tensor cores accumulate in f32.  The
JAX package walks the jaxprs of its Pallas kernels for it.  The port's
kernels are CUDA C++, so this pass reads their sources
(``src/repro_torch/csrc/*.cu`` and ``*.cuh``) instead, and runs the
kernel arms' plain routes:

  NM401  every ``wgmma.mma_async`` / ``mma.sync.aligned`` PTX string whose
         A/B types are below f32 names an ``.f32`` D type (for
         ``mma.sync`` a C type too), and its asm output constraints are
         ``"+f"`` / ``"=f"``.  On the Python side, every kernel arm's plain
         route (the ``PALLAS_*`` and fused-attention candidates), run on
         bf16 CPU operands, reaches ``aten.mm`` / ``bmm`` / ``addmm`` /
         ``baddbmm`` only with f32 or f64 operands; and ``import
         repro_torch`` leaves cuBLAS's bf16 reduced-precision reduction
         off, which the library arms' f32 accumulation rests on.
  NM402  a variable that is the target of ``+=``, of ``= fmaf(...)`` or
         the D operand of an mma helper is declared ``float`` (or a float
         vector), register array or ``__shared__`` alike -- never a
         sub-f32 type, nor a template type that may be one.  Integers and
         pointer arithmetic are not accumulators and pass.  The port's form
         of the JAX package's f32 VMEM scratch rule.
  NM403  a downcast (``__float2bfloat16``, ``from_float<T>``,
         ``static_cast<__nv_bfloat16>``, ...) does not feed a compound
         assignment or an arithmetic expression, directly or through the
         variable it initialises: a downcast before the final accumulation
         throws away the mantissa the f32 accumulator exists to keep.  A
         downcast assigned to a bf16 store or operand tile is fine (the
         flash kernel's P before its PV mma), as is one widened straight
         back (``to_float(from_float<T>(x))``).

The source reader is a lexer over comments, string literals and brackets,
not a C++ front end: a name whose declaration it cannot find is left
alone rather than guessed.  The dynamic complement -- proving that no
kernel reads memory outside its operands -- is the poison sanitizer in
``sanitize.py`` (NM404, ``lint --sanitize``).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .findings import Finding

__all__ = ["TRACE_SHAPES", "lint_cuda_source", "check_plain_routes", "check_backend_flags",
           "run"]

# shapes to run the plain routes at: one aligned, one ragged cell from the
# contract grid
TRACE_SHAPES: Tuple[Tuple[int, int, int, int], ...] = (
    (256, 256, 256, 2),
    (96, 160, 224, 3),
)

_LOW_PTX = {"bf16", "f16", "tf32", "e4m3", "e5m2"}
_F32_CONSTRAINTS = {"+f", "=f"}
_MMA_RE = {
    "wgmma": re.compile(r"wgmma\.mma_async(?:\.sp)?\.sync\.aligned\.m\d+n\d+k\d+"
                        r"\.(\w+)\.(\w+)\.(\w+)"),
    "mma.sync": re.compile(r"(?<![\w.])mma\.sync\.aligned\.m\d+n\d+k\d+"
                           r"(?:\.(?:row|col)){0,2}(?:\.satfinite)?"
                           r"\.(\w+)\.(\w+)\.(\w+)\.(\w+)"),
}
_FLOAT_TYPES = {"float", "float1", "float2", "float3", "float4", "double", "double2",
                "double4"}
_LOW_TYPES = {"__nv_bfloat16", "__nv_bfloat162", "nv_bfloat16", "nv_bfloat162", "__half",
              "__half2", "half", "half2", "bf16", "bfloat16", "__nv_fp8_e4m3",
              "__nv_fp8_e5m2"}
_INT_TYPES = {"int", "unsigned", "long", "short", "char", "bool", "size_t", "ptrdiff_t",
              "int8_t", "int16_t", "int32_t", "int64_t", "uint8_t", "uint16_t", "uint32_t",
              "uint64_t", "uint2", "uint4", "int2", "int4", "dim3"}
_KEYWORDS = {"return", "else", "case", "goto", "delete", "new", "sizeof", "typedef",
             "using", "throw", "do", "co_return", "operator", "template", "typename"}
_DOWNCAST = re.compile(
    r"(?:\b\w+::)*(?:__float2bfloat16(?:_rn|_rz|_rd|_ru)?|__floats2bfloat162_rn"
    r"|__float22bfloat162_rn|__float2half(?:_rn|_rz|_rd|_ru)?|__floats2half2_rn"
    r"|__float22half2_rn|from_float\s*<[^<>;]*>|static_cast\s*<\s*(?:__nv_bfloat16|__half"
    r"|half|__nv_bfloat162|__half2)\s*>)\s*\(")
_COMPOUND = ("+=", "-=", "*=", "/=")
_ARITH = set("+-*/")


# -- a small lexer over CUDA C++ ---------------------------------------------


def strip_comments(text: str) -> str:
    """``text`` with every comment blanked to spaces (newlines kept, so
    offsets and line numbers hold); string and char literals untouched."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            i = j + 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out[i:j] = " " * (j - i)
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out[i:j] = [ch if ch == "\n" else " " for ch in text[i:j]]
            i = j
        else:
            i += 1
    return "".join(out)


def _skip_string(code: str, i: int) -> int:
    """The index just past the string (or char) literal opening at ``i``."""
    quote, j = code[i], i + 1
    while j < len(code) and code[j] != quote:
        j += 2 if code[j] == "\\" else 1
    return j + 1


def _close(code: str, i: int) -> int:
    """The index of the bracket closing the one at ``i`` (strings skipped)."""
    pairs = {"(": ")", "[": "]", "{": "}", "<": ">"}
    opener, closer, depth, j = code[i], pairs[code[i]], 0, i
    while j < len(code):
        c = code[j]
        if c in "\"'":
            j = _skip_string(code, j)
            continue
        if c == opener:
            depth += 1
        elif c == closer:
            depth -= 1
            if depth == 0:
                return j
        j += 1
    return len(code) - 1


def _split_top(code: str, sep: str) -> List[str]:
    """``code`` split at ``sep`` outside strings and brackets."""
    pieces, depth, start, j = [], 0, 0, 0
    while j < len(code):
        c = code[j]
        if c in "\"'":
            j = _skip_string(code, j)
            continue
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        elif c == sep and depth == 0:
            pieces.append(code[start:j])
            start = j + 1
        j += 1
    pieces.append(code[start:])
    return pieces


def _strings(code: str) -> str:
    """The concatenated contents of the string literals in ``code``."""
    return "".join(m.group(1) for m in re.finditer(r'"((?:[^"\\]|\\.)*)"', code))


def _line(code: str, pos: int) -> int:
    return code.count("\n", 0, pos) + 1


def _lvalue_before(code: str, end: int) -> Tuple[Optional[str], bool, int]:
    """The assignment target ending just before ``end``: (its base name,
    whether it is subscripted or dereferenced, its start)."""
    j = end - 1
    while j >= 0 and code[j].isspace():
        j -= 1
    indexed = False
    while j >= 0:
        c = code[j]
        if c == "]":
            depth = 0
            while j >= 0:
                depth += code[j] == "]"
                depth -= code[j] == "["
                j -= 1
                if depth == 0:
                    break
            indexed = True
        elif c.isalnum() or c == "_" or c == ".":
            j -= 1
        elif c == ">" and j > 0 and code[j - 1] == "-":
            j -= 2
        else:
            break
    start = j + 1
    while j >= 0 and code[j].isspace():
        j -= 1
    if j >= 0 and code[j] == "*" and (j == 0 or not (code[j - 1].isalnum() or code[j - 1]
                                                     in "_)]")):
        indexed = True
    m = re.match(r"\s*([A-Za-z_]\w*)", code[start:end])
    return (m.group(1) if m else None), indexed, start


_TYPE = r"(?:[A-Za-z_]\w*::)*[A-Za-z_]\w*(?:\s*<[^;{}()]*?>)?"
_QUALS = (r"(?:(?:const|constexpr|static|volatile|register|extern|__shared__|unsigned"
          r"|__align__\s*\(\s*\d+\s*\))\s+)*")


def declared_type(code: str, name: str, pos: int) -> Optional[Tuple[str, bool]]:
    """(type word, declared as a pointer) of the nearest declaration of
    ``name`` before ``pos``, or None when none is found."""
    n = re.escape(name)
    # a pointer or reference mark sits against the type or the name, never
    # spaced on both sides as a product is (``float* p``, not ``a * p``)
    patterns = (
        rf"\b(?P<type>{_TYPE})(?:(?P<ptr>[\*&]+)\s*|\s+(?P<ptr2>[\*&]*))"
        rf"(?:__restrict__\s+)?\b{n}\b(?=\s*[\[=;,){{(])",
        rf"(?:^|(?<=[;{{}}]))\s*{_QUALS}(?P<type>{_TYPE})\s+[^;{{}}()]*?,\s*(?P<ptr>[\*&]*)"
        rf"{n}\b(?=\s*[\[=;,)])",
        rf"\b(?P<type>{_TYPE})\s*\(\s*(?P<ptr>&)\s*{n}\s*\)\s*\[",
    )
    best = None
    for pat in patterns:
        for m in re.finditer(pat, code[:pos]):
            word = re.sub(r"\s*<.*", "", m.group("type")).split("::")[-1]
            if word in _KEYWORDS:
                continue
            ptr = (m.group("ptr") or "") + ((m.groupdict().get("ptr2")) or "")
            if best is None or m.start() > best[0]:
                best = (m.start(), word, "*" in ptr)
    return None if best is None else best[1:]


def _type_problem(word: str) -> Optional[str]:
    """Why a floating accumulator of type ``word`` breaks NM402, or None."""
    if word in _FLOAT_TYPES or word in _INT_TYPES:
        return None
    if word in _LOW_TYPES:
        return f"declared {word}, a type below f32"
    return f"declared {word}, a type that may be below f32"


def _mma_helpers(code: str) -> Set[str]:
    """Names of the functions whose body holds an mma asm: their first
    parameter is the accumulator D."""
    helpers = set()
    for m in re.finditer(r"\b([A-Za-z_]\w*)\s*\(", code):
        if m.group(1) in ("asm", "if", "for", "while", "switch", "return", "sizeof"):
            continue
        close = _close(code, m.end() - 1)
        body = re.match(r"\s*\{", code[close + 1:])
        if body is None:
            continue
        brace = close + body.end()
        if any(rx.search(_strings(code[brace:_close(code, brace) + 1]))
               for rx in _MMA_RE.values()):
            helpers.add(m.group(1))
    return helpers


def lint_cuda_source(path: str, relpath: str, text: Optional[str] = None,
                     helpers: Sequence[str] = ()) -> List[Finding]:
    """NM401 (PTX accumulator types), NM402 (accumulator declarations) and
    NM403 (downcast before accumulation) over one CUDA source.
    ``helpers`` names the mma helpers other sources define (a header's
    ``mma_bf16``), whose calls here write their first argument."""
    if text is None:
        with open(path) as fh:
            text = fh.read()
    code = strip_comments(text)
    findings: List[Finding] = []

    def add(rule, pos, message, context):
        findings.append(Finding(rule=rule, path=relpath, line=_line(code, pos),
                                message=message, context=context))

    # NM401: the mma instructions' types and their asm outputs
    ordinal = 0
    for m in re.finditer(r"\basm\b\s*(?:volatile\s*|__volatile__\s*)?\(", code):
        open_ = m.end() - 1
        sections = _split_top(code[open_ + 1:_close(code, open_)], ":")
        template = _strings(sections[0])
        for kind, rx in _MMA_RE.items():
            for ins in rx.finditer(template):
                types = ins.groups()
                d, a, b = types[0], types[1], types[2]
                c = types[3] if kind == "mma.sync" else None
                if a not in _LOW_PTX and b not in _LOW_PTX:
                    continue
                ctx = f"ptx:{relpath}:{kind}:{ordinal}"
                ordinal += 1
                if d != "f32" or (c is not None and c != "f32"):
                    add("NM401", m.start(), f"{kind} on {a}.{b} operands accumulates in "
                        f"D={d}" + (f", C={c}" if c else "") + " (must be f32)", ctx)
                outs = [o for o in _split_top(sections[1], ",") if o.strip()] \
                    if len(sections) > 1 else []
                cons = [_strings(o.split("(")[0]) for o in outs]
                bad = sorted({x for x in cons if x not in _F32_CONSTRAINTS})
                if not cons or bad:
                    add("NM401", m.start(), f"{kind} on {a}.{b} operands: asm outputs "
                        f"{bad or 'none'} are not f32 registers (\"+f\" / \"=f\")",
                        ctx + ":outputs")

    # NM402: what += , = fmaf(...) and the mma helpers' D write into
    targets = []
    for m in re.finditer(r"(?<![+\-*/%&|^<>=!])\+=", code):
        targets.append(("+=", m.start()))
    for m in re.finditer(r"(?<![=!<>+\-*/%&|^])=\s*(?:\b\w+::)*(?:__)?fmaf(?:_r[nzdu])?\s*\(",
                         code):
        targets.append(("fmaf", m.start()))
    for name in sorted(set(helpers) | _mma_helpers(code)):
        for m in re.finditer(rf"\b{re.escape(name)}\s*(?:<[^<>;]*>)?\s*\(", code):
            close = _close(code, m.end() - 1)
            if code[close + 1:close + 80].lstrip().startswith("{"):
                continue  # the definition itself
            first = _split_top(code[m.end():close], ",")[0]
            targets.append((f"{name} D", m.end() + len(first)))
    for kind, pos in targets:
        name, indexed, start = _lvalue_before(code, pos)
        if name is None:
            continue
        decl = declared_type(code, name, start)
        if decl is None:
            continue
        word, pointer = decl
        if pointer and not indexed:
            continue  # pointer arithmetic
        problem = _type_problem(word)
        if problem is not None:
            add("NM402", start, f"accumulator {name!r} (target of {kind}) is {problem}",
                f"accum:{relpath}:{name}:{kind}")

    # NM403: a downcast feeding arithmetic, directly or through a variable
    ordinals: Dict[str, int] = {}
    for m in _DOWNCAST.finditer(code):
        if re.search(r"<\s*(?:float|double)\s*>", m.group(0)):
            continue  # from_float<float>: no narrowing
        close = _close(code, m.end() - 1)
        reason = _arith_context(code, m.start(), close + 1)
        if reason is None:
            decl = re.search(rf"\b({_TYPE})\s+([A-Za-z_]\w*)\s*=\s*$", code[:m.start()])
            if decl and not code[close + 1:].lstrip().startswith(("?", "+", "-", "*", "/")):
                var = decl.group(2)
                scope_end = _scope_end(code, m.start())
                for use in re.finditer(rf"\b{re.escape(var)}\b", code[close + 1:scope_end]):
                    u0 = close + 1 + use.start()
                    why = _arith_context(code, u0, u0 + len(var))
                    if why is not None:
                        reason = f"through {var!r}, {why}"
                        break
        call = re.sub(r"\s+", "", code[m.start():m.end() - 1])
        ordinals[call] = ordinals.get(call, -1) + 1
        if reason is not None:
            add("NM403", m.start(), f"downcast {call}(...) {reason}: downcast before "
                "accumulation", f"downcast:{relpath}:{call}:{ordinals[call]}")
    return findings


def _arith_context(code: str, start: int, end: int) -> Optional[str]:
    """How the expression at [start, end) feeds arithmetic, or None."""
    j = start - 1
    while j >= 0 and code[j].isspace():
        j -= 1
    before = code[max(0, j - 1):j + 1]
    if before in _COMPOUND:
        return f"feeds a compound assignment ({before})"
    if j >= 0 and code[j] in _ARITH and not code[max(0, j - 1):j + 1] in ("++", "--", "->") \
            and (j == 0 or code[j - 1] not in "+-"):
        return f"is an operand of {code[j]!r}"
    k = end
    while k < len(code) and code[k].isspace():
        k += 1
    after = code[k:k + 2]
    if after in _COMPOUND:
        return f"is the target of a compound assignment ({after})"
    if k < len(code) and code[k] in _ARITH and after not in ("->", "++", "--", "*/", "//"):
        return f"is an operand of {code[k]!r}"
    return None


def _scope_end(code: str, pos: int) -> int:
    """The end of the innermost brace block holding ``pos``."""
    depth, j = 0, pos
    while j < len(code):
        c = code[j]
        if c in "\"'":
            j = _skip_string(code, j)
            continue
        if c == "{":
            depth += 1
        elif c == "}":
            if depth == 0:
                return j
            depth -= 1
        j += 1
    return len(code)


def cuda_sources(repo_root: str) -> List[Tuple[str, str]]:
    """(path, checkout-relative path) of every CUDA source of the port."""
    cdir = os.path.join(repo_root, "src", "repro_torch", "csrc")
    return [(os.path.join(cdir, f), f"src/repro_torch/csrc/{f}")
            for f in sorted(os.listdir(cdir)) if f.endswith((".cu", ".cuh"))]


# -- the kernel arms' plain routes ---------------------------------------------

_MATMUL_OPS = ("mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot",
               "matmul", "_scaled_mm")


def _matmul_dtypes(fn, args) -> List[Tuple[str, Tuple[str, ...]]]:
    """(aten op, operand dtypes) of each matrix-product op ``fn(*args)``
    dispatches to."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    seen: List[Tuple[str, Tuple[str, ...]]] = []

    class _Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, fargs=(), kwargs=None):
            if func.overloadpacket.__name__ in _MATMUL_OPS:
                seen.append((func.overloadpacket.__name__,
                             tuple(str(a.dtype).split(".")[-1] for a in fargs
                                   if isinstance(a, torch.Tensor))))
            return func(*fargs, **(kwargs or {}))

    with _Spy():
        fn(*args)
    return seen


def check_plain_routes(shapes: Sequence[Tuple[int, int, int, int]] = TRACE_SHAPES,
                       repo_root: Optional[str] = None) -> List[Finding]:
    """NM401 over every kernel arm's plain route on bf16 CPU operands: each
    matrix product it reaches takes f32 or f64 operands."""
    import torch

    from repro_torch.core.candidates import CANDIDATES
    from repro_torch.core.measure import operand_shapes
    from repro_torch.core.opkey import GROUPED_OPS
    from repro_torch.kernels.common import config_key

    from .contracts import _candidate_location

    findings: List[Finding] = []
    for name, cand in sorted(CANDIDATES.items()):
        if cand.kernel is None:  # a library arm: check_backend_flags covers it
            continue
        path, line = _candidate_location(cand, repo_root)
        for op in cand.ops:
            for m, n, k, g in shapes:
                gg = g if op in GROUPED_OPS else 1
                xs = tuple(torch.zeros(s, dtype=torch.bfloat16)
                           for s in operand_shapes(op, m, n, k, gg))
                space = cand.config_space(m, n, k, 2, g=gg)
                for cfg in [None] + ([space[0]] if space else []):
                    where = f"{name}:{op}:{m}x{n}x{k}x{gg}:{config_key(cfg)}"
                    try:
                        seen = _matmul_dtypes(lambda *a, _c=cfg: cand.run(*a, config=_c), xs)
                    except Exception as exc:  # a plain route that raises is a bug
                        findings.append(Finding(
                            rule="NM401", path=path, line=line,
                            message=f"{where}: the bf16 plain route raised "
                                    f"{type(exc).__name__}: {exc}",
                            context=f"numerics:{where}:raise"))
                        continue
                    low = sorted({f"aten.{op_} on {'/'.join(dts)}" for op_, dts in seen
                                  if any(d not in ("float32", "float64") for d in dts)})
                    if low:
                        findings.append(Finding(
                            rule="NM401", path=path, line=line,
                            message=f"{where}: the plain route multiplies below f32 "
                                    f"({'; '.join(low)}): it must accumulate in f32",
                            context=f"numerics:{where}:plain"))
    return findings


def check_backend_flags(repo_root: str) -> List[Finding]:
    """NM401: after ``import repro_torch``, cuBLAS may not reduce bf16
    products in bf16 (the library arms' f32 accumulation)."""
    import torch

    import repro_torch  # noqa: F401  (the import sets the flag)

    if not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        return []
    rel = "src/repro_torch/__init__.py"
    line = 1
    try:
        with open(os.path.join(repo_root, rel)) as fh:
            line = next((i for i, ln in enumerate(fh, 1)
                         if "allow_bf16_reduced_precision_reduction" in ln), 1)
    except OSError:
        pass
    return [Finding(rule="NM401", path=rel, line=line,
                    message="torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction "
                            "is True after import repro_torch: cuBLAS may reduce the library "
                            "arms' bf16 products below f32",
                    context="numerics:allow_bf16_reduced_precision_reduction")]


def run(repo_root: Optional[str] = None, cache=None) -> List[Finding]:
    if repo_root is None:
        from .lint import _repo_root

        repo_root = _repo_root()
    findings: List[Finding] = []
    sources = []
    for path, relpath in cuda_sources(repo_root):
        if cache is not None:
            text = cache.read(path)
        else:
            with open(path) as fh:
                text = fh.read()
        sources.append((path, relpath, text))
    helpers = set()
    for _, _, text in sources:
        helpers |= _mma_helpers(strip_comments(text))
    for path, relpath, text in sources:
        findings.extend(lint_cuda_source(path, relpath, text, sorted(helpers)))
    findings.extend(check_backend_flags(repo_root))
    findings.extend(check_plain_routes(repo_root=repo_root))
    return findings
