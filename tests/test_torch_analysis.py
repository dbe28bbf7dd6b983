"""The port's static analysis (``repro_torch.analysis``), after the cases
of ``tests/test_analysis.py`` that cover the frame, the dispatch-bypass,
registry and concurrency passes and the CLI: the finding and baseline
primitives, every rule firing on a seeded snippet (or a seeded registry),
the einsum heuristic on the JAX package's own cases, the port's tree
linting clean under its committed baseline -- which names the JAX
package's ten MoE and SSD einsums, with their justifications, and
nothing else -- and the AST passes running with neither ``jax`` nor the
JAX package importable."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import RULES, Baseline, Finding
from repro_torch.analysis import dispatch_lint
from repro_torch.analysis.dispatch_lint import einsum_is_gemm_shaped, lint_file
from repro_torch.analysis.findings import apply_baseline
from repro_torch.analysis.lint import main as lint_main

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
ANALYSIS = os.path.join(REPO_ROOT, "src", "repro_torch", "analysis")
BASELINE = os.path.join(ANALYSIS, "baseline.json")


# -- findings / baseline primitives ------------------------------------------


def test_finding_fingerprint_excludes_line():
    a = Finding(rule="DL001", path="p.py", line=10, message="m", context="c")
    b = Finding(rule="DL001", path="p.py", line=99, message="m", context="c")
    assert a.fingerprint == b.fingerprint == "DL001:p.py:c"


@pytest.mark.parametrize("rule,severity", [("XX999", "error"), ("DL001", "fatal")])
def test_unregistered_rule_or_severity_rejected(rule, severity):
    with pytest.raises(ValueError):
        Finding(rule=rule, path="p.py", line=1, message="m", severity=severity)


def test_baseline_round_trip(tmp_path):
    bl = Baseline(entries={"DL001:p.py:c": "known debt"})
    path = str(tmp_path / "baseline.json")
    bl.save(path)
    assert Baseline.load(path).entries == bl.entries
    (tmp_path / "bad.json").write_text(json.dumps({"entries": []}))
    with pytest.raises(ValueError):
        Baseline.load(str(tmp_path / "bad.json"))


def test_apply_baseline_suppresses_and_flags():
    f = Finding(rule="DL001", path="p.py", line=1, message="m", context="c")
    active, suppressed = apply_baseline([f], Baseline(entries={f.fingerprint: "because"}))
    assert not active and len(suppressed) == 1
    assert suppressed[0].suppressed and suppressed[0].justification == "because"
    # an empty justification: the finding stays active and BL901 fires
    active, suppressed = apply_baseline([f], Baseline(entries={f.fingerprint: "  "}))
    assert not suppressed and {a.rule for a in active} == {"DL001", "BL901"}
    # a stale entry: BL902, a warning
    active, _ = apply_baseline([], Baseline(entries={"DL001:gone.py:x": "old"}))
    assert [a.rule for a in active] == ["BL902"] and active[0].severity == "warning"


def test_baseline_duplicate_fingerprints_warn_bl903(tmp_path):
    path = tmp_path / "dup.json"
    path.write_text('{"entries": {"DL001:p.py:c": "first", "DL001:p.py:c": "second"}}')
    bl = Baseline.load(str(path))
    assert bl.duplicates == ["DL001:p.py:c"] and bl.entries["DL001:p.py:c"] == "second"
    f = Finding(rule="DL001", path="p.py", line=1, message="m", context="c")
    active, suppressed = apply_baseline([f], bl)
    assert len(suppressed) == 1 and [a.rule for a in active] == ["BL903"]
    assert active[0].severity == "warning"


# -- dispatch-bypass pass ----------------------------------------------------


@pytest.mark.parametrize(
    "spec,gemm",
    [
        ("mk,nk->mn", True),
        ("gtd,ed->gte", True),
        ("bcln,bcsn->bcls", True),
        ("...ij,...jk->...ik", True),
        ("ij,jk", True),  # implicit output contracts j
        ("bh,bhp,bn->bhpn", False),  # pure broadcast/outer, nothing contracted
        ("ij->ji", False),  # transpose, single operand
        ("ii->i", False),  # diagonal, single operand
        ("bij,bij->bij", False),  # elementwise
    ],
)
def test_einsum_gemm_heuristic(spec, gemm):
    assert einsum_is_gemm_shaped(spec) is gemm


def test_dispatch_lint_seeded_violations(tmp_path):
    src = textwrap.dedent(
        """
        import torch
        import torch.nn.functional as F

        def f(a, b, w, spec):
            c = torch.einsum("mk,nk->mn", a, b)     # DL001
            d = torch.einsum("ij->ji", a)           # fine: transpose
            e = torch.einsum(spec, a, b)            # DL001: dynamic spec
            g = torch.matmul(a, b)                  # DL002
            h = a @ b                               # DL002
            i = torch.mm(a, b)                      # DL002
            j = torch.bmm(a, b)                     # DL002
            k = torch.tensordot(a, b, dims=1)       # DL002
            m = F.linear(a, w)                      # DL002
            n = a.matmul(b)                         # DL002: a method too
            o = torch.einsum("bh,bhp,bn->bhpn", a, b, w)  # fine: no contraction
            return c, d, e, g, h, i, j, k, m, n, o
        """
    )
    p = tmp_path / "seeded.py"
    p.write_text(src)
    findings = lint_file(str(p), "seeded.py")
    assert sorted(f.rule for f in findings) == ["DL001"] * 2 + ["DL002"] * 7
    assert {f.context for f in findings if f.rule == "DL001"} == {"einsum:mk,nk->mn",
                                                                 "einsum:<dynamic>"}
    assert {f.context for f in findings if f.rule == "DL002"} == {
        "call:matmul", "call:matmul-op", "call:mm", "call:bmm", "call:tensordot",
        "call:linear"}


def test_dispatch_lint_walks_the_ports_models_and_launchers():
    assert dispatch_lint.DEFAULT_ROOTS == (os.path.join("src", "repro_torch", "models"),
                                           os.path.join("src", "repro_torch", "launch"))


def test_dispatch_lint_repo_findings_all_baselined():
    findings = dispatch_lint.run(REPO_ROOT)
    active, suppressed = apply_baseline(findings, Baseline.load(BASELINE))
    assert not [f for f in active if f.severity == "error"], [f.render() for f in active]
    assert suppressed and all(f.justification.strip() for f in suppressed)


def test_the_baseline_names_the_jax_packages_ten_einsums_and_nothing_else():
    """The same ten MoE and SSD einsums as the JAX package's baseline,
    each justified, and no entry for the attention code."""
    ours = Baseline.load(BASELINE).entries
    ref = json.load(open(os.path.join(REPO_ROOT, "src", "repro", "analysis",
                                      "baseline.json")))["entries"]
    assert len(ours) == 10
    assert {k.replace("src/repro_torch/", "src/repro/") for k in ours} == set(ref)
    assert all(v.strip() for v in ours.values())
    assert not any("attention.py" in k for k in ours)


def test_attention_and_the_moe_router_route_through_dispatch():
    findings = dispatch_lint.run(REPO_ROOT)
    assert not [f for f in findings if f.path.endswith("models/attention.py")]
    assert all("gtd,ed" not in f.context for f in findings if f.path.endswith("models/moe.py"))


# -- registry pass -------------------------------------------------------------


def test_registry_pass_is_clean_on_the_ports_registry():
    from repro_torch.analysis import registry_lint

    assert registry_lint.run(REPO_ROOT) == []


def _seed_candidate(name, **kw):
    from repro_torch.core.candidates import register_candidate

    @register_candidate(name, **kw)
    def _seed(a, b, block=None):  # pragma: no cover - never run
        return a

    return _seed


@pytest.mark.parametrize("rule", ["RC101", "RC102", "RC103", "RC104", "RC105", "RC106"])
def test_registry_pass_detects_its_seeded_violation(rule, monkeypatch):
    from repro_torch.analysis import registry_lint
    from repro_torch.core import candidates as C

    seeded = None
    if rule == "RC101":  # a default that is not distributed-safe
        seeded = _seed_candidate("_LINT_SEED", sim_algo="NT_DIRECT", ops=("NT",))
        monkeypatch.setitem(C.DEFAULT_BY_OP, "NT", "_LINT_SEED")
    elif rule == "RC102":  # a pair member that is not registered
        monkeypatch.setitem(C.BINARY_PAIRS_BY_OP, "NN", ("XLA_NN", "_NO_SUCH"))
    elif rule == "RC103":  # an analytic arm the cost model does not price
        seeded = _seed_candidate("_LINT_SEED", sim_algo="NO_SUCH_ARM", ops=("NT",))
    elif rule == "RC104":  # tunable, but no kernel: an empty tile space
        seeded = _seed_candidate("_LINT_SEED", sim_algo="NT_DIRECT", ops=("NT",),
                                 tunable=True)
    elif rule == "RC105":  # a platform no candidate runs on
        monkeypatch.setattr(C, "ALL_PLATFORMS", C.ALL_PLATFORMS + ("tpu",))
    else:  # a chain that does not end at the default
        monkeypatch.setattr(C, "fallback_chain", lambda op, name=None: (name or "XLA_NT",))
    try:
        rules = {f.rule for f in registry_lint.run(REPO_ROOT)}
    finally:
        if seeded is not None:
            C.unregister_candidate("_LINT_SEED")
    assert rule in rules
    monkeypatch.undo()
    assert registry_lint.run(REPO_ROOT) == []


# -- concurrency pass ----------------------------------------------------------


def test_concurrency_pass_repo_is_clean():
    from repro_torch.analysis import concurrency

    findings = concurrency.run(REPO_ROOT)
    assert findings == [], [f.render() for f in findings]


def test_the_ports_shared_state_carries_the_jax_packages_annotations():
    """Every ``# guarded-by:`` declaration of the JAX package's core,
    serving and analysis modules has its counterpart in the port's
    module of the same name, on the same name."""
    def declared(root):
        out = set()
        for sub in ("core", "serving", "analysis"):
            for dirpath, _, files in os.walk(os.path.join(REPO_ROOT, "src", root, sub)):
                for fn in files:
                    if not fn.endswith(".py"):
                        continue
                    for line in open(os.path.join(dirpath, fn)):
                        code, _, note = line.partition("#")
                        if "guarded-by:" in note and ("=" in code):
                            out.add((sub, fn, code.split("=")[0].split(":")[0].strip()))
        return out

    ref = declared("repro")
    assert ref and ref <= declared("repro_torch")


def test_concurrency_detects_seeded_violations(tmp_path):
    from repro_torch.analysis.concurrency import check_file

    src = textwrap.dedent(
        """
        import contextvars
        import threading

        _LOCK = threading.Lock()
        _STATE = {}  # guarded-by: _LOCK
        _CTX = contextvars.ContextVar("ctx", default=None)


        def good(key, value):
            with _LOCK:
                _STATE[key] = value


        def bad_mutation(key, value):
            _STATE[key] = value  # CC501


        def bad_ctx():
            _CTX.set("x")  # CC503: no reset in a finally


        def bad_thread():
            threading.Thread(target=good).start()  # CC504: never joined


        def bad_acquire():
            _LOCK.acquire()  # CC505


        class Holder:
            def __init__(self):
                self._lock = threading.Lock()
                self.items = []  # guarded-by: _lock
                self.other = 0  # guarded-by: _missing_lock (CC502)

            def ok(self, x):
                with self._lock:
                    self.items.append(x)

            def racy(self, x):
                self.items.append(x)  # CC501
        """
    )
    p = tmp_path / "seeded_cc.py"
    p.write_text(src)
    findings = check_file(str(p), "seeded_cc.py")
    rules = sorted(f.rule for f in findings)
    assert rules == ["CC501", "CC501", "CC502", "CC503", "CC504", "CC505"], [
        f.render() for f in findings]
    assert not any("good" in f.context or ":ok:" in f.context for f in findings)


# -- imports -------------------------------------------------------------------


def test_the_analysis_modules_import_nothing_of_the_jax_package():
    for fn in sorted(os.listdir(ANALYSIS)):
        if not fn.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ANALYSIS, fn)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and not node.level else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("repro", "jax", "jaxlib"), (fn, name)


def test_ast_passes_run_without_jax_or_the_jax_package():
    code = ("import sys; sys.path.insert(0, 'src'); sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "from repro_torch.analysis.lint import main; "
            "sys.exit(main(['--passes', 'dispatch,concurrency']))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 error(s)" in proc.stdout


# -- the CLI end to end --------------------------------------------------------


def test_lint_cli_repo_is_clean():
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint"], cwd=REPO_ROOT,
                          capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": os.path.join(REPO_ROOT, "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("7 pass(es) [dispatch, registry, artifacts, contracts, coverage, numerics, "
            "concurrency]: 0 error(s), 0 warning(s), 11 baselined") in proc.stdout


def test_lint_cli_fails_without_baseline(capsys):
    assert lint_main(["--passes", "dispatch", "--no-baseline"]) == 1
    assert "DL001" in capsys.readouterr().out


def test_lint_cli_fails_when_baseline_entry_removed(tmp_path):
    entries = dict(Baseline.load(BASELINE).entries)
    del entries[next(fp for fp in entries if fp.startswith("DL001:src/repro_torch/models/moe.py"))]
    path = str(tmp_path / "baseline.json")
    Baseline(entries=entries, path=path).save()
    assert lint_main(["--passes", "dispatch", "--baseline", path]) == 1


def test_lint_cli_write_baseline_requires_justification(tmp_path, capsys):
    path = str(tmp_path / "bl.json")
    assert lint_main(["--passes", "dispatch", "--baseline", path, "--write-baseline"]) == 0
    capsys.readouterr()
    assert lint_main(["--passes", "dispatch", "--baseline", path]) == 1
    assert "BL901" in capsys.readouterr().out
    bl = Baseline.load(path)
    bl.entries = {fp: "justified in test" for fp in bl.entries}
    bl.save()
    assert lint_main(["--passes", "dispatch", "--baseline", path]) == 0


def test_write_baseline_output_is_stable_and_sorted(tmp_path):
    path = str(tmp_path / "bl.json")
    assert lint_main(["--passes", "dispatch", "--baseline", path, "--write-baseline"]) == 0
    first = open(path).read()
    assert lint_main(["--passes", "dispatch", "--baseline", path, "--write-baseline"]) == 0
    assert open(path).read() == first
    entries = json.loads(first)["entries"]
    assert list(entries) == sorted(entries)


def test_lint_cli_rejects_unknown_pass():
    with pytest.raises(SystemExit):
        lint_main(["--passes", "nope"])


def test_lint_cli_json_format(capsys):
    assert lint_main(["--passes", "dispatch,concurrency", "--format", "json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["passes"] == ["dispatch", "concurrency"]
    assert payload["summary"] == {"errors": 0, "warnings": 0, "baselined": 11}
    assert payload["stats"]["files_parsed"] > 0 and payload["stats"]["reparses_avoided"] > 0
    for f in payload["findings"] + payload["suppressed"]:
        assert f["rule"] in RULES and f["fingerprint"]


def test_lint_cli_stats_line(capsys):
    assert lint_main(["--passes", "dispatch,registry", "--stats", "--jobs", "1"]) == 0
    out = capsys.readouterr().out
    assert "repro_torch-lint: pass dispatch:" in out and "parse cache:" in out


def test_rule_catalogue_lists_every_rule(capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in RULES:
        assert rule in out


def test_rules_md_catalogue_is_committed_and_current(capsys):
    assert lint_main(["--list-rules", "--format", "md"]) == 0
    rendered = capsys.readouterr().out
    committed = open(os.path.join(ANALYSIS, "lint-rules.md")).read()
    assert rendered.rstrip("\n") == committed.rstrip("\n"), (
        "src/repro_torch/analysis/lint-rules.md is stale; regenerate it with "
        "python -m repro_torch.analysis.lint --list-rules --format md")


def test_rule_sections_partition_the_catalogue():
    from repro_torch.analysis.lint import RULE_SECTIONS

    sectioned = [r for _, _, rules in RULE_SECTIONS for r in rules]
    assert sorted(sectioned) == sorted(RULES) and len(sectioned) == len(set(sectioned))


def test_lint_cli_rejects_md_without_list_rules():
    with pytest.raises(SystemExit):
        lint_main(["--format", "md"])
