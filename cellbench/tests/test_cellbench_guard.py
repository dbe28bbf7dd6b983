"""What the benchmark's files may import, that BENCHMARK.json keeps its
contract, and that a cell is found by name from files alone."""

import ast
import json
import re
import shutil
import sys
import types
from pathlib import Path

import pytest

from cellbench import harness
from cellbench.tests.tiny import ROOT, run_tiny, tiny_context

PKG = ROOT / "cellbench"
SOURCES = sorted(PKG.rglob("*.py"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path):
    """(top-level module, relative level) of every import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_jax_package(path):
    bad = {m for m, level in _imports(path) if level == 0 and m in harness.FORBIDDEN_MODULES}
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for module, level in _imports(path):
        assert level <= 1, f"{path} reaches outside the reference"
        if level == 0:
            assert module in {"__future__", "math", "typing", "torch"}, (path, module)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in ("repro_torch_probe", "repro.probe", "jaxlib_probe"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    loaded = harness.forbidden_loaded()
    assert "repro.probe" in loaded
    assert "repro_torch_probe" not in loaded and "jaxlib_probe" not in loaded


SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["cellbench"] and 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32 and not any(w.startswith("/") for w in SPEC["command"])
    names = [x["name"] for group in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[group]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("cellbench/")
        assert set(c["reduced"]) == set(json.loads((ROOT / c["file"]).read_text())["reduced"])
    cells = {w["name"]: w for w in SPEC["workloads"]}
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert w["config"] in configs and len(w["why"]) <= 200
        assert (PKG / "traffic" / f"{w['traffic']}.json").is_file()
        assert (PKG / "limits" / f"{w['name']}.json").is_file()
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (PKG / "metrics" / f"{m['name']}.py").is_file() and UNIT.match(m["unit"])
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
    for cell in cells:
        reported = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in SPEC["per_layer"])


def test_a_cell_of_new_files_is_found_by_name(tmp_path):
    """A later change adds a cell, its traffic, its limits and a per-layer
    metric as new files and BENCHMARK.json entries, and edits nothing."""
    shutil.copytree(PKG, tmp_path / "cellbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "fcn-synthetic-3h.train-b256", "config": "fcn-synthetic-3h",
                              "traffic": "fcn-train-b256", "chips": 1, "why": "a small batch"})
    spec["end_to_end"][0]["workloads"].append("fcn-synthetic-3h.train-b256")
    spec["per_layer"].append({"name": "steps.fcn_train", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "train step",
                              "moves": "fcn_train_samples_per_s",
                              "workloads": ["fcn-synthetic-3h.train-b256"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    mix = json.loads((PKG / "traffic" / "fcn-train-b4096.json").read_text())
    (tmp_path / "cellbench/traffic/fcn-train-b256.json").write_text(json.dumps(dict(mix, batch=256)))
    shutil.copy(PKG / "limits/fcn-synthetic-3h.train.json",
                tmp_path / "cellbench/limits/fcn-synthetic-3h.train-b256.json")
    (tmp_path / "cellbench/metrics/steps.fcn_train.py").write_text(
        "def read(r):\n    return float(r.counters['steps'])\n")

    found = harness.load_cell("fcn-synthetic-3h.train-b256", tmp_path)
    assert found["mix"]["batch"] == 256
    ctx = tiny_context("fcn-synthetic-3h.train-b256", trace=True, root=tmp_path,
                       mix={"batch": 8})
    line = run_tiny(ctx, tmp_path)["line"]
    assert line["metrics"]["steps.fcn_train"]["value"] == line["attempted"] > 0
    assert line["correct"] is True
