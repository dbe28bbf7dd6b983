"""Package rules of the PyTorch port: it imports neither jax nor the JAX
package, its entry points refuse CUDA on a machine without a card
instead of carrying on on the CPU, and ``chip_smoke.py`` fails without
a card."""

import ast
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import PagedKVCache, ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels.ops, "
        "repro_torch.kernels.attention_fused, repro_torch.models.lm, "
        "repro_torch.serving, repro_torch.launch.serve, repro_torch.convert, "
        "repro_torch.launch.train, repro_torch.optim, repro_torch.checkpoint, "
        "repro_torch.data, repro_torch.models.fcn, repro_torch.configs.fcn_paper, "
        "repro_torch.examples.train_fcn, repro_torch.benchmarks.table10_fcn, "
        "repro_torch.configs.gemma3_4b, repro_torch.configs.paligemma_3b, "
        "repro_torch.kernels.tiling, repro_torch.benchmarks.run, "
        "repro_torch.benchmarks.kernel_sweep, repro_torch.examples.quickstart, "
        "repro_torch.examples.collect_and_train_selector, repro_torch.core.faults, "
        "repro_torch.benchmarks.serve_load, repro_torch.benchmarks.bench_drift, "
        "repro_torch.benchmarks.fault_drill, repro_torch.examples.serve_lm, "
        "repro_torch.examples.arch_tour, repro_torch.distributed, "
        "repro_torch.launch.dryrun, repro_torch.launch.accounting, "
        "repro_torch.benchmarks.roofline_table, repro_torch.benchmarks.gemma2_accum_iter, "
        "repro_torch.analysis.lint, repro_torch.analysis.artifacts_lint, "
        "repro_torch.analysis.contracts, repro_torch.analysis.numerics, "
        "repro_torch.analysis.sanitize, repro_torch.analysis.coverage, "
        "repro_torch.kernels.gridspec, repro_torch.core.spans\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'repro' not in sys.modules\n"
        "from repro_torch.kernels import _build\n"
        "assert not _build._LIBS  # nothing is built at import\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_raise_on_cuda_without_a_card(no_card):
    cfg = smoke_config("smollm-135m")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        lm.init_lm(0, cfg)
    params = lm.init_lm(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="is_available"):
        lm.init_lm_cache(cfg, batch=1, max_seq=8)
    with pytest.raises(RuntimeError, match="is_available"):
        PagedKVCache(cfg, n_slots=1, max_seq=8)
    with pytest.raises(RuntimeError, match="is_available"):
        serve.main(["--arch", "smollm-135m", "--smoke", "--policy", "fixed:XLA_NT"])


@pytest.mark.parametrize("argv", [["--legacy", "--mesh", "2x4"],
                                  ["--chaos", "raise:PALLAS_*", "--mesh", "1x2"],
                                  ["--mesh", "2x4"]])
def test_serve_launcher_exits_on_a_mesh_this_process_cannot_form(argv, capsys):
    """``--legacy`` and ``--chaos`` are served (``tests/test_torch_launch.py``),
    and so is a mesh (``tests/test_torch_distributed.py``), but only over a
    process group of as many ranks: one process has one rank."""
    with pytest.raises(SystemExit):
        serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu"] + argv)
    ranks = 8 if "2x4" in argv else 2
    assert f"needs {ranks} devices; 1 present" in capsys.readouterr().err


def test_train_launcher_raises_on_cuda_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--arch", "smollm-135m", "--smoke", "--steps", "1",
                    "--policy", "fixed:XLA_NT"])


@pytest.mark.parametrize("argv", [["--chaos", "raise:PALLAS_*", "--mesh", "2x2"],
                                  ["--mesh", "2x4"]])
def test_train_launcher_exits_on_a_mesh_this_process_cannot_form(argv, capsys):
    """``--chaos`` is trained under; a mesh needs a process group of as
    many ranks."""
    with pytest.raises(SystemExit):
        train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "1",
                    "--policy", "fixed:XLA_NT"] + argv)
    ranks = 8 if "2x4" in argv else 4
    assert f"needs {ranks} devices; 1 present" in capsys.readouterr().err


def test_train_launcher_default_policy_names_the_roadmap_item():
    """Named when the default ``--policy model`` raised; now it trains the
    smoke config on the CPU under the default learned selector."""
    run = train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "3",
                      "--batch", "4", "--seq", "32"])
    assert len(run.metrics) == 3 and all(math.isfinite(m["loss"]) for m in run.metrics)
    assert type(run.policy).__name__ == "ModelPolicy" and run.policy.stats.calls > 0


@pytest.mark.parametrize("arch,keys", [("musicgen-large", {"frames", "labels"}),
                                       ("paligemma-3b", {"patches", "tokens", "labels"}),
                                       ("gemma3-4b", {"tokens", "labels"}),
                                       ("grok-1-314b", {"tokens", "labels"}),
                                       ("zamba2-7b", {"tokens", "labels"})])
def test_train_launcher_takes_every_architecture(arch, keys, monkeypatch):
    """``--arch`` trains the frames and vlm models too: their f32 frames
    and patches reach the model as floats, token ids as int64."""
    seen = []
    to_device = train._to_device

    def spy(batch, device):
        out = to_device(batch, device)
        seen.append({k: v.dtype for k, v in out.items()})
        return out

    monkeypatch.setattr(train, "_to_device", spy)
    run = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                      "--batch", "2", "--seq", "16", "--policy", "fixed:XLA_NT"])
    assert len(run.metrics) == 2 and all(math.isfinite(m["loss"]) for m in run.metrics)
    assert set(seen[0]) == keys
    for k, dtype in seen[0].items():
        assert dtype == (torch.float32 if k in ("frames", "patches") else torch.int64)


@pytest.mark.parametrize("arch", ["gemma3-4b", "gemma2-27b", "h2o-danube-3-4b", "grok-1-314b",
                                  "kimi-k2-1t-a32b", "mamba2-2.7b", "zamba2-7b"])
def test_launcher_serves_the_token_architectures_on_cpu(arch):
    engine = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                         "--prompt-len", "20", "--gen", "4", "--slots", "2", "--max-seq", "32",
                         "--policy", "fixed:nt=PALLAS_TNN,attn=fused"])
    assert engine.health()["finished"] == 3 and engine.health()["crashed_steps"] == 0


def test_launcher_serves_on_cpu_and_returns_the_engine(capsys):
    engine = serve.main([
        "--arch", "smollm-135m", "--smoke", "--device", "cpu", "--requests", "3",
        "--prompt-len", "9", "--gen", "3", "--slots", "2",
        "--class-policy", "interactive=fixed:nt=PALLAS_TNN,attn=fused",
        "--class-policy", "bulk=fixed:nt=PALLAS_NT,attn=fused",
    ])
    assert engine.health()["finished"] == 3 and engine.health()["crashed_steps"] == 0
    assert "PALLAS_TNN" in capsys.readouterr().out


def test_launcher_default_policy_names_the_roadmap_item(capsys):
    """Named when the default ``--policy model`` raised; now it serves the
    smoke config on the CPU under the default learned selector."""
    engine = serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                         "--requests", "3", "--prompt-len", "9", "--gen", "3", "--slots", "2"])
    assert engine.health()["finished"] == 3 and engine.health()["crashed_steps"] == 0
    assert "ModelPolicy" in capsys.readouterr().out


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA card" in res.stderr
    assert '"ok"' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and '"ok"' not in res.stdout


def test_build_directory_holds_one_library_per_source(tmp_path, monkeypatch):
    """The libraries live under the build directory, one per source."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    names = {_build.library_path(s).name for s in _build.SOURCES}
    assert len(names) == len(_build.SOURCES)
    assert all(_build.library_path(s).parent == tmp_path for s in _build.SOURCES)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
