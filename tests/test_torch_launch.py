"""The port's launchers against the JAX package's: ``--legacy`` (the
fixed-batch prefill, then greedy decode, under ``--policy``) gives the
JAX launcher's greedy tokens on the same weights (smoke config, f32,
weights carried over by ``repro_torch.convert``); ``--chaos`` on both
launchers degrades the faulted arm and prints the health report; and
the two examples that wrap them run at smoke size on the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import engine, faults  # noqa: E402
from repro_torch.examples import arch_tour, serve_lm  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from test_torch_lm import to_port_cfg  # noqa: E402

LEGACY = ["--arch", "smollm-135m", "--smoke", "--legacy", "--batch", "3", "--prompt-len", "9",
          "--gen", "6", "--seed", "2"]


@pytest.fixture(autouse=True)
def _clean_ledger(monkeypatch):
    monkeypatch.setattr(engine, "_WARNED", set())
    faults.clear_quarantine()
    jfaults.clear_quarantine()
    yield
    faults.clear_quarantine()
    jfaults.clear_quarantine()


@pytest.fixture(scope="module")
def legacy_weights():
    """The JAX launcher's smoke weights for ``--seed 2``, carried over."""
    jcfg = j_smoke_config("smollm-135m")
    tree = jax.tree.map(lambda x: np.array(x, np.float32),
                        jlm.init_lm(jax.random.PRNGKey(2), jcfg))
    return params_from_numpy(tree, to_port_cfg(jcfg), device="cpu")


@pytest.mark.parametrize("policy", ["fixed:XLA_NT", "fixed:nt=PALLAS_TNN,attn=fused"])
def test_legacy_tokens_match_the_jax_launcher(monkeypatch, legacy_weights, policy):
    want = jserve.main(LEGACY + ["--mesh", "1x1", "--policy", "fixed:XLA_NT"])
    monkeypatch.setattr(lm, "init_lm", lambda seed, cfg, device: legacy_weights)
    got = serve.main(LEGACY + ["--device", "cpu", "--policy", policy])
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_legacy_steps_run_under_their_policy(capsys):
    serve.main(["--arch", "smollm-135m", "--smoke", "--legacy", "--device", "cpu",
                "--batch", "2", "--prompt-len", "5", "--gen", "3",
                "--policy", "fixed:nt=PALLAS_TNN,attn=fused"])
    out = capsys.readouterr().out
    assert "NT   PALLAS_TNN" in out and "ATTN FUSED_ATTN" in out
    assert "health report" in out and "fallbacks taken: (none)" in out


def test_serve_launcher_chaos_degrades_and_reports(capsys):
    eng = serve.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--requests", "4",
                      "--prompt-len", "6", "--gen", "3", "--policy",
                      "fixed:nt=PALLAS_NT,attn=fused",
                      "--chaos", "raise:PALLAS_NT.NT;raise:FUSED_ATTN.ATTN"])
    health = eng.health()
    assert health["crashed_steps"] == 0 and health["finished"] == 4
    assert {e.label() for e in faults.quarantine_entries()} == {"PALLAS_NT", "FUSED_ATTN"}
    counts = faults.fallback_counts()
    assert counts[("NT", "PALLAS_NT", "XLA_NT")] > 0
    assert counts[("ATTN", "FUSED_ATTN", "UNFUSED_ATTN")] > 0
    out = capsys.readouterr().out
    assert "fault injection: 2 armed rule(s)" in out and "quarantined arms: 2" in out


def test_train_launcher_chaos_matches_the_unfaulted_losses(capsys):
    argv = ["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "2", "--batch",
            "2", "--seq", "16", "--policy", "fixed:PALLAS_NT"]
    clean = train.main(argv)
    faulted = train.main(argv + ["--chaos", "raise:PALLAS_NT.NT"])
    np.testing.assert_allclose([m["loss"] for m in faulted.metrics],
                               [m["loss"] for m in clean.metrics], rtol=1e-5)
    assert {e.label() for e in faults.quarantine_entries()} == {"PALLAS_NT"}
    out = capsys.readouterr().out
    assert "PALLAS_NT -> XLA_NT" in out and "raise:PALLAS_NT.NT (fired 1x)" in out


def test_serve_lm_example_runs_the_legacy_path(capsys):
    gen = serve_lm.main(["--device", "cpu", "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert gen.shape == (2, 3)
    assert "sample generations" in capsys.readouterr().out


def test_arch_tour_covers_all_ten_architectures():
    rows = arch_tour.main(["--device", "cpu"])
    assert sorted(rows) == sorted(ARCHS) and len(rows) == 10
    for name, row in rows.items():
        assert np.isfinite(row["loss"]) and row["decode_shape"][:2] == (2, 1), name
    assert rows["smollm-135m"]["params"] == 134515008
