"""The port's serving-load benchmark and drift guard against the JAX
package's: the same seeded arrival trace, draw for draw; the same report
schema as the JAX package's committed ``benchmarks/BENCH_serve.json``
(plus the device the run took, the engine's health and the
measurement record); no post-warmup
cold miss; and ``bench_drift`` passing a fresh CPU kernel sweep and
serve report against the port's committed pair, and failing a copy of
the pair with a class or a candidate removed.
"""

import copy
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import serve_load as jserve_load  # noqa: E402
from repro_torch.benchmarks import bench_drift, kernel_sweep, serve_load  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK = dict(requests=8, max_prompt=24, gen=8, slots=4, max_seq=48)


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """A fresh quick serve report and quick kernel sweep on the CPU, the
    autotune class measuring into a cache of its own."""
    cache = str(tmp_path_factory.mktemp("autotune") / "cache.json")
    old = os.environ.get("REPRO_AUTOTUNE_CACHE")
    os.environ["REPRO_AUTOTUNE_CACHE"] = cache
    try:
        args = types.SimpleNamespace(arch="smollm-135m", full=False, device="cpu", quick=True,
                                     seed=0, interactive_policy="autotune",
                                     bulk_policy="analytic", **QUICK)
        report = serve_load.run_load(args)
    finally:
        if old is None:
            os.environ.pop("REPRO_AUTOTUNE_CACHE")
        else:
            os.environ["REPRO_AUTOTUNE_CACHE"] = old
    sweep = kernel_sweep.sweep(kernel_sweep.QUICK_SHAPES, kernel_sweep.QUICK_BATCHED,
                               kernel_sweep.QUICK_ATTN, reps=1, device="cpu", verbose=False)
    return json.loads(json.dumps(report)), json.loads(json.dumps(sweep))


@pytest.mark.parametrize("seed,n,max_prompt,max_gen", [(0, 8, 24, 8), (0, 32, 48, 24),
                                                      (5, 40, 7, 3)])
def test_trace_is_the_jax_packages(seed, n, max_prompt, max_gen):
    classes = ["bulk", "interactive"]
    mine = serve_load.build_trace(np.random.RandomState(seed), n, max_prompt, max_gen, classes)
    theirs = jserve_load.build_trace(np.random.RandomState(seed), n, max_prompt, max_gen,
                                     classes)
    assert len(mine) == len(theirs) == n
    for (s1, p1, g1, c1), (s2, p2, g2, c2) in zip(mine, theirs):
        assert (s1, g1, c1) == (s2, g2, c2)
        assert p1.dtype == p2.dtype and np.array_equal(p1, p2)


def test_report_keys_are_the_jax_packages(fresh):
    report, _ = fresh
    with open(os.path.join(ROOT, "benchmarks", "BENCH_serve.json")) as fh:
        theirs = json.load(fh)
    assert set(report) - set(theirs) == {"device", "name", "dtype", "health", "measurement"}
    assert set(theirs) <= set(report)
    assert report["schema_version"] == theirs["schema_version"] == serve_load.SCHEMA_VERSION
    assert report["trace"] == theirs["trace"] and report["mode"] == theirs["mode"] == "quick"
    assert report["buckets"] == theirs["buckets"]
    assert set(report["classes"]) == set(theirs["classes"])
    for cls, row in report["classes"].items():
        assert set(row) == set(theirs["classes"][cls]), cls
    assert report["backend"] == "cpu" and report["name"] == "cpu"


def test_no_cold_miss_after_warmup_and_every_request_finishes(fresh):
    report, _ = fresh
    assert report["cold_misses_after_warmup"] == {"bulk": 0, "interactive": 0}
    assert report["health"]["crashed_steps"] == 0
    assert report["health"]["finished"] == QUICK["requests"]
    assert sum(r["requests"] for r in report["classes"].values()) == QUICK["requests"]
    assert report["totals"]["tokens"] == sum(r["tokens"] for r in report["classes"].values())
    # the autotune class measured at warmup, every pair at its first try
    assert report["measurement"]["interactive"] == {"max_attempts": 1, "failures": {}}
    assert report["measurement"]["bulk"] == {"max_attempts": None, "failures": {}}


def _committed():
    with open(bench_drift.COMMITTED_KERNELS) as fh:
        kernels = json.load(fh)
    with open(bench_drift.COMMITTED_SERVE) as fh:
        serve = json.load(fh)
    return kernels, serve


def test_bench_drift_passes_the_fresh_run_against_the_committed_pair(fresh, tmp_path, capsys):
    report, sweep = fresh
    kernels, serve = _committed()
    assert bench_drift.check_drift(sweep, kernels) == []
    assert bench_drift.check_serve_drift(report, serve) == []
    paths = {}
    for name, payload in (("k", sweep), ("s", report)):
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as fh:
            json.dump(payload, fh)
    assert bench_drift.main(["--fresh", paths["k"], "--serve-fresh", paths["s"]]) == 0
    assert "serve OK" in capsys.readouterr().out


def test_bench_drift_fails_on_a_class_or_a_candidate_removed(fresh):
    report, sweep = fresh
    kernels, serve = _committed()
    no_cls = copy.deepcopy(report)
    del no_cls["classes"]["bulk"]
    errors = bench_drift.check_serve_drift(no_cls, serve)
    assert any("request classes ['bulk']" in e for e in errors)
    no_cand = copy.deepcopy(sweep)
    no_cand["rows"] = [r for r in no_cand["rows"] if r["candidate"] != "PALLAS_TNN_FUSED"]
    errors = bench_drift.check_drift(no_cand, kernels)
    assert any("candidates ['PALLAS_TNN_FUSED']" in e for e in errors)
    assert any("coverage shrank" in e for e in errors)
    cold = copy.deepcopy(report)
    cold["cold_misses_after_warmup"]["interactive"] = 1
    assert any("cold-miss" in e for e in bench_drift.check_serve_drift(cold, serve))
    no_key = copy.deepcopy(sweep)
    del no_key["rows"][0]["bound_us"]
    assert any("missing keys ['bound_us']" in e for e in bench_drift.check_drift(no_key, kernels))


def test_a_fallback_or_quarantined_arm_fails_the_run(fresh, monkeypatch, capsys):
    """The run injects no fault, so an arm that fell back or was
    quarantined means a kernel failed: the run exits non-zero."""
    from repro_torch.core import faults

    report, _ = fresh
    monkeypatch.setattr(serve_load, "run_load", lambda args: report)
    argv = ["--quick", "--device", "cpu"]
    faults.clear_quarantine()
    try:
        assert serve_load.main(argv) == 0
        faults.quarantine("PALLAS_NT", "NT", None, RuntimeError("boom"))
        assert serve_load.main(argv) == 1
        assert "quarantined ['PALLAS_NT/NT']" in capsys.readouterr().out
        faults.clear_quarantine()
        faults.record_fallback("NT", "PALLAS_NT", "XLA_NT")
        assert serve_load.main(argv) == 1
    finally:
        faults.clear_quarantine()
