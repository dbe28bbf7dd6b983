"""The readers of the port's own spans and counters: each reads a number
in a traced tiny run of its cell and nothing in an untraced one, and a
traced run's breakdown can name the port's spans."""

from types import SimpleNamespace

import pytest

from cellbench import harness
from cellbench.tests.tiny import ROOT, run_tiny, tiny_context

READERS = {
    "optim.update_ms.lm_train": "danube3-12L.train-8x2048",
    "attn.backward_ms.lm_train": "danube3-12L.train-8x2048",
    "optim.update_ms.fcn_train": "fcn-synthetic-3h.train",
    "engine.queue_wait_p90_ms.serve_ttft": "danube3.serve-docqa",
    "engine.prefill_ms.serve_ttft": "danube3.serve-docqa",
    "dispatch.select_us.serve_ttft": "danube3.serve-docqa",
    "engine.prefill_share.serve": "danube3.serve-docqa-over",
    "engine.step_self_ms.serve": "danube3.serve-docqa-over",
}
_RUNS = {}


def _run(cell: str, trace: bool):
    """One tiny run of ``cell`` a mode (untraced first, so that it cannot
    see a traced run's records): (outcome, result line, the counts of the
    port's spans by name right after it)."""
    if (cell, trace) not in _RUNS:
        if trace:
            _run(cell, False)
        done = run_tiny(tiny_context(cell, seed=2**31 + 11, trace=trace))
        from repro_torch.core import spans

        counts = {}
        for s in spans.records():
            counts[s.name] = counts.get(s.name, 0) + 1
        _RUNS[cell, trace] = done["outcome"], done["line"], counts
    return _RUNS[cell, trace]


def test_the_readers_are_the_benchmarks_metrics():
    spec = {m["name"]: m for m in harness.load_cell(next(iter(READERS.values())))["spec"]
            ["per_layer"]}
    for name, cell in READERS.items():
        assert spec[name]["workloads"] == [cell]
        assert spec[name]["source"] in ("program_span", "program_counter")


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_a_number_traced(name):
    _, line, _ = _run(READERS[name], True)
    value = line["metrics"][name]["value"]
    assert isinstance(value, float) and value >= 0.0
    if name.endswith("_share.serve"):
        assert 0.0 < value < 100.0
    assert line["correct"] is True


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_nothing_untraced(name):
    cell = READERS[name]
    outcome, line, _ = _run(cell, False)
    assert name not in line["metrics"]
    ctx = tiny_context(cell)
    r = SimpleNamespace(cell=cell, cfg=ctx.cfg, mix=ctx.mix, counters=outcome.counters,
                        trace=None)
    assert harness._reader(name, ROOT).read(r) is None


def test_the_update_and_backward_share_one_step():
    _, line, counts = _run("danube3-12L.train-8x2048", True)
    steps = line["attempted"]
    assert steps > 0
    layers = 2  # the tiny configuration's
    assert counts == {"repro_torch.optim.update": steps,
                      "repro_torch.attn.backward": steps * layers}


def test_the_serving_spans_cover_every_admission():
    outcome, line, counts = _run("danube3.serve-docqa", True)
    assert counts["repro_torch.engine.queued"] == counts["repro_torch.engine.prefill"] > 0
    assert counts["repro_torch.engine.step"] >= counts["repro_torch.engine.decode"] > 0


def test_a_reader_reads_nothing_from_a_program_without_the_recorder(monkeypatch):
    """Laid over a checkout whose port has no ``core.spans``, every reader
    finds nothing to read and raises nothing."""
    import sys

    import repro_torch.core

    _run("danube3.serve-docqa", True)
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    monkeypatch.delattr(repro_torch.core, "spans")
    for name, cell in READERS.items():
        ctx = tiny_context(cell)
        r = SimpleNamespace(cell=cell, cfg=ctx.cfg, mix=ctx.mix, counters={}, trace=object())
        assert harness._reader(name, ROOT).read(r) is None
