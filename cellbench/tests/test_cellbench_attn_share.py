"""The readers of the share of attention dispatches that ran the port's
fused kernel: nothing untraced or from a program without the counters, a
known share on a recorded session, and every dispatch fused in a traced
tiny run of each danube3 cell under the default policy."""

from types import SimpleNamespace

import pytest

from cellbench import harness
from cellbench.tests.tiny import ROOT, run_tiny, tiny_context

READERS = {
    "attn.fused_share.lm_train": ("danube3-12L.train-8x2048", "lm_train_tokens_per_s"),
    "attn.fused_share.serve": ("danube3.serve-docqa-over", "serve_tokens_per_s"),
    "attn.fused_share.serve_ttft": ("danube3.serve-docqa", "serve_ttft_p90_ms"),
}


def _read(name, trace=object()):
    return harness._reader(name, ROOT).read(SimpleNamespace(counters={}, trace=trace))


def test_the_readers_are_the_benchmarks_metrics():
    spec = {m["name"]: m for m in harness.load_cell("danube3.serve-docqa")["spec"]["per_layer"]}
    for name, (cell, moves) in READERS.items():
        assert spec[name] == {"name": name, "unit": "%", "better": "higher",
                              "source": "program_counter", "layer": "selector",
                              "moves": moves, "workloads": [cell]}


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_a_known_share_on_a_recorded_session(name):
    from repro_torch.core import spans

    with spans.recording():
        for arm in ("attn.fused", "attn.fused", "attn.unfused", "attn.fused"):
            spans.add(arm, 0)
    assert _read(name) == 75.0
    assert _read(name, trace=None) is None  # untraced
    with spans.recording():
        spans.add("attn.unfused", 0)
    assert _read(name) == 0.0
    with spans.recording():
        spans.add("dispatch.select", 1000)  # a program whose dispatch has no such counters
    assert _read(name) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_reads_nothing_from_a_program_without_the_recorder(name, monkeypatch):
    import sys

    import repro_torch.core

    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    monkeypatch.delattr(repro_torch.core, "spans")
    assert _read(name) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_every_attention_dispatch_of_a_traced_tiny_run_is_fused(name):
    cell = READERS[name][0]
    line = run_tiny(tiny_context(cell, seed=2**31 + 5, trace=True))["line"]
    assert line["metrics"][name] == {"value": 100.0, "unit": "%"}
    assert line["correct"] is True
    untraced = run_tiny(tiny_context(cell, seed=2**31 + 5))["line"]
    assert name not in untraced["metrics"]
