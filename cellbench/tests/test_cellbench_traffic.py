"""The serving traffic: every seed offers the same requests at the same
times, their sizes in another order, each request's sizes and gap drawn
alone from the mix's distributions; and a run above the knee leaves what
is still queued at the close unanswered rather than failed."""

import itertools
import json
import math
import statistics

import numpy as np
import pytest

from cellbench import traffic
from cellbench.tests.tiny import ROOT, run_tiny, tiny_context

MIXES = ("docqa-open", "docqa-bursty-over")


def _mix(name, **kw):
    return dict(json.loads((ROOT / "cellbench" / "traffic" / f"{name}.json").read_text()), **kw)


def _block(mix, seed):
    got = list(itertools.islice(traffic.arrivals(mix, seed), int(mix["block"])))
    gaps = np.diff([0.0] + [a.due_s for a in got])
    return got, gaps


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_offers_the_same_block_at_the_same_times(name):
    mix = _mix(name)
    one, gaps_one = _block(mix, 2**33 + 5)
    two, gaps_two = _block(mix, 12)
    assert sorted(a.prompt_len for a in one) == sorted(a.prompt_len for a in two)
    assert sorted(a.max_new for a in one) == sorted(a.max_new for a in two)
    assert np.array_equal(gaps_one, gaps_two)
    assert [a.prompt_len for a in one] != [a.prompt_len for a in two]
    assert [a.max_new for a in one] != [a.max_new for a in two]
    assert one[-1].due_s == pytest.approx(mix["block"] / mix["rate_per_s"])


@pytest.mark.parametrize("name,cv", [("docqa-open", 1.0), ("docqa-bursty-over", math.sqrt(2))])
def test_a_long_block_follows_the_mixes_distributions(name, cv):
    """At 4000 requests a block shows the distributions the mix states:
    the log-normal's median and the share clipped at the window, outputs
    over their whole range, and gaps as variable as the arrival process
    (Poisson: 1; gamma of shape 0.5: sqrt 2)."""
    mix = _mix(name, block=4000)
    got, gaps = _block(mix, 3)
    p = mix["prompt"]
    prompts = [a.prompt_len for a in got]
    assert statistics.median(prompts) == pytest.approx(p["median"], rel=0.05)
    clipped = statistics.NormalDist().cdf(-math.log(p["max"] / p["median"]) / p["sigma"])
    assert np.mean(np.asarray(prompts) == p["max"]) == pytest.approx(clipped, abs=0.015)
    assert min(prompts) >= p["min"] and max(prompts) == p["max"]
    assert {a.max_new for a in got} == set(range(mix["output"]["min"], mix["output"]["max"] + 1))
    assert np.std(gaps) / np.mean(gaps) == pytest.approx(cv, rel=0.1)


def test_a_run_above_the_knee_leaves_the_queue_unanswered_not_failed():
    out = run_tiny(tiny_context("danube3.serve-docqa-over", seconds=2.0))
    line, counters = out["line"], out["outcome"].counters
    assert line["failed"] == 0 and line["correct"] is True, line["checks"]
    assert line["attempted"] == counters["requests"] > 0
    assert "serve_tokens_per_s" in line["metrics"] and "serve_ttft_p90_ms" not in line["metrics"]
