"""The ZeRO-1 cell on the CPU at a tiny size: its driver's four ranks as
gloo processes (this one and three spawned), the program's data-parallel
steps against the reference's over the same ranks, sound, with the
control in the program's place, with rank 0's step broken, and with
rank 0's gradients left out of the exchange."""

import pytest

from cellbench import checks
from cellbench.tests.tiny import TINY_CFG, run_tiny, tiny_context

CELL = "danube3.train-zero1-4chip"
MIX = {"batch": 2, "seq": 16}
CFG = TINY_CFG["h2o-danube3-4b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this rank, as the spawned ranks take: four
    ranks must not starve the other test workers' timed windows."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_a_sound_run_is_correct_and_counts_its_collectives():
    line = run_tiny(tiny_context(CELL, cfg=CFG, mix=MIX, seconds=1.0, trace=True))["line"]
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    gib = line["metrics"]["collectives.gib_per_step.lm_train"]["value"]
    # the gradients' reduce-scatter in f32 and the parameters' all-gather
    assert gib > 0


def test_the_run_reports_every_ranks_tokens():
    out = run_tiny(tiny_context(CELL, cfg=CFG, mix=MIX, seconds=1.0))
    c = out["outcome"].counters
    tokens = out["line"]["metrics"]["lm_train_tokens_per_s"]["value"]
    assert tokens == pytest.approx(c["steps"] * 2 * 4 * 16 / c["window_s"])


@pytest.mark.parametrize("control", ["fp8", "half_batch"])
def test_the_control_is_not_correct(control):
    ctx = tiny_context(CELL, cfg=CFG, mix=MIX, seconds=0.5, control=control)
    outcome = run_tiny(ctx)["outcome"]
    ok, got = checks.judge(outcome.control_numbers, ctx.limits)
    assert not ok, got


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from repro_torch.launch import steps

    real = steps.make_train_step

    def made(*a, **kw):
        step = real(*a, **kw)
        return lambda state, batch: (state, step(state, batch)[1])

    monkeypatch.setattr(steps, "make_train_step", made)
    line = run_tiny(tiny_context(CELL, cfg=CFG, mix=MIX, seconds=0.5))["line"]
    assert line["correct"] is False, line["checks"]


def test_a_step_without_the_gradient_exchange_is_not_correct(monkeypatch):
    """Rank 0 updates its piece from its own gradients where the
    reduce-scatter's sum over the ranks belongs (it still joins the
    collective, so the other ranks do not wait for it)."""
    from repro_torch.distributed import collectives

    real = collectives.reduce_scatter

    def own_piece(x, axes, dim=0, mesh=None):
        summed = real(x, axes, dim, mesh=mesh)
        mesh_, axes_, _ = collectives._resolve(axes, mesh)
        part = summed.shape[dim]
        return x.narrow(dim, mesh_.axis_index(axes_) * part, part).contiguous()

    monkeypatch.setattr(collectives, "reduce_scatter", own_piece)
    line = run_tiny(tiny_context(CELL, cfg=CFG, mix=MIX, seconds=0.5))["line"]
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["grad_norm_gap"]["value"] > line["checks"]["grad_norm_gap"]["limit"]
