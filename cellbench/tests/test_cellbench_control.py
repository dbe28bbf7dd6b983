"""``correct`` comes out false for the control and for each fault a cell
can have, and true for a sound run: the harness's look for a card is
skipped and the rest of a run is driven on the CPU at small sizes, under
each cell's own limits, with the timed path broken underneath."""

import itertools

import pytest

from cellbench import checks
from cellbench.tests.tiny import CHECK_SIZES, run_tiny, tiny_context

FCN, LM = "fcn-synthetic-3h.train", "danube3-12L.train-8x2048"
SERVE, SERVE_OVER = "danube3.serve-docqa", "danube3.serve-docqa-over"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the serving runs are timed windows, and test
    workers that each spread over every core starve them of steps."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ctx(cell, **kw):
    if cell == SERVE:  # wide enough that the served-token check separates
        kw.update(cfg=CHECK_SIZES["cfg"], mix=CHECK_SIZES["short_mix"], seconds=3.0)
    return tiny_context(cell, **kw)


@pytest.mark.parametrize("cell", [FCN, LM, SERVE, SERVE_OVER])
def test_a_sound_run_is_correct(cell):
    line = run_tiny(tiny_context(cell, seconds=2.0))["line"]
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("cell,control", [(FCN, "tf32"), (LM, "fp8")])
def test_the_control_is_not_correct(cell, control):
    """The reference in the precision below the configuration's, in the
    program's place: it fails at least one of the cell's numbers."""
    ctx = _ctx(cell, control=control)
    outcome = run_tiny(ctx)["outcome"]
    ok, got = checks.judge(outcome.control_numbers, ctx.limits)
    assert not ok, got


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_serving_control_is_not_correct(seed):
    """The served tokens of a fixed set of requests, read at each position
    against the token the reference in fp8 puts first: the program's
    pass the cell's limit, the control's do not."""
    from cellbench import program, traffic
    from cellbench.drivers import lm_serve

    ctx = _ctx(SERVE, seed=seed, control="fp8")
    ctx.mix.update(CHECK_SIZES["mix"])  # answers of up to 32 tokens: ~200 compared
    engine = lm_serve._engine(ctx, program.lm_params(ctx.cfg, seed, "cpu"))
    for a in itertools.islice(traffic.arrivals(ctx.mix, seed), 12):
        engine.submit(traffic.prompt_tokens(seed, a.index, a.prompt_len, ctx.cfg["vocab_size"]),
                      a.max_new, cls="serve")
    engine.run()
    numbers, control = lm_serve._reference(ctx, lm_serve._sample(engine, seed, 12))
    assert checks.judge(numbers, ctx.limits)[0], numbers
    assert not checks.judge(control, ctx.limits)[0], control


def _train_fault(kind):
    """A train step of the port broken one way: its state returned as it
    came, or half of each batch left out (the mean over the rest)."""
    def half(batch):
        n = next(iter(batch.values())).shape[0] // 2
        return {k: v[:n] for k, v in batch.items()}

    def fcn(make):
        def made(*a, **kw):
            real = make(*a, **kw)

            def step(params, opt, i, batch):
                if kind == "half_batch":
                    return real(params, opt, i, half(batch))
                _, _, loss, gnorm = real(params, opt, i, batch)
                return params, opt, loss, gnorm
            return step
        return made

    def lm(make):
        def made(*a, **kw):
            real = make(*a, **kw)

            def step(state, batch):
                if kind == "half_batch":
                    return real(state, half(batch))
                return state, real(state, batch)[1]
            return step
        return made

    return fcn, lm


@pytest.mark.parametrize("cell", [FCN, LM])
@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(monkeypatch, cell, kind):
    from repro_torch.examples import train_fcn
    from repro_torch.launch import steps

    fcn, lm = _train_fault(kind)
    monkeypatch.setattr(train_fcn, "make_fcn_step", fcn(train_fcn.make_fcn_step))
    monkeypatch.setattr(steps, "make_train_step", lm(steps.make_train_step))
    line = run_tiny(_ctx(cell))["line"]
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("kind", ["token_altered", "state_unchanged"])
def test_a_broken_decode_step_is_not_correct(monkeypatch, kind):
    """A decode step whose token is altered where it is produced, or that
    leaves the cache as it found it."""
    from repro_torch.serving import ServeEngine

    real = ServeEngine._decode_step

    def broken(self, cls, tok, slot_ids, lengths):
        if kind == "token_altered":
            return (real(self, cls, tok, slot_ids, lengths) + 1) % self.cfg.vocab
        saved = [leaf.clone() for leaf in self.kv.leaves()]
        out = real(self, cls, tok, slot_ids, lengths)
        for leaf, old in zip(self.kv.leaves(), saved):
            leaf.copy_(old)
        return out

    monkeypatch.setattr(ServeEngine, "_decode_step", broken)
    line = run_tiny(_ctx(SERVE))["line"]
    gap = line["checks"]["logit_gap"]
    assert gap["value"] is not None, "no request finished: nothing was compared"
    assert line["correct"] is False and gap["value"] > gap["limit"], gap
