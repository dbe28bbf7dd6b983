"""granite-4.0-h-small's cell on the CPU at a tiny size: the plain
reference against the port's forward, its engine's prefill then cached
decode against the reference's full forward, the whole cell's driver
through ``tiny.py`` (sound, and broken), its work counts and its
readers."""

import numpy as np
import pytest
import torch

from cellbench import checks, granite, traffic
from cellbench.flops import granite as gflops
from cellbench.reference import granite_hybrid
from cellbench.tests.tiny import run_tiny, tiny_context

CELL = "granite-h-small.serve-rag-over"
# one period of the Mamba/attention pattern, 8 experts top-2, a shared expert
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
        "num_hidden_layers": 4, "layer_types": ["mamba", "attention", "mamba", "mamba"],
        "mamba_n_heads": 8, "mamba_d_head": 16, "mamba_d_state": 16, "mamba_chunk_size": 8,
        "num_local_experts": 8, "num_experts_per_tok": 2, "intermediate_size": 32,
        "shared_intermediate_size": 48, "vocab_size": 256, "attention_multiplier": 0.25,
        "torch_dtype": "float32"}
MIX = {"slots": 4, "prompt_bucket": 24, "rate_per_s": 400.0, "block": 8, "max_queue": 4000,
       "prompt": {"median": 10, "sigma": 0.6, "min": 3, "max": 20},
       "output": {"min": 2, "max": 4}, "sample": {"requests": 3}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg():
    return tiny_context(CELL, cfg=TINY, mix=MIX).cfg


def _params(cfg, seed=3):
    """The benchmark's weights, with norm scales that matter."""
    tree = granite.params(cfg, seed, "cpu")
    for path, t in _leaves(tree):
        if path[-1] == "scale":
            t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(len(path))) * 0.1)
    return tree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_config_file_builds_the_registered_model():
    from repro_torch.configs import get_config

    full = tiny_context(CELL, cfg={}, mix={}).cfg
    assert granite.arch_config(full).replace(name="x", remat="full") == get_config(
        "granite-4.0-h-small").replace(name="x")


@pytest.mark.parametrize("S", [7, 19])
def test_reference_forward_matches_the_port(S):
    from repro_torch.models import lm

    cfg = _cfg()
    tree = _params(cfg)
    tokens = traffic.lm_batch(5, 0, 256, 1, S, "cpu")["tokens"]
    got = lm.lm_forward(tree, granite.arch_config(cfg), {"tokens": tokens})[0]
    want = granite_hybrid.forward(granite.reference_params(tree, cfg), cfg, tokens[0])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    at = torch.tensor([2, S - 1])
    torch.testing.assert_close(
        granite_hybrid.forward(granite.reference_params(tree, cfg), cfg, tokens[0], at=at),
        want[at], rtol=1e-5, atol=1e-6)


def test_engine_prefill_then_decode_matches_the_reference():
    """Requests through the engine (exact-length prefill into a slot,
    then cached decode beside other requests); each step's logits against
    the reference's full forward over the prompt and the tokens served."""
    from cellbench.drivers import hybrid_serve
    from repro_torch.serving import RequestState

    ctx = tiny_context(CELL, cfg=TINY, mix=MIX)
    tree = _params(ctx.cfg)
    eng = hybrid_serve.engine(ctx, tree)
    seen = {}
    real = eng._decode_step

    def spy(cls, tok, slot_ids, lengths):
        out = real(cls, tok, slot_ids, lengths)
        seen.setdefault("calls", 0)
        seen["calls"] += 1
        return out

    eng._decode_step = spy
    reqs = [eng.submit(traffic.prompt_tokens(1, i, n, 256), 5, cls="serve")
            for i, n in enumerate((3, 17, 9, 20, 11))]
    eng.run()
    assert seen["calls"] > 0
    ref = granite.reference_params(tree, ctx.cfg)
    for r in reqs:
        assert r.state is RequestState.FINISHED
        seq = torch.as_tensor(np.concatenate([r.tokens, r.generated[:-1]]))
        logits = granite_hybrid.forward(ref, ctx.cfg, seq, at=torch.arange(r.prompt_len - 1,
                                                                           len(seq)))
        assert logits.argmax(-1).tolist() == r.generated


def test_the_cell_runs_correct_and_reads_its_metrics():
    line = run_tiny(tiny_context(CELL, cfg=TINY, mix=MIX, seconds=2.0, trace=True))["line"]
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    m = line["metrics"]
    assert 0 < m["mfu.serve"]["value"]
    assert 0 < m["engine.occupancy.serve"]["value"] <= 100  # lm_serve's reader, unchanged
    # the CPU runs no kernels: the readers of the device's time find none
    assert "moe.expert_roofline.granite_serve" not in m


def test_the_cell_reports_throughput():
    line = run_tiny(tiny_context(CELL, cfg=TINY, mix=MIX, seconds=1.0))["line"]
    assert set(line["metrics"]) == {"serve_tokens_per_s", "setup_s"}
    assert line["metrics"]["serve_tokens_per_s"]["value"] > 0


@pytest.mark.parametrize("kind", ["token_altered", "state_unchanged"])
def test_a_broken_decode_step_is_not_correct(monkeypatch, kind):
    """A decode step whose token is altered where it is produced, or that
    leaves the Mamba and attention state as it found it."""
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
    line = run_tiny(tiny_context(CELL, cfg=TINY, mix=MIX, seconds=2.0))["line"]
    gap = line["checks"]["logit_gap"]
    assert gap["value"] is not None, "no request finished: nothing was compared"
    assert line["correct"] is False and gap["value"] > gap["limit"], gap


def test_a_dropped_expert_row_is_not_correct(monkeypatch):
    """Every fifth token-expert row of the grouped GEMMs left out: the
    served tokens drift from the reference's."""
    from repro_torch.models import moe

    real = moe.grouped_mm

    def dropping(a, w, offs):
        out = real(a, w, offs)
        return out * (torch.arange(out.shape[0])[:, None] % 5 != 0)

    monkeypatch.setattr(moe, "grouped_mm", dropping)
    line = run_tiny(tiny_context(CELL, cfg=TINY, mix=MIX, seconds=2.0))["line"]
    assert line["correct"] is False, line["checks"]


def test_flops_at_the_published_widths():
    cfg = tiny_context(CELL, cfg={}, mix={}).cfg
    per = gflops.token_flops(cfg)
    assert 17.0e9 < per + gflops.head_flops(cfg) < 18.0e9
    routed = 40 * 6.0 * 4096 * 768 * 10
    assert gflops.expert_flops(cfg, 10) == routed / 40
    assert gflops.prefill_flops(cfg, 2) == pytest.approx(
        2 * per + gflops.head_flops(cfg) + 4.0 * 4096 * 3 * 4)
    # a decode step of 32 rows touches nearly every expert: bound by bandwidth
    one = gflops.expert_bound_s(cfg, 320, 72)
    assert one == pytest.approx(gflops.expert_bytes(cfg, 320, 72) / 3.35e12)
    assert gflops.expert_bound_s(cfg, 40000, 72) == pytest.approx(
        gflops.expert_flops(cfg, 40000) / 989e12)


def test_control_reads_above_the_limit_at_a_wider_size():
    """The reference in fp8 in the program's place, on served requests:
    the program's tokens pass the cell's limit, the control's do not."""
    import itertools

    from cellbench.drivers import hybrid_serve

    wide = dict(TINY, hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
                mamba_n_heads=8, mamba_d_head=64, intermediate_size=128,
                shared_intermediate_size=256, vocab_size=1024)
    mix = dict(MIX, prompt_bucket=64, prompt={"median": 30, "sigma": 0.6, "min": 8, "max": 60},
               output={"min": 16, "max": 40}, sample={"requests": 12})
    ctx = tiny_context(CELL, cfg=wide, mix=mix, control="fp8")
    eng = hybrid_serve.engine(ctx, granite.params(ctx.cfg, ctx.seed, "cpu"))
    for a in itertools.islice(traffic.arrivals(ctx.mix, 1), 12):
        eng.submit(traffic.prompt_tokens(1, a.index, a.prompt_len, 1024), a.max_new, cls="serve")
    eng.run()
    numbers, control = hybrid_serve.reference(ctx, hybrid_serve._sample(eng, 1, 12))
    assert checks.judge(numbers, ctx.limits)[0], numbers
    assert not checks.judge(control, ctx.limits)[0], control
