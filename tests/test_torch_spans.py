"""The port's span and counter recorder (``core/spans.py``) and the spans
it places: the optimizer update, the attention backward, the serving
engine's step, queue, prefill and decode, and the dispatch counter."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.autograd.profiler as autograd_profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.arch import ArchConfig, BlockCfg  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.core.engine import dispatch_attention, policy_from_spec  # noqa: E402
from repro_torch.core.faults import clear_quarantine, fallback_counts, inject_faults  # noqa: E402
from repro_torch.core.policy import FixedPolicy  # noqa: E402
from repro_torch.examples.train_fcn import make_fcn_step  # noqa: E402
from repro_torch.launch.steps import TrainStepConfig, init_train_state, make_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.fcn import FCNConfig, init_fcn  # noqa: E402
from repro_torch.optim import adamw_init, constant  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

TINY = ArchConfig(
    name="tiny-spans", family="dense", d_model=32, n_heads=2, n_kv=2, d_head=16, d_ff=64,
    vocab=64, segments=((2, (BlockCfg("attn", "mlp"),)),), param_dtype="float32",
    attn_chunk=16, remat="none",
)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


# -- the recorder --------------------------------------------------------------


def test_the_profiler_flag_the_recorder_reads_flips_with_a_session():
    """A torch without this flag, or whose profiler start no longer calls
    the hook the recorder wraps, must fail here rather than record nothing."""
    assert autograd_profiler._is_profiler_enabled is False
    assert getattr(autograd_profiler._run_on_profiler_start, "_drops_span_records", False)
    prof = _cpu_profile()
    prof.start()
    try:
        assert autograd_profiler._is_profiler_enabled is True and spans.enabled()
    finally:
        prof.stop()
    assert autograd_profiler._is_profiler_enabled is False and not spans.enabled()


def test_off_returns_the_shared_null_context_and_records_nothing():
    with spans.recording():
        pass
    assert not spans.enabled()
    first = spans.span("repro_torch.test.a", rid=1)
    assert first is spans.span("repro_torch.test.b", device=torch.device("cpu"))
    with first as rec:
        assert rec is None
    spans.record("repro_torch.test.c", 0, 10)
    spans.add("test.counter", 5)
    assert spans.stamp() == 0
    assert spans.records() == [] and spans.counter("test.counter") is None
    assert spans.summary("repro_torch.test.a") is None


def test_recording_turns_it_on_and_a_new_session_drops_the_old_records():
    with spans.recording():
        assert spans.enabled()
        with spans.span("repro_torch.test.first"):
            pass
        spans.add("test.counter", 7)
    assert not spans.enabled()
    assert [s.name for s in spans.records()] == ["repro_torch.test.first"]
    assert spans.counter("test.counter") == (7, 1)
    with spans.recording():
        with spans.span("repro_torch.test.second"):
            pass
    assert [s.name for s in spans.records()] == ["repro_torch.test.second"]
    assert spans.counter("test.counter") is None
    prof = _cpu_profile()
    prof.start()
    try:
        assert spans.records() == []  # the profiler's start is a new session
        with spans.span("repro_torch.test.third"):
            torch.ones(4).sum()
    finally:
        prof.stop()
    assert [s.name for s in spans.records()] == ["repro_torch.test.third"]


def test_parents_and_self_time_of_nested_spans():
    with spans.recording():
        with spans.span("repro_torch.test.outer", step=3) as outer:
            with spans.span("repro_torch.test.inner", k=0) as a:
                sum(range(20000))
            with spans.span("repro_torch.test.inner", k=1) as b:
                with spans.span("repro_torch.test.leaf") as leaf:
                    sum(range(20000))
            sum(range(20000))
        t0 = spans.stamp()
        assert t0 > 0
        spans.add("test.select", spans.stamp() - t0)
        spans.add("test.select", 100, n=2)
    assert outer.parent is None and a.parent is outer and b.parent is outer
    assert leaf.parent is b and outer.ids == {"step": 3} and b.ids == {"k": 1}
    assert outer.child_ns == (a.end_ns - a.start_ns) + (b.end_ns - b.start_ns)
    assert b.self_s == pytest.approx(b.host_s - leaf.host_s)
    assert 0 < outer.self_s < outer.host_s
    inner = spans.summary("repro_torch.test.inner")
    assert inner.count == 2 and inner.host == [a.host_s, b.host_s]
    assert inner.host_s == pytest.approx(a.host_s + b.host_s)
    assert inner.self_s == [a.host_s, b.self_s]
    ns, n = spans.counter("test.select")
    assert n == 3 and ns >= 100


def test_device_time_is_host_time_off_the_card():
    with spans.recording():
        with spans.span("repro_torch.test.dev", device=torch.device("cpu")) as rec:
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert rec.events is None and rec.device_s == rec.host_s > 0
    s = spans.summary("repro_torch.test.dev")
    assert s.device == s.host and s.device_s == s.host_s


def test_a_finished_span_has_no_parent():
    with spans.recording():
        with spans.span("repro_torch.test.open"):
            spans.record("repro_torch.test.wait", 1_000, 4_000, rid=9)
    (wait,) = spans.records("repro_torch.test.wait")
    assert wait.parent is None and wait.ids == {"rid": 9} and wait.host_s == 3e-6
    assert spans.records("repro_torch.test.open")[0].child_ns == 0


# -- the engine ----------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    return lm.init_lm(0, TINY, device="cpu")


def _engine(params):
    return ServeEngine(TINY, params, n_slots=3, max_seq=32, cache_dtype=torch.float32,
                       device="cpu")


def _submit(eng, n=6):
    rng = np.random.RandomState(3)
    return [eng.submit(rng.randint(0, TINY.vocab, (int(rng.randint(3, 12)),)),
                       max_new=int(rng.randint(2, 5)),
                       cls=("interactive", "bulk")[i % 2]) for i in range(n)]


def test_engine_spans_under_recording(params):
    eng = _engine(params)
    with spans.recording():
        reqs = _submit(eng)
        eng.run()
    assert all(r.state.value == "finished" for r in reqs)
    queued = {s.ids["rid"]: s for s in spans.records("repro_torch.engine.queued")}
    prefill = {s.ids["rid"]: s for s in spans.records("repro_torch.engine.prefill")}
    assert sorted(queued) == sorted(prefill) == [r.rid for r in reqs]
    assert len(spans.records("repro_torch.engine.queued")) == len(reqs)
    for r in reqs:
        q, p = queued[r.rid], prefill[r.rid]
        assert q.end_ns == p.start_ns and q.start_ns == int(r.submit_time * 1e9)
        assert q.ids["cls"] == r.cls and p.ids["prompt_len"] == r.prompt_len
        assert p.parent.name == "repro_torch.engine.step"
    steps = spans.records("repro_torch.engine.step")
    assert len(steps) == eng.clock and [s.ids["clock"] for s in steps] == list(range(eng.clock))
    decode = spans.records("repro_torch.engine.decode")
    for step in steps:
        classes = [d.ids["cls"] for d in decode if d.parent is step]
        assert len(classes) == len(set(classes))  # one decode a class a step
    # every token after a request's first came from one decode row
    assert sum(d.ids["rows"] for d in decode) == sum(len(r.generated) - 1 for r in reqs)
    assert all(s.self_s >= 0 for s in steps)
    s = spans.summary("repro_torch.engine.step")
    children = sum(x.host_s for x in decode) + sum(x.host_s for x in prefill.values())
    assert sum(s.self_s) == pytest.approx(s.host_s - children, abs=1e-6)


def test_engine_records_nothing_off(params):
    with spans.recording():
        pass
    eng = _engine(params)
    _submit(eng, 2)
    eng.run()
    assert spans.records() == [] and spans.counter("dispatch.select") is None


def test_a_profile_of_an_engine_step_names_the_ports_spans(params):
    eng = _engine(params)
    _submit(eng, 3)
    with _cpu_profile() as prof:
        eng.step()
        eng.step()
    names = {e.name() for e in prof.profiler.kineto_results.events() if e.is_user_annotation()}
    assert {"repro_torch.engine.step", "repro_torch.engine.prefill",
            "repro_torch.engine.decode"} <= names
    assert not any(n.startswith("repro_torch.dispatch") for n in names)  # no span a dispatch
    assert spans.counter("dispatch.select")[1] > 0
    assert len(spans.records("repro_torch.engine.queued")) == 3


def test_submit_time_is_on_the_perf_counter_clock(params):
    import time

    eng = _engine(params)
    before = time.perf_counter()
    (req,) = _submit(eng, 1)
    assert before <= req.submit_time <= time.perf_counter()


# -- training ------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_lm_train_step_spans(params, remat):
    cfg = TINY.replace(remat=remat)
    policy = policy_from_spec("fixed:XLA_NT")
    step = make_train_step(cfg, TrainStepConfig(warmup=1, total_steps=4), policy=policy)
    state = init_train_state(cfg, {k: v for k, v in params.items()})
    rng = np.random.RandomState(0)
    batch = {k: torch.from_numpy(rng.randint(0, TINY.vocab, (2, 16))) for k in ("tokens",
                                                                               "labels")}
    with spans.recording():
        calls = policy.stats.calls
        for _ in range(2):
            state, _ = step(state, batch)
        calls = policy.stats.calls - calls
    updates = spans.records("repro_torch.optim.update")
    assert [u.ids["step"] for u in updates] == [0, 1]
    backward = spans.records("repro_torch.attn.backward")
    assert len(backward) == 2 * TINY.n_layers
    assert {(b.ids["g"], b.ids["m"], b.ids["n"]) for b in backward} == {(2 * TINY.n_heads, 16, 16)}
    assert all(b.device_s == b.host_s for b in backward)
    # every dispatch that selects is counted once; a remat replay selects nothing
    assert spans.counter("dispatch.select")[1] == calls > 0


def test_fcn_step_has_one_update_span_a_step():
    cfg = FCNConfig("fcn-spans", 24, 10, (16, 16))
    params = init_fcn(0, cfg, device="cpu")
    opt = adamw_init(params)
    step = make_fcn_step(policy_from_spec("fixed:XLA_NT"), constant(1e-3))
    rng = np.random.RandomState(0)
    batch = {"x": torch.from_numpy(rng.randn(8, 24).astype(np.float32)),
             "labels": torch.from_numpy(rng.randint(0, 10, (8,)))}
    with spans.recording():
        for i in range(3):
            params, opt, _, _ = step(params, opt, i, batch)
    s = spans.summary("repro_torch.optim.update")
    assert s.count == 3 and [u.ids["step"] for u in spans.records()
                             if u.name == "repro_torch.optim.update"] == [0, 1, 2]


# -- the attention arm counters -------------------------------------------------


def _attend(policy=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(4, s, 16, generator=g) for s in (8, 12, 12))
    return dispatch_attention(q, k, v, causal=True, q_start=4, policy=policy)


@pytest.mark.parametrize("arm", ["FUSED_ATTN", "UNFUSED_ATTN", None])
def test_attention_dispatches_count_the_arm_that_ran(arm):
    """A fixed arm counts under its own name; the default policy sends this
    d_head 16 key to the fused kernel.  Off, nothing counts."""
    with spans.recording():
        pass
    _attend(None if arm is None else FixedPolicy(arm))
    assert spans.counter("attn.fused") is None and spans.counter("attn.unfused") is None
    with spans.recording():
        for seed in range(3):
            _attend(None if arm is None else FixedPolicy(arm), seed)
    ran, other = ("attn.unfused", "attn.fused") if arm == "UNFUSED_ATTN" else (
        "attn.fused", "attn.unfused")
    assert spans.counter(ran) == (0, 3) and spans.counter(other) is None


def test_a_degraded_fused_dispatch_counts_as_unfused():
    want = _attend(FixedPolicy("UNFUSED_ATTN"))
    try:
        with warnings.catch_warnings(), spans.recording():
            warnings.simplefilter("ignore")
            with inject_faults("raise:FUSED_ATTN.ATTN"):
                out = _attend(FixedPolicy("FUSED_ATTN"))
            out2 = _attend(FixedPolicy("FUSED_ATTN"))  # quarantined: not tried again
        assert spans.counter("attn.unfused") == (0, 2) and spans.counter("attn.fused") is None
        assert fallback_counts()[("ATTN", "FUSED_ATTN", "UNFUSED_ATTN")] >= 2
        assert torch.equal(out, want) and torch.equal(out2, want)
    finally:
        clear_quarantine()
