"""The port's serving engine against the JAX package's, on the same
weights (``tests/test_serving.py``'s TINY config, converted with
``repro_torch.convert``): mixed prompt lengths across both request
classes must give identical greedy tokens to the JAX ``ServeEngine`` and
to unbatched greedy generation, with the same bucket, slot and admission
bookkeeping and no crashed steps.  Both classes of the port run the
kernel policies (plain versions on the CPU); the JAX engine runs the
library policy, which computes the same function.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.arch import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.arch import BlockCfg as JBlockCfg  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    PagedKVCache,
    QueueFullError,
    RequestState,
    ServeEngine,
)
from test_torch_lm import converted_params, to_port_cfg  # noqa: E402

TINY = JArchConfig(  # tests/test_serving.py::TINY
    name="tiny-serve", family="dense", d_model=32, n_heads=2, n_kv=2, d_head=16, d_ff=64,
    vocab=64, segments=((2, (JBlockCfg("attn", "mlp"),)),), param_dtype="float32",
    compute_dtype="float32", attn_chunk=16, remat="none",
)
KERNEL_POLICIES = {"interactive": "fixed:nt=PALLAS_TNN,attn=fused",
                   "bulk": "fixed:nt=PALLAS_NT,attn=fused"}


@pytest.fixture(scope="module")
def weights():
    return converted_params(TINY)


def port_engine(params, **kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("max_seq", 32)
    policies = {cls: engine.policy_from_spec(s) for cls, s in KERNEL_POLICIES.items()}
    return ServeEngine(to_port_cfg(TINY), params, policies=policies,
                       cache_dtype=torch.float32, device="cpu", **kw)


def mixed_prompts(lens, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, TINY.vocab, (n,)).astype(np.int32) for n in lens]


def port_reference(params, prompt, max_new, max_seq=32):
    """Unbatched greedy generation with the port's LM."""
    cfg = to_port_cfg(TINY)
    with engine.use_policy(engine.policy_from_spec("fixed:XLA_NT")):
        logits, cache = lm.lm_prefill(params, cfg, {"tokens": torch.from_numpy(prompt)[None]},
                                      max_seq=max_seq, cache_dtype=torch.float32)
        toks = [int(torch.argmax(logits[0, -1, : cfg.vocab]))]
        for _ in range(max_new - 1):
            logits, cache = lm.lm_decode(params, cfg, cache, {"tokens": torch.tensor([[toks[-1]]])})
            toks.append(int(torch.argmax(logits[0, -1, : cfg.vocab])))
    return toks


def jax_reference(jparams, prompt, max_new, max_seq=32):
    """tests/test_serving.py::reference_generate (JAX, unbatched)."""
    with jengine.use_policy(jengine.policy_from_spec("fixed:XLA_NT")):
        logits, cache = jlm.lm_prefill(jparams, TINY, {"tokens": jnp.asarray(prompt)[None]},
                                       max_seq=max_seq, cache_dtype=jnp.float32)
        toks = [int(jnp.argmax(logits[0, -1, : TINY.vocab]))]
        for _ in range(max_new - 1):
            step = jnp.asarray([[toks[-1]]], jnp.int32)
            logits, cache = jlm.lm_decode(jparams, TINY, cache, {"tokens": step})
            toks.append(int(jnp.argmax(logits[0, -1, : TINY.vocab])))
    return toks


def test_mixed_classes_match_jax_engine_and_reference(weights):
    jparams, params = weights
    prompts = mixed_prompts([3, 17, 9, 1, 12, 5])
    jeng = JServeEngine(
        TINY, jparams, n_slots=4, max_seq=32, cache_dtype=jnp.float32,
        policies={c: jengine.policy_from_spec("fixed:XLA_NT") for c in KERNEL_POLICIES},
    )
    eng = port_engine(params)
    classes = sorted(KERNEL_POLICIES)
    for i, p in enumerate(prompts):
        jeng.submit(p, max_new=6, cls=classes[i % 2])
        eng.submit(p, max_new=6, cls=classes[i % 2])
    jeng.run()
    eng.run()
    assert dataclasses.astuple(eng.buckets) == dataclasses.astuple(jeng.buckets)
    assert eng.health() == jeng.health()
    assert eng.health()["crashed_steps"] == 0
    assert eng.clock == jeng.clock
    np.testing.assert_array_equal(eng.kv.lengths, jeng.kv.lengths)
    for rid, req in eng.requests.items():
        jreq = jeng.requests[rid]
        assert req.state is RequestState.FINISHED
        assert req.generated == jreq.generated, f"rid={rid}"
        assert (req.slot, req.admit_step, req.finish_step) == \
            (jreq.slot, jreq.admit_step, jreq.finish_step)
    for req, p in zip(eng.requests.values(), prompts):
        assert req.generated == port_reference(params, p, 6)
    for req, p in list(zip(eng.requests.values(), prompts))[:2]:  # eager JAX is slow
        assert req.generated == jax_reference(jparams, p, 6)
    rows = eng.class_dispatch_rows()
    assert rows["interactive"]["NT"] == {"PALLAS_TNN": rows["interactive"]["NT"]["PALLAS_TNN"]}
    assert set(rows["bulk"]) == {"NT", "ATTN"} and "FUSED_ATTN" in rows["bulk"]["ATTN"]


def test_budget_admission_matches_jax(weights):
    """FCFS under a tight token budget: the head of the queue blocks until
    it fits, in both engines alike."""
    jparams, params = weights
    prompts = mixed_prompts([10, 4, 14, 2], seed=3)
    jeng = JServeEngine(TINY, jparams, n_slots=4, max_seq=32, cache_dtype=jnp.float32,
                        budget_tokens=40,
                        policies={c: jengine.policy_from_spec("fixed:XLA_NT")
                                  for c in KERNEL_POLICIES})
    eng = port_engine(params, budget_tokens=40)
    for p in prompts:
        jeng.submit(p, max_new=8)
        eng.submit(p, max_new=8)
    jeng.run()
    eng.run()
    for rid, req in eng.requests.items():
        jreq = jeng.requests[rid]
        assert (req.admit_step, req.finish_step, req.generated) == \
            (jreq.admit_step, jreq.finish_step, jreq.generated)


def test_evict_midstream_reuses_slot(weights):
    _, params = weights
    eng = port_engine(params, n_slots=2)
    p0, p1, p2 = mixed_prompts([5, 7, 6], seed=5)
    r0, r1, r2 = (eng.submit(p, max_new=6) for p in (p0, p1, p2))
    eng.step()
    slot0 = r0.slot
    eng.evict(r0.rid)
    eng.run()
    assert r0.state is RequestState.EVICTED and r2.slot == slot0
    for req, p in ((r1, p1), (r2, p2)):
        assert req.state is RequestState.FINISHED
        assert req.generated == port_reference(params, p, 6)


def test_null_row_absorbs_bucket_padding(weights):
    """Three active rows decode in a bucket of four: the padding row
    points at the null slot, and the live rows still match the
    unbatched reference."""
    _, params = weights
    eng = port_engine(params)
    assert eng.kv.null_slot == 4 and eng.kv.leaves()[0].shape[1] == 5
    prompts = mixed_prompts([4, 9, 2], seed=9)
    reqs = [eng.submit(p, max_new=5) for p in prompts]
    eng.run()
    for req, p in zip(reqs, prompts):
        assert req.generated == port_reference(params, p, 5)


def test_queue_bound_and_deadlines(weights):
    _, params = weights
    eng = port_engine(params, n_slots=1, max_queue=2)
    p = mixed_prompts([3])[0]
    eng.submit(p, max_new=2)
    eng.submit(p, max_new=2)
    with pytest.raises(QueueFullError):
        eng.submit(p, max_new=2)
    late = port_engine(params, n_slots=1)
    req = late.submit(p, max_new=4, deadline_s=0.0)
    late.step()
    assert req.state is RequestState.DEADLINE_EXCEEDED
    assert late.health()["deadline_exceeded"] == 1


def test_warmup_runs_every_bucket_on_the_null_row(weights):
    _, params = weights
    eng = port_engine(params)
    assert eng.warmup() == {"shapes_run": 2 * (3 + 2)}
    assert not eng.kv.lengths.any() and eng.kv.n_free == 4


def test_crashing_step_is_contained_and_counted(weights):
    _, params = weights
    eng = port_engine(params)
    eng.policies["bulk"] = None  # no policy in scope: dispatch raises
    ok = eng.submit(mixed_prompts([4])[0], max_new=3, cls="interactive")
    bad = eng.submit(mixed_prompts([4])[0], max_new=3, cls="bulk")
    with pytest.warns(UserWarning, match="crashed"):
        eng.run()
    assert ok.state is RequestState.FINISHED and bad.state is RequestState.EVICTED
    assert eng.health()["crashed_steps"] == 1


def test_kv_cache_insert_requires_allocation():
    kv = PagedKVCache(to_port_cfg(TINY), n_slots=2, max_seq=16, dtype=torch.float32,
                      device="cpu")
    with pytest.raises(KeyError):
        kv.insert({"segments": []}, 0, 3)
    with pytest.raises(ValueError):
        PagedKVCache(to_port_cfg(TINY), n_slots=0, max_seq=16, device="cpu")
