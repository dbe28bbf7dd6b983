"""The port's serving engine against the JAX package's, on the same
weights (``tests/test_serving.py``'s TINY config and the smoke configs of
the windowed architectures, converted with ``repro_torch.convert``):
mixed prompt lengths across both request classes must give identical
greedy tokens to the JAX ``ServeEngine`` and to unbatched greedy
generation, with the same bucket, slot and admission bookkeeping and no
crashed steps.  Both classes of the port run the
kernel policies (plain versions on the CPU); the JAX engine runs the
library policy, which computes the same function.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.configs.arch import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.arch import BlockCfg as JBlockCfg  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro.serving.buckets import default_buckets as j_default_buckets  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.policy import FixedPolicy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    PagedKVCache,
    QueueFullError,
    RequestState,
    ServeEngine,
)
from repro_torch.serving.buckets import default_buckets  # noqa: E402
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


@pytest.mark.parametrize("arch", ["gemma3-4b", "gemma2-27b", "h2o-danube-3-4b"])
def test_windowed_architectures_match_jax_engine(arch):
    """gemma3's 5:1 local:global pattern, gemma2's local/global alternation
    with soft-caps and h2o-danube's sliding window, at their smoke sizes
    (window 8): every local block holds a ring of ``window`` slots and
    every global one ``max_seq``, block by block; prompts and generations
    run past the window, so the rings wrap; greedy tokens equal the JAX
    engine's."""
    jcfg = j_smoke_config(arch)
    cfg = to_port_cfg(jcfg)
    jparams, params = converted_params(jcfg)
    max_seq = 32
    policies = {cls: engine.policy_from_spec(s) for cls, s in KERNEL_POLICIES.items()}
    eng = ServeEngine(cfg, params, n_slots=4, max_seq=max_seq, policies=policies,
                      cache_dtype=torch.float32, device="cpu")
    for (count, blocks), seg in zip(cfg.segments, eng.kv.data):
        for b, slot in zip(blocks, seg):
            rows = b.window if b.window is not None else max_seq
            assert slot["k"].shape == (count, 5, rows, cfg.n_kv, cfg.d_head)
    jeng = JServeEngine(jcfg, jparams, n_slots=4, max_seq=max_seq, cache_dtype=jnp.float32,
                        policies={c: jengine.policy_from_spec("fixed:XLA_NT")
                                  for c in KERNEL_POLICIES})
    rng = np.random.RandomState(11)
    classes = sorted(KERNEL_POLICIES)
    for i, n in enumerate([3, 17, 9, 12, 20, 5]):
        prompt = rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
        jeng.submit(prompt, max_new=7, cls=classes[i % 2])
        eng.submit(prompt, max_new=7, cls=classes[i % 2])
    jeng.run()
    eng.run()
    assert dataclasses.astuple(eng.buckets) == dataclasses.astuple(jeng.buckets)
    assert eng.health() == jeng.health() and eng.health()["crashed_steps"] == 0
    for rid, req in eng.requests.items():
        assert req.state is RequestState.FINISHED
        assert req.generated == jeng.requests[rid].generated, f"rid={rid}"


@pytest.mark.parametrize("n_slots,max_prompt_len,window", [(4, 2048, 1024), (4, 1100, 1024),
                                                           (8, 4096, 4096), (2, 30, 8)])
def test_bucket_grid_matches_jax_at_the_architectures_windows(n_slots, max_prompt_len, window):
    """gemma3's window of 1024 raises the length step to 1024, so a
    2048-slot cache holds the prefill buckets 1024 and 2048."""
    mine = default_buckets(n_slots, max_prompt_len, window=window)
    assert dataclasses.astuple(mine) == dataclasses.astuple(
        j_default_buckets(n_slots, max_prompt_len, window=window))
    assert mine.len_step == max(16, window)
    if window == 1024:
        assert mine.prefill_lens == (1024, 2048) and mine.bucket_len(1025) == 2048


@pytest.mark.parametrize("arch", ["musicgen-large", "paligemma-3b"])
def test_engine_rejects_frames_and_vlm_as_the_jax_engine_does(arch):
    jcfg = j_smoke_config(arch)
    jparams, params = converted_params(jcfg)
    with pytest.raises(ValueError, match="input_mode"):
        JServeEngine(jcfg, jparams, n_slots=2, max_seq=16)
    with pytest.raises(ValueError, match="input_mode"):
        ServeEngine(to_port_cfg(jcfg), params, n_slots=2, max_seq=16, device="cpu")


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


class _Crashing(FixedPolicy):
    """A policy whose select raises: the step it runs in crashes."""

    def __init__(self):
        super().__init__("XLA_NT")

    def select(self, key):
        raise RuntimeError("policy fault")


def test_crashing_step_is_contained_and_counted(weights):
    _, params = weights
    eng = port_engine(params)
    eng.policies["bulk"] = _Crashing()  # None would mean the default policy
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


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_mamba_architectures_prefill_at_exact_lengths_and_match_jax_engine(arch):
    """mamba2's SSD blocks and zamba2's Mamba blocks around a shared
    attention block, at their smoke sizes (chunk 8): an SSM state sums
    over every position, so both engines prefill each prompt (1-13
    tokens: the conv cache's pad branch, one chunk, the ragged fallback)
    at its exact length, warm up no prefill bucket, and admit a prompt
    longer than any bucket; greedy tokens equal the JAX engine's."""
    jcfg = j_smoke_config(arch)
    cfg = to_port_cfg(jcfg)
    jparams, params = converted_params(jcfg)
    max_seq = 32
    policies = {cls: engine.policy_from_spec(s) for cls, s in KERNEL_POLICIES.items()}
    eng = ServeEngine(cfg, params, n_slots=4, max_seq=max_seq, policies=policies,
                      cache_dtype=torch.float32, device="cpu",
                      bucket_spec=default_buckets(4, 8))
    jeng = JServeEngine(jcfg, jparams, n_slots=4, max_seq=max_seq, cache_dtype=jnp.float32,
                        bucket_spec=j_default_buckets(4, 8),
                        policies={c: jengine.policy_from_spec("fixed:XLA_NT")
                                  for c in KERNEL_POLICIES})
    assert eng.exact_prefill and jeng.exact_prefill
    assert eng.warmup() == {"shapes_run": 2 * len(eng.buckets.decode_batches)}
    lens = []
    step = eng._prefill_step
    eng._prefill_step = lambda cls, tokens, true_len: (lens.append(
        (tokens.shape[1], true_len)) or step(cls, tokens, true_len))
    rng = np.random.RandomState(13)
    prompt_lens = [1, 13, 3, 8, 2, 11]
    classes = sorted(KERNEL_POLICIES)
    for i, n in enumerate(prompt_lens):
        prompt = rng.randint(0, cfg.vocab, (n,)).astype(np.int32)
        jeng.submit(prompt, max_new=6, cls=classes[i % 2])
        eng.submit(prompt, max_new=6, cls=classes[i % 2])
    jeng.run()
    eng.run()
    assert lens == [(n, n) for n in prompt_lens]
    assert eng.health() == jeng.health() and eng.health()["crashed_steps"] == 0
    for rid, req in eng.requests.items():
        assert req.state is RequestState.FINISHED
        assert req.generated == jeng.requests[rid].generated, f"rid={rid}"


def test_cold_misses_after_warmup_under_autotune_match_the_reference(weights, tmp_path):
    """tests/test_serving.py::test_warmup_covers_every_bucket_no_cold_misses:
    after warmup the bucketed loop only hits measured keys, so each class's
    autotune policy measures nothing more -- the reference's
    {"interactive": 0, "bulk": 0}."""
    from repro_torch.core.policy import AutotunePolicy

    _, params = weights
    policies = {cls: AutotunePolicy(cache_path=str(tmp_path / f"{cls}.json"), device="cpu",
                                    reps=1)
                for cls in ("interactive", "bulk")}
    eng = ServeEngine(to_port_cfg(TINY), params, policies=policies, n_slots=4, max_seq=32,
                      cache_dtype=torch.float32, device="cpu")
    assert eng.cold_misses() == {"interactive": 0, "bulk": 0}  # nothing measured yet
    eng.warmup()
    measured = {cls: p.n_measured for cls, p in policies.items()}
    assert all(n > 0 for n in measured.values())
    for i, p in enumerate(mixed_prompts([3, 9, 14, 6, 11])):
        eng.submit(p, max_new=4, cls=("interactive", "bulk")[i % 2])
    eng.run()
    assert eng.cold_misses() == {"interactive": 0, "bulk": 0}
    assert {cls: p.n_measured for cls, p in policies.items()} == measured
    assert eng.health()["crashed_steps"] == 0


def test_cold_misses_count_measurements_after_warmup(weights, tmp_path):
    """A key first seen after warmup is a cold miss of its class."""
    from repro_torch.core.opkey import OpKey
    from repro_torch.core.policy import AutotunePolicy

    _, params = weights
    policy = AutotunePolicy(cache_path=str(tmp_path / "c.json"), device="cpu", reps=1)
    eng = ServeEngine(to_port_cfg(TINY), params, policies={"interactive": policy},
                      n_slots=2, max_seq=32, cache_dtype=torch.float32, device="cpu")
    eng.warmup()
    policy.select(OpKey("NT", 3, 5, 7, 4))
    assert eng.cold_misses() == {"interactive": 1}


def test_serve_launcher_reports_cold_misses(tmp_path, capsys):
    from repro_torch.launch import serve as serve_mod

    eng = serve_mod.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                          "--requests", "2", "--prompt-len", "6", "--gen", "2",
                          "--policy", f"autotune:{tmp_path / 'cache.json'}"])
    assert set(eng.cold_misses().values()) == {0}
    assert "post-warmup cold-miss measurements" in capsys.readouterr().out
