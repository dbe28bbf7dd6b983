"""The port's LM against the JAX package's on the same weights: JAX
``init_lm`` params go through ``repro_torch.convert.params_from_numpy``,
then ``lm_prefill`` logits and caches and several ``lm_decode`` steps
must agree under both kernel policies and the library policy (the JAX
side runs its Pallas kernels in interpret mode; the port's kernel arms
run their plain versions on the CPU).  The configs: tiny ones, and the
smoke configs of every architecture that decodes (the token models, the
MoE, Mamba-2 and Zamba2 hybrid ones among them, and musicgen-large
decoding ``frames``).

Tolerance: f32, ``rtol = atol = 1e-4``.  The two frameworks sum GEMMs of
k <= 128 in another order and round RoPE's sin/cos and the softmax exp
differently; through a layer or two that drift stays near 1e-6, so 1e-4
catches any wrong mask, position or cache slot, which move logits at
1e-2 or more.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.configs.arch import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.arch import BlockCfg as JBlockCfg  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.arch import ArchConfig, BlockCfg, MoEConfig, SSMConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.models import lm  # noqa: E402

POLICIES = ["fixed:nt=PALLAS_TNN,attn=fused", "fixed:nt=PALLAS_NT,attn=fused", "fixed:XLA_NT"]
TOL = dict(rtol=1e-4, atol=1e-4)

# tests/test_serving.py::TINY_WINDOWED's shape, plus a GQA fold and a
# chunked prefill (attn_chunk 8 < prompt) so the chunk schedule runs
TINY_WINDOWED = JArchConfig(
    name="tiny-windowed", family="dense", d_model=32, n_heads=4, n_kv=2, d_head=16,
    d_ff=64, vocab=64, segments=((2, (JBlockCfg("attn", "mlp", window=8),)),),
    param_dtype="float32", compute_dtype="float32", attn_chunk=8, remat="none",
)
TINY_GLOBAL_CHUNKED = TINY_WINDOWED.replace(
    name="tiny-global", segments=((2, (JBlockCfg("attn", "mlp"),)),), attn_softcap=30.0,
    final_softcap=20.0, qk_norm=True, post_norm=True,
)
# every architecture of the port, and the ones that decode beside smollm:
# gemma3's 5:1 local:global pattern with QK-norm and post-norms, gemma2's
# soft-caps, h2o-danube's sliding window, musicgen's frames, the MoE FFNs
# of grok-1 (top-2 of 4 at smoke size) and kimi-k2, mamba2's SSD blocks
# and zamba2's Mamba blocks around one shared attention block
MOE_SSM_ARCHS = ["grok-1-314b", "kimi-k2-1t-a32b", "mamba2-2.7b", "zamba2-7b"]
ARCHS = ["gemma2-27b", "gemma3-4b", "h2o-danube-3-4b", "musicgen-large", "paligemma-3b",
         "smollm-135m", *MOE_SSM_ARCHS]
DECODE_ARCHS = ["gemma3-4b", "gemma2-27b", "h2o-danube-3-4b", "musicgen-large",
                *MOE_SSM_ARCHS]


def to_port_cfg(jcfg) -> ArchConfig:
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {n: getattr(jcfg, n) for n in names}
    kw["segments"] = tuple(
        (count, tuple(BlockCfg(b.mixer, b.ffn, b.window) for b in blocks))
        for count, blocks in jcfg.segments
    )
    for name, port_cls in (("moe", MoEConfig), ("ssm", SSMConfig)):
        if kw[name] is not None:
            kw[name] = port_cls(**dataclasses.asdict(kw[name]))
    return ArchConfig(**kw)


def converted_params(jcfg, seed=0):
    jparams = jlm.init_lm(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(lambda x: np.array(x, np.float32), jparams)
    return jparams, params_from_numpy(tree, to_port_cfg(jcfg), device="cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def model_input(cfg, rng, B, S):
    """A numpy batch of S positions for ``cfg``'s input mode: tokens, f32
    frames (musicgen), or f32 patches of the prefix and text tokens (vlm)."""
    if cfg.input_mode == "frames":
        return {"frames": (rng.randn(B, S, cfg.d_model) * 0.02).astype(np.float32)}
    tokens = {"tokens": rng.randint(0, cfg.vocab, (B, S - cfg.prefix_len)).astype(np.int64)}
    if cfg.input_mode == "vlm":
        tokens["patches"] = (rng.randn(B, cfg.prefix_len, cfg.d_model) * 0.02).astype(np.float32)
    return tokens


def _cache_leaves_np(cache):
    """K/V or conv/SSM leaves of every block slot, in one order for both."""
    if isinstance(cache, dict) and "segments" in cache:
        cache = cache["segments"]
    return [_np(slot[k]) for seg in cache for slot in seg for k in sorted(slot)]


@pytest.mark.parametrize("arch", ARCHS)
def test_port_smoke_config_matches_the_jax_one(arch):
    assert to_port_cfg(j_smoke_config(arch)) == smoke_config(arch)
    assert to_port_cfg(j_get_config(arch)) == get_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_converted_tree_keeps_the_jax_structure(arch):
    """Every leaf of the JAX tree, ``qn``/``kn``/``ln1b``/``ln2b`` included,
    lands where the port's own ``init_lm`` puts a leaf of that shape."""
    jparams, params = converted_params(j_smoke_config(arch))
    jleaves = jax.tree.leaves(jparams)
    own = lm.init_lm(0, smoke_config(arch), device="cpu")
    assert jax.tree.structure(own) == jax.tree.structure(params)
    assert [tuple(x.shape) for x in jax.tree.leaves(own)] == \
        [tuple(x.shape) for x in jax.tree.leaves(params)]
    flat = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            flat.append(node)

    walk(params)
    assert [tuple(x.shape) for x in flat] == [tuple(x.shape) for x in jleaves]
    for a, b in zip(flat, jleaves):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_init_lm_draws_the_jax_distributions():
    cfg = smoke_config("smollm-135m")
    params = lm.init_lm(0, cfg, device="cpu")
    w = params["segments"][0][0]["mlp"]["up"]["w"]
    assert w.shape == (1, cfg.d_ff, cfg.d_model) and w.dtype == torch.float32
    assert abs(float(w.std()) * cfg.d_model**0.5 - 1.0) < 0.05
    assert abs(float(params["embed"]["emb"].std()) - 0.02) < 0.002
    assert torch.all(params["final_norm"]["scale"] == 0)
    again = lm.init_lm(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(again["embed"]["emb"], params["embed"]["emb"])


@pytest.mark.parametrize("spec", POLICIES)
@pytest.mark.parametrize("jcfg", [j_smoke_config("smollm-135m"), TINY_WINDOWED,
                                  TINY_GLOBAL_CHUNKED,
                                  *(j_smoke_config(a) for a in DECODE_ARCHS)],
                         ids=lambda c: c.name)
def test_prefill_and_decode_match_jax(jcfg, spec):
    """Prefill, then four decode steps fed the greedy token (or, for a
    ``frames`` model, the next frame of a seeded stream)."""
    cfg = to_port_cfg(jcfg)
    jparams, params = converted_params(jcfg)
    rng = np.random.RandomState(0)
    B, S, max_seq, steps = 2, 13, 24, 4
    prompt = model_input(cfg, rng, B, S)
    frames = [model_input(cfg, rng, B, 1) for _ in range(steps)]

    def feed(i, logits, lib):
        """The input of decode step ``i`` after ``logits``, as ``lib`` arrays."""
        if cfg.input_mode == "frames":
            return {"frames": lib.asarray(frames[i]["frames"])}
        return {"tokens": lib.argmax(logits[:, -1, : cfg.vocab], -1)[:, None]}

    # jit traces each JAX step once under the scope (interpret-mode Pallas
    # inside); eager JAX would re-dispatch every kernel call
    prefill = jax.jit(lambda p, b: jlm.lm_prefill(p, jcfg, b, max_seq=max_seq,
                                                  cache_dtype=jnp.float32))
    decode = jax.jit(lambda p, c, b: jlm.lm_decode(p, jcfg, c, b))
    with jengine.use_policy(jengine.policy_from_spec(spec)):
        jlogits, jcache = prefill(jparams, jax.tree.map(jnp.asarray, prompt))
        jdec, out = [], jlogits
        for i in range(steps):
            out, jcache = decode(jparams, jcache, feed(i, out, jnp))
            jdec.append(out)
    with engine.use_policy(engine.policy_from_spec(spec)):
        logits, cache = lm.lm_prefill(params, cfg, {k: torch.from_numpy(v) for k, v in
                                                    prompt.items()},
                                      max_seq=max_seq, cache_dtype=torch.float32)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
        out = logits
        for i, want in enumerate(jdec):
            out, cache = lm.lm_decode(params, cfg, cache, feed(i, out, torch))
            np.testing.assert_allclose(_np(out), _np(want), **TOL)
    assert int(cache["pos"]) == S + steps == int(jcache["pos"])
    for got, want in zip(_cache_leaves_np(cache), _cache_leaves_np(jcache)):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("jcfg", [TINY_WINDOWED, j_smoke_config("smollm-135m"),
                                  j_smoke_config("gemma3-4b")], ids=lambda c: c.name)
def test_padded_prefill_with_true_len_matches_jax(jcfg):
    """Right-padded (bucketed) prefill: logits at each row's real last
    position and the cache over real positions only -- the windowed ring
    included, and gemma3's rings beside its global caches, block by
    block -- then ragged per-row decode positions."""
    cfg = to_port_cfg(jcfg)
    jparams, params = converted_params(jcfg, seed=1)
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab, (2, 16)).astype(np.int64)
    true_len = np.array([11, 5], np.int32)
    spec = "fixed:nt=PALLAS_TNN,attn=fused"
    with jengine.use_policy(jengine.policy_from_spec(spec)):
        jlogits, jcache = jlm.lm_prefill(
            jparams, jcfg, {"tokens": jnp.asarray(tokens)}, max_seq=24,
            cache_dtype=jnp.float32, true_len=jnp.asarray(true_len))
        jcache["pos"] = jnp.asarray(true_len)
        jout, jcache = jlm.lm_decode(jparams, jcfg, jcache,
                                     {"tokens": jnp.asarray([[3], [9]], jnp.int32)})
    with engine.use_policy(engine.policy_from_spec(spec)):
        logits, cache = lm.lm_prefill(
            params, cfg, {"tokens": torch.from_numpy(tokens)}, max_seq=24,
            cache_dtype=torch.float32, true_len=torch.from_numpy(true_len))
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
        cache["pos"] = torch.from_numpy(true_len)
        out, cache = lm.lm_decode(params, cfg, cache, {"tokens": torch.tensor([[3], [9]])})
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    for got, want in zip(_cache_leaves_np(cache), _cache_leaves_np(jcache)):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("jcfg", [TINY_GLOBAL_CHUNKED, j_smoke_config("musicgen-large"),
                                  j_smoke_config("paligemma-3b"),
                                  *(j_smoke_config(a) for a in MOE_SSM_ARCHS)],
                         ids=lambda c: c.name)
def test_lm_forward_matches_jax(jcfg):
    """Full-sequence logits: tokens, ``frames`` entering directly, ``vlm``
    patches ahead of the text under the prefix mask, and the MoE and
    Mamba blocks (16 positions: two SSD chunks of 8, one MoE group)."""
    cfg = to_port_cfg(jcfg)
    jparams, params = converted_params(jcfg, seed=2)
    batch = model_input(cfg, np.random.RandomState(2), 2, 16)
    with jengine.use_policy(jengine.policy_from_spec("fixed:XLA_NT")):
        want = jlm.lm_forward(jparams, jcfg, jax.tree.map(jnp.asarray, batch))
    with engine.use_policy(engine.policy_from_spec("fixed:nt=PALLAS_NT,attn=fused")):
        got = lm.lm_forward(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, 16, cfg.vocab_padded)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
