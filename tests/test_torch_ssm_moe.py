"""The port's Mamba-2 SSD layer, MoE layer and Adafactor against the JAX
package's, on the same numpy inputs and weights (made from a seed): the
SSD layer at lengths that take the conv cache's pad branch (S < d_conv -
1), the chunked path (a multiple of the chunk), the one-chunk fallback
for a ragged S, and a ragged S long enough that the masked decay
overflows; decode steps from the prefill's state; the MoE layer with a
random router, an all-zero router (every expert ties at the threshold)
and a capacity low enough to drop tokens; the load-balancing loss; one
Adafactor update on a tree with stacked leaves; and the dtypes of a bf16
``params_from_numpy`` tree.

Tolerance: f32, ``rtol = atol = 1e-4`` (``tests/test_torch_lm.py``'s):
the two frameworks sum the SSD's and the experts' contractions in
another order, a drift near 1e-6; a wrong mask, cast, route or dropped
token moves outputs by 1e-2 or more.  Adafactor on identical gradients:
1e-6, the f32 rounding of its means and square roots.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import adafactor_init as j_adafactor_init  # noqa: E402
from repro.optim import adafactor_update as j_adafactor_update  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.models import lm, moe, ssm  # noqa: E402
from repro_torch.optim import adafactor_init, adafactor_update, make_optimizer  # noqa: E402

from test_torch_lm import MOE_SSM_ARCHS, converted_params, to_port_cfg  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SPEC = "fixed:nt=PALLAS_TNN,attn=fused"  # the port's kernel arm (plain on the CPU)
J_SPEC = "fixed:XLA_NT"
SSM_CFG = dict(d_model=32, d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, np.float32)), tree)


def _ssm_pair(seed):
    jcfg = jssm.SSMConfig(**SSM_CFG)
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    # nonzero A_log, D and dt_bias, so every term of the recurrence is checked
    H = jcfg.n_heads
    for name, v in (("A_log", rng.randn(H) * 0.5), ("D", rng.randn(H)),
                    ("dt_bias", rng.randn(H) * 0.5)):
        jp[name] = jnp.asarray(v, jnp.float32)
    return jcfg, ssm.SSMConfig(**SSM_CFG), jp, _to_torch(jp)


@pytest.mark.parametrize("S", [1, 3, 8, 13, 203])
def test_ssm_layer_and_decode_match_jax(S):
    """ssm_layer without and with the decode state (the last d_conv - 1 raw
    conv inputs and the SSD state after the last chunk), then three
    ssm_decode steps from that state.  S = 203 is ragged (one chunk of
    203): above the diagonal its decay overflows to inf, which the mask
    must drop."""
    jcfg, cfg, jp, p = _ssm_pair(S)
    rng = np.random.RandomState(100 + S)
    x = rng.randn(2, S, cfg.d_model).astype(np.float32)
    steps = [rng.randn(2, 1, cfg.d_model).astype(np.float32) for _ in range(3)]
    with jengine.use_policy(jengine.policy_from_spec(J_SPEC)):
        jout = jssm.ssm_layer(jp, jnp.asarray(x), jcfg)
        _, jcache = jssm.ssm_layer(jp, jnp.asarray(x), jcfg, return_state=True,
                                   cache_dtype=jnp.float32)
        jcaches, jdec = [jcache], []
        for xs in steps:
            y, jcache = jssm.ssm_decode(jp, jnp.asarray(xs), jcfg, jcache)
            jdec.append(y)
            jcaches.append(jcache)
    with engine.use_policy(engine.policy_from_spec(SPEC)):
        out = ssm.ssm_layer(p, torch.from_numpy(x), cfg)
        out2, cache = ssm.ssm_layer(p, torch.from_numpy(x), cfg, return_state=True,
                                    cache_dtype=torch.float32)
        assert torch.isfinite(out).all() and torch.equal(out, out2)
        np.testing.assert_allclose(_np(out), _np(jout), **TOL)
        assert cache["conv"].shape == (2, cfg.d_conv - 1, cfg.d_inner)
        if S < cfg.d_conv - 1:  # the pad branch: zero rows ahead of the prompt
            assert torch.all(cache["conv"][:, : cfg.d_conv - 1 - S] == 0)
        caches = [cache]
        for xs, jy in zip(steps, jdec):
            before = {k: v.clone() for k, v in cache.items()}
            y, new = ssm.ssm_decode(p, torch.from_numpy(xs), cfg, cache)
            assert all(torch.equal(cache[k], before[k]) for k in cache)  # input left alone
            np.testing.assert_allclose(_np(y), _np(jy), **TOL)
            cache = new
            caches.append(cache)
    for c, jc in zip(caches, jcaches):
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(_np(c[k]), _np(jc[k]), **TOL)


MOE_CASES = {
    "random": dict(router_scale=1.0, capacity_factor=2.0, S=16),
    "ragged-group": dict(router_scale=1.0, capacity_factor=2.0, S=13),
    "all-zero-router": dict(router_scale=0.0, capacity_factor=2.0, S=16),  # every expert ties
    "drops": dict(router_scale=1.0, capacity_factor=0.25, S=16),  # capacity 1 a group of 8
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_layer_matches_jax(case):
    c = MOE_CASES[case]
    kw = dict(d_model=32, d_ff=24, n_experts=4, top_k=2, group=8,
              capacity_factor=c["capacity_factor"])
    jcfg, cfg = jmoe.MoEConfig(**kw), moe.MoEConfig(**kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    jp["router"]["w"] = jp["router"]["w"] * c["router_scale"]
    p = _to_torch(jp)
    x = np.random.RandomState(4).randn(2, c["S"], cfg.d_model).astype(np.float32)
    with jengine.use_policy(jengine.policy_from_spec(J_SPEC)):
        want = jmoe.moe_layer(jp, jnp.asarray(x), jcfg)
    with engine.use_policy(engine.policy_from_spec(SPEC)):
        got = moe.moe_layer(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    group = cfg.group if c["S"] % cfg.group == 0 else c["S"]
    logits = torch.from_numpy(x).reshape(-1, group, cfg.d_model) @ p["router"]["w"].t()
    dispatch, combine = moe._route(logits, cfg, cfg.capacity(group))
    kept = dispatch.sum(dim=(2, 3))  # experts each token reached
    if case == "all-zero-router":
        # every expert ties at the threshold: each token reaches all of them
        assert torch.all(kept == cfg.n_experts)
    if case == "drops":
        assert (kept < cfg.top_k).any()  # some tokens lost an expert
        dropped = kept == 0
        assert dropped.any()  # a token every expert dropped reads 0
        out = got.reshape(-1, group, cfg.d_model)
        assert torch.all(out[dropped] == 0)
    else:
        assert torch.all(kept >= cfg.top_k)
    jd, jc = jmoe._route(jnp.asarray(logits.numpy()), jcfg, jcfg.capacity(group))
    np.testing.assert_array_equal(_np(dispatch), _np(jd))
    np.testing.assert_allclose(_np(combine), _np(jc), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scale", [1.0, 0.0])
def test_router_aux_loss_matches_jax(scale):
    logits = np.random.RandomState(5).randn(3, 8, 6).astype(np.float32) * scale
    cfg = moe.MoEConfig(d_model=8, d_ff=8, n_experts=6, top_k=2)
    jcfg = jmoe.MoEConfig(d_model=8, d_ff=8, n_experts=6, top_k=2)
    np.testing.assert_allclose(float(moe.router_aux_loss(torch.from_numpy(logits), cfg)),
                               float(jmoe.router_aux_loss(jnp.asarray(logits), jcfg)),
                               rtol=1e-6)


def test_adafactor_matches_jax_on_the_same_gradients():
    """Three updates on a tree with a stacked matrix (layers, out, in), a
    stacked norm (layers, d) -- factored in both packages, since any leaf
    with ndim >= 2 is -- and an unfactored vector."""
    rng = np.random.RandomState(8)
    params = {"w": rng.randn(2, 5, 4).astype(np.float32),
              "norm": (rng.randn(3, 6).astype(np.float32),),
              "b": rng.randn(7).astype(np.float32) * 1e-4}  # below the relative-step floor
    jp = jax.tree.map(jnp.asarray, params)
    tp = _to_torch(params)
    js, ts = j_adafactor_init(jp), adafactor_init(tp)
    assert set(ts["stats"]["norm"][0]) == {"vr", "vc"} and set(ts["stats"]["b"]) == {"v"}
    init, update = make_optimizer("adafactor", clip_threshold=1.0)
    assert init is adafactor_init
    for step in range(3):
        g = jax.tree.map(lambda x: rng.randn(*x.shape).astype(np.float32) * 10.0 ** -step,
                         params)
        jp, js = j_adafactor_update(jax.tree.map(jnp.asarray, g), js, jp, jnp.float32(1e-2))
        tp, ts = update(_to_torch(g), ts, tp, 1e-2)
    for a, b in zip(jax.tree.leaves(jax.tree.map(_np, tp)), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    for a, b in zip(jax.tree.leaves(jax.tree.map(_np, ts["stats"])),
                    jax.tree.leaves(js["stats"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-30)
    assert int(ts["count"]) == int(js["count"]) == 3


def _dtypes(tree):
    return jax.tree.map(lambda x: x.dtype, tree)


@pytest.mark.parametrize("arch", MOE_SSM_ARCHS)
def test_bf16_conversion_keeps_the_f32_leaves(arch):
    """A bf16 config: every converted leaf has the dtype of the port's own
    init_lm tree; the routers and the Mamba blocks' A_log, D and dt_bias
    stay f32, as the JAX package keeps them."""
    jcfg = j_smoke_config(arch).replace(param_dtype="bfloat16")
    cfg = to_port_cfg(jcfg)
    jtree = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree.map(lambda x: np.array(x, np.float32), jtree)
    params = params_from_numpy(jparams, cfg, device="cpu")
    own = lm.init_lm(0, cfg, device="cpu")
    assert _dtypes(params) == _dtypes(own)
    f32 = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        names = [getattr(k, "key", None) for k in path]
        if leaf.dtype == torch.float32:
            f32.append(names[-1] if names[-1] != "w" else names[-2])
    want = {"router"} if cfg.moe is not None else {"A_log", "D", "dt_bias"}
    assert set(f32) == want
    assert [str(x.dtype).split(".")[-1] for x in jax.tree.leaves(params)] == \
        [str(x.dtype) for x in jax.tree.leaves(jtree)]


def test_conversion_rejects_a_tree_of_another_config():
    jcfg = j_smoke_config("mamba2-2.7b")
    _, params = converted_params(jcfg)
    tree = jax.tree.map(lambda x: x.numpy(), params)
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(tree, smoke_config("grok-1-314b"), device="cpu")
