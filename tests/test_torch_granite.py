"""The port's granite-4.0-h-small paths on the CPU, at a tiny size: the
dropless MoE against a per-token loop, the shared expert, the xBC conv's
cache through decode, the SSD's ragged tail against one whole chunk,
the muP multipliers, NoPE and the registry.  (The whole model against
the plain reference: ``cellbench/tests/test_cellbench_granite.py``.)"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.arch import ArchConfig
from repro_torch.core import spans
from repro_torch.models import lm, moe, ssm
from repro_torch.models.attention import AttnConfig, attention, init_attention

TOL = dict(rtol=1e-5, atol=1e-5)
GRANITE = "granite-4.0-h-small"


def _moe_cfg(**kw):
    base = dict(d_model=32, d_ff=24, n_experts=8, top_k=2, capacity_factor=None)
    base.update(kw)
    return moe.MoEConfig(**base)


def _per_token(p, x, cfg):
    """Each token alone: the softmax over its top k router logits, each
    chosen expert's SiLU-gated MLP, summed under those weights."""
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        logits = p["router"]["w"].float() @ x[t].float()
        top, idx = torch.topk(logits, cfg.top_k)
        for gate, e in zip(torch.softmax(top, -1), idx.tolist()):
            h = torch.nn.functional.silu(p["gate"][e] @ x[t]) * (p["up"][e] @ x[t])
            out[t] += gate * (p["down"][e] @ h)
    return out


@pytest.mark.parametrize("tokens", [1, 5, 37])
def test_dropless_moe_matches_a_per_token_loop(tokens):
    cfg = _moe_cfg()
    p = moe.init_moe(torch.Generator().manual_seed(1), cfg)
    x = torch.randn(1, tokens, cfg.d_model, generator=torch.Generator().manual_seed(2))
    got = moe.moe_layer(p, x, cfg)
    torch.testing.assert_close(got[0], _per_token(p, x[0], cfg), **TOL)


def test_dropless_moe_drops_nothing_when_one_expert_takes_every_token():
    """Every token routed to expert 0 first: the capacity path would drop
    most of them, the dropless one computes them all."""
    cfg = _moe_cfg()
    p = moe.init_moe(torch.Generator().manual_seed(3), cfg)
    p["router"]["w"][0] = 0.0
    p["router"]["w"][0, 0] = 50.0
    x = torch.randn(1, 40, cfg.d_model, generator=torch.Generator().manual_seed(4))
    x[..., 0] = x[..., 0].abs() + 1.0
    torch.testing.assert_close(moe.moe_layer(p, x, cfg)[0], _per_token(p, x[0], cfg), **TOL)
    capped = moe.moe_layer(p, x, dataclasses.replace(cfg, capacity_factor=1.0))
    assert not torch.allclose(capped[0], _per_token(p, x[0], cfg), atol=1e-3)


def test_shared_expert_adds_a_gated_mlp_to_the_routed_output():
    from repro_torch.models.layers import gated_mlp

    cfg = _moe_cfg(shared_d_ff=16)
    p = moe.init_moe(torch.Generator().manual_seed(5), cfg)
    assert p["shared"]["gate"]["w"].shape == (16, 32)
    x = torch.randn(2, 7, cfg.d_model, generator=torch.Generator().manual_seed(6))
    routed = moe.moe_layer({k: v for k, v in p.items() if k != "shared"}, x,
                           dataclasses.replace(cfg, shared_d_ff=0))
    want = routed + gated_mlp(p["shared"], x, "silu")
    torch.testing.assert_close(moe.moe_layer(p, x, cfg), want, **TOL)


def test_grouped_mm_takes_each_experts_rows():
    a = torch.randn(9, 6)
    w = torch.randn(3, 4, 6)
    offs = torch.tensor([2, 2, 9], dtype=torch.int32)  # expert 1 takes no row
    got = moe.grouped_mm(a, w, offs)
    torch.testing.assert_close(got, torch.cat([a[:2] @ w[0].t(), a[2:] @ w[2].t()]), **TOL)


def test_dropless_moe_counts_its_rows_and_its_span():
    cfg = _moe_cfg()
    p = moe.init_moe(torch.Generator().manual_seed(7), cfg)
    x = torch.randn(2, 11, cfg.d_model, generator=torch.Generator().manual_seed(8))
    with spans.recording():
        moe.moe_layer(p, x, cfg)
        moe.moe_layer(p, x[:, :3], cfg)
    assert spans.counter("moe.rows") == (2 * 11 * 2 + 2 * 3 * 2, 2)
    busiest, calls = spans.counter("moe.rows_max")
    assert calls == 2 and 2 * 11 * 2 / 8 <= busiest <= 2 * 11 + 2 * 3
    recs = spans.records("repro_torch.moe.experts")
    assert [r.ids["rows"] for r in recs] == [44, 12]
    assert all(isinstance(r.ids["experts"], int) and 1 <= r.ids["experts"] <= 8 for r in recs)


def test_tensor_ids_and_amounts_are_read_when_read():
    """A device tensor given as an id or a counted amount is kept as it is
    and read to a number only when the records or the counter are."""
    with spans.recording():
        for i in range(3):
            with spans.span("repro_torch.test.deferred", i=i) as rec:
                pass
            rec.ids["n"] = torch.tensor(2 * i)
            spans.add("test.amount", torch.tensor(i + 1))
        spans.add("test.amount", 10)
        assert isinstance(spans._State.spans[0].ids["n"], torch.Tensor)
    assert [r.ids["n"] for r in spans.records("repro_torch.test.deferred")] == [0, 2, 4]
    assert spans.counter("test.amount") == (16, 4)
    assert spans.counter("test.amount") == (16, 4)  # read once, kept


def test_dropless_moe_is_refused_on_a_mesh():
    from repro_torch.distributed.context import use_mesh
    from repro_torch.launch.mesh import Mesh

    cfg = _moe_cfg()
    p = moe.init_moe(torch.Generator().manual_seed(9), cfg)
    with use_mesh(Mesh((2, 1), ("data", "model"))), pytest.raises(NotImplementedError):
        moe.moe_layer(p, torch.zeros(1, 4, cfg.d_model), cfg)


def _ssm_cfg(**kw):
    base = dict(d_model=32, d_state=8, d_conv=4, expand=2, head_dim=16, chunk=8)
    base.update(kw)
    return ssm.SSMConfig(**base)


@pytest.mark.parametrize("S", [1, 5, 8, 13, 29])
def test_ssd_ragged_tail_matches_one_whole_chunk(S):
    g = torch.Generator().manual_seed(S)
    H, P, N = 3, 4, 5
    xh = torch.randn(2, S, H, P, generator=g, dtype=torch.float64)
    Bv, Cv = (torch.randn(2, S, N, generator=g, dtype=torch.float64) for _ in range(2))
    dt = torch.rand(2, S, H, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 2
    h0 = torch.randn(2, H, P, N, generator=g, dtype=torch.float64)
    y, h = ssm._ssd_chunked(xh, Bv, Cv, dt, A, 8, h0)
    y1, h1 = ssm._ssd_chunked(xh, Bv, Cv, dt, A, S, h0)
    torch.testing.assert_close(y, y1, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(h, h1, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("conv_xbc", [False, True])
def test_conv_cache_carries_prefill_into_decode(conv_xbc):
    """Prefill S tokens, then decode one at a time from the cache: each
    step's output is the full sequence's at that position."""
    cfg = _ssm_cfg(conv_xbc=conv_xbc)
    p = ssm.init_ssm(torch.Generator().manual_seed(11), cfg)
    p["conv_b"] = torch.randn(p["conv_b"].shape, generator=torch.Generator().manual_seed(12))
    assert p["conv_w"].shape == (4, 64 + (16 if conv_xbc else 0))
    x = torch.randn(2, 19, cfg.d_model, generator=torch.Generator().manual_seed(13))
    full = ssm.ssm_layer(p, x, cfg)
    _, cache = ssm.ssm_layer(p, x[:, :11], cfg, return_state=True, cache_dtype=torch.float32)
    assert cache["conv"].shape == (2, 3, cfg.conv_width)
    for t in range(11, 19):
        out, cache = ssm.ssm_decode(p, x[:, t:t + 1], cfg, cache)
        torch.testing.assert_close(out[:, 0], full[:, t], rtol=1e-4, atol=1e-5)


def test_xbc_conv_changes_b_and_c():
    """Over x alone and over xBC the same taps on x give different
    outputs once the B and C taps are not the identity."""
    cfg = _ssm_cfg(conv_xbc=True)
    p = ssm.init_ssm(torch.Generator().manual_seed(14), cfg)
    x = torch.randn(1, 9, cfg.d_model, generator=torch.Generator().manual_seed(15))
    plain = dict(p, conv_w=p["conv_w"][:, :cfg.d_inner], conv_b=p["conv_b"][:cfg.d_inner])
    assert not torch.allclose(ssm.ssm_layer(p, x, cfg),
                              ssm.ssm_layer(plain, x, _ssm_cfg()), atol=1e-4)


def test_ssm_scan_span_wraps_prefill_and_decode():
    cfg = _ssm_cfg(conv_xbc=True)
    p = ssm.init_ssm(torch.Generator().manual_seed(16), cfg)
    x = torch.randn(1, 6, cfg.d_model)
    with spans.recording():
        _, cache = ssm.ssm_layer(p, x, cfg, return_state=True)
        ssm.ssm_decode(p, x[:, :1], cfg, cache)
    assert [r.ids["tokens"] for r in spans.records("repro_torch.ssm.scan")] == [6, 1]


def test_nope_and_query_scale():
    """NoPE: attention at shifted positions is unchanged; the query scale
    replaces d_head ** -0.5."""
    cfg = AttnConfig(d_model=32, n_heads=4, n_kv=2, d_head=8, rope=False, q_scale=0.05)
    p = init_attention(torch.Generator().manual_seed(17), cfg)
    x = torch.randn(1, 6, 32, generator=torch.Generator().manual_seed(18))
    pos = torch.arange(6)[None]
    torch.testing.assert_close(attention(p, x, cfg, pos), attention(p, x, cfg, pos + 100))
    roped = dataclasses.replace(cfg, rope=True)
    assert not torch.allclose(attention(p, x, roped, pos), attention(p, x, roped, pos + 100))
    same = dataclasses.replace(cfg, q_scale=None, d_head=8)
    assert same.scale == 8 ** -0.5 and cfg.scale == 0.05


def test_granite_is_registered_beside_the_ten():
    from repro_torch.configs.registry import ARCHS, PORT_ARCHS, list_archs

    cfg = get_config(GRANITE)
    assert GRANITE in PORT_ARCHS and GRANITE not in ARCHS and GRANITE not in list_archs()
    assert cfg.n_layers == 40 and sum(b.mixer == "attn" for b in cfg.segments[0][1]) == 1
    assert (cfg.moe.capacity_factor, cfg.moe.shared_d_ff, cfg.ssm.conv_xbc) == (None, 1536, True)
    assert 32.1e9 < cfg.param_count() < 32.3e9
    assert dataclasses.fields(ArchConfig)[-1].name == "sub_quadratic"  # the JAX package's


def test_granite_smoke_keeps_its_paths_and_multipliers():
    cfg = smoke_config(GRANITE)
    assert (cfg.moe.capacity_factor, cfg.ssm.conv_xbc, cfg.attn_rope) == (None, True, False)
    assert (cfg.emb_mult, cfg.residual_mult, cfg.logits_div, cfg.rms_eps) == (12.0, 0.22,
                                                                               16.0, 1e-5)


def test_multipliers_scale_embeddings_residuals_and_logits():
    """With ``residual_mult`` 0 the blocks add nothing: the logits are the
    tied head over the normed embeddings times ``emb_mult``, over
    ``logits_div``; with it, the blocks' outputs enter."""
    full = smoke_config(GRANITE)
    cfg = full.replace(segments=((1, (full.segments[0][1][0],)),))
    params = lm.init_lm(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 5), generator=torch.Generator().manual_seed(19))
    emb = params["embed"]["emb"]
    x = emb[tokens] * 12.0
    x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-5)
    want = x @ emb.t() / 16.0
    quiet = cfg.replace(residual_mult=0.0)
    torch.testing.assert_close(lm.lm_forward(params, quiet, {"tokens": tokens}), want, **TOL)
    assert not torch.allclose(lm.lm_forward(params, cfg, {"tokens": tokens}), want, atol=1e-6)


def test_granite_smoke_prefill_then_decode_matches_its_forward():
    cfg = smoke_config(GRANITE)
    params = lm.init_lm(0, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 23), generator=torch.Generator().manual_seed(20))
    full = lm.lm_forward(params, cfg, {"tokens": tokens})
    logits, cache = lm.lm_prefill(params, cfg, {"tokens": tokens[:, :13]}, max_seq=32,
                                  cache_dtype=torch.float32)
    torch.testing.assert_close(logits[:, 0], full[:, 12], **TOL)
    for t in range(13, 23):
        logits, cache = lm.lm_decode(params, cfg, cache, {"tokens": tokens[:, t:t + 1]})
        torch.testing.assert_close(logits[:, 0], full[:, t], **TOL)


def test_granite_serves_through_the_launcher(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", GRANITE, "--smoke", "--device", "cpu", "--requests", "3",
                "--prompt-len", "11", "--gen", "3"])
    assert "[serve] 3 requests, 9 tokens" in capsys.readouterr().out


def test_dropless_moe_row_ranges_match_bincount():
    """The experts' row ranges come from the sorted picks (no read back of
    the largest pick): the same offsets as ``bincount``'s cumulative sum,
    an expert that takes no row included."""
    cfg = _moe_cfg(n_experts=8, top_k=2)
    p = moe.init_moe(torch.Generator().manual_seed(11), cfg)
    p["router"]["w"][3] = -100.0  # against positive tokens: never in a token's top 2
    x = torch.randn(1, 9, cfg.d_model, generator=torch.Generator().manual_seed(12)).abs()
    seen = []
    real = moe.grouped_mm
    try:
        moe.grouped_mm = lambda a, w, offs: seen.append(offs.clone()) or real(a, w, offs)
        got = moe.moe_layer(p, x, cfg)
    finally:
        moe.grouped_mm = real
    picks = torch.topk(p["router"]["w"].float() @ x[0].float().T, 2, dim=0).indices.reshape(-1)
    want = torch.cumsum(torch.bincount(picks, minlength=8), 0).to(torch.int32)
    assert len(seen) == 3 and all(torch.equal(o, want) for o in seen)
    assert int(want[3] - want[2]) == 0
    torch.testing.assert_close(got[0], _per_token(p, x[0], cfg), **TOL)


def _smoke_engine(device, dtype="float32", **kw):
    from repro_torch.serving import BucketSpec, ServeEngine

    cfg = dataclasses.replace(smoke_config(GRANITE), param_dtype=dtype)
    params = lm.init_lm(0, cfg, device=device)
    return ServeEngine(cfg, params, n_slots=4, max_seq=48, policies={"serve": None},
                       bucket_spec=BucketSpec((1, 2, 4), 32, 32), device=device, **kw)


def _serve(eng, n=5):
    gen = torch.Generator().manual_seed(13)
    reqs = [eng.submit(torch.randint(0, eng.cfg.vocab, (7 + 3 * i,), generator=gen).numpy(),
                       4 + i, cls="serve") for i in range(n)]
    eng.run()
    return [list(r.generated) for r in reqs]


def test_decode_graphs_change_nothing_on_the_cpu():
    eng = _smoke_engine("cpu", decode_graphs=True)
    eng.warmup()
    assert not eng.decode_graphs and not eng._graphs
    assert _serve(eng) == _serve(_smoke_engine("cpu"))


def test_decode_graphs_are_refused_on_a_mesh():
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serving import ServeEngine

    cfg = smoke_config(GRANITE)
    with pytest.raises(ValueError, match="decode_graphs"):
        ServeEngine(cfg, {}, n_slots=2, max_seq=16, device="cpu",
                    mesh=Mesh((1, 2), ("data", "model")), decode_graphs=True)


def test_replayed_dispatches_reach_the_accounting_hook():
    from repro_torch.core.engine import account_dispatches, account_replayed
    from repro_torch.core.opkey import OpKey

    seen = []
    keys = [OpKey("NT", 4, 8, 16, 2), OpKey("NT", 4, 16, 8, 2)]
    account_replayed(keys)  # no hook: nothing
    with account_dispatches(lambda key, operands, out: seen.append((key, operands, out))):
        account_replayed(keys)
    assert seen == [(keys[0], None, None), (keys[1], None, None)]


@pytest.mark.gpu
def test_decode_graphs_serve_the_eager_tokens_on_the_card():
    """Every bucket's graph, replayed on the engine's own schedule, gives
    the eager engine's tokens bit for bit, and the accounting hook sees
    each replay's dispatches.  In bf16, as the cell serves: the f32
    dropless MoE's per-expert loop reads the row ranges back, which no
    graph can capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    from repro_torch.core.engine import account_dispatches

    eager = _smoke_engine("cuda", "bfloat16")
    eager.warmup()
    want = _serve(eager)
    graphs = _smoke_engine("cuda", "bfloat16", decode_graphs=True)
    graphs.warmup()
    assert sorted(graphs._graphs) == [("serve", 1), ("serve", 2), ("serve", 4)]
    counted = []
    with account_dispatches(lambda key, operands, out: counted.append(key)):
        assert _serve(graphs) == want
    assert len(counted) > sum(len(g.keys) for g in graphs._graphs.values())
