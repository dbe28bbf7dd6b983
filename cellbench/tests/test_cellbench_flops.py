"""The benchmark's frozen arithmetic against counts made by hand."""

from types import SimpleNamespace

import pytest

from cellbench import flops, harness, readers
from cellbench.trace import TraceData

DANUBE = {"hidden_size": 3840, "num_attention_heads": 32, "num_key_value_heads": 8,
          "head_dim": 120, "intermediate_size": 10240, "vocab_size": 32000,
          "num_hidden_layers": 1, "sliding_window": 4096}


def test_fcn_layer_by_hand():
    # one layer 26752 -> 4096 at batch 4096: forward and weight gradient,
    # and no input gradient: it is the first layer
    fwd = 2 * 4096 * 4096 * 26752
    assert flops.fcn_train_step_flops([26752, 4096], 4096) == 2 * fwd
    # two layers: the second one's input gradient counts once more
    second = 2 * 4096 * 4096 * 4096
    assert flops.fcn_train_step_flops([26752, 4096, 4096], 4096) == 2 * fwd + 3 * second


def test_synthetic_fcn_step_is_5_3_tflop():
    step = flops.fcn_train_step_flops([26752, 4096, 4096, 4096, 26752], 4096)
    assert step == pytest.approx(5.31e12, rel=2e-3)


def test_danube_layer_by_hand():
    d, q, kv, ff = 3840, 32 * 120, 8 * 120, 10240
    layer = d * q + 2 * d * kv + q * d + 3 * d * ff
    assert layer == 154_828_800
    w = flops.lm_layer_matmul_params(DANUBE)
    assert w == {"layer": layer, "head": 32000 * 3840}
    # one sequence of 2048: 6 a weight a token, and both attention products
    # at 2048 * 2049 / 2 visible pairs, 4 FLOPs a pair and a head dim, x3
    pairs = 2048 * 2049 // 2
    expect = 6 * (layer + 32000 * 3840) * 2048 + 3 * 4 * 3840 * pairs
    assert flops.lm_train_step_flops(DANUBE, 1, 2048) == expect


def test_decode_step_by_hand():
    w = flops.lm_layer_matmul_params(DANUBE)
    # a token at position 99 attends 100 keys
    assert flops.lm_decode_token_flops(DANUBE, 100) == 2 * (w["layer"] + w["head"]) + 4 * 3840 * 100
    # beyond the window it attends the window
    assert flops.lm_decode_token_flops(DANUBE, 5000) == 2 * (w["layer"] + w["head"]) + 4 * 3840 * 4096
    # a prefill of 10 tokens: the head once, 55 visible pairs
    assert flops.lm_prefill_flops(DANUBE, 10) == 2 * w["layer"] * 10 + 2 * w["head"] + 4 * 3840 * 55


@pytest.mark.parametrize("s,window,start", [(10, 0, 0), (10, 4, 0), (7, 3, 5), (4096, 4096, 0),
                                            (5000, 4096, 0)])
def test_visible_pairs_counts_the_mask(s, window, start):
    brute = sum(min(q + 1, window) if window else q + 1 for q in range(start, start + s))
    assert flops.visible_pairs(s, window, start) == brute


def test_gemm_bound_reads_operands_once():
    # a bf16 square product of 4096 is bound by compute
    assert flops.gemm_bound_s(4096, 4096, 4096, 2) == pytest.approx(2 * 4096 ** 3 / 989e12)
    # a decode GEMV of one row is bound by the weight's bytes
    assert flops.gemm_bound_s(1, 4096, 4096, 2) == pytest.approx(2 * (4096 + 4096 * 4096 + 4096)
                                                                 / 3.35e12)
    # f32 runs against the 67 TF/s peak, a batch of g counts g times
    assert flops.gemm_bound_s(512, 512, 512, 4, g=3) == pytest.approx(3 * 2 * 512 ** 3 / 67e12)


def _reading(gemms, kernels, window=1.0):
    trace = TraceData(window_s=window, busy_s=sum(s for _, s in kernels), kernels=kernels)
    return SimpleNamespace(counters={"gemms": gemms, "window_s": window, "steps": 2},
                           trace=trace)


def test_gemm_roofline_over_the_gemm_kernels_only():
    gemms = {("NT", 4096, 4096, 4096, 2, 1): 10, ("ATTN", 128, 128, 64, 2, 8): 5}
    bound = 10 * flops.gemm_bound_s(4096, 4096, 4096, 2)
    r = _reading(gemms, [("nvjet_tst_256x128", 4 * bound), ("attention_flash", 1.0),
                         ("at::native::vectorized_elementwise_kernel", 1.0)])
    assert readers.gemm_roofline(r) == pytest.approx(25.0)
    assert readers.calls_per_step(r) == 7.5


def test_a_share_over_105_percent_fails_the_run():
    gemms = {("NT", 4096, 4096, 4096, 2, 1): 10}
    bound = 10 * flops.gemm_bound_s(4096, 4096, 4096, 2)
    r = _reading(gemms, [("nvjet_tst_256x128", bound / 2)])
    assert readers.gemm_roofline(r) == pytest.approx(200.0)  # never clipped
    ctx = SimpleNamespace(cell={"name": "c"}, cfg={}, mix={}, spec={"per_layer": [
        {"name": "gemm_roofline.fcn_train", "unit": "%"}]})
    outcome = SimpleNamespace(counters=r.counters)
    with pytest.raises(ValueError, match="counted too high"):
        harness.read_per_layer(ctx, outcome, r.trace)


def test_readers_find_nothing_without_a_trace():
    r = SimpleNamespace(counters={"gemms": None, "window_s": 1.0}, trace=None)
    assert readers.gemm_roofline(r) is None
    assert readers.device_idle(r) is None
    assert readers.calls_per_step(r) is None
    assert readers.mfu(r) is None
