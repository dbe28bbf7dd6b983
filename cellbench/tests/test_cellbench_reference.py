"""The plain reference against the port at tiny sizes on the CPU (where
every kernel runs its plain version), in float32."""

import pytest
import torch

from cellbench import program, traffic, weights
from cellbench.reference import decoder, fcn, numerics, train

LM = {"name": "tiny", "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
      "head_dim": 16, "intermediate_size": 96, "vocab_size": 256, "num_hidden_layers": 2,
      "hidden_act": "silu", "tie_word_embeddings": True, "rope_theta": 10000.0,
      "rms_norm_eps": 1e-6, "torch_dtype": "float32", "remat": "none"}
FCN = {"name": "tiny-fcn", "input_dim": 48, "hidden": [32, 32], "output_dim": 24,
       "torch_dtype": "float32"}
HP = {"schedule": "warmup_cosine", "lr": 1e-3, "warmup": 1, "total_steps": 100,
      "max_grad_norm": 1.0, "weight_decay": 0.1}


def _lm_params(cfg, seed=3):
    params = program.lm_params(cfg, seed, "cpu")
    for path, t in weights.tree_items(params):
        if path[-1] == "scale":  # norm scales that matter
            t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(len(path))) * 0.1)
    return params


@pytest.mark.parametrize("window", [0, 8])
def test_decoder_forward_matches_the_port(window):
    from repro_torch.models import lm

    cfg = dict(LM, sliding_window=window)
    params = _lm_params(cfg)
    tokens = traffic.lm_batch(5, 0, 256, 2, 24, "cpu")["tokens"]
    got = lm.lm_forward(params, program.arch_config(cfg), {"tokens": tokens})
    want = decoder.forward(weights.reference_copy(params), cfg, tokens)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_decoder_loss_and_gradients_match_the_port():
    from repro_torch.launch import steps

    params = _lm_params(LM)
    batch = traffic.lm_batch(6, 0, 256, 2, 16, "cpu")
    loss, grads = steps.loss_and_grads(program.arch_config(LM), params, batch)
    ref = weights.reference_copy(params)
    for p in ref.values():
        p.requires_grad_(True)
    want = decoder.loss(ref, LM, batch)
    want.backward()
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-6)
    for name, g in weights.named(grads).items():
        torch.testing.assert_close(g, ref[name].grad, rtol=1e-4, atol=1e-6)


def test_fcn_loss_and_gradients_match_the_port():
    from repro_torch.models.fcn import fcn_loss_and_grads

    params = program.fcn_params(FCN, 4, "cpu")
    batch = traffic.fcn_batch(4, 0, [48, 32, 32, 24], 8, "cpu")
    loss, grads = fcn_loss_and_grads(params, batch)
    ref = weights.reference_copy(params)
    for p in ref.values():
        p.requires_grad_(True)
    want = fcn.loss(ref, batch)
    want.backward()
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-6)
    for name, g in weights.named(grads).items():
        torch.testing.assert_close(g, ref[name].grad, rtol=1e-5, atol=1e-7)


def test_reference_training_follows_the_port_step_for_step():
    from repro_torch.launch import steps

    arch = program.arch_config(LM)
    sc = steps.TrainStepConfig(lr=HP["lr"], warmup=HP["warmup"], total_steps=HP["total_steps"],
                               max_grad_norm=HP["max_grad_norm"], weight_decay=0.1)
    step = steps.make_train_step(arch, sc)
    params = _lm_params(LM)
    ref = weights.reference_copy(params)
    state = steps.init_train_state(arch, params)
    losses = []
    for i in range(3):
        state, metrics = step(state, traffic.lm_batch(8, i, 256, 2, 16, "cpu"))
        losses.append(float(metrics["loss"]))
    out = train.train_steps(ref, lambda p, b: decoder.loss(p, LM, b),
                            lambda i: [(traffic.lm_batch(8, i, 256, 2, 16, "cpu"), 1.0)], HP, 3)
    assert out["losses"] == pytest.approx(losses, rel=1e-5)
    # Adam divides by the root of the second moment: an element whose gradient
    # is near nought moves by up to the rate on round-off alone
    for name, p in weights.named(state["params"]).items():
        torch.testing.assert_close(p, ref[name], rtol=1e-3, atol=HP["lr"] / 4)


def test_one_sequence_microbatches_sum_to_the_batch_step():
    batch = traffic.lm_batch(9, 0, 256, 4, 16, "cpu")
    ref_a = weights.reference_copy(_lm_params(LM))
    ref_b = {k: v.clone() for k, v in ref_a.items()}
    whole = train.train_steps(ref_a, lambda p, b: decoder.loss(p, LM, b),
                              lambda i: [(batch, 1.0)], HP, 1)
    split = train.train_steps(
        ref_b, lambda p, b: decoder.loss(p, LM, b),
        lambda i: [({k: v[j:j + 1] for k, v in batch.items()}, 0.25) for j in range(4)], HP, 1)
    assert split["losses"][0] == pytest.approx(whole["losses"][0], rel=1e-6)
    assert split["grad_norm"] == pytest.approx(whole["grad_norm"], rel=1e-5)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10, -3.0 - 2 ** -12])
    got = numerics.quantize(x, "tf32")
    # ties to even: 1 + 2^-11 -> 1, 1 + 3 2^-11 -> 1 + 2^-9
    assert got.tolist() == [1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10, -3.0]


def test_fp8_keeps_three_mantissa_bits_under_one_scale():
    x = torch.tensor([448.0, 1.0, 1.06, -2.2])
    got = numerics.quantize(x, "fp8")
    assert got.tolist() == [448.0, 1.0, 1.0, -2.25]


@pytest.mark.parametrize("precision", numerics.PRECISIONS)
def test_products_keep_their_gradients(precision):
    a = torch.randn(5, 7, requires_grad=True)
    b = torch.randn(7, 3, requires_grad=True)
    numerics.mm(a, b, precision).sum().backward()
    ga, gb = a.grad.clone(), b.grad.clone()
    a.grad = b.grad = None
    (a @ b).sum().backward()
    tol = {"f32": 1e-6, "tf32": 2e-3, "fp8": 0.2}[precision]
    torch.testing.assert_close(ga, a.grad, rtol=tol, atol=tol)
    torch.testing.assert_close(gb, b.grad, rtol=tol, atol=tol)
