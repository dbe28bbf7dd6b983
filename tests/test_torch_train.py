"""The port's training path against the JAX package's on the same weights
and batches: ``lm_loss`` and every gradient leaf, and three optimizer
steps, under each of the three training policies (the port's kernel arms
run their plain versions on the CPU) against JAX under ``fixed:XLA_NT``,
for token models and for the ``frames`` (musicgen-large) and ``vlm``
(paligemma-3b: patches ahead of the text, the loss on the text only)
input modes (``test_torch_train_moe_ssm.py`` runs these tests on the MoE,
Mamba-2 and Zamba2 smoke configs); plus the port's own rules: remat, policy scope,
accumulation, the checkpoint manager and a resumed launcher run; and
``remat="dots"`` against the JAX package's.

Tolerances, f32 throughout.  Loss: rtol 1e-5 (one mean over B*S
log-softmaxes of sums in another order).  Gradient leaves:
``tests/test_kernels.py::_tol`` at the longest contraction a gradient
sums over, the B*S tokens of a weight gradient (rtol 1e-5, atol
1e-5*sqrt(B*S)), on leaves whose entries are O(1e-2) or smaller.  After
three AdamW steps: losses rtol 1e-5; params atol 0.1 * lr.  AdamW moves
each weight by about lr * m/sqrt(v), and for an entry whose gradient is
a near-cancelling sum that ratio takes the rounding of the two
frameworks' sums into its leading digits: with torch.matmul on one side
and XLA on the other, 2-3 entries of ~10^4 end 2-3 % of a step apart
and every other entry within 0.1 %.  The optimizer alone, on identical
gradients, is held to 1e-7.

zamba2's smoke stack is the exception, held to wider bounds of its own
(``WIDE``): its 8 Mamba blocks chain exponentials, its gradients reach
O(1) (the embedding's largest entry is 7.9), and f32 runs of either
package land 3e-5 of a leaf's largest entry from an f64 run of the port,
so its leaves are held to 1e-4 of their largest entry; after three AdamW
steps 6 of its 7168 embedding entries end 0.45 of a step apart, so its
params are held to one step (lr).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke_config  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.data import make_train_batch as j_make_train_batch  # noqa: E402
from repro.launch.steps import TrainStepConfig as JTrainStepConfig  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro.optim import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro.optim import warmup_linear as j_warmup_linear  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.data import make_train_batch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    TrainStepConfig,
    init_train_state,
    loss_and_grads,
    make_train_step,
)
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.optim import make_optimizer, warmup_cosine, warmup_linear  # noqa: E402

from test_torch_lm import TINY_WINDOWED, converted_params, to_port_cfg  # noqa: E402

KERNEL = ("fixed:nt=PALLAS_TNN_FUSED,nn=PALLAS_NN,tn=PALLAS_TN,bnt=PALLAS_BNT,"
          "bnn=PALLAS_BNN,attn=fused")
TNN = "fixed:nt=PALLAS_TNN,nn=PALLAS_NN,tn=PALLAS_TN,bnt=PALLAS_BNT,bnn=PALLAS_BNN,attn=unfused"
CUBLAS = "fixed:XLA_NT"
POLICIES = [KERNEL, TNN, CUBLAS]
JCFGS = {"smollm-smoke": j_smoke_config("smollm-135m"), "tiny-windowed": TINY_WINDOWED,
         "musicgen-smoke": j_smoke_config("musicgen-large"),
         "paligemma-smoke": j_smoke_config("paligemma-3b")}
B, S = 2, 16
STEP_CFG = dict(lr=1e-3, warmup=1, total_steps=3)
WIDE = {"zamba2-smoke"}  # see the module docstring


def _leaves(tree):
    """Leaves in jax.tree.leaves order (dict keys sorted) for both packages."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree.detach().float().numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree, np.float32)]


def _batches(cfg, steps):
    return [make_train_batch(cfg, S, B, step) for step in range(steps)]


def _t(batch):
    """Tokens and labels as int64; frames and patches keep their f32."""
    return {k: torch.from_numpy(v) if v.dtype.kind == "f" else torch.from_numpy(v).long()
            for k, v in batch.items()}


def _noise_rows(g):
    """The rows of a factored leaf (ndim >= 2) whose step-0 gradient is
    rounding noise: the router row of an expert no token chose (grok's
    smoke batch leaves expert 0 unchosen; its row norm is 3e-10 against
    4e-2).  Adafactor divides such a row by the root of its own mean
    square, so both packages step it by O(1) in directions their rounding
    picks; the three-step comparison leaves those rows out."""
    if g.ndim < 2:
        return np.zeros(g.shape, bool)
    norms = np.linalg.norm(g, axis=-1, keepdims=True)
    return np.broadcast_to(norms <= 1e-6 * norms.max(), g.shape)


def make_case(name, jcfg):
    """One config: converted params, batches, and the JAX side's loss,
    gradients and three train steps under fixed:XLA_NT, each traced once."""
    cfg = to_port_cfg(jcfg)
    jparams, params = converted_params(jcfg, seed=3)
    batches = _batches(cfg, 3)
    jpol = jengine.policy_from_spec(CUBLAS)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, jcfg, b)[0]))
    with jengine.use_policy(jpol):
        jloss, jgrads = grad_fn(jparams, jax.tree.map(jnp.asarray, batches[0]))
    step = jax.jit(j_make_train_step(jcfg, JTrainStepConfig(**STEP_CFG), mesh=None,
                                     policy=jpol))
    state = {"params": jparams, "opt": j_make_optimizer(jcfg.optimizer)[0](jparams),
             "step": jnp.zeros((), jnp.int32)}
    jlosses = []
    for b in batches:
        state, metrics = step(state, jax.tree.map(jnp.asarray, b))
        jlosses.append(float(metrics["loss"]))
    return dict(name=name, cfg=cfg, params=params, batches=batches,
                jloss=float(jloss), jgrads=_leaves(jgrads), jlosses=jlosses,
                jparams_final=_leaves(state["params"]))


@pytest.fixture(scope="module", params=sorted(JCFGS))
def case(request):
    return make_case(request.param, JCFGS[request.param])


@pytest.mark.parametrize("jcfg,keys", [
    (TINY_WINDOWED, ["labels", "tokens"]),
    (j_smoke_config("musicgen-large"), ["frames", "labels"]),
    (j_smoke_config("paligemma-3b"), ["labels", "patches", "tokens"]),
], ids=lambda x: getattr(x, "name", None))
def test_batches_are_the_jax_packages(jcfg, keys):
    cfg = to_port_cfg(jcfg)
    for step in (0, 5):
        mine, theirs = make_train_batch(cfg, S, B, step, seed=1), \
            j_make_train_batch(jcfg, S, B, step, seed=1)
        assert sorted(mine) == sorted(theirs) == keys
        for k in mine:
            assert mine[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(mine[k], theirs[k])


@pytest.mark.parametrize("spec", POLICIES)
def test_loss_and_grads_match_jax(case, spec):
    pol = engine.policy_from_spec(spec)
    loss, grads = loss_and_grads(case["cfg"], case["params"], _t(case["batches"][0]), pol)
    np.testing.assert_allclose(float(loss), case["jloss"], rtol=1e-5)
    got = _leaves(grads)
    assert [g.shape for g in got] == [g.shape for g in case["jgrads"]]
    for g, want in zip(got, case["jgrads"]):
        atol = 1e-4 * np.abs(want).max() if case["name"] in WIDE else 1e-5 * (B * S) ** 0.5
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=atol)
    if spec != CUBLAS:  # every gradient GEMM went through the policy's arms
        ops = {op: (set(row), sum(row.values())) for op, row in pol.stats.by_op.items()}
        n_nt = ops["NT"][1]
        assert ops["NN"] == ({"PALLAS_NN"}, n_nt) and ops["TN"] == ({"PALLAS_TN"}, n_nt)
        if case["cfg"].n_heads:  # the attention backward's batched GEMMs
            assert ops["BNT"][0] == {"PALLAS_BNT"} and ops["BNN"][0] == {"PALLAS_BNN"}
        else:
            assert "BNT" not in ops and "BNN" not in ops


@pytest.mark.parametrize("spec", POLICIES)
def test_three_train_steps_match_jax(case, spec):
    cfg = case["cfg"]
    step = make_train_step(cfg, TrainStepConfig(**STEP_CFG), policy=engine.policy_from_spec(spec))
    state = init_train_state(cfg, case["params"])
    losses = []
    for b in case["batches"]:
        state, metrics = step(state, _t(b))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, case["jlosses"], rtol=1e-5)
    assert int(state["step"]) == 3
    for p, want, g in zip(_leaves(state["params"]), case["jparams_final"], case["jgrads"]):
        keep = ~_noise_rows(g) if cfg.optimizer == "adafactor" else np.ones(g.shape, bool)
        atol = STEP_CFG["lr"] * (1.0 if case["name"] in WIDE else 0.1)
        np.testing.assert_allclose(p[keep], want[keep], rtol=0, atol=atol)


def test_adamw_matches_jax_on_the_same_gradients():
    rng = np.random.RandomState(7)
    params = {"a": rng.randn(4, 3).astype(np.float32), "b": (rng.randn(5),)}
    params["b"] = (params["b"][0].astype(np.float32),)
    jp = jax.tree.map(jnp.asarray, params)
    tp = {"a": torch.from_numpy(params["a"]), "b": (torch.from_numpy(params["b"][0]),)}
    j_init, j_update = j_make_optimizer("adamw", weight_decay=0.1)
    t_init, t_update = make_optimizer("adamw", weight_decay=0.1)
    js, ts = j_init(jp), t_init(tp)
    for step in range(3):
        g = {"a": rng.randn(4, 3).astype(np.float32) * 10.0 ** -step,
             "b": (rng.randn(5).astype(np.float32),)}
        jp, js = j_update(jax.tree.map(jnp.asarray, g), js, jp, jnp.float32(1e-2))
        tp, ts = t_update({"a": torch.from_numpy(g["a"]), "b": (torch.from_numpy(g["b"][0]),)},
                          ts, tp, 1e-2)
    for a, b in zip(_leaves(tp), _leaves(jp)):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-7)
    assert int(ts["count"]) == int(js["count"]) == 3


def test_train_step_leaves_its_inputs_alone(case):
    cfg = case["cfg"]
    state = init_train_state(cfg, case["params"])
    before = _leaves(state["params"])
    new, _ = make_train_step(cfg, TrainStepConfig(**STEP_CFG),
                             policy=engine.policy_from_spec(KERNEL))(state, _t(case["batches"][0]))
    for p, q in zip(_leaves(state["params"]), before):
        np.testing.assert_array_equal(p, q)
    assert int(state["step"]) == 0 and int(new["step"]) == 1


@pytest.mark.parametrize("spec", [KERNEL, TNN])
def test_remat_full_gives_the_gradients_of_none(spec):
    cfg = to_port_cfg(TINY_WINDOWED)
    _, params = converted_params(TINY_WINDOWED, seed=4)
    batch = _t(_batches(cfg, 1)[0])
    runs = {}
    for remat in ("none", "full"):
        pol = engine.policy_from_spec(spec)
        runs[remat] = loss_and_grads(cfg.replace(remat=remat), params, batch, pol), pol
    (loss_n, g_n), pol_n = runs["none"]
    (loss_f, g_f), pol_f = runs["full"]
    assert float(loss_n) == float(loss_f)
    for a, b in zip(_leaves(g_n), _leaves(g_f)):
        np.testing.assert_array_equal(a, b)
    # the recompute runs every forward GEMM of the layers once more
    n_layers = cfg.n_layers
    assert pol_f.stats.by_op["NT"] == {
        k: v + 7 * n_layers for k, v in pol_n.stats.by_op["NT"].items()}


def test_backward_outside_any_policy_scope_raises():
    a = torch.randn(3, 8, requires_grad=True)
    w = torch.randn(5, 8, requires_grad=True)
    with engine.use_policy(engine.policy_from_spec(KERNEL)):
        out = engine.dispatch("NT", a, w)
    with pytest.raises(RuntimeError, match="no dispatch policy"):
        out.sum().backward()
    cfg = to_port_cfg(TINY_WINDOWED).replace(remat="full")
    _, params = converted_params(TINY_WINDOWED)
    params["embed"]["emb"].requires_grad_()
    with engine.use_policy(engine.policy_from_spec(CUBLAS)):
        loss, _ = lm.lm_loss(params, cfg, _t(_batches(cfg, 1)[0]))
    with pytest.raises(RuntimeError, match="no dispatch policy"):
        loss.backward()


def test_accumulation_matches_one_batch():
    cfg = to_port_cfg(TINY_WINDOWED)
    _, params = converted_params(TINY_WINDOWED, seed=5)
    batch = _t(make_train_batch(cfg, S, 4, 0))
    out = {}
    for accum in (1, 2):
        step = make_train_step(cfg, TrainStepConfig(accum=accum, **STEP_CFG),
                               policy=engine.policy_from_spec(KERNEL))
        out[accum] = step(init_train_state(cfg, params), batch)
    (s1, m1), (s2, m2) = out[1], out[2]
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    for a, b in zip(_leaves(s2["params"]), _leaves(s1["params"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=0.1 * STEP_CFG["lr"])


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_jax(z_loss):
    rng = np.random.RandomState(6)
    logits = (rng.randn(2, 5, 11) * 3).astype(np.float32)
    labels = rng.randint(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.rand(2, 5) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jlayers.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                          None if m is None else jnp.asarray(m), z_loss)
        got = layers.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                        None if m is None else torch.from_numpy(m), z_loss)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_schedules_match_jax():
    for mine, theirs in ((warmup_cosine(3e-4, 10, 50), j_warmup_cosine(3e-4, 10, 50)),
                         (warmup_linear(1e-3, 4, 20), j_warmup_linear(1e-3, 4, 20))):
        for step in (0, 3, 4, 9, 10, 30, 50, 80):
            np.testing.assert_allclose(mine(step), float(theirs(jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("spec", [KERNEL, CUBLAS])
def test_remat_dots_gradients_match_jax_dots_and_none(spec):
    """``remat="dots"`` keeps the unit's NT/NN/TN outputs and recomputes
    the rest: the JAX package's ``dots_with_no_batch_dims_saveable``
    gradients and the port's ``remat="none"`` ones, within ``_tol``, and
    no non-batched GEMM dispatched twice (the recompute replays them)."""
    jcfg = TINY_WINDOWED.replace(remat="dots")
    jparams, params = converted_params(TINY_WINDOWED, seed=4)
    cfg = to_port_cfg(jcfg)
    batch = _batches(cfg, 1)[0]
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, jcfg, b)[0]))
    with jengine.use_policy(jengine.policy_from_spec(CUBLAS)):
        jloss, jgrads = grad_fn(jparams, jax.tree.map(jnp.asarray, batch))
    runs = {}
    for remat in ("none", "dots"):
        pol = engine.policy_from_spec(spec)
        engine.REMAT_COUNTS.update(saved=0, replayed=0, recompute_gemms=0)
        runs[remat] = loss_and_grads(cfg.replace(remat=remat), params, _t(batch), pol), pol
        counts = dict(engine.REMAT_COUNTS)
    (loss_d, g_d), pol_d = runs["dots"]
    (loss_n, g_n), pol_n = runs["none"]
    np.testing.assert_allclose(float(loss_d), float(jloss), rtol=1e-5)
    assert float(loss_d) == float(loss_n)
    for g, want, none in zip(_leaves(g_d), _leaves(jgrads), _leaves(g_n)):
        np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5 * (B * S) ** 0.5)
        np.testing.assert_allclose(g, none, rtol=1e-5, atol=1e-5 * (B * S) ** 0.5)
    # 7 NT dispatches a layer, each kept by the forward; the recompute
    # replays them (up to the unit's last saved tensor) and launches none
    assert counts["saved"] == 7 * cfg.n_layers and counts["recompute_gemms"] == 0
    assert 0 < counts["replayed"] <= counts["saved"]
    for op in ("NT", "NN", "TN"):
        assert pol_d.stats.by_op[op] == pol_n.stats.by_op[op]
    # attention is recomputed: its plan is selected once more per layer
    assert sum(pol_d.stats.by_op["ATTN"].values()) == 2 * sum(pol_n.stats.by_op["ATTN"].values())


def test_checkpoints_are_atomic_kept_and_skipped_when_torn(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "step": torch.tensor(1)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save_async(step, {**state, "step": torch.tensor(step)})
    mgr.wait()
    assert mgr.steps() == [2, 3]
    (tmp_path / "step_3" / "tensors.pt").write_bytes(b"torn")
    restored, step = mgr.restore(state)
    assert step == 2 and int(restored["step"]) == 2
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    with pytest.raises(FileNotFoundError, match="no restorable"):  # shapes differ
        mgr.restore({"params": {"w": torch.zeros(3, 2)}, "step": torch.tensor(0)}, step=2)


def _launch(tmp_path, name, *extra):
    return train.main([
        "--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
        "--seq", "16", "--ckpt-dir", str(tmp_path / name), "--ckpt-every", "2",
        "--policy", KERNEL, *extra,
    ])


def test_launcher_resumes_where_an_uninterrupted_run_ends(tmp_path):
    whole = _launch(tmp_path, "whole")
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        _launch(tmp_path, "cut", "--fail-at", "3")
    resumed = _launch(tmp_path, "cut")
    # the last checkpoint before the failure is step 2: steps 2 and 3 run again
    assert len(whole.metrics) == 4 and resumed.metrics == whole.metrics[2:]
    for a, b in zip(_leaves(resumed.state), _leaves(whole.state)):
        np.testing.assert_array_equal(a, b)
    assert int(resumed.state["step"]) == 4
