"""The port's FCN (the paper's §VI-C networks) against the JAX package's,
on the same numpy weights and batches: ``fcn_forward``, and ``fcn_loss``
with every gradient leaf against ``jax.value_and_grad``, under the
cuBLAS arm, the paper's TNN arm, and the kernel arms of every GEMM (the
JAX side runs its Pallas kernels in interpret mode; the port's kernel
arms run their plain versions on the CPU); the paper's configurations;
the FCN example and the Table X benchmark end to end on the CPU.

Tolerance: ``tests/test_kernels.py::_tol`` for f32, rtol 1e-5 and atol
``1e-5*sqrt(k)`` with k the longest contraction (sums in another order).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import fcn_paper as jpaper  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core.engine import policy_from_spec as jspec  # noqa: E402
from repro.models import fcn as jfcn  # noqa: E402
from repro_torch.configs import fcn_paper  # noqa: E402
from repro_torch.convert import fcn_params_from_numpy  # noqa: E402
from repro_torch.core.engine import policy_from_spec  # noqa: E402
from repro_torch.core.policy import use_policy  # noqa: E402
from repro_torch.examples import train_fcn  # noqa: E402
from repro_torch.models import fcn  # noqa: E402

DIMS = (64, 128, 96, 10)  # 64-128-96-10
BATCH = 24
SPECS = ["fixed:XLA_NT", "fixed:PALLAS_TNN",
         "fixed:nt=PALLAS_TNN,nn=PALLAS_NN,tn=PALLAS_TN"]


def _tol(k):
    return dict(rtol=1e-5, atol=1e-5 * max(1.0, k**0.5))


TOL = _tol(max(DIMS + (BATCH,)))


@pytest.fixture(scope="module")
def net():
    """Random weights, biases and a batch from numpy, in both packages."""
    rng = np.random.RandomState(0)
    tree = {"layers": [
        {"w": (rng.randn(o, i) / np.sqrt(i)).astype(np.float32),
         "b": (0.1 * rng.randn(o)).astype(np.float32)}
        for i, o in zip(DIMS[:-1], DIMS[1:])
    ]}
    x = rng.randn(BATCH, DIMS[0]).astype(np.float32)
    labels = rng.randint(0, DIMS[-1], (BATCH,)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = fcn_params_from_numpy(tree, device="cpu")
    jbatch = {"x": jnp.asarray(x), "labels": jnp.asarray(labels)}
    batch = {"x": torch.from_numpy(x), "labels": torch.from_numpy(labels).long()}
    return jparams, params, jbatch, batch


@pytest.mark.parametrize("spec", SPECS)
def test_forward_matches_jax(net, spec):
    jparams, params, jbatch, batch = net
    with jpolicy.use_policy(jspec(spec)):
        want = np.asarray(jfcn.fcn_forward(jparams, jbatch["x"]))
    with use_policy(policy_from_spec(spec)):
        got = fcn.fcn_forward(params, batch["x"])
    assert got.shape == (BATCH, DIMS[-1])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("spec", SPECS)
def test_loss_and_every_gradient_match_jax(net, spec):
    jparams, params, jbatch, batch = net
    jpol, pol = jspec(spec), policy_from_spec(spec)
    with jpolicy.use_policy(jpol):
        (jloss, _), jgrads = jax.value_and_grad(
            lambda p: jfcn.fcn_loss(p, jbatch), has_aux=True)(jparams)
    loss, grads = fcn.fcn_loss_and_grads(params, batch, pol)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for mine, theirs in zip(grads["layers"], jgrads["layers"]):
        for leaf in ("w", "b"):
            assert mine[leaf].shape == theirs[leaf].shape
            np.testing.assert_allclose(mine[leaf].numpy(), np.asarray(theirs[leaf]), **TOL)
    # the same (op, candidate) rows: 3 NT forwards and 3 TN weight
    # gradients; NN data gradients for layers 1 and 2 only, where JAX also
    # traces the input's (its custom_vjp computes both cotangents)
    theirs = {op: dict(v) for op, v in jpol.stats.by_op.items()}
    (name, n_nn), = theirs["NN"].items()
    theirs["NN"] = {name: n_nn - 1}
    assert pol.stats.by_op == theirs and sum(pol.stats.by_op["NT"].values()) == 3


def test_no_policy_runs_the_default_selector(net):
    _, params, _, batch = net
    loss, grads = fcn.fcn_loss_and_grads(params, batch)
    want, _ = fcn.fcn_loss_and_grads(params, batch, policy_from_spec("fixed:XLA_NT"))
    assert float(loss) == pytest.approx(float(want), rel=1e-6)
    assert all(torch.isfinite(g).all() for layer in grads["layers"] for g in layer.values())


def test_paper_configs_match_the_jax_package():
    for mine, theirs in ((fcn_paper.MNIST_FCNS, jpaper.MNIST_FCNS),
                         (fcn_paper.SYNTHETIC_FCNS, jpaper.SYNTHETIC_FCNS)):
        assert {h: (c.name, c.dims) for h, c in mine.items()} == \
            {h: (c.name, c.dims) for h, c in theirs.items()}
    assert fcn_paper.SYNTHETIC_FCNS[3].dims == (26752, 4096, 4096, 4096, 26752)
    assert fcn_paper.MNIST_FCNS[3].dims == (784, 2048, 2048, 1024, 10)
    assert (fcn_paper.MNIST_BATCHES, fcn_paper.SYNTHETIC_BATCHES) == \
        (jpaper.MNIST_BATCHES, jpaper.SYNTHETIC_BATCHES)


def test_init_fcn_is_seeded_and_shaped():
    cfg = fcn.FCNConfig("t", 8, 3, (16,))
    a, b = fcn.init_fcn(0, cfg, device="cpu"), fcn.init_fcn(0, cfg, device="cpu")
    assert [tuple(layer["w"].shape) for layer in a["layers"]] == [(16, 8), (3, 16)]
    assert all(torch.equal(x["w"], y["w"]) for x, y in zip(a["layers"], b["layers"]))
    assert not any(layer["b"].any() for layer in a["layers"])


def test_fcn_params_from_numpy_rejects_other_trees():
    with pytest.raises(ValueError, match="FCN tree"):
        fcn_params_from_numpy({"layers": [{"w": np.zeros((2, 2), np.float32)}]},
                              device="cpu")
    with pytest.raises(ValueError, match="FCN tree"):
        fcn_params_from_numpy({"layers": []}, device="cpu")


@pytest.mark.parametrize("argv", [[], ["--always-nt"], ["--policy", "analytic"]])
def test_train_fcn_example_smoke_on_cpu(argv, capsys):
    losses = train_fcn.main(["--smoke", "--device", "cpu"] + argv)
    assert len(losses) == 5 and all(math.isfinite(x) for x in losses)
    out = capsys.readouterr().out
    assert "dispatch report" in out and "done; median" in out


def test_table10_benchmark_on_cpu(tmp_path, monkeypatch):
    from repro_torch.benchmarks.table10_fcn import table10

    monkeypatch.chdir(tmp_path)
    out = table10(device="cpu", nets={"small": fcn.FCNConfig("small", 64, 10, (128, 96))},
                  batches=(16,), grid_hi=7)
    row = out["small@16"]
    assert all(row[k] > 0 for k in ("fwd_nt_ms", "fwd_mtnn_ms", "bwd_nt_ms"))
    assert out["_device"] == {"device": "cpu", "name": "cpu"}
    assert set(out["_summary"]["selector_decisions"]) == {"NT", "NN", "TN"}
    assert (tmp_path / "build" / "bench" / "table10.json").exists()
