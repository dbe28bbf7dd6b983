"""The port's multi-rank program on gloo ranks on the CPU, against the JAX
package and against the port's own one-rank runs.

Ranks are processes started with ``torch.multiprocessing.spawn`` over a
file store in ``tmp_path``; several checks share each spawn (starting
four ranks takes seconds).  Weights come from the JAX package
(``jax.random``, converted), so both packages compute the same function.

  * gemma3 smoke at accum 2 on 2x1, 1x2 and 2x2: step-0 loss within 1e-3
    of the JAX package's one-device loss (``tests/test_distributed.py``'s
    bound); f32 params after two AdamW steps within ``_tol`` of the
    port's one-rank run (``tests/test_kernels.py::_tol`` at the longest
    contraction a weight gradient sums, the B*S tokens);
  * a smollm smoke config with smollm's 3:1 head ratio at 3 heads and 1 kv
    head on 1x2: neither count divides 2, so every rank gathers the q/k/v
    projections (the head-boundary gather) and its decode cache splits
    over the slots, which serving gathers whole; same bounds;
  * each rank's param pieces and ZeRO-1 ``m``/``v`` leaves have the
    shapes their specs give;
  * ``compressed_psum`` over four ranks within
    ``tests/test_distributed.py``'s bound;
  * greedy tokens of a 1x2 ``ServeEngine`` equal the JAX engine's (f32),
    and with the 3:1 config's slot-split cache one rank's;
  * a checkpoint the train launcher saved at 2x1, restored at 1x2,
    continues as an unbroken run: the restored pieces are the saved
    state's bit for bit, and the losses and params of the continued run
    are the unbroken run's within the bounds above;
  * mamba2 smoke at 2x1 equals its one-rank run; grok-1 smoke under
    Adafactor at 2x1 (its experts' second dim over the data axis, FSDP)
    and mamba2 at 1x2 (its blocks split by head) hold the JAX package's
    loss and one rank's run (grok's router rows of experts no token chose
    left out: their gradient is rounding noise, which Adafactor steps by
    O(1)), and their state pieces have their specs' shapes
    (``tests/test_torch_mesh_moe_ssm.py`` has the rest of those meshes);
  * the launchers' policy under a mesh keeps the kernels
    (``distributed=False``).
"""

import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

B, S, ACCUM, STEPS = 4, 16, 2, 2
STEP_KW = dict(accum=ACCUM, lr=1e-3, warmup=1, total_steps=STEPS)
KERNEL = ("fixed:nt=PALLAS_TNN_FUSED,nn=PALLAS_NN,tn=PALLAS_TN,bnt=PALLAS_BNT,"
          "bnn=PALLAS_BNN,attn=fused")
SERVE_POLICIES = {"interactive": "fixed:nt=PALLAS_TNN,attn=fused",
                  "bulk": "fixed:nt=PALLAS_NT,attn=fused"}
PROMPTS = (3, 7, 5, 6)  # one prefill bucket: the JAX engine compiles each
GEN = 6
MAX_SEQ = 32
SMOLLM_31 = dict(n_heads=3, n_kv=1)  # smollm's 9:3, cut to the smoke width
GROK = dict(optimizer="adafactor")  # the optimizer grok-1's full config names


def _tol(k):
    return 1e-5 * np.sqrt(k)


# -- what every rank runs -----------------------------------------------------------------


def _port_cfg(name, over=None):
    from repro_torch.configs import smoke_config

    return smoke_config(name).replace(**(over or {}))


def _params(cfg, tree):
    from repro_torch.convert import params_from_numpy

    return params_from_numpy(tree, cfg, device="cpu")


def _batches(cfg):
    from repro_torch.data import make_train_batch

    return [{k: torch.from_numpy(v).long() for k, v in make_train_batch(cfg, S, B, i).items()}
            for i in range(STEPS)]


def train_run(cfg, params, mesh, steps=STEPS):
    """``steps`` train steps from full ``params`` on ``mesh`` (None: one
    rank); returns (metrics, state)."""
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.distributed.sharding import batch_specs, param_specs, shard
    from repro_torch.launch.steps import TrainStepConfig, init_train_state, make_train_step

    if mesh is not None:
        params = shard(params, param_specs(params, mesh), mesh)
    state = init_train_state(cfg, params, mesh)
    step = make_train_step(cfg, TrainStepConfig(**STEP_KW), policy=policy_from_spec(KERNEL),
                           mesh=mesh)
    metrics = []
    for b in _batches(cfg)[:steps]:
        if mesh is not None:
            b = shard(b, batch_specs(b, mesh), mesh)
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def serve_tokens(cfg, params, mesh):
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.serving import ServeEngine

    eng = ServeEngine(cfg, params, n_slots=4, max_seq=MAX_SEQ, cache_dtype=torch.float32,
                      policies={c: policy_from_spec(s) for c, s in SERVE_POLICIES.items()},
                      device="cpu", mesh=mesh)
    rng = np.random.RandomState(11)
    classes = sorted(SERVE_POLICIES)
    for i, n in enumerate(PROMPTS):
        eng.submit(rng.randint(0, cfg.vocab, (n,)).astype(np.int32), max_new=GEN,
                   cls=classes[i % 2])
    eng.run()
    assert eng.health()["crashed_steps"] == 0
    return [eng.requests[r].generated for r in sorted(eng.requests)]


def _full(cfg, state, mesh):
    from repro_torch.launch.steps import unshard_train_state

    return unshard_train_state(cfg, state, mesh)["params"]


def _np_tree(tree):
    from repro_torch.optim import tree_map

    return tree_map(lambda t: t.detach().float().numpy().copy(), tree)


def _state_shapes_ok(cfg, state, mesh):
    """Every leaf of this rank's state has the shape its spec gives."""
    from repro_torch.distributed.sharding import local_shape, map_with_path
    from repro_torch.launch.steps import train_state_shapes, train_state_specs

    shapes = train_state_shapes(cfg)
    specs = train_state_specs(shapes, mesh)
    bad = []
    for part in ("params", "opt"):
        map_with_path(lambda names, t, full, s: bad.append(names)
                      if tuple(t.shape) != local_shape(full.shape, s, mesh) else None,
                      state[part], shapes[part], specs[part])
    return not bad


def _noise_rows(g):
    """``tests/test_torch_train.py::_noise_rows``: the rows of a factored
    leaf whose gradient is rounding noise (an expert no token chose)."""
    if g.ndim < 2:
        return np.zeros(g.shape, bool)
    norms = np.linalg.norm(g, axis=-1, keepdims=True)
    return np.broadcast_to(norms <= 1e-6 * norms.max(), g.shape)


def kept_rows(cfg, params):
    """Per leaf, the entries whose gradient is not rounding noise at any
    step of ``train_run`` (one rank)."""
    from repro_torch.launch.steps import loss_and_grads

    noise = None
    for step, batch in enumerate(_batches(cfg)):
        now = params if step == 0 else train_run(cfg, params, None, steps=step)[1]["params"]
        rows = [_noise_rows(g) for g in _leaves(_np_tree(loss_and_grads(cfg, now, batch)[1]))]
        noise = rows if noise is None else [a | b for a, b in zip(noise, rows)]
    return [~n for n in noise]


def _start(rank, world, tmp):
    torch.set_num_threads(1)  # the ranks share this machine's cores
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world)
    return pickle.loads(open(os.path.join(tmp, "job.pkl"), "rb").read())


def _finish(rank, tmp, out):
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def two_ranks(rank, world, tmp):
    from repro_torch.launch import train
    from repro_torch.launch.common import resolve_mesh_and_policy
    from repro_torch.launch.mesh import make_local_mesh

    job = _start(rank, world, tmp)
    out = {}
    for key, name, over, meshes in (("gemma3", "gemma3-4b", None, ((2, 1), (1, 2))),
                                    ("smollm31", "smollm-135m", SMOLLM_31, ((1, 2),))):
        cfg = _port_cfg(name, over)
        params = _params(cfg, job[key])
        for dm in meshes:
            mesh = make_local_mesh(*dm)
            metrics, state = train_run(cfg, params, mesh)
            out[(key, dm)] = {"metrics": metrics, "params": _np_tree(_full(cfg, state, mesh)),
                              "opt_ok": _state_shapes_ok(cfg, state, mesh)}
        out[(key, "tokens")] = serve_tokens(cfg, params, make_local_mesh(1, 2))

    # mamba2 over the data axis
    cfg = _port_cfg("mamba2-2.7b")
    params = _params(cfg, job["mamba2"])
    metrics, state = train_run(cfg, params, make_local_mesh(2, 1))
    out["mamba2"] = {"metrics": metrics,
                     "params": _np_tree(_full(cfg, state, make_local_mesh(2, 1)))}
    if rank == 0:
        metrics, state = train_run(cfg, params, None)
        out["mamba2_one"] = {"metrics": metrics, "params": _np_tree(state["params"])}
    # grok-1's experts over the data axis, mamba2's blocks over the model axis
    for key, name, over, dm in (("grok", "grok-1-314b", GROK, (2, 1)),
                                ("mamba2", "mamba2-2.7b", None, (1, 2))):
        cfg = _port_cfg(name, over)
        mesh = make_local_mesh(*dm)
        metrics, state = train_run(cfg, _params(cfg, job[key]), mesh)
        out[(key, dm)] = {"metrics": metrics, "params": _np_tree(_full(cfg, state, mesh)),
                          "state_ok": _state_shapes_ok(cfg, state, mesh)}

    class Args:
        mesh, policy, device = "1x2", "analytic", "cpu"

    _, policy = resolve_mesh_and_policy(Args())
    out["policy_distributed"] = policy.distributed

    # checkpoints: saved at 2x1 by the launcher, restored at 1x2
    argv = ["--arch", "gemma3-4b", "--smoke", "--device", "cpu", "--batch", str(B), "--seq",
            str(S), "--policy", KERNEL, "--lr", "1e-3", "--log-every", "1"]
    ck = os.path.join(tmp, "ckpt")
    first = train.main(argv + ["--mesh", "2x1", "--steps", "1", "--ckpt-dir", ck])
    saved = _np_tree(_full(first.cfg, first.state, make_local_mesh(2, 1)))
    resumed = train.main(argv + ["--mesh", "1x2", "--steps", "2", "--ckpt-dir", ck])
    unbroken = train.main(argv + ["--mesh", "2x1", "--steps", "2"])
    out["ckpt"] = {"saved": saved, "resumed_metrics": resumed.metrics,
                   "resumed": _np_tree(_full(resumed.cfg, resumed.state, make_local_mesh(1, 2))),
                   "unbroken_metrics": unbroken.metrics,
                   "unbroken": _np_tree(_full(unbroken.cfg, unbroken.state,
                                              make_local_mesh(2, 1)))}
    _finish(rank, tmp, out)


def four_ranks(rank, world, tmp):
    from repro_torch.distributed import compressed_psum
    from repro_torch.launch.mesh import make_local_mesh

    job = _start(rank, world, tmp)
    out = {}
    cfg = _port_cfg("gemma3-4b")
    mesh = make_local_mesh(2, 2)
    metrics, state = train_run(cfg, _params(cfg, job["gemma3"]), mesh)
    out["gemma3"] = {"metrics": metrics, "params": _np_tree(_full(cfg, state, mesh)),
                     "opt_ok": _state_shapes_ok(cfg, state, mesh)}
    g = {k: torch.from_numpy(v) for k, v in job["grads"].items()}
    out["psum"] = _np_tree(compressed_psum(g, make_local_mesh(4, 1), ("data",)))
    _finish(rank, tmp, out)


# -- the references, in this process, while the ranks run --------------------------------


def _start_ranks(fn, world, tmp_path, job):
    (tmp_path / "job.pkl").write_bytes(pickle.dumps(job))
    return mp.start_processes(fn, args=(world, str(tmp_path)), nprocs=world, join=False,
                              start_method="spawn")


def _join(ctx, world, tmp_path):
    while not ctx.join():
        pass
    return [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes()) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Weights from the JAX package; the two- and four-rank runs, started
    first; then, while they run, the JAX package's one-device losses and
    engine tokens and the port's one-rank runs."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as j_smoke_config
    from repro.core import engine as jengine
    from repro.models import lm as jlm
    from repro.serving import ServeEngine as JServeEngine

    ref, jax_side = {}, {}
    for key, name, over in (("gemma3", "gemma3-4b", None), ("smollm31", "smollm-135m",
                                                            SMOLLM_31),
                            ("mamba2", "mamba2-2.7b", None), ("grok", "grok-1-314b", GROK)):
        jcfg = j_smoke_config(name).replace(**(over or {}))
        jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
        jax_side[key] = (jcfg, jparams)
        ref[key] = {"tree": jax.tree.map(lambda x: np.array(x, np.float32), jparams)}
    rng = np.random.RandomState(0)
    grads = {"a": rng.randn(64, 33).astype(np.float32), "b": rng.randn(129).astype(np.float32)}
    two_dir, four_dir = tmp_path_factory.mktemp("two"), tmp_path_factory.mktemp("four")
    two = _start_ranks(two_ranks, 2, two_dir, {k: ref[k]["tree"] for k in ref})
    four = _start_ranks(four_ranks, 4, four_dir, {"gemma3": ref["gemma3"]["tree"],
                                                  "grads": grads})
    for key, (jcfg, jparams) in jax_side.items():
        cfg, tree = to_port(key), ref[key]["tree"]
        batch = {k: jnp.asarray(v.numpy()) for k, v in _batches(cfg)[0].items()}
        with jengine.use_policy(jengine.policy_from_spec("fixed:XLA_NT")):
            ref[key]["jax_loss"] = float(jax.jit(
                lambda p, b, c=jcfg: jlm.lm_loss(p, c, b)[0])(jparams, batch))
        ref[key]["metrics"], state = train_run(cfg, _params(cfg, tree), None)
        ref[key]["params"] = _np_tree(state["params"])
        if key == "grok":
            ref[key]["keep"] = kept_rows(cfg, _params(cfg, tree))
        if key == "gemma3":
            jeng = JServeEngine(jcfg, jparams, n_slots=4, max_seq=MAX_SEQ,
                                cache_dtype=jnp.float32,
                                policies={c: jengine.policy_from_spec("fixed:XLA_NT")
                                          for c in SERVE_POLICIES})
            prompts = np.random.RandomState(11)
            classes = sorted(SERVE_POLICIES)
            for i, n in enumerate(PROMPTS):
                jeng.submit(prompts.randint(0, cfg.vocab, (n,)).astype(np.int32), max_new=GEN,
                            cls=classes[i % 2])
            jeng.run()
            ref[key]["jax_tokens"] = [jeng.requests[r].generated for r in sorted(jeng.requests)]
        if key == "smollm31":  # its slot-split cache against the port's one-rank engine
            ref[key]["one_rank_tokens"] = serve_tokens(cfg, _params(cfg, tree), None)
    return ref, _join(two, 2, two_dir), (grads, _join(four, 4, four_dir))


def to_port(key):
    return {"gemma3": _port_cfg("gemma3-4b"), "smollm31": _port_cfg("smollm-135m", SMOLLM_31),
            "mamba2": _port_cfg("mamba2-2.7b"), "grok": _port_cfg("grok-1-314b", GROK)}[key]


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def two(runs):
    return runs[1]


@pytest.fixture(scope="module")
def four(runs):
    return runs[2]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _close_params(got, want, keep=None):
    """Every leaf within ``_tol``; ``keep``: per leaf, the entries held."""
    tol = _tol(B * S)
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(want))):
        k = keep[i] if keep is not None else slice(None)
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol)


def _check_run(run, one, jax_loss):
    assert abs(run["metrics"][0]["loss"] - jax_loss) <= 1e-3
    for m, w in zip(run["metrics"], one["metrics"]):
        np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=1e-5)
    _close_params(run["params"], one["params"], one.get("keep"))


@pytest.mark.parametrize("dm", [(2, 1), (1, 2)], ids=["2x1", "1x2"])
def test_gemma3_on_two_ranks_matches_jax_and_one_rank(ref, two, dm):
    for r in two:
        _check_run(r[("gemma3", dm)], ref["gemma3"], ref["gemma3"]["jax_loss"])
        assert r[("gemma3", dm)]["opt_ok"]


def test_gemma3_at_2x2_matches_jax_and_one_rank(ref, four):
    _, ranks = four
    for r in ranks:
        _check_run(r["gemma3"], ref["gemma3"], ref["gemma3"]["jax_loss"])
        assert r["gemma3"]["opt_ok"]


def test_head_boundary_gather_matches_jax_and_one_rank(ref, two):
    for r in two:
        _check_run(r[("smollm31", (1, 2))], ref["smollm31"], ref["smollm31"]["jax_loss"])


def test_engine_on_1x2_serves_the_jax_engines_tokens(ref, two):
    for r in two:
        assert r[("gemma3", "tokens")] == ref["gemma3"]["jax_tokens"]


def test_engine_with_a_slot_split_cache_serves_one_ranks_tokens(ref, two):
    """smollm's 3:1 heads at 1x2: each rank holds half of every cache's
    slots, writes the positions it owns and gathers the rest to attend."""
    for r in two:
        assert r[("smollm31", "tokens")] == ref["smollm31"]["one_rank_tokens"]


def test_compressed_psum_over_four_ranks(four):
    grads, ranks = four
    for r in ranks:
        for k, g in grads.items():
            err = np.abs(r["psum"][k] - 4 * g)
            scale = np.abs(g).max() / 127.0
            assert err.max() <= 4 * (0.5 * scale) + 1e-5, (k, err.max())


def test_checkpoint_saved_at_2x1_continues_at_1x2(two):
    for r in two:
        ck = r["ckpt"]
        assert [m["loss"] for m in ck["resumed_metrics"]] == [
            m["loss"] for m in ck["unbroken_metrics"][1:]] or np.allclose(
            [m["loss"] for m in ck["resumed_metrics"]],
            [m["loss"] for m in ck["unbroken_metrics"][1:]], rtol=1e-5)
        _close_params(ck["resumed"], ck["unbroken"])
    # the restored pieces were the saved state's: one resumed step from it
    # reproduces on both ranks, and the saved state is the 2x1 run's first
    for a, b in zip(_leaves(two[0]["ckpt"]["saved"]), _leaves(two[1]["ckpt"]["saved"])):
        np.testing.assert_array_equal(a, b)


def test_restored_pieces_are_the_saved_state(tmp_path):
    """One process: a full state saved, restored through the launcher's
    path and cut at 1x2 for each rank, equals the saved state's pieces."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import init_train_state, shard_train_state
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves

    cfg = _port_cfg("gemma3-4b")
    state = init_train_state(cfg, lm.init_lm(0, cfg, device="cpu"))
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(3, state)
    for rank in (0, 1):
        mesh = Mesh((1, 2), ("data", "model"), rank=rank)
        got, step = train._restore(ckpt, cfg, mesh, torch.device("cpu"))
        want = shard_train_state(cfg, state, mesh)
        assert step == 3
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)


def test_mamba2_over_the_data_axis_equals_one_rank(two):
    for r in two:
        for m, w in zip(r["mamba2"]["metrics"], two[0]["mamba2_one"]["metrics"]):
            np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-5)
        _close_params(r["mamba2"]["params"], two[0]["mamba2_one"]["params"])


def test_grok_with_its_experts_over_the_data_axis_matches_jax_and_one_rank(ref, two):
    """grok-1 at 2x1: each rank holds half of every expert's d_ff, gathers
    it a layer at a time and reduce-scatters its gradient; Adafactor
    updates the pieces."""
    for r in two:
        _check_run(r[("grok", (2, 1))], ref["grok"], ref["grok"]["jax_loss"])


def test_mamba2_on_the_model_axis_matches_jax_and_one_rank(ref, two):
    """mamba2 at 1x2: each rank runs the SSD on its own 4 of the 8 heads."""
    for r in two:
        _check_run(r[("mamba2", (1, 2))], ref["mamba2"], ref["mamba2"]["jax_loss"])


@pytest.mark.parametrize("key,dm", [("grok", (2, 1)), ("mamba2", (1, 2))],
                         ids=["grok-2x1", "mamba2-1x2"])
def test_moe_and_mamba_state_pieces_have_their_specs_shapes(two, key, dm):
    """Adafactor's statistics and AdamW's moments, and every param piece,
    as ``train_state_specs`` cuts them."""
    for r in two:
        assert r[(key, dm)]["state_ok"]


def test_launchers_keep_the_kernels_under_a_mesh(two):
    """Each rank runs a local program, so the policy is not restricted to
    the distributed-safe library candidates (the JAX package's is)."""
    assert all(r["policy_distributed"] is False for r in two)


def test_ranks_outnumbering_cards_raise_unless_gloo_is_named(monkeypatch):
    """Two ranks on a node of one card: NCCL refuses two ranks on a card,
    so the launch raises before it makes a process group."""
    from repro_torch.launch.common import setup_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in {"WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": "0",
                 "RANK": "0"}.items():
        monkeypatch.setenv(k, v)

    class Args:
        device, dist_backend = "cuda", None

    with pytest.raises(ValueError, match="--dist-backend gloo"):
        setup_distributed(Args())
    assert not dist.is_initialized()
