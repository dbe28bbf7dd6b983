"""The MoE, Mamba-2 and hybrid architectures on gloo ranks on the CPU,
against the JAX package and the port's own one-rank runs.

Ranks are spawned as in ``tests/test_torch_distributed.py`` (whose
helpers, step and bounds this file takes); one spawn of two ranks and one
of four carry every check, and a process of one rank computes the port's
references meanwhile.  Weights are the port's seeded ones, which the
JAX package runs as they are (the two trees are the same), so both
packages compute the same function; the smoke configs train with the
optimizer their full config names (Adafactor for grok-1).

  * grok-1's MoE expert parallel (4 experts over ``model``) at 1x2 and
    2x2, its experts' second dim over the data axes (FSDP) at 2x1 and
    2x2, and tensor parallel within each expert on a 6-expert variant at
    1x4 (6 does not divide 4): step-0 loss within 1e-3 of the JAX
    package's, losses and grad norms within 1e-5 of one rank's and f32
    params after two steps within ``_tol`` of one rank's, leaving out
    the router rows of experts no token chose (their gradient is
    rounding noise, which Adafactor steps by O(1));
  * every rank's dispatch masks are one rank's, row for row (a flipped
    route fails here, whatever the seed);
  * mamba2 and zamba2 (five Mamba blocks and the shared attention) at
    1x2 and 2x2 by the same bounds, and mamba2 with 3 heads at 1x2,
    whose split misses a head boundary (the head-boundary gather).
    zamba2's 8-Mamba smoke stack carries f32 gradients 3e-5 of a leaf's
    largest entry from f64 (ROADMAP queue C; a mesh's step-0 gradient is
    as close to f64 as one rank's), and AdamW's first step moves an entry
    by up to lr whatever its gradient's size, so rounding noise in
    near-zero entries becomes a move of up to lr: after step 0 its leaves
    are held to ``tests/test_torch_train.py``'s bound for zamba2 (lr)
    and its grad norm, which follows them, to lr relative;
  * each rank's state pieces have the shapes their specs give;
  * greedy tokens of a 1x2 ``ServeEngine`` equal one rank's for mamba2,
    zamba2 and grok-1, and at 2x1 for grok-1 (its experts gathered over
    the data axis a layer at a time), and the JAX engine's for mamba2 and
    grok-1 (zamba2's one-rank tokens are held to the JAX engine's by
    ``tests/test_torch_serving.py``);
  * the harness's negative case: at 2x1 with an expert leaf's gradient
    summed over the data axis a second time (as an optimizer that does
    not know FSDP's leaves would), the grad norm leaves one rank's;
  * ``adafactor_update_zero1`` on a mesh of one is ``clip_by_global_norm``
    and ``adafactor_update`` bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import (  # noqa: E402
    B,
    KERNEL,
    S,
    SERVE_POLICIES,
    _batches,
    _finish,
    _full,
    _join,
    _leaves,
    _np_tree,
    _params,
    _start,
    _start_ranks,
    _state_shapes_ok,
    _tol,
    kept_rows,
    serve_tokens,
    train_run,
)

CASES = {  # key: (architecture, changes to its smoke config)
    "grok": ("grok-1-314b", {"optimizer": "adafactor"}),
    "grok6": ("grok-1-314b", {"optimizer": "adafactor", "moe": {"n_experts": 6}}),
    "mamba2": ("mamba2-2.7b", {}),
    "zamba2": ("zamba2-7b", {}),
    "mamba3h": ("mamba2-2.7b", {"ssm": {"expand": 3, "head_dim": 64}}),  # 3 heads
}
TWO = {"grok": ((2, 1), (1, 2)), "mamba2": ((1, 2),), "zamba2": ((1, 2),),
       "mamba3h": ((1, 2),)}
FOUR = {"grok": ((2, 2),), "grok6": ((1, 4),), "mamba2": ((2, 2),), "zamba2": ((2, 2),)}
SERVED = {"mamba2": (1, 2), "zamba2": (1, 2), "grok": (1, 2), "grok_2x1": (2, 1)}
JAX_SERVED = ("mamba2", "grok")
MOE = ("grok", "grok6")
WIDE = ("zamba2",)  # after step 0: leaves and grad norm within LR (the module docstring)
LR = 1e-3  # test_torch_distributed.STEP_KW's


def _cfg(smoke_config, key):
    name, over = CASES[key]
    cfg = smoke_config(name)
    return cfg.replace(**{k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
                          else v for k, v in over.items()})


def port_cfg(key):
    from repro_torch.configs import smoke_config

    return _cfg(smoke_config, key)


def routes(cfg, params, mesh):
    """Every dispatch mask of a forward on step 0's batch (this rank's
    shard on ``mesh``), per MoE layer, as numpy."""
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.core.policy import use_policy
    from repro_torch.distributed.context import mesh_scope
    from repro_torch.distributed.sharding import batch_specs, param_specs, shard
    from repro_torch.models import lm, moe

    batch = _batches(cfg)[0]
    if mesh is not None:
        params = shard(params, param_specs(params, mesh), mesh)
        batch = shard(batch, batch_specs(batch, mesh), mesh)
    seen, route = [], moe._route

    def record(logits, c, capacity):
        out = route(logits, c, capacity)
        seen.append(out[0].numpy().copy())
        return out

    moe._route = record
    try:
        with torch.no_grad(), use_policy(policy_from_spec(KERNEL)), mesh_scope(mesh):
            lm.lm_forward(params, cfg, batch)
    finally:
        moe._route = route
    return seen


def _mesh_runs(job, meshes):
    from repro_torch.launch.mesh import make_local_mesh

    out = {}
    for key, dms in meshes.items():
        cfg = port_cfg(key)
        params = _params(cfg, job[key])
        for dm in dms:
            mesh = make_local_mesh(*dm)
            metrics, state = train_run(cfg, params, mesh)
            out[(key, dm)] = {"metrics": metrics, "params": _np_tree(_full(cfg, state, mesh)),
                              "state_ok": _state_shapes_ok(cfg, state, mesh)}
            if key in MOE:
                out[(key, dm)]["routes"] = routes(cfg, params, mesh)
    return out


def two_ranks(rank, world, tmp):
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_local_mesh

    job = _start(rank, world, tmp)
    out = _mesh_runs(job, TWO)
    for key, dm in SERVED.items():
        cfg = port_cfg(key.split("_")[0])
        out[("tokens", key)] = serve_tokens(cfg, _params(cfg, job[key.split("_")[0]]),
                                            make_local_mesh(*dm))
    # the negative case: FSDP's expert gradients summed over data again
    splits = sharding.splits
    sharding.splits = lambda spec, axes: False
    try:
        cfg = port_cfg("grok")
        out["summed_twice"] = train_run(cfg, _params(cfg, job["grok"]), make_local_mesh(2, 1))[0]
    finally:
        sharding.splits = splits
    _finish(rank, tmp, out)


def four_ranks(rank, world, tmp):
    job = _start(rank, world, tmp)
    out = _mesh_runs(job, FOUR)
    _finish(rank, tmp, out)


def one_rank(rank, world, tmp):
    """The port's one-rank references of every case."""
    job = _start(rank, world, tmp)
    out = {}
    for key in CASES:
        cfg = port_cfg(key)
        params = _params(cfg, job[key])
        r = out[key] = {}
        r["metrics"], state = train_run(cfg, params, None)
        r["params"] = _np_tree(state["params"])
        r["keep"] = kept_rows(cfg, params) if key in MOE else None
        if key in MOE:
            r["routes"] = routes(cfg, params, None)
        if key in SERVED:
            r["tokens"] = serve_tokens(cfg, params, None)
    _finish(rank, tmp, out)


# -- the references, in this process, while the ranks run --------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's seeded weights; the two- and four-rank runs and the
    one-rank references, each in processes of their own; while they run,
    the JAX package's losses and engine tokens on the same weights."""
    from repro_torch.models import lm

    trees = {key: _np_tree(lm.init_lm(0, port_cfg(key), device="cpu")) for key in CASES}
    dirs = [tmp_path_factory.mktemp(n) for n in ("two", "four", "one")]
    spawned = [_start_ranks(fn, world, d, trees)
               for fn, world, d in zip((two_ranks, four_ranks, one_rank), (2, 4, 1), dirs)]
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as j_smoke_config
    from repro.core import engine as jengine
    from repro.models import lm as jlm
    from repro.serving import ServeEngine as JServeEngine

    xla = jengine.policy_from_spec("fixed:XLA_NT")
    ref = {}
    for key in CASES:
        r = ref[key] = {}
        jcfg, jparams = _cfg(j_smoke_config, key), jax.tree.map(jnp.asarray, trees[key])
        cfg = port_cfg(key)
        batch = {k: jnp.asarray(v.numpy()) for k, v in _batches(cfg)[0].items()}
        with jengine.use_policy(xla):
            r["jax_loss"] = float(jax.jit(lambda p, b, c=jcfg: jlm.lm_loss(p, c, b)[0])(
                jparams, batch))
        if key in JAX_SERVED:
            jeng = JServeEngine(jcfg, jparams, n_slots=4, max_seq=32, cache_dtype=jnp.float32,
                                policies={c: xla for c in SERVE_POLICIES})
            rng = np.random.RandomState(11)
            classes = sorted(SERVE_POLICIES)
            for i, n in enumerate((3, 7, 5, 6)):
                jeng.submit(rng.randint(0, cfg.vocab, (n,)).astype(np.int32), max_new=6,
                            cls=classes[i % 2])
            jeng.run()
            r["jax_tokens"] = [jeng.requests[q].generated for q in sorted(jeng.requests)]
    two, four, (one,) = (_join(ctx, world, d)
                         for ctx, world, d in zip(spawned, (2, 4, 1), dirs))
    for key, r in one.items():
        ref[key].update(r)
    return ref, two, four


@pytest.fixture(scope="module")
def ref(runs):
    return runs[0]


@pytest.fixture(scope="module")
def ranks(runs):
    """{(key, (D, M)): every rank's record of that run}."""
    out = {}
    for world in runs[1:]:
        for r in world:
            for k, v in r.items():
                out.setdefault(k, []).append(v)
    return out


def _check_run(runs, one, jax_loss, wide=False):
    """Every rank's run against one rank's: the bounds of
    ``tests/test_torch_distributed.py`` (``wide``: after step 0, LR for
    the grad norm and the leaves); a router row in ``one["keep"]``'s
    complement is left out."""
    tol = LR if wide else _tol(B * S)
    for run in runs:
        assert abs(run["metrics"][0]["loss"] - jax_loss) <= 1e-3
        for s, (m, w) in enumerate(zip(run["metrics"], one["metrics"])):
            np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"], w["grad_norm"],
                                       rtol=LR if wide and s else 1e-5)
        keep = one["keep"] or [np.ones(np.shape(x), bool) for x in _leaves(one["params"])]
        for a, b, k in zip(_leaves(run["params"]), _leaves(one["params"]), keep):
            np.testing.assert_allclose(a[k], b[k], rtol=0 if wide else tol, atol=tol)
        assert run["state_ok"]


RUNS = [(k, dm) for meshes in (TWO, FOUR) for k, dms in meshes.items() for dm in dms]


@pytest.mark.parametrize("key,dm", RUNS, ids=[f"{k}-{d}x{m}" for k, (d, m) in RUNS])
def test_mesh_run_matches_jax_and_one_rank(ref, ranks, key, dm):
    _check_run(ranks[(key, dm)], ref[key], ref[key]["jax_loss"], wide=key in WIDE)


MOE_RUNS = [(k, dm) for k, dm in RUNS if k in MOE]


@pytest.mark.parametrize("key,dm", MOE_RUNS, ids=[f"{k}-{d}x{m}" for k, (d, m) in MOE_RUNS])
def test_every_ranks_dispatch_masks_are_one_ranks(ref, ranks, key, dm):
    """Each rank routes the groups of its batch shard exactly as one rank
    routes them: rank r of ``D`` data replicas holds groups ``[r G/D,
    (r+1) G/D)`` of each layer's mask."""
    from repro_torch.launch.mesh import Mesh

    D = dm[0]
    for rank, run in enumerate(ranks[(key, dm)]):
        i = Mesh(dm, ("data", "model"), rank=rank).axis_index(("data",))
        assert len(run["routes"]) == len(ref[key]["routes"])
        for got, want in zip(run["routes"], ref[key]["routes"]):
            part = want.shape[0] // D
            np.testing.assert_array_equal(got, want[i * part:(i + 1) * part])


def test_the_moe_runs_take_both_expert_splits():
    """grok's 4 experts divide 2 and 2x2's model axis (expert parallel);
    the 6-expert variant's do not divide 4, its d_ff does (within each
    expert)."""
    from repro_torch.distributed.context import use_mesh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.moe import _expert_specs

    for key, dm, want in (("grok", (1, 2), 0), ("grok", (2, 2), 0), ("grok6", (1, 4), 1),
                          ("grok", (2, 1), None)):
        with use_mesh(Mesh(dm, ("data", "model"))):
            specs, mdim = _expert_specs(port_cfg(key).moe)
        assert mdim == want, (key, dm)
        assert "data" in specs["gate"] or dm[0] == 1  # FSDP wherever data > 1


@pytest.mark.parametrize("key", sorted(SERVED))
def test_engine_on_a_mesh_serves_one_ranks_and_the_jax_engines_tokens(ref, ranks, key):
    arch = key.split("_")[0]
    for tokens in ranks[("tokens", key)]:
        assert tokens == ref[arch]["tokens"]
    if arch in JAX_SERVED:
        assert ref[arch]["tokens"] == ref[arch]["jax_tokens"]


def test_an_expert_gradient_summed_twice_fails_the_grad_norm_check(ref, ranks):
    """At 2x1 FSDP's backward sums each expert leaf's gradient over the
    data axis; summing it there again adds different rows together.  The
    loss hides it at step 0 (the update comes after), the grad norm
    does not."""
    one = ref["grok"]["metrics"]
    for metrics in ranks["summed_twice"]:
        assert abs(metrics[0]["grad_norm"] / one[0]["grad_norm"] - 1) > 1e-3


def test_the_mid_head_split_gathers_every_head():
    """mamba2 with 3 heads at 1x2: ``wx`` and ``wz`` split d_inner (192)
    in mid-head, so every rank runs every head; the decode cache's conv
    state stays split over d_inner, its SSM state whole."""
    from repro_torch.distributed.context import use_mesh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.ssm import _split
    from repro_torch.serving.kv_cache import pool_specs

    cfg = port_cfg("mamba3h")
    mesh = Mesh((1, 2), ("data", "model"))
    with use_mesh(mesh):
        sp = _split(cfg.ssm)
    assert cfg.ssm.n_heads == 3 and not sp.local and sp.conv_split
    seg = pool_specs(cfg, 2, 16, mesh)["segments"][0][0]
    assert "model" in seg["conv"] and "model" not in seg["ssm"]


@pytest.mark.parametrize("specs", ["whole", "rules"])
def test_adafactor_zero1_on_one_rank_is_clip_and_adafactor_bit_for_bit(specs):
    """The one-rank train step takes ``adafactor_update_zero1`` over a mesh
    of one: it must give ``clip_by_global_norm`` + ``adafactor_update``'s
    params, statistics and norm bit for bit, with whole-leaf specs or the
    rules' on a 1x1 mesh (axes of size one named)."""
    from repro_torch.distributed.sharding import P, opt_state_specs, param_specs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm
    from repro_torch.optim import (
        adafactor_init,
        adafactor_update,
        adafactor_update_zero1,
        clip_by_global_norm,
        tree_leaves,
        tree_map,
    )

    cfg = port_cfg("grok")
    params = lm.init_lm(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    mesh = Mesh((1, 1), ("data", "model"))
    if specs == "whole":
        p_specs = tree_map(lambda p: P(*(None,) * p.ndim), params)
        o_specs = {"stats": tree_map(lambda t: P(*(None,) * t.ndim),
                                     adafactor_init(params)["stats"])}
    else:
        p_specs = param_specs(params, mesh)
        o_specs = opt_state_specs(adafactor_init(params), None, mesh)
    want_p, want_s = got_p, got_s = params, adafactor_init(params)
    for _ in range(2):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen) * 3.0, params)
        clipped, want_n = clip_by_global_norm(grads, 1.0)
        want_p, want_s = adafactor_update(clipped, want_s, want_p, 1e-3)
        got_p, got_s, got_n = adafactor_update_zero1(grads, got_s, got_p, 1e-3, p_specs,
                                                     o_specs, mesh, max_grad_norm=1.0)
        assert torch.equal(got_n, want_n)
        for a, b in zip(tree_leaves((got_p, got_s)), tree_leaves((want_p, want_s))):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_no_architecture_is_refused_on_a_mesh_its_rules_admit():
    """The four architectures' train steps build on the production mesh
    and on 2x4 (the rules admit both), on meta tensors."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step

    for name in ("grok-1-314b", "kimi-k2-1t-a32b", "mamba2-2.7b", "zamba2-7b"):
        for dm in ((16, 16), (2, 4)):
            assert callable(make_train_step(get_config(name), mesh=Mesh(dm, ("data", "model"))))

