"""The JAX package's ``optimized`` variant on gloo ranks on the CPU:
sequence-parallel attention (``AttnConfig.sp_attention``) and the sharded
gradient accumulators (``TrainStepConfig(zero1_grads=True)``), against
the port's one-rank runs, the same runs without them and the JAX
package.

Ranks are spawned as in ``tests/test_torch_distributed.py`` (whose
helpers, step and bounds this file takes): one spawn of two ranks and
one of four carry every run, and a process of one rank computes the
port's references meanwhile.  Weights are the port's seeded ones, which
the JAX package runs as they are.

  * ``sp_attention`` with smollm's 3:1 heads cut to 3 and 1 (neither
    divides ``model``), a sequence of two 16-row chunks, at 1x2, 2x2 and
    1x4, at ``MIN_MODEL_DIM`` 0 (the projections split over ``model``:
    the queries cut to this rank's rows after the head-boundary gather)
    and 1024 (every projection whole: each rank projects its own rows
    and gathers the keys and values over the sequence); gemma3 with the
    same heads (window 8, QK-norm) at 1x2 and 2x2 at both; and a
    single 18-row chunk at 1x4, which does not divide 4 and runs
    replicated.  Losses and grad norms within 1e-5 of one rank's, f32
    params after two AdamW steps within ``_tol``, step-0 loss within
    1e-3 of the JAX package's with ``sp_attention`` on (which off a mesh
    computes the plain function);
  * the prefill logits and caches at 1x2 and 1x4 are one rank's, and a
    1x2 ``ServeEngine``'s greedy tokens are one rank's;
  * ``zero1_grads`` at 2x1 and 2x2, accum 2: gemma3 with AdamW and grok-1
    with Adafactor equal the same runs without it (losses and grad norms
    within 1e-5, params within ``_tol``; grok's router rows of experts no
    token chose left out, as ``tests/test_torch_mesh_moe_ssm.py`` does);
    each accumulator is its ZeRO-1 piece: 1/data of the param piece
    along its ZeRO-1 dim, the param piece elsewhere;
  * the harness's two negative cases: keys and values gathered with a
    backward that slices (``gather_from_group``) in place of one that
    reduce-scatters, and zero1 accumulators summed over the data axes a
    second time, each move the grad norm off one rank's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import (  # noqa: E402
    KERNEL,
    STEP_KW,
    _finish,
    _full,
    _join,
    _leaves,
    _np_tree,
    _params,
    _start,
    _start_ranks,
    _tol,
    kept_rows,
    serve_tokens,
)

B = 4
CASES = {  # key: (architecture, changes to its smoke config, sequence length)
    "smollm31": ("smollm-135m", {"n_heads": 3, "n_kv": 1}, 32),
    "gemma31": ("gemma3-4b", {"n_heads": 3, "n_kv": 1}, 32),
    "odd": ("smollm-135m", {"n_heads": 3, "n_kv": 1}, 18),  # one chunk of 18
    "gemma3": ("gemma3-4b", {}, 16),
    "grok": ("grok-1-314b", {"optimizer": "adafactor"}, 16),
}
SP = ("smollm31", "gemma31", "odd")
ZERO1 = ("gemma3", "grok")
MIN_DIMS = (0, 1024)
SP_TWO = {"smollm31": ((1, 2),), "gemma31": ((1, 2),)}
SP_FOUR = {"smollm31": ((2, 2), (1, 4)), "gemma31": ((2, 2),), "odd": ((1, 4),)}
ZERO1_TWO, ZERO1_FOUR = ((2, 1),), ((2, 2),)
PREFILL = {"smollm31": ((1, 2), (1, 4)), "gemma31": ((1, 2),)}  # (world 2, world 4) meshes
MAX_SEQ = 48


def _cfg(smoke_config, key, sp=False):
    name, over, _ = CASES[key]
    cfg = smoke_config(name).replace(**over)
    return cfg.replace(sp_attention=True) if sp else cfg


def port_cfg(key, sp=False):
    from repro_torch.configs import smoke_config

    return _cfg(smoke_config, key, sp)


def batches(cfg, key):
    from repro_torch.data import make_train_batch

    seq = CASES[key][2]
    return [{k: torch.from_numpy(v).long() for k, v in make_train_batch(cfg, seq, B, i).items()}
            for i in range(STEP_KW["total_steps"])]


def train_run(cfg, key, params, mesh, zero1=False):
    """``tests/test_torch_distributed.py::train_run`` at ``key``'s sequence
    length; returns (metrics, full params as numpy)."""
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.distributed.sharding import batch_specs, param_specs, shard
    from repro_torch.launch.steps import TrainStepConfig, init_train_state, make_train_step

    if mesh is not None:
        params = shard(params, param_specs(params, mesh), mesh)
    state = init_train_state(cfg, params, mesh)
    step = make_train_step(cfg, TrainStepConfig(**STEP_KW, zero1_grads=zero1),
                           policy=policy_from_spec(KERNEL), mesh=mesh)
    metrics = []
    for b in batches(cfg, key):
        if mesh is not None:
            b = shard(b, batch_specs(b, mesh), mesh)
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    full = _full(cfg, state, mesh) if mesh is not None else state["params"]
    return metrics, _np_tree(full)


def prefill(cfg, key, params, mesh):
    """``make_prefill_step``'s logits and f32 cache of step 0's tokens,
    the cache gathered whole."""
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.distributed.sharding import param_specs, shard, unshard
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.serving.kv_cache import pool_specs

    tokens = batches(cfg, key)[0]["tokens"]
    if mesh is not None:
        params = shard(params, param_specs(params, mesh), mesh)
    step = make_prefill_step(cfg, MAX_SEQ, policy=policy_from_spec(KERNEL),
                             cache_dtype=torch.float32, mesh=mesh)
    logits, cache = step(params, {"tokens": tokens})
    if mesh is not None:
        cache = unshard(cache, pool_specs(cfg, B, MAX_SEQ, mesh), mesh)
    return {"logits": _np_tree(logits), "cache": _np_tree(cache)}


def _sp_runs(job, meshes):
    from repro_torch.distributed.sharding import min_model_dim
    from repro_torch.launch.mesh import make_local_mesh

    out = {}
    for key, dms in meshes.items():
        cfg = port_cfg(key, sp=True)
        params = _params(cfg, job[key])
        for dm in dms:
            for n in MIN_DIMS:
                with min_model_dim(n):
                    out[(key, dm, n)] = train_run(cfg, key, params, make_local_mesh(*dm))
    return out


def _zero1_runs(job, meshes):
    from repro_torch.launch.mesh import make_local_mesh

    out = {}
    for key in ZERO1:
        cfg = port_cfg(key)
        params = _params(cfg, job[key])
        for dm in meshes:
            for zero1 in (False, True):
                out[(key, dm, zero1)] = train_run(cfg, key, params, make_local_mesh(*dm), zero1)
    return out


def _prefills(job, meshes):
    from repro_torch.distributed.sharding import min_model_dim
    from repro_torch.launch.mesh import make_local_mesh

    out = {}
    for key, dm in meshes:
        cfg = port_cfg(key, sp=True)
        for n in MIN_DIMS:
            with min_model_dim(n):
                out[("prefill", key, dm, n)] = prefill(cfg, key, _params(cfg, job[key]),
                                                       make_local_mesh(*dm))
    return out


def two_ranks(rank, world, tmp):
    from repro_torch.distributed import collectives, sharding
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import attention

    job = _start(rank, world, tmp)
    out = _sp_runs(job, SP_TWO)
    out.update(_zero1_runs(job, ZERO1_TWO))
    out.update(_prefills(job, [(k, dms[0]) for k, dms in PREFILL.items()]))
    cfg = port_cfg("smollm31", sp=True)
    with sharding.min_model_dim(1024):
        out["tokens"] = serve_tokens(cfg, _params(cfg, job["smollm31"]), make_local_mesh(1, 2))

        # negative case 1: the keys and values gathered with a backward that
        # slices the gradient, as if every rank's were the same
        gather = attention.gather_seq
        attention.gather_seq = collectives.gather_from_group
        try:
            out["sliced_kv"] = train_run(cfg, "smollm31", _params(cfg, job["smollm31"]),
                                         make_local_mesh(1, 2))[0]
        finally:
            attention.gather_seq = gather

    # negative case 2: the zero1 accumulators summed over the data axes again
    make = steps.make_zero1_update

    def twice(name, **kw):
        update = make(name, **kw)

        def summed_again(grads, *a, reduced=False, **k):
            if reduced:
                grads = steps.tree_map(lambda g: collectives.all_reduce(g, ("data",)), grads)
            return update(grads, *a, reduced=reduced, **k)

        return summed_again

    steps.make_zero1_update = twice
    try:
        cfg = port_cfg("gemma3")
        out["summed_twice"] = train_run(cfg, "gemma3", _params(cfg, job["gemma3"]),
                                        make_local_mesh(2, 1), zero1=True)[0]
    finally:
        steps.make_zero1_update = make
    _finish(rank, tmp, out)


def four_ranks(rank, world, tmp):
    job = _start(rank, world, tmp)
    out = _sp_runs(job, SP_FOUR)
    out.update(_zero1_runs(job, ZERO1_FOUR))
    out.update(_prefills(job, [(k, dms[1]) for k, dms in PREFILL.items() if len(dms) > 1]))
    _finish(rank, tmp, out)


def one_rank(rank, world, tmp):
    """The port's one-rank references: every train run, the prefills, the
    served tokens, and the entries of grok's leaves that are not rounding
    noise (its sequence is ``tests/test_torch_distributed.py``'s)."""
    job = _start(rank, world, tmp)
    out = {}
    for key in CASES:
        cfg = port_cfg(key, sp=key in SP)
        params = _params(cfg, job[key])
        out[key] = train_run(cfg, key, params, None)
        if key in PREFILL:
            out[("prefill", key)] = prefill(cfg, key, params, None)
    cfg = port_cfg("smollm31", sp=True)
    out["tokens"] = serve_tokens(cfg, _params(cfg, job["smollm31"]), None)
    cfg = port_cfg("grok")
    out["grok_keep"] = kept_rows(cfg, _params(cfg, job["grok"]))
    _finish(rank, tmp, out)


# -- the references, in this process, while the ranks run --------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's seeded weights; the two- and four-rank runs and the
    one-rank references, each in processes of their own; while they run,
    the JAX package's step-0 losses with ``sp_attention`` on."""
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

    jax_loss = {}
    with jengine.use_policy(jengine.policy_from_spec("fixed:XLA_NT")):
        for key in SP:
            jcfg, jparams = _cfg(j_smoke_config, key, sp=True), jax.tree.map(jnp.asarray,
                                                                            trees[key])
            batch = {k: jnp.asarray(v.numpy()) for k, v in batches(port_cfg(key), key)[0].items()}
            jax_loss[key] = float(jax.jit(lambda p, b, c=jcfg: jlm.lm_loss(p, c, b)[0])(
                jparams, batch))
    two, four, (one,) = (_join(ctx, world, d)
                         for ctx, world, d in zip(spawned, (2, 4, 1), dirs))
    return jax_loss, two, four, one


@pytest.fixture(scope="module")
def ranks(runs):
    """{run key: every rank's record of that run}."""
    out = {}
    for world in runs[1:3]:
        for r in world:
            for k, v in r.items():
                out.setdefault(k, []).append(v)
    return out


@pytest.fixture(scope="module")
def one(runs):
    return runs[3]


def _same_run(key, got, want, keep=None):
    """Losses and grad norms within 1e-5, f32 params within ``_tol`` at the
    longest contraction a weight gradient sums (B*S tokens); ``keep``: per
    leaf, the entries to compare."""
    (gm, gp), (wm, wp) = got, want
    assert len(gm) == len(wm)
    for m, w in zip(gm, wm):
        np.testing.assert_allclose(m["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], w["grad_norm"], rtol=1e-5)
    tol = _tol(B * CASES[key][2])
    keep = keep or [np.ones(np.shape(x), bool) for x in _leaves(wp)]
    for a, b, k in zip(_leaves(gp), _leaves(wp), keep):
        np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol)


SP_RUNS = [(k, dm, n) for meshes in (SP_TWO, SP_FOUR) for k, dms in meshes.items()
           for dm in dms for n in MIN_DIMS]


@pytest.mark.parametrize("key,dm,n", SP_RUNS,
                         ids=[f"{k}-{d}x{m}-min{n}" for k, (d, m), n in SP_RUNS])
def test_sp_attention_run_matches_one_rank_and_jax(runs, ranks, one, key, dm, n):
    jax_loss = runs[0][key]
    for run in ranks[(key, dm, n)]:
        assert abs(run[0][0]["loss"] - jax_loss) <= 1e-3
        _same_run(key, run, one[key])


PREFILL_RUNS = [(k, dm, n) for k, dms in PREFILL.items() for dm in dms for n in MIN_DIMS]


@pytest.mark.parametrize("key,dm,n", PREFILL_RUNS,
                         ids=[f"{k}-{d}x{m}-min{n}" for k, (d, m), n in PREFILL_RUNS])
def test_sp_attention_prefill_gives_one_ranks_logits_and_caches(ranks, one, key, dm, n):
    want = one[("prefill", key)]
    for got in ranks[("prefill", key, dm, n)]:
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=1e-5, atol=1e-5)
        for a, b in zip(_leaves(got["cache"]), _leaves(want["cache"])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_sp_attention_engine_serves_one_ranks_tokens(ranks, one):
    for tokens in ranks["tokens"]:
        assert tokens == one["tokens"]


def test_sp_attention_takes_its_path_where_the_chunk_divides():
    """smollm31's 16-row chunks split over 2 and 4 (each rank attends 8 or
    4 rows of each); the 18-row chunk does not split over 4, so that layer
    runs replicated; heads that divide ``model`` keep the head split."""
    from repro_torch.distributed.context import use_mesh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import attention as A
    from repro_torch.models.blocks import _attn_cfg

    for key, m, want in (("smollm31", 2, True), ("smollm31", 4, True), ("odd", 4, False)):
        cfg = port_cfg(key, sp=True)
        acfg = _attn_cfg(cfg.segments[0][1][0], cfg)
        chunk = min(acfg.chunk, CASES[key][2])
        chunk = chunk if CASES[key][2] % chunk == 0 else CASES[key][2]
        with use_mesh(Mesh((1, m), ("data", "model"))):
            sp = A._split(acfg)
            assert acfg.sp_attention and not sp.local
            assert (chunk % sp.m == 0) == want, key
    acfg = _attn_cfg(port_cfg("gemma3", sp=True).segments[0][1][0], port_cfg("gemma3", sp=True))
    with use_mesh(Mesh((1, 2), ("data", "model"))):
        assert A._split(acfg).local  # 4 heads, 2 kv heads over 2


ZERO1_RUNS = [(k, dm) for k in ZERO1 for dm in ZERO1_TWO + ZERO1_FOUR]


@pytest.mark.parametrize("key,dm", ZERO1_RUNS, ids=[f"{k}-{d}x{m}" for k, (d, m) in ZERO1_RUNS])
def test_zero1_grads_equals_the_run_without_it(ranks, one, key, dm):
    keep = one["grok_keep"] if key == "grok" else None
    for plain, sharded in zip(ranks[(key, dm, False)], ranks[(key, dm, True)]):
        _same_run(key, sharded, plain, keep)


@pytest.mark.parametrize("key,dm", ZERO1_RUNS, ids=[f"{k}-{d}x{m}" for k, (d, m) in ZERO1_RUNS])
def test_zero1_accumulators_are_the_zero1_pieces(key, dm):
    """Each accumulator has the local shape of ``opt_state_specs(f32
    grads, None, mesh, zero1=True)``: 1/data of the param piece along its
    ZeRO-1 dim, the param piece where there is none (FSDP's experts, a
    leaf no dim of which divides)."""
    from repro_torch.distributed.sharding import (
        local_shape,
        map_with_path,
        opt_state_specs,
        param_specs,
        shard,
    )
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import grad_accumulators
    from repro_torch.models import lm

    cfg = port_cfg(key)
    mesh = Mesh(dm, ("data", "model"))
    full = lm.init_lm(0, cfg, device="meta")
    p_specs = param_specs(full, mesh)
    pieces = shard(full, p_specs, mesh)
    g_specs = opt_state_specs(full, None, mesh, zero1=True)
    plain = grad_accumulators(pieces, p_specs, mesh, False)
    acc = grad_accumulators(pieces, p_specs, mesh, True)
    cut = []

    def check(_, t, a, p, g, ps, gs):
        assert tuple(a.shape) == local_shape(t.shape, gs, mesh) and a.dtype == torch.float32
        assert tuple(p.shape) == local_shape(t.shape, ps, mesh)
        if ps != gs:
            cut.append(a.numel() * dm[0] == p.numel())

    map_with_path(check, full, acc, plain, g_specs, p_specs, g_specs)
    assert cut and all(cut)


def test_kv_gathered_with_a_slicing_backward_fails_the_gradient_check(ranks, one):
    """Each rank's queries use every key differently, so the keys'
    gradients differ from rank to rank: slicing this rank's rows of its
    own (``gather_from_group``'s backward) drops the other ranks' share.
    The step-0 loss comes before the backward and holds; the grad norm
    does not."""
    want = one["smollm31"][0][0]
    for metrics in ranks["sliced_kv"]:
        assert abs(metrics[0]["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert abs(metrics[0]["grad_norm"] / want["grad_norm"] - 1) > 1e-3


def test_a_reduced_piece_reduced_twice_fails_the_grad_norm_check(ranks, one):
    """zero1's accumulators hold this rank's piece of the data sum; summing
    them over the data axes again adds the other rank's piece (a different
    slice) into it."""
    want = one["gemma3"][0][0]
    for metrics in ranks["summed_twice"]:
        assert abs(metrics[0]["grad_norm"] / want["grad_norm"] - 1) > 1e-3


def test_sp_attention_off_a_mesh_changes_nothing():
    """Without a mesh, and at ``model`` 1, ``sp_attention`` is the plain
    layer, bit for bit."""
    from repro_torch.distributed.context import use_mesh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm

    cfg = port_cfg("gemma31")
    params = lm.init_lm(0, cfg, device="cpu")
    batch = batches(cfg, "gemma31")[0]
    want = lm.lm_loss(params, cfg, batch)[0]
    for mesh in (None, Mesh((1, 1), ("data", "model"))):
        with use_mesh(mesh):
            got = lm.lm_loss(params, dataclasses.replace(cfg, sp_attention=True), batch)[0]
        assert torch.equal(got, want)
