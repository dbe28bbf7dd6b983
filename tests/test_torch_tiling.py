"""The selector's tile dimension in the port against the JAX package's, on
the CPU.

Config keys, the tile tables folded from one v5 measurement cache, and the
learned tile of one artifact must match the JAX package exactly (where
both packages' feasibility checks admit the tile: the port's are its CUDA
kernels' plans, the JAX package's a VMEM budget).  Every config of every
kernel's space (``repro_torch.kernels.tiling``) must run on the CPU route
and give the plain version's result, and a config outside it must raise
before the plain version runs.  Inputs come from numpy with a seed;
tolerances are ``tests/test_kernels.py::_tol``'s (f32 1e-5*sqrt(k), bf16
2e-2*sqrt(k)) and attention's 1e-4 / 2e-2.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import measure as jmeasure  # noqa: E402
from repro.core import selector as jselector  # noqa: E402
from repro.core.gbdt import GBDTClassifier as JGBDT  # noqa: E402
from repro.kernels import tiling as jtiling  # noqa: E402
from repro_torch.core import measure as pmeasure  # noqa: E402
from repro_torch.core import selector as pselector  # noqa: E402
from repro_torch.core.candidates import get_candidate  # noqa: E402
from repro_torch.core.opkey import OpKey  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.policy import (  # noqa: E402
    AutotunePolicy,
    CascadePolicy,
    FixedPolicy,
    ModelPolicy,
)
from repro_torch.kernels import common, ops, ref, tiling  # noqa: E402
from repro_torch.kernels.attention_fused import MaskParams, attention_fused  # noqa: E402

DT = {2: torch.bfloat16, 4: torch.float32}


def _tol(dsize, k):
    return (dict(rtol=1e-5, atol=1e-5 * max(1.0, k**0.5)) if dsize == 4
            else dict(rtol=2e-2, atol=2e-2 * max(1.0, k**0.5)))


# -- config keys ------------------------------------------------------------------


@pytest.mark.parametrize("config", [None, (128, 128, 128), (8, 128, 576), (64, 64), (1, 2, 3)])
def test_config_key_matches_the_reference(config):
    assert tiling.config_key(config) == jtiling.config_key(config)
    assert common.config_key(config) == jtiling.config_key(config)


@pytest.mark.parametrize("key,arity", [("default", 3), ("128x256x64", 3), ("4x32", 2),
                                       ("8x128x576", 3), ("64x64", 3), ("0x8x8", 3),
                                       ("axbxc", 3), ("8x-1", 2), ("", 2)])
def test_parse_config_key_matches_the_reference(key, arity):
    def outcome(fn):
        try:
            return fn(key, arity=arity)
        except ValueError:
            return "ValueError"

    assert outcome(tiling.parse_config_key) == outcome(jtiling.parse_config_key)


@pytest.mark.parametrize("config,arity", [((128, 128, 128), 3), ((64, 64), 2), ((8, 8), 3),
                                          ((0, 8, 8), 3), ((8, 8, 8.0), 3), ((True, 8, 8), 3),
                                          ((4, 32, 1), 2), ((1, 2, 3, 4), 3)])
def test_validate_config_matches_the_reference(config, arity):
    def outcome(fn):
        try:
            return fn(config, arity=arity)
        except ValueError:
            return "ValueError"

    assert outcome(tiling.validate_config) == outcome(jtiling.validate_config)


@pytest.mark.parametrize("kernel,m,n,k,dsize", [
    ("matmul_tnn_fused", 2048, 1536, 576, 4),  # f32_tiled
    ("matmul_tnn_fused", 1024, 8, 6144, 4),  # f32_skinny, n <= 64
    ("matmul_tnn_fused", 8, 1536, 576, 4),  # f32_skinny, m <= 16
    ("matmul_tnn_fused", 2048, 1536, 576, 2),  # wgmma
    ("attention_fused", 2048, 1024, 256, 4),  # flash_f32, 32-key tile
    ("attention_fused", 768, 256, 64, 4),  # flash_f32
])
def test_new_route_config_keys_match_the_reference(kernel, m, n, k, dsize):
    """Every config of the route's space keeps the JAX package's key form
    (both packages write it and parse it back alike), and a config that
    both packages admit at this shape -- the port's as a plan, the JAX
    package's within its VMEM budget -- is the same tile under both."""
    configs = tiling.enumerate_tile_configs(kernel, m, n, k, dsize)
    arity = 2 if kernel == "attention_fused" else 3
    assert configs
    for cfg in configs:
        key = tiling.config_key(cfg)
        assert key == jtiling.config_key(cfg)
        assert jtiling.parse_config_key(key, arity=arity) == tuple(cfg)
        assert tiling.parse_config_key(jtiling.config_key(cfg), arity=arity) == tuple(cfg)
    theirs = (jtiling.enumerate_attn_configs(m, n, k, dsize) if arity == 2
              else jtiling.enumerate_tile_configs(m, n, k, dsize))
    for cfg in set(configs) & set(map(tuple, theirs)):
        assert tiling.config_feasible(kernel, cfg, m, n, k, dsize)
        assert jtiling.config_key(cfg) == tiling.config_key(cfg)


# -- tile tables from one cache ----------------------------------------------------


def _v5_cache_file(path):
    """A v5 cache of two platforms, two dtypes and three ops; some shapes
    won by an explicit tile, some by "default", ties broken by key."""
    rng = np.random.RandomState(0)
    entries = {}
    tiles = ["128x64x512", "128x256x512", "8x128x192", "64x64x128"]
    for plat in ("gpu", "cpu"):
        for dtype in ("bfloat16", "float32"):
            for op in ("NT", "NN", "TN"):
                for m, n, k in ((128, 256, 512), (1024, 1024, 1024), (8, 4096, 576),
                                (2048, 576, 1536), (512, 512, 512)):
                    times = {"XLA_NT": {"default": float(rng.uniform(1, 2))}}
                    for name in ("PALLAS_TNN", "PALLAS_NT"):
                        times[name] = {"default": float(rng.uniform(1, 2))}
                        for ck in rng.choice(tiles, 2, replace=False):
                            times[name][str(ck)] = float(rng.uniform(0.5, 2.5))
                    entries[f"{plat}|h100|{dtype}|{op}|1|{m}|{n}|{k}"] = times
    path.write_text(json.dumps({"schema_version": 5, "entries": entries}))
    return str(path)


@pytest.mark.parametrize("dtype,platform", [(None, None), ("bfloat16", "gpu"),
                                            ("float32", None), (None, "cpu")])
def test_tile_tables_from_one_cache_match_the_reference(tmp_path, dtype, platform):
    path = _v5_cache_file(tmp_path / "cache.json")
    mine, theirs = (pmeasure.MeasurementCache.load(path), jmeasure.MeasurementCache.load(path))
    got = pmeasure.tile_tables_from_cache(mine, dtype=dtype, platform=platform)
    assert got == jmeasure.tile_tables_from_cache(theirs, dtype=dtype, platform=platform)
    assert got  # the cache has explicit winners
    for op in (None, "NT", "TN"):
        assert (pmeasure.top_configs_by_candidate(mine, dtype=dtype, platform=platform, op=op)
                == jmeasure.top_configs_by_candidate(theirs, dtype=dtype, platform=platform,
                                                     op=op))


# -- the learned tile of an artifact ---------------------------------------------------


TABLES = {
    "NT": {
        "PALLAS_TNN": {"modal": "128x256x512",
                       "by_shape": {"1024x1024x1024": "128x192x512", "512x512x512": "128x64x256",
                                    "2048x576x1536": "128x128x768"}},
        "PALLAS_NT": {"modal": "8x128x192", "by_shape": {"8x4096x576": "8x128x192",
                                                         "4x576x1536": "8x128x512"}},
        "XLA_NT": {"modal": "64x64x64", "by_shape": {}},
    },
    "NN": {"PALLAS_NN": {"modal": "bogus", "by_shape": {"300x300x300": "128x64x128"}}},
}

PROBES = [(name, op, mnk, dsize) for dsize in (2, 4) for name, op in
          (("PALLAS_TNN", "NT"), ("PALLAS_NT", "NT"), ("XLA_NT", "NT"), ("PALLAS_NN", "NN"))
          for mnk in ((1024, 1024, 1024), (512, 512, 512), (1000, 1100, 900), (8, 4096, 576),
                      (4, 576, 1536), (6, 4000, 600), (300, 300, 300), (128, 96, 64), None)]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    clf = JGBDT(n_estimators=2, max_depth=2).fit(np.eye(10), np.array([1, -1] * 5))
    path = str(tmp_path_factory.mktemp("artifact") / "sel.json")
    jselector.MTNNSelector(clf, tile_tables=TABLES).save(path)
    return path


def test_tile_config_for_matches_the_reference_where_both_admit_the_tile(artifact):
    mine = pselector.MTNNSelector.load(artifact)
    theirs = jselector.MTNNSelector.load(artifact)
    agreed = 0
    for name, op, mnk, dsize in PROBES:
        got = mine.tile_config_for(name, dsize, op=op, mnk=mnk)
        want = theirs.tile_config_for(name, dsize, op=op, mnk=mnk)
        if got is not None and want is not None:
            assert tuple(got) == tuple(want), (name, op, mnk, dsize)
            agreed += 1
        if got is not None and mnk is not None:  # the port's tile is a plan at this shape
            assert get_candidate(name).supports(config=got, shape=(1, *mnk, dsize))
    assert agreed >= 6
    # an exact entry the port's wrapper has a plan for, at bf16: chosen
    assert mine.tile_config_for("PALLAS_TNN", 2, op="NT", mnk=(1024, 1024, 1024)) == (128, 192,
                                                                                      512)
    # the same tile at f32 names no plan of the FMA route: the wrapper's own plan
    assert mine.tile_config_for("PALLAS_TNN", 4, op="NT", mnk=(1024, 1024, 1024)) is None
    # the nearest recorded shape's tile where that is a plan here
    assert mine.tile_config_for("PALLAS_TNN", 2, op="NT", mnk=(1000, 1104, 904)) == (128, 192,
                                                                                     512)
    # a non-tunable candidate and a malformed modal key choose nothing
    assert mine.tile_config_for("XLA_NT", 2, op="NT", mnk=(64, 64, 64)) is None
    assert mine.tile_config_for("PALLAS_NN", 2, op="NN", mnk=(64, 64, 64)) is None


def test_model_policy_dispatches_the_tuned_tile_and_memoises_it(artifact):
    sel = pselector.MTNNSelector.load(artifact)
    sel.select = lambda key: "PALLAS_TNN"  # the tile, not the classifier, is on test
    policy = ModelPolicy(sel)
    key = OpKey("NT", 1024, 1024, 1024, 2)
    decision = policy.select(key)
    assert decision.config == (128, 192, 512) and decision.label() == "PALLAS_TNN@128x192x512"
    assert policy.select(key) == decision
    assert policy.select(OpKey("NT", 1024, 1024, 1024, 4)).config is None
    # the tile reaches the kernel: the plain route checks it and agrees
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(torch.bfloat16)
            for s in ((1024, 1024), (1024, 1024)))
    with engine.use_policy(policy):
        out = engine.dispatch("NT", a, b)
    torch.testing.assert_close(out.float(), ref.matmul_nt(a, b).float(), **_tol(2, 1024))
    # an operand at an offset takes the NN kernel's FMA route, which has no
    # plan at the tuned tile: the policy runs the candidate's own plan
    off = torch.cat([a.reshape(-1)[:1], a.reshape(-1)])[1:].view(1024, 1024)
    assert off.data_ptr() % 16 and torch.equal(off, a)
    with engine.use_policy(policy):
        out = engine.dispatch("NT", off, b)
    torch.testing.assert_close(out.float(), ref.matmul_nt(a, b).float(), **_tol(2, 1024))


def _offset_view(x):
    """``x``'s values in a view one element into a larger buffer: not
    16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16
    return view


@pytest.mark.parametrize("op,a_shape,b_shape,dsize", [("NN", (256, 128), (128, 256), 2),
                                                      ("BNT", (2, 40, 64), (2, 24, 64), 4)])
def test_tuned_tiles_give_way_to_operands_at_an_offset(op, a_shape, b_shape, dsize):
    """A cascade's tile names a plan of aligned operands' route; operands at
    an offset take the FMA route, where the tile has no plan, so the policy
    runs the candidate's own plan.  A fixed policy's tile is the caller's:
    the wrapper raises."""
    rng = np.random.RandomState(6)
    a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(DT[dsize])
            for s in (a_shape, b_shape))
    name, kernel = ("PALLAS_NN", "matmul_nn") if op == "NN" else ("PALLAS_BNT", "matmul_bnt")
    k = a_shape[-1]
    g, m, n = (1, a_shape[0], b_shape[1]) if op == "NN" else (a_shape[0], a_shape[1], b_shape[1])
    tile = tiling.shortlist_tile_configs(kernel, m, n, k, dsize, g, max_configs=1)[0]
    assert not tiling.config_feasible(kernel, tile, m, n, k, dsize, g, aligned=False)
    a_off, b_off = _offset_view(a), _offset_view(b)
    want = (ref.matmul_nn(a, b) if op == "NN" else ref.matmul_bnt(a, b)).float()
    run = (lambda x, y: engine.dispatch("NN", x, y)) if op == "NN" else (
        lambda x, y: engine.dispatch_batched("BNT", x, y))
    cascade = CascadePolicy([f"{name}@{tiling.config_key(tile)}"])
    with engine.use_policy(cascade):
        torch.testing.assert_close(run(a, b).float(), want, **_tol(dsize, k))
        torch.testing.assert_close(run(a_off, b_off).float(), want, **_tol(dsize, k))
    with engine.use_policy(FixedPolicy(name, config=tile)):
        torch.testing.assert_close(run(a, b).float(), want, **_tol(dsize, k))
        with pytest.raises(ValueError, match="fma route, has no plan"):
            run(a_off, b_off)


# -- every config of every space on the CPU route -----------------------------------------


GEMM_CELLS = {  # kernel: (g, m, n, k) on each route of both dtypes
    "matmul_nt": ((1, 4, 96, 200), (1, 33, 40, 64), (1, 70, 24, 130)),
    "matmul_nn": ((1, 4, 96, 200), (1, 130, 72, 136), (1, 65, 37, 40)),
    "matmul_tnn_fused": ((1, 130, 72, 136), (1, 65, 37, 30)),
    "matmul_bnt": ((3, 20, 24, 80), (2, 5, 9, 7)),
    "matmul_bnn": ((3, 20, 24, 80), (2, 5, 9, 7)),
}


def _gemm_call(kernel, g, m, n, k, dt, rng):
    a_shape = (g, m, k) if kernel in ("matmul_bnt", "matmul_bnn") else (m, k)
    b_shape = {"matmul_nn": (k, n), "matmul_bnt": (g, n, k), "matmul_bnn": (g, k, n)}.get(
        kernel, (n, k))
    a, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dt) for s in (a_shape, b_shape))
    fn = {"matmul_nt": ops.matmul_nt, "matmul_nn": ops.matmul_nn,
          "matmul_tnn_fused": ops.matmul_tnn_fused, "matmul_bnt": ops.matmul_bnt,
          "matmul_bnn": ops.matmul_bnn}[kernel]
    plain = {"matmul_nt": ref.matmul_nt, "matmul_nn": ref.matmul_nn,
             "matmul_tnn_fused": ref.matmul_tnn_fused, "matmul_bnt": ref.matmul_bnt,
             "matmul_bnn": ref.matmul_bnn}[kernel]
    return fn, a, b, plain(a, b)


@pytest.mark.parametrize("dsize", [2, 4])
@pytest.mark.parametrize("kernel", sorted(GEMM_CELLS))
def test_every_gemm_config_runs_on_the_cpu_route(kernel, dsize):
    rng = np.random.RandomState(1)
    for g, m, n, k in GEMM_CELLS[kernel]:
        fn, a, b, want = _gemm_call(kernel, g, m, n, k, DT[dsize], rng)
        configs = tiling.enumerate_tile_configs(kernel, m, n, k, dsize, g)
        dflt = tiling.default_config(kernel, m, n, k, dsize, g)
        assert dflt in configs
        short = tiling.shortlist_tile_configs(kernel, m, n, k, dsize, g, max_configs=0)
        assert set(short) == set(configs) - {dflt}
        for cfg in configs:
            assert tiling.config_feasible(kernel, cfg, m, n, k, dsize, g)
            torch.testing.assert_close(fn(a, b, block=cfg).float(), want.float(),
                                       **_tol(dsize, k))


@pytest.mark.parametrize("dsize", [2, 4])
@pytest.mark.parametrize("kernel", sorted(GEMM_CELLS))
def test_configs_outside_a_space_raise_on_the_cpu_route(kernel, dsize):
    rng = np.random.RandomState(2)
    for g, m, n, k in GEMM_CELLS[kernel]:
        fn, a, b, _ = _gemm_call(kernel, g, m, n, k, DT[dsize], rng)
        configs = tiling.enumerate_tile_configs(kernel, m, n, k, dsize, g)
        bad = [(128, 128, 128), (64, 64, 48), (16, 16, 16), (8, 128, 100),
               (128, 96, 64), (64, 64, 4096), (128, 64, 64 * 64)]
        for cfg in bad:
            if tiling.config_feasible(kernel, cfg, m, n, k, dsize, g):
                continue  # a plan of this route after all
            with pytest.raises(ValueError):
                fn(a, b, block=cfg)
        assert all(c not in configs for c in bad
                   if not tiling.config_feasible(kernel, c, m, n, k, dsize, g))


def test_configs_name_one_route_only():
    """A wgmma tile at an m the skinny kernel owns, a split of a k that
    leaves a split empty, a width with no instance, an f32 tile of another
    route or a split off the route's list: rejected."""
    a = torch.zeros(8, 576, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"skinny route, has no plan for tile \(128, 64, 576\)"):
        ops.matmul_nn(a, torch.zeros(576, 96, dtype=torch.bfloat16), block=(128, 64, 576))
    with pytest.raises(ValueError, match=r"mma route, has no plan for tile \(8, 128, 640\)"):
        ops.matmul_nt(a, torch.zeros(96, 576, dtype=torch.bfloat16), block=(8, 128, 640))
    big = torch.zeros(256, 576, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"wgmma route, has no plan for tile \(128, 96, 576\)"):
        ops.matmul_nn(big, torch.zeros(576, 96, dtype=torch.bfloat16), block=(128, 96, 576))
    with pytest.raises(ValueError, match=r"fma route, has no plan for tile \(128, 64, 576\)"):
        ops.matmul_nn(torch.zeros(256, 575), torch.zeros(575, 96), block=(128, 64, 576))
    # f32: gemm_f32's tiled and skinny tiles name their own route
    with pytest.raises(ValueError, match=r"tiled route, has no plan for tile \(128, 64, 576\)"):
        ops.matmul_nn(big.float(), torch.zeros(576, 96), block=(128, 64, 576))
    with pytest.raises(ValueError, match=r"tiled route, has no plan for tile \(16, 128, 576\)"):
        ops.matmul_nt(big.float(), torch.zeros(96, 576), block=(16, 128, 576))
    with pytest.raises(ValueError, match=r"skinny route, has no plan for tile \(128, 128, 576\)"):
        ops.matmul_nt(a.float(), torch.zeros(96, 576), block=(128, 128, 576))
    with pytest.raises(ValueError, match=r"skinny route, has no plan for tile \(16, 128, 64\)"):
        ops.matmul_nn(a.float(), torch.zeros(576, 96), block=(16, 128, 64))  # 9 splits: not listed
    # the tiled batched kernel's splits stay within gridDim.z
    with pytest.raises(ValueError, match=r"tiled route, has no plan for tile \(64, 64, 16\)"):
        ops.matmul_bnt(torch.zeros(40000, 2, 32), torch.zeros(40000, 2, 32), block=(64, 64, 16))


@pytest.mark.parametrize("dsize", [2, 4])
@pytest.mark.parametrize("g,m,n,dh,kw", [(3, 3, 200, 16, {}), (2, 9, 70, 64, {}),
                                         (2, 40, 50, 64, dict(causal=True)),
                                         (2, 40, 50, 24, dict(causal=True))])
def test_every_attention_config_runs_on_the_cpu_route(g, m, n, dh, kw, dsize):
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(g, s, dh).astype(np.float32) * 0.3).to(DT[dsize])
               for s in (m, n, n))
    lengths = torch.from_numpy(rng.randint(1, n + 1, (g,)).astype(np.int32))
    mask = MaskParams(**kw)
    want = ref.attention_fused(q, k, v, lengths, mask)
    configs = tiling.enumerate_tile_configs("attention_fused", m, n, dh, dsize, g)
    assert tiling.default_config("attention_fused", m, n, dh, dsize, g) in configs
    rtol = 1e-4 if dsize == 4 else 2e-2
    for cfg in configs:
        out = attention_fused(q, k, v, lengths, mask=mask, block=cfg)
        torch.testing.assert_close(out.float(), want.float(), rtol=rtol, atol=rtol)
    for cfg in ((128, 128), (16, 48), (4, 24), (4, 10_000), (64, 32)):
        if cfg not in configs and not tiling.config_feasible("attention_fused", cfg, m, n, dh,
                                                             dsize, g):
            with pytest.raises(ValueError):
                attention_fused(q, k, v, lengths, mask=mask, block=cfg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_transpose_instances_on_the_cpu_route(dtype):
    b = torch.from_numpy(np.random.RandomState(4).randn(65, 33).astype(np.float32)).to(dtype)
    space = tiling.transpose_config_space(65, 33, b.element_size())
    assert set(space) == set(tiling.TRANSPOSE_INSTANCES)
    for block in tiling.TRANSPOSE_INSTANCES:
        assert torch.equal(ops.transpose(b, block=block), b.t().contiguous())
    for block in ((16, 16), (128, 128), (32, 48)):
        with pytest.raises(ValueError, match="instances"):
            ops.transpose(b, block=block)
    # the two-kernel schedules pass their transpose tile through
    a = torch.from_numpy(np.random.RandomState(5).randn(7, 33).astype(np.float32)).to(dtype)
    tol = _tol(b.element_size(), 33)
    torch.testing.assert_close(ops.matmul_tnn(a, b, tblock=(64, 32)).float(),
                               ref.matmul_nt(a, b).float(), **tol)
    with pytest.raises(ValueError, match="instances"):
        ops.matmul_tn(b, b, tblock=(8, 8))


# -- measurement with tiles, and the policies that use it --------------------------------


def test_measure_candidates_tunes_default_plus_the_shortlist():
    times = pmeasure.measure_candidates(128, 128, 128, dtype="bfloat16", op="NN",
                                        device="cpu", reps=1)
    cand = get_candidate("PALLAS_NN")
    short = cand.config_space(128, 128, 128, 2, max_configs=4,
                              hardware=pmeasure.device_spec("cpu"))
    assert short and len(short) <= 4
    assert set(times["PALLAS_NN"]) == {"default"} | {tiling.config_key(c) for c in short}
    assert set(times["XLA_NN"]) == {"default"}
    untuned = pmeasure.measure_candidates(128, 128, 128, dtype="bfloat16", op="NN",
                                          device="cpu", reps=1, tune=False)
    assert all(set(cfgs) == {"default"} for cfgs in untuned.values())
    attn = pmeasure.measure_candidates(3, 200, 16, dtype="float32", op="ATTN", g=2,
                                       device="cpu", reps=1, max_tile_configs=2)
    assert len(attn["FUSED_ATTN"]) == 3 and "default" in attn["FUSED_ATTN"]


def test_measure_transpose_configs_times_every_instance():
    times = pmeasure.measure_transpose_configs(96, 40, device="cpu", reps=1)
    assert set(times) == {"default"} | {tiling.config_key(c) for c in tiling.TRANSPOSE_INSTANCES}
    best = pmeasure.best_transpose_config(96, 40, device="cpu", reps=1)
    assert best is None or best in tiling.TRANSPOSE_INSTANCES


def test_autotune_dispatches_the_fastest_measured_config(tmp_path):
    policy = AutotunePolicy(cache_path=str(tmp_path / "c.json"), device="cpu", reps=1,
                            candidates=("XLA_NN", "PALLAS_NN"))
    key = OpKey("NN", 128, 128, 128, 2)
    decision = policy.select(key)
    times = policy.cache.get(("cpu", policy.hardware.name, "bfloat16", "NN", 1, 128, 128, 128))
    best = min(((t, name, ck) for name, cfgs in times.items() for ck, t in cfgs.items()))
    assert (decision.name, tiling.config_key(decision.config)) == best[1:]
    assert policy.n_measured == 1 and policy.select(key) == decision
    # a cached tile the kernel has no plan for never dispatches
    policy2 = AutotunePolicy(cache_path=str(tmp_path / "d.json"), device="cpu",
                             candidates=("XLA_NN", "PALLAS_NN"))
    policy2.cache.put(("cpu", policy2.hardware.name, "bfloat16", "NN", 1, 128, 128, 128),
                      {"PALLAS_NN": {"16x16x16": 1e-9, "default": 2.0}, "XLA_NN": {"default": 1.0}})
    assert policy2.select(key).name == "XLA_NN" and policy2.n_measured == 0


def test_cascade_entries_carry_their_tile_where_it_is_a_plan():
    policy = CascadePolicy(["PALLAS_NN@128x64x128", "XLA_NN"])
    assert policy.select(OpKey("NN", 256, 256, 128, 2)) == ("PALLAS_NN", (128, 64, 128))
    assert policy.select(OpKey("NN", 8, 256, 128, 2)).name == "XLA_NN"  # skinny route
    assert policy.select(OpKey("NN", 256, 256, 128, 4)).name == "XLA_NN"  # FMA route
    with pytest.raises(ValueError):
        CascadePolicy(["XLA_NN@128x64x128"])
