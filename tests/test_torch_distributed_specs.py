"""The port's distribution bookkeeping against the JAX package's, exactly,
with no devices and no process group.

The reference's sharding rules read only ``mesh.shape`` and
``mesh.axis_names``, so an object with those two attributes gives its
specs over ``repro.launch.steps.train_state_shapes(cfg)`` (abstract
shapes); the port's rules run over its own meta-tensor trees.  Compared
for all ten architectures at full config on the 16x16, 2x16x16 and 2x4
meshes: the param and optimizer-state (ZeRO-1) specs, the batch specs of
every shape cell, and the decode-cache specs; specs compare as tuples,
keyed by tree path.  Also exactly: ``param_count`` and
``active_param_count``, ``SHAPES``, ``cell_applicable``, the inputs'
shapes and dtypes, ``model_flops_for_cell`` for all 40 (arch, shape)
pairs, ``parse_mesh``'s messages, int8 quantisation (bit for bit, on a
padded tail and exact .5 ties) and the collective byte conventions
(against ``parse_collectives`` on one synthetic HLO line per kind and
group size).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, SHAPES, cache_specs, cell_applicable, input_specs  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    P,
    batch_specs,
    cache_specs_tree,
    local_shape,
    map_with_path,
    param_specs,
    shard,
)
from repro_torch.launch.common import parse_mesh  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.roofline import model_flops_for_cell  # noqa: E402
from repro_torch.launch.steps import train_state_shapes, train_state_specs  # noqa: E402
from repro_torch.models import lm  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
ARCH_NAMES = sorted(ARCHS)


class _AbstractMesh:
    """The two attributes the JAX package's rules read."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (imported here, not at collection)."""
    import importlib

    import jax
    from jax.sharding import PartitionSpec

    from repro import configs as jconfigs
    from repro.distributed import sharding as jsharding
    from repro.launch import common as jcommon
    from repro.launch import steps as jsteps
    from repro.models import lm as jlm

    jroofline = importlib.import_module("repro.launch.roofline")  # the package re-exports
    return dict(jax=jax, P=PartitionSpec, configs=jconfigs, sharding=jsharding,  # roofline()
                common=jcommon, roofline=jroofline, steps=jsteps, lm=jlm)


def _jax_table(ref, specs):
    """{path names: spec tuple} of a JAX spec tree."""
    flat, _ = ref["jax"].tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, ref["P"]))
    return {ref["sharding"]._path_names(path): tuple(spec) for path, spec in flat}


def _jax_shapes(ref, tree):
    flat, _ = ref["jax"].tree_util.tree_flatten_with_path(tree)
    return {ref["sharding"]._path_names(path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


def _table(specs):
    out = {}
    map_with_path(lambda names, s: out.__setitem__(names, tuple(s)), specs)
    return out


def _shapes(tree):
    out = {}
    map_with_path(lambda names, t: out.__setitem__(
        names, (tuple(t.shape), str(t.dtype).replace("torch.", ""))), tree)
    return out


def _pad(spec, n):
    """A JAX spec may list fewer entries than dims; the rest are None."""
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.fixture(scope="module")
def jax_state_shapes(ref):
    return {name: ref["steps"].train_state_shapes(ref["configs"].get_config(name))
            for name in ARCH_NAMES}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_state_specs_equal_the_jax_packages(ref, jax_state_shapes, mesh_name):
    shape, axes = MESHES[mesh_name]
    jmesh = _AbstractMesh(shape, axes)
    mesh = Mesh(shape, axes)
    for name in ARCH_NAMES:
        jshapes = jax_state_shapes[name]
        jspecs = ref["steps"].train_state_specs(jshapes, jmesh)
        shapes = train_state_shapes(ARCHS[name])
        specs = train_state_specs(shapes, mesh)
        want, got = _jax_table(ref, jspecs), _table(specs)
        dims = _shapes(shapes)
        assert set(got) == set(want), name
        for path in want:
            assert got[path] == _pad(want[path], len(dims[path][0])), (name, path)
        jdims = _jax_shapes(ref, jshapes)
        assert {k: v[0] for k, v in dims.items()} == {k: v[0] for k, v in jdims.items()}, name


def test_state_specs_at_min_model_dim_1024_equal_the_jax_packages(ref, jax_state_shapes):
    """The optimized variant's thin-shard rule: with ``MIN_MODEL_DIM`` 1024
    in both packages, the param and optimizer-state specs of all ten
    architectures on 16x16 are the JAX package's; the port's knob is put
    back after its block, and the memoised per-weight specs follow it."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import min_model_dim, param_spec

    shape, axes = MESHES["16x16"]
    jmesh, mesh = _AbstractMesh(shape, axes), Mesh(shape, axes)
    jsh = ref["sharding"]
    prev = jsh.MIN_MODEL_DIM
    jsh.MIN_MODEL_DIM = 1024
    try:
        with min_model_dim(1024):
            for name in ARCH_NAMES:
                jspecs = ref["steps"].train_state_specs(jax_state_shapes[name], jmesh)
                shapes = train_state_shapes(ARCHS[name])
                got, want = _table(train_state_specs(shapes, mesh)), _jax_table(ref, jspecs)
                dims = _shapes(shapes)
                assert set(got) == set(want), name
                for path in want:
                    assert got[path] == _pad(want[path], len(dims[path][0])), (name, path)
            wq = param_spec(("attn", "wq", "w"), (576, 576), mesh)
    finally:
        jsh.MIN_MODEL_DIM = prev
    assert sharding.MIN_MODEL_DIM == 0 and wq == P(None, None)
    assert param_spec(("attn", "wq", "w"), (576, 576), mesh) == P("model", None)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_and_cache_specs_equal_the_jax_packages(ref, mesh_name):
    shape, axes = MESHES[mesh_name]
    jmesh, mesh = _AbstractMesh(shape, axes), Mesh(shape, axes)
    jax, jcfgs = ref["jax"], ref["configs"]
    for name in ARCH_NAMES:
        cfg, jcfg = ARCHS[name], jcfgs.get_config(name)
        for cell in SHAPES.values():
            b, jb = input_specs(cfg, cell), jcfgs.input_specs(jcfg, cell)
            assert _shapes(b) == _jax_shapes(ref, jb), (name, cell.name)
            assert _table(batch_specs(b, mesh)) == {
                k: _pad(v, len(b[k[0]].shape))
                for k, v in _jax_table(ref, ref["sharding"].batch_specs(jb, jmesh)).items()}
        for c, jc in ((cache_specs(cfg, SHAPES["decode_32k"]),
                       jcfgs.cache_specs(jcfg, SHAPES["decode_32k"])),
                      (lm.init_lm_cache(cfg, 8, 64, device="meta"),
                       jax.eval_shape(lambda c=jcfg: ref["lm"].init_lm_cache(c, 8, 64)))):
            dims = _shapes(c)
            assert dims == _jax_shapes(ref, jc), name
            want = _jax_table(ref, ref["sharding"].cache_specs_tree(jc, jmesh))
            assert _table(cache_specs_tree(c, mesh)) == {
                k: _pad(v, len(dims[k][0])) for k, v in want.items()}, name


def _check_divides(tree, specs, mesh):
    def check(names, leaf, spec):
        for dim, entry in zip(leaf.shape, spec):
            if entry is None:
                continue
            size = mesh.axis_size(entry if isinstance(entry, tuple) else (entry,))
            assert dim % size == 0, (names, tuple(leaf.shape), spec)

    map_with_path(check, tree, specs)


def test_every_spec_divides_its_dim_on_the_ports_trees():
    """The invariant of ``tests/test_distributed.py``'s divisibility test,
    on the port's own trees at 2x4, and each rank's piece of a leaf has the
    shape ``local_shape`` gives."""
    mesh = Mesh((2, 4), ("data", "model"))
    for cfg in ARCHS.values():
        shapes = lm.init_lm(0, cfg, device="meta")
        specs = param_specs(shapes, mesh)
        _check_divides(shapes, specs, mesh)
        for sn in ("train_4k", "decode_32k"):
            b = input_specs(cfg, SHAPES[sn])
            _check_divides(b, batch_specs(b, mesh), mesh)
        c = lm.init_lm_cache(cfg, 8, 64, device="meta")
        _check_divides(c, cache_specs_tree(c, mesh), mesh)
    cfg = ARCHS["smollm-135m"]
    shapes = lm.init_lm(0, cfg, device="meta")
    specs = param_specs(shapes, mesh)
    for rank in (0, 5):
        pieces = shard(shapes, specs, Mesh((2, 4), ("data", "model"), rank=rank))
        map_with_path(lambda n, piece, full, s: None if tuple(piece.shape) == local_shape(
            full.shape, s, mesh) else pytest.fail(str(n)), pieces, shapes, specs)


def test_param_counts_equal_the_jax_packages_and_the_ports_tree(ref):
    for name in ARCH_NAMES:
        cfg, jcfg = ARCHS[name], ref["configs"].get_config(name)
        assert cfg.param_count() == jcfg.param_count(), name
        assert cfg.active_param_count() == jcfg.active_param_count(), name
        n = sum(t.numel() for t in _leaf_list(lm.init_lm(0, cfg, device="meta")))
        assert n == cfg.param_count(), name


def _leaf_list(tree):
    out = []
    map_with_path(lambda _, t: out.append(t), tree)
    return out


def test_shapes_cells_and_model_flops_equal_the_jax_packages(ref):
    jcfgs = ref["configs"]
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()} == {
        k: (v.name, v.seq_len, v.global_batch, v.kind) for k, v in jcfgs.SHAPES.items()}
    for name in ARCH_NAMES:
        cfg, jcfg = ARCHS[name], jcfgs.get_config(name)
        for cell in SHAPES.values():
            assert cell_applicable(cfg, cell) == jcfgs.cell_applicable(jcfg, cell)
            assert model_flops_for_cell(cfg, cell) == ref["roofline"].model_flops_for_cell(
                jcfg, jcfgs.SHAPES[cell.name]), (name, cell.name)


@pytest.mark.parametrize("spec", ["4", "axb", "", "2x", "x2", "0x2", "2x0", "-1x2", "1x1x1",
                                  "3x2", "1x2"])
def test_parse_mesh_messages_equal_the_jax_packages(ref, spec):
    """The malformed specs of ``tests/test_serving.py``, and meshes larger
    than this process's one rank (the JAX test process has one device)."""
    with pytest.raises(ValueError) as want:
        ref["common"].parse_mesh(spec)
    with pytest.raises(ValueError) as got:
        parse_mesh(spec)
    assert str(got.value) == str(want.value)


def test_parse_mesh_builds_one_rank_and_the_production_meshes():
    mesh = parse_mesh("1x1")
    assert mesh.size == 1 and mesh.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="needs 256 devices; 1 present"):
        parse_mesh("production")
    for multi, shape in ((False, (16, 16)), (True, (2, 16, 16))):
        m = make_production_mesh(multi_pod=multi)
        assert m.devices_shape == shape and m.size == int(np.prod(shape))
        assert m.rank_of(m.coords(m.size - 1)) == m.size - 1
    m = Mesh((2, 4), ("data", "model"))
    assert [m.coords(r) for r in (0, 5)] == [{"data": 0, "model": 0}, {"data": 1, "model": 1}]
    assert m.group_ranks("model") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert m.group_ranks("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]


@pytest.mark.parametrize("n", [1, 2047, 2048, 5000])
def test_int8_quantisation_is_the_jax_packages_bit_for_bit(ref, n):
    from repro.distributed import collectives as jcoll

    rng = np.random.RandomState(n)
    x = (rng.randn(n) * 3).astype(np.float32)
    x[: min(n, 8)] = [127.0, -127.0, 63.5, -63.5, 0.5, -0.5, 1.5, 2.5][: min(n, 8)]  # .5 ties
    q, s = collectives.quantize_int8(torch.from_numpy(x))
    jq, js = jcoll.quantize_int8(ref["jax"].numpy.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = collectives.dequantize_int8(q, s, (n,), torch.float32)
    jback = jcoll.dequantize_int8(jq, js, (n,), ref["jax"].numpy.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


@pytest.mark.parametrize("S", [2, 4, 16])
@pytest.mark.parametrize("kind,call", [
    ("all-reduce", lambda x, mesh: collectives.all_reduce(x, "model", mesh=mesh)),
    ("all-gather", lambda x, mesh: collectives.all_gather(x, "model", dim=0, mesh=mesh)),
    ("reduce-scatter", lambda x, mesh: collectives.reduce_scatter(x, "model", dim=0, mesh=mesh)),
])
def test_collective_bytes_follow_the_jax_packages_conventions(ref, kind, call, S):
    """Each wrapper, given a meta tensor, records the effective bytes
    ``parse_collectives`` reads off one HLO line of the same result and
    group size (and returns a meta result of that shape)."""
    mesh = Mesh((1, S), ("data", "model"))
    x = torch.empty((S * 8, 6), dtype=torch.bfloat16, device="meta")
    collectives.reset_stats()
    out = call(x, mesh)
    assert out.is_meta
    dims = ",".join(map(str, out.shape))
    line = (f"  %c = bf16[{dims}]{{1,0}} {kind}(bf16[8,6]{{1,0}} %p), "
            f"replica_groups=[{16 // S if S < 16 else 1},{S}]<=[16]")
    want = ref["roofline"].parse_collectives(line)
    assert want.count == 1
    assert collectives.STATS.by_kind == want.by_kind
    assert collectives.STATS.effective_bytes == want.effective_bytes
    assert collectives.STATS.result_bytes == want.result_bytes


def test_a_group_of_one_is_the_identity_and_records_nothing():
    mesh = Mesh((1, 1), ("data", "model"))
    x = torch.randn(3, 4)
    collectives.reset_stats()
    for fn in (collectives.all_reduce, collectives.broadcast):
        assert fn(x, "model", mesh=mesh) is x
    assert collectives.all_gather(x, "data", dim=1, mesh=mesh) is x
    assert collectives.STATS.count == 0
    assert P(None, "model") == (None, "model")


@pytest.mark.parametrize("specs", ["whole", "rules"])
def test_zero1_update_on_one_rank_is_clip_and_adamw_value_for_value(specs):
    """The one-rank train step takes ``adamw_update_zero1`` over a mesh of
    one: it must give ``clip_by_global_norm`` + ``adamw_update``'s params,
    moments and norm bit for bit, with whole-leaf specs or with the rules'
    specs on a 1x1 mesh (axes of size one named)."""
    from repro_torch.configs import smoke_config
    from repro_torch.distributed.sharding import opt_state_specs
    from repro_torch.optim import (
        adamw_init,
        adamw_update,
        adamw_update_zero1,
        clip_by_global_norm,
        tree_leaves,
        tree_map,
    )

    cfg = smoke_config("gemma3-4b")
    params = lm.init_lm(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    mesh = Mesh((1, 1), ("data", "model"))
    if specs == "whole":
        p_specs = tree_map(lambda p: P(*(None,) * p.ndim), params)
        o_specs = {"m": p_specs}
    else:
        p_specs = param_specs(params, mesh)
        o_specs = opt_state_specs(adamw_init(params), None, mesh)
    want_p, want_s = got_p, got_s = params, adamw_init(params)
    for _ in range(2):
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen) * 3.0, params)
        clipped, want_n = clip_by_global_norm(grads, 1.0)
        want_p, want_s = adamw_update(clipped, want_s, want_p, 1e-3)
        got_p, got_s, got_n = adamw_update_zero1(grads, got_s, got_p, 1e-3, p_specs, o_specs,
                                                 mesh, max_grad_norm=1.0)
        assert torch.equal(got_n, want_n)
        for a, b in zip(tree_leaves((got_p, got_s)), tree_leaves((want_p, want_s))):
            assert a.dtype == b.dtype and torch.equal(a, b)
