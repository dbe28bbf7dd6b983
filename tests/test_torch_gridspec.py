"""The port's declared grids (``repro_torch.kernels.gridspec``) and their
proof (``repro_torch.analysis.coverage``, KC310-KC315), after the JAX
package's coverage tests (``tests/test_analysis.py``): the same unit rigs,
the same rule set as the JAX package's ``verify_spec`` on its rigs, their
mutations and every schedule it builds, each wrapper's spec against the
grid its C entry point computed before the grids were declared, the
wrappers passing exactly their specs' launches, and the causal row order
and persistent walks proven at many shapes.

The ``gpu`` tests launch every route from its spec on the card, and on a
grid one block short; jax is imported in a fixture, so they also run
where jax is not installed:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gridspec.py``
"""

import dataclasses
import os
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import coverage  # noqa: E402
from repro_torch.analysis.contracts import SHAPE_GRID  # noqa: E402
from repro_torch.analysis.sanitize import ROUTE_SHAPES  # noqa: E402
from repro_torch.core import candidates as pcand  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    _build,
    attention_fused,
    gridspec,
    matmul_batched,
    matmul_nn,
    matmul_nt,
    matmul_tnn_fused,
    tiling,
    transpose,
)
from repro_torch.kernels.common import H100_SMS, cdiv  # noqa: E402
from repro_torch.kernels.gridspec import BlockMap, KernelGridSpec  # noqa: E402

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.fixture(scope="module")
def J():
    """The JAX package's side, imported here and not at module top, so the
    ``gpu`` tests of this file also run where jax is not installed."""
    pytest.importorskip("jax")
    from repro.analysis import coverage as ref_coverage
    from repro.analysis.contracts import SHAPE_GRID as ref_shapes
    from repro.core import candidates as ref_candidates
    from repro.kernels import gridspec as ref_gridspec

    return types.SimpleNamespace(coverage=ref_coverage, gridspec=ref_gridspec,
                                 candidates=ref_candidates, shapes=ref_shapes)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _square_spec(index_map, grid=(2, 2), in_map=None, sequential=(), spec_types=gridspec):
    """A 256x256 two-axis spec with 128x128 blocks -- the unit-test rig:
    ``index_map`` drives the output, ``in_map`` (default: identity) the
    single operand."""
    out = spec_types.BlockMap(block=(128, 128), index_map=index_map, extent=(256, 256))
    inp = spec_types.BlockMap(block=(128, 128), index_map=in_map or (lambda i, j: (i, j)),
                              extent=(256, 256))
    return spec_types.KernelGridSpec(name="unit", grid=grid, in_specs=(inp,), out_spec=out,
                                     sequential=sequential)


def _rules(spec, verify=coverage.verify_spec):
    return {r for r, _ in verify(spec)}


# -- the JAX package's coverage tests, on the port ----------------------------------


def test_verify_spec_accepts_correct_schedules():
    assert coverage.verify_spec(_square_spec(lambda i, j: (i, j))) == []
    # ragged shapes, default tiles, every spec function
    for name, op in [("PALLAS_NT", "NT"), ("PALLAS_TNN", "NT"), ("PALLAS_NN", "NN"),
                     ("PALLAS_TN", "TN"), ("PALLAS_BNT", "BNT"), ("PALLAS_BNN", "BNN"),
                     ("PALLAS_TNN_FUSED", "NT"), ("FUSED_ATTN", "ATTN")]:
        for dsize in (4, 2):
            for spec in gridspec.candidate_grid_specs(name, op, 129, 127, 65, g=3, dsize=dsize):
                assert coverage.verify_spec(spec) == [], (name, op, dsize, spec.name)


def test_verify_spec_detects_overlapping_tiles():
    # both grid rows write output block-row 0: overlap + a row-1 gap
    rules = _rules(_square_spec(lambda i, j: (0, j)))
    assert "KC311" in rules and "KC310" in rules


def test_verify_spec_sequential_axis_rewrites_are_not_overlaps():
    # a k-style reduction axis revisits the same output block -- the
    # sequential-accumulation pattern, not a race
    out = BlockMap(block=(128, 128), index_map=lambda i, kk: (i, 0), extent=(256, 128))
    inp = BlockMap(block=(128, 128), index_map=lambda i, kk: (i, kk), extent=(256, 256))
    spec = KernelGridSpec(name="acc", grid=(2, 2), in_specs=(inp,), out_spec=out,
                          sequential=(1,))
    assert coverage.verify_spec(spec) == []


def test_verify_spec_detects_ragged_edge_gap():
    # grid built with floor-div instead of cdiv: the ragged tail block is
    # never written and the grid extent disagrees with cdiv
    rules = _rules(_square_spec(lambda i, j: (i, j), grid=(1, 2)))
    assert "KC313" in rules and "KC310" in rules


def test_verify_spec_detects_operand_overrun():
    # off-by-one operand map walks past the extent
    rules = _rules(_square_spec(lambda i, j: (i, j), in_map=lambda i, j: (i, j + 1)))
    assert rules == {"KC312"}


def test_verify_spec_detects_transposed_index_map():
    # operand map swaps the grid axes on a non-square grid
    out = BlockMap(block=(128, 128), index_map=lambda i, j: (i, j), extent=(256, 384))
    inp = BlockMap(block=(128, 128), index_map=lambda i, j: (j, i), extent=(256, 384))
    spec = KernelGridSpec(name="tr", grid=(2, 3), in_specs=(inp,), out_spec=out)
    assert _rules(spec) == {"KC312"}


def test_verify_spec_detects_malformed_maps():
    assert "KC314" in _rules(_square_spec(lambda i: (i, 0)))  # wrong arity for the grid
    assert "KC314" in _rules(_square_spec(lambda i, j: (i,)))  # wrong rank for the block


def test_coverage_pass_proves_every_registered_pair():
    report = coverage.check_coverage(repo_root=REPO_ROOT)
    assert report.findings == [], [f.render() for f in report.findings[:10]]
    all_pairs = {(n, op) for n, c in pcand.CANDIDATES.items() for op in c.ops}
    assert set(report.pairs) == all_pairs
    tunable = {(n, op) for n, c in pcand.CANDIDATES.items() for op in c.ops if c.tunable}
    assert set(report.proven_pairs) == tunable and len(tunable) == 8
    assert report.cells >= len(tunable) and report.specs >= report.cells


def test_coverage_pass_detects_missing_grid_spec():
    @pcand.register_candidate("_NO_SPEC", sim_algo="NT_DIRECT", tunable=True, ops=("NT",))
    def _ns(a, b, block=None):  # pragma: no cover - never run
        return a

    try:
        findings = coverage.check_coverage(shapes=((64, 64, 64, 1),)).findings
        assert any(f.rule == "KC315" and "_NO_SPEC" in f.context for f in findings)
    finally:
        pcand.unregister_candidate("_NO_SPEC")


# -- rule for rule with the JAX package ----------------------------------------------


def _mutations(spec):
    """``spec`` with each grid axis one short, each map shifted by one
    block (on its first and last axis), transposed (its first two grid
    arguments swapped) and of the wrong arity."""
    n = len(spec.grid)
    out = []
    for a in range(n):
        grid = tuple(e - (i == a) for i, e in enumerate(spec.grid))
        out.append(dataclasses.replace(spec, grid=grid))
    maps = [("in", i, bm) for i, bm in enumerate(spec.in_specs)] + [("out", 0, spec.out_spec)]

    def put(where, i, bm):
        if where == "out":
            return dataclasses.replace(spec, out_spec=bm)
        ins = list(spec.in_specs)
        ins[i] = bm
        return dataclasses.replace(spec, in_specs=tuple(ins))

    for where, i, bm in maps:
        f, rank = bm.index_map, len(bm.block)
        for d in sorted({0, rank - 1}):
            def shifted(*p, _f=f, _d=d):
                idx = list(_f(*p))
                idx[_d] = idx[_d] + 1
                return tuple(idx)
            out.append(put(where, i, dataclasses.replace(bm, index_map=shifted)))
        if n >= 2:
            out.append(put(where, i, dataclasses.replace(
                bm, index_map=lambda *p, _f=f: _f(p[1], p[0], *p[2:]))))

        def wrong_arity(*p, _f=f, _n=n):
            if len(p) != _n - 1:
                raise TypeError(f"takes {_n - 1} grid axes, got {len(p)}")
            return _f(*p, 0)
        out.append(put(where, i, dataclasses.replace(bm, index_map=wrong_arity)))
    return out


def test_verify_spec_matches_the_jax_package_on_its_rigs_and_their_mutations(J):
    rigs = [
        _square_spec(lambda i, j: (i, j), spec_types=J.gridspec),
        _square_spec(lambda i, j: (0, j), spec_types=J.gridspec),
        _square_spec(lambda i, j: (i, j), grid=(1, 2), spec_types=J.gridspec),
        _square_spec(lambda i, j: (i, j), in_map=lambda i, j: (i, j + 1),
                     spec_types=J.gridspec),
        _square_spec(lambda i, kk: (i, 0), sequential=(1,), spec_types=J.gridspec),
        J.gridspec.KernelGridSpec(
            name="tr", grid=(2, 3),
            in_specs=(J.gridspec.BlockMap((128, 128), lambda i, j: (j, i), (256, 384)),),
            out_spec=J.gridspec.BlockMap((128, 128), lambda i, j: (i, j), (256, 384))),
    ]
    checked = 0
    for rig in rigs:
        for spec in [rig] + _mutations(rig):
            assert _rules(spec) == _rules(spec, J.coverage.verify_spec), spec
            checked += 1
    assert checked > 60


def test_verify_spec_matches_the_jax_package_on_every_schedule_it_builds(J):
    checked = 0
    for name in sorted(J.gridspec.GRID_SPEC_BUILDERS):
        cand = J.candidates.CANDIDATES[name]
        for op in cand.ops:
            for m, n, k, g in J.shapes:
                for spec in J.gridspec.candidate_grid_specs(name, op, m, n, k, g=g):
                    ref = _rules(spec, J.coverage.verify_spec)
                    assert _rules(spec) == ref == set(), (name, op, m, n, k, spec.name)
                    checked += 1
                    if (m, n, k, g) == J.shapes[1]:  # the mutations at one ragged cell
                        for bad in _mutations(spec):
                            assert (_rules(bad) == _rules(bad, J.coverage.verify_spec)), (
                                name, op, spec.name)
                            checked += 1
    assert checked > 100


def test_both_packages_prove_the_same_tunable_pairs(J):
    ours = {(n, op) for n, c in pcand.CANDIDATES.items() for op in c.ops if c.tunable}
    theirs = {(n, op) for n, c in J.candidates.CANDIDATES.items() for op in c.ops if c.tunable}
    assert ours == theirs
    assert set(gridspec.GRID_SPEC_BUILDERS) == set(J.gridspec.GRID_SPEC_BUILDERS)
    report = J.coverage.check_coverage(shapes=J.shapes[:2], repo_root=REPO_ROOT)
    assert report.findings == [] and set(report.proven_pairs) == theirs
    assert set(coverage.check_coverage(shapes=SHAPE_GRID[:2]).proven_pairs) == ours


# -- each spec against the grid its C entry point computed -----------------------------

# The main-path shapes of PERF.md's kernel table and the sanitizer's route cells.
SHAPES = coverage.MAIN_PATH_SHAPES + ROUTE_SHAPES


def _c_grids(kernel, plan, m, n, k, g, sms, nt=True):
    """The launches the C entry points computed from (m, n, k, g), the plan
    and the SM count before the grids were declared (csrc/matmul.cu:144-147,
    333; matmul_nt.cu:173; matmul_nn.cu:250-256, 395; matmul_tnn_fused.cu:
    408, 560-566, 578; matmul_batched.cu:144-147, 446, 460; attention_fused.cu:
    701, 1011, 1018, 1309, 1327, 1368; common.cuh:121-122)."""
    def reduce(mn):
        return (min(cdiv(mn, 256), 4096), 1, 1)

    if kernel == "attention_fused":
        variant, splits, per = plan
        if variant == "decode_split":
            return [(g, splits, 1)] + ([(g, 1, 1)] if splits > 1 else [])
        if variant == "fma":
            return [(g, cdiv(m, 16), 1)]
        if variant == "flash_mma":
            return [(g, cdiv(m, 64), 1)]
        return [(g, cdiv(m, 64), splits)] + ([(cdiv(m * (k // 4), 256), g, 1)]
                                             if splits > 1 else [])
    variant, tile, splits, per = plan
    red = [reduce(m * n * g)] if splits > 1 else []
    if variant == "fma":
        if kernel == "matmul_tnn_fused":
            return [(cdiv(m, 64), cdiv(n, 64), 1)]
        return [(cdiv(n, 64), cdiv(m, 16 if m <= 16 else 64), g)]
    if kernel in ("matmul_bnt", "matmul_bnn"):
        return [(cdiv(n, 64), cdiv(m, 64), g * splits)] + red
    if isinstance(tile, tuple):  # gemm_f32, tnn_fused_f32
        return [(cdiv(n, tile[1]), cdiv(m, tile[0]), splits)] + red
    if variant == "wgmma":
        units = cdiv(m, 128) * cdiv(n, tile) * splits
        return [(min(units, sms), 1, 1)] + red
    if variant == "mma_sync":
        return [(cdiv(m, 64), cdiv(n, 64), 1)]
    return [(cdiv(n, 128), cdiv(m, 64), splits)] + red  # nt_bf16, nn_skinny


def _specs(kernel, plan, m, n, k, g, sms):
    if kernel == "matmul_nt":
        return matmul_nt.nt_grid_specs(m, n, k, plan)
    if kernel == "matmul_nn":
        return matmul_nn.nn_grid_specs(m, n, k, plan, sms)
    if kernel == "matmul_tnn_fused":
        return matmul_tnn_fused.tnn_fused_grid_specs(m, n, k, plan, sms)
    if kernel in ("matmul_bnt", "matmul_bnn"):
        return matmul_batched.batched_grid_specs(g, m, n, k, kernel == "matmul_bnt", plan)
    return attention_fused.attention_grid_specs(g, m, n, k, plan)


@pytest.mark.parametrize("kernel", tiling.TUNABLE_KERNELS)
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_each_spec_launches_what_its_entry_point_computed(kernel, sms):
    cells = 0
    for m, n, k, g in SHAPES:
        g = g if kernel in ("matmul_bnt", "matmul_bnn", "attention_fused") else 1
        for dsize in (4, 2):
            for aligned in (True, False):
                for cfg, plan in tiling.tile_plans(kernel, m, n, k, dsize, g, aligned, sms):
                    specs = _specs(kernel, plan, m, n, k, g, sms)
                    want = _c_grids(kernel, plan, m, n, k, g, sms)
                    assert [s.launch for s in specs] == want, (kernel, m, n, k, g, cfg, plan)
                    cells += 1
    assert cells > 40


@pytest.mark.parametrize("shape", SHAPES[:5] + ROUTE_SHAPES)
def test_transpose_spec_launches_what_its_entry_point_computed(shape):
    n, k = shape[1], shape[2]
    for br, bc in transpose.TRANSPOSE_INSTANCES:
        spec = transpose.transpose_grid_spec(n, k, (br, bc))
        assert spec.launch == (cdiv(k, bc), cdiv(n, br), 1)  # csrc/transpose.cu:70
        assert coverage.verify_spec(spec) == []


@pytest.mark.parametrize("shape", SHAPES)
def test_workspace_extents_are_the_wrappers_allocations(shape):
    m, n, k, g = shape
    for sms in (H100_SMS, 7):
        ws = matmul_nt.nt_workspace_shape(m, n, k, sms)
        plan = tiling.tile_plans("matmul_nt", m, n, k, 2, 1, True, sms)[0][1]
        specs = matmul_nt.nt_grid_specs(m, n, k, plan)
        assert (specs[0].out_spec.extent if len(specs) > 1 else None) == ws
        for kernel in ("matmul_nn", "matmul_tnn_fused", "matmul_bnt", "attention_fused"):
            gg = g if kernel in ("matmul_bnt", "attention_fused") else 1
            for dsize in (4, 2):
                for _, plan in tiling.tile_plans(kernel, m, n, k, dsize, gg, True, sms):
                    specs = _specs(kernel, plan, m, n, k, gg, sms)
                    if len(specs) == 1:
                        continue
                    ext = specs[0].out_spec.extent
                    if kernel == "attention_fused":
                        splits = plan[1]
                        assert int(torch.tensor(ext).prod()) == gg * splits * m * (k + 2)
                        assert ext[:2] == (gg, splits)
                    elif kernel == "matmul_bnt":
                        assert ext == (plan[2], gg, m, n)
                    else:
                        assert ext == (plan[2], m, n)


# -- the wrappers pass exactly their specs' launches -----------------------------------


@pytest.fixture
def recorded(monkeypatch):
    """Route every wrapper to its kernel on CPU tensors and record the C
    calls instead of making them."""
    calls = []

    def launch(lib, fn, *args):
        calls.append((lib, fn, args))

    monkeypatch.setattr(_build, "launch", launch)
    for mod in (matmul_nt, matmul_nn, matmul_tnn_fused, matmul_batched, attention_fused,
                transpose):
        monkeypatch.setattr(mod, "route", lambda *t: "kernel")
        if hasattr(mod, "sm_count"):
            monkeypatch.setattr(mod, "sm_count", lambda index: H100_SMS)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    return calls


CALL_CASES = [
    ("PALLAS_NT", "NT", (12, 296, 64, 1), "bfloat16"),
    ("PALLAS_NT", "NT", (12, 296, 64, 1), "float32"),
    ("PALLAS_NT", "NT", (129, 127, 65, 1), "float32"),
    ("PALLAS_NN", "NN", (200, 136, 72, 1), "bfloat16"),
    ("PALLAS_NN", "NN", (200, 136, 72, 1), "float32"),
    ("PALLAS_NN", "NN", (12, 296, 64, 1), "bfloat16"),
    ("PALLAS_TNN", "NT", (200, 136, 72, 1), "bfloat16"),
    ("PALLAS_TNN_FUSED", "NT", (200, 136, 72, 1), "bfloat16"),
    ("PALLAS_TNN_FUSED", "NT", (200, 136, 72, 1), "float32"),
    ("PALLAS_TNN_FUSED", "NT", (129, 127, 65, 1), "bfloat16"),
    ("PALLAS_BNT", "BNT", (200, 136, 72, 3), "float32"),
    ("PALLAS_BNN", "BNN", (200, 136, 72, 3), "bfloat16"),
    ("PALLAS_BNT", "BNT", (129, 127, 65, 3), "float32"),
    ("FUSED_ATTN", "ATTN", (12, 296, 64, 2), "bfloat16"),
    ("FUSED_ATTN", "ATTN", (129, 127, 64, 3), "bfloat16"),
    ("FUSED_ATTN", "ATTN", (129, 127, 64, 3), "float32"),
    ("FUSED_ATTN", "ATTN", (129, 127, 65, 3), "float32"),
]


@pytest.mark.parametrize("name,op,shape,dtype", CALL_CASES)
def test_wrappers_pass_their_specs_launches_to_the_entry_points(recorded, name, op, shape,
                                                                 dtype):
    from repro_torch.core.measure import operand_shapes

    m, n, k, g = shape
    dt = getattr(torch, dtype)
    xs = [torch.zeros(s, dtype=dt) for s in operand_shapes(op, m, n, k, g)]
    pcand.CANDIDATES[name].run(*xs)
    dsize = torch.finfo(dt).bits // 8
    specs = gridspec.candidate_grid_specs(name, op, m, n, k, g=g, dsize=dsize)
    assert recorded, "no launch recorded"
    kernels = [sp for sp in specs if sp.name != "transpose"]
    main, second = kernels[0], (kernels[1] if len(kernels) > 1 else None)
    for lib, fn, args in recorded:
        assert len(args) == len(_build._SIGNATURES[lib][fn]), fn  # the C signature's arity
        if fn == "repro_transpose":
            want = specs[0].launch
        elif fn == "repro_matmul_tnn_fused_wgmma":
            want = (main.launch[0],)
        elif fn == "repro_matmul_nn_wgmma":
            want = (main.launch[0], second.launch[0] if second else 0)
        elif fn in ("repro_attention_fused_decode", "repro_attention_fused_flash_f32"):
            want = main.launch + (second.launch if second else (0, 0, 0))
        elif fn in ("repro_matmul_f32", "repro_matmul_nt", "repro_matmul_nn_skinny",
                    "repro_matmul_tnn_fused_f32", "repro_matmul_batched_f32"):
            want = main.launch + (second.launch[0] if second else 0,)
        else:
            want = main.launch
        assert tuple(args[-1 - len(want):-1]) == tuple(want), (fn, args, specs)


# -- targeted proofs ---------------------------------------------------------------------


@pytest.mark.parametrize("rows", [64])
def test_flash_row_order_is_a_bijection_at_every_segment(rows):
    tried = 0
    for m in list(range(1, 200, 13)) + [256, 768, 1000, 2048]:
        blocks = cdiv(m, rows)
        for seg in sorted({0, 1, 63, 64, 128, 192, m // 2, m // 3, m}):
            for causal in (False, True):
                mask = attention_fused.MaskParams(causal=causal, q_seg=seg)
                order = [attention_fused.flash_block_row(r, blocks, rows, m, seg or m, causal)
                         // rows for r in range(blocks)]
                assert sorted(order) == list(range(blocks)), (m, seg, causal, order)
                for variant in ("flash_mma", "flash_f32"):
                    for spec in attention_fused.attention_grid_specs(3, m, 127, 64,
                                                                     (variant, 1, None), mask):
                        assert coverage.verify_spec(spec) == [], (m, seg, causal, variant)
                tried += 1
    assert tried > 200


@pytest.mark.parametrize("sms", [1, 7, 132])
def test_persistent_walks_cover_every_unit_once(sms):
    for m, n, k, _ in SHAPES:
        for dsize in (2,):
            for kernel, build in (("matmul_nn", matmul_nn.nn_grid_specs),
                                  ("matmul_tnn_fused", matmul_tnn_fused.tnn_fused_grid_specs)):
                for _, plan in tiling.tile_plans(kernel, m, n, k, dsize, 1, True, sms):
                    for spec in build(m, n, k, plan, sms):
                        if spec.programs is None:
                            continue
                        cap = 4096 if spec.name == "splitk_reduce" else sms
                        assert spec.programs == min(spec.units, cap)
                        assert coverage.verify_spec(spec) == [], (kernel, m, n, k, plan)
    # a walk that skips or repeats units is caught
    spec = matmul_nn.nn_grid_specs(200, 136, 72, ("wgmma", 64, 1, 2), sms)[0]
    bad = dataclasses.replace(spec, launch=(spec.programs + 1, 1, 1))
    assert "KC313" in _rules(bad)


def test_short_grid_is_named_by_kc313_and_kc310():
    spec = matmul_nt.nt_grid_specs(200, 136, 72, ("mma", None, 1, 2))[0]
    short = coverage.short_grid(spec)
    assert short.launch == (spec.launch[0], spec.launch[1] - 1, 1)
    missing = coverage.unwritten_blocks(short)
    assert missing == [(spec.launch[1] - 1, x) for x in range(spec.launch[0])]
    rules = dict(coverage.verify_spec(short))
    assert {"KC313", "KC310"} <= set(rules) and str(missing[0]) in rules["KC310"]
    for spec in (transpose.transpose_grid_spec(136, 72),
                 attention_fused.attention_grid_specs(2, 12, 296, 64, ("decode_split", 1, 304))[0],
                 matmul_batched.batched_grid_specs(3, 200, 136, 72, True, ("mma", None, 1, 1))[0]):
        short = coverage.short_grid(spec)
        missing = coverage.unwritten_blocks(short)
        rules = dict(coverage.verify_spec(short))
        assert missing and {"KC313", "KC310"} <= set(rules), spec.name
        assert str(missing[0]) in rules["KC310"]


def test_grid_limits_live_in_one_table():
    assert gridspec.GRID_LIMITS == (2**31 - 1, 65535, 65535)
    spec = transpose.transpose_grid_spec(65536 * 32, 64)
    assert gridspec.launch_error(spec) is not None
    with pytest.raises(ValueError, match="at most"):
        gridspec.check_launch((spec,), "transpose kernel takes at most 2097120 rows")
    assert gridspec.launch_error(transpose.transpose_grid_spec(65535 * 32, 64)) is None


# -- on the card -------------------------------------------------------------------------


@pytest.mark.gpu
def test_coverage_proof_on_the_cards_sm_count(cuda):
    from repro_torch.kernels.common import sm_count

    report = coverage.check_coverage(sms=sm_count(cuda.index or 0))
    assert report.findings == []
    tunable = {(n, op) for n, c in pcand.CANDIDATES.items() for op in c.ops if c.tunable}
    assert set(report.proven_pairs) == tunable


@pytest.mark.gpu
@pytest.mark.parametrize("route", coverage.LAUNCH_ROUTES, ids=lambda r: r[0])
def test_every_route_runs_the_grid_it_is_given(cuda, route):
    from repro_torch.kernels.common import sm_count

    [row] = coverage.launch_routes(cuda, sm_count(cuda.index or 0), routes=(route,))
    assert row["ok"], row
