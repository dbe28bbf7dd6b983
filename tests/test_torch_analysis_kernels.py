"""The port's artifact, contract and numerics passes and its poison
sanitizer (``repro_torch.analysis.{schemas,artifacts_lint,contracts,
numerics,sanitize}``), after the cases of ``tests/test_analysis.py`` that
cover the JAX package's: the schema mirrors against the port's own
constants, the committed artifacts validating clean and each rule firing
on a seeded payload, the measurement-cache and selector findings equal
to the JAX package's on the same payloads, the contract report covering
every registered (candidate, op) pair, the CUDA sources and the plain
routes linting clean and each numerics rule firing on a seeded snippet,
and the sanitizer clean on the plain routes and firing on a seeded leak.

The ``gpu`` test runs the full sanitizer on the card; jax is imported in
a fixture, so it also runs where jax is not installed:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu
tests/test_torch_analysis_kernels.py``
"""

import copy
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (  # noqa: E402
    artifacts_lint,
    contracts,
    numerics,
    sanitize,
    schemas,
)
from repro_torch.analysis.findings import RULES  # noqa: E402
from repro_torch.core import candidates as pcand  # noqa: E402

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CSRC = os.path.join(REPO_ROOT, "src", "repro_torch", "csrc")


@pytest.fixture(scope="module")
def J():
    """The JAX package's side, imported here and not at module top, so the
    ``gpu`` test of this file also runs where jax is not installed."""
    pytest.importorskip("jax")
    from repro.analysis import artifacts_lint as ref_artifacts
    from repro.core import candidates as ref_candidates

    return types.SimpleNamespace(artifacts=ref_artifacts, candidates=ref_candidates)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture
def seeded():
    """Register candidates for one test and unregister them after it."""
    names = []

    def register(name, fn, **kw):
        pcand.register_candidate(name, **kw)(fn)
        names.append(name)

    yield register
    for name in names:
        pcand.unregister_candidate(name)


# -- schemas ---------------------------------------------------------------------


def test_schema_mirrors_match_the_ports_sources():
    from repro_torch.benchmarks import bench_drift, serve_load
    from repro_torch.core import measure, opkey, selector
    from repro_torch.kernels import common

    assert schemas.OPS == opkey.OPS
    assert schemas.BATCHED_OPS == opkey.BATCHED_OPS
    assert schemas.GROUPED_OPS == opkey.GROUPED_OPS
    assert schemas.MEASURE_SCHEMA_VERSION == measure.MEASURE_SCHEMA_VERSION
    assert schemas.SELECTOR_SCHEMA_VERSION == selector.SCHEMA_VERSION
    assert schemas.SERVE_SCHEMA_VERSION == serve_load.SCHEMA_VERSION
    assert schemas.DEFAULT_CONFIG_KEY == common.DEFAULT_CONFIG_KEY
    assert schemas.BENCH_KERNELS_TOP_KEYS == frozenset(bench_drift.REQUIRED_TOP_KEYS)
    assert schemas.BENCH_KERNELS_ROW_KEYS == frozenset(bench_drift.REQUIRED_ROW_KEYS)
    assert schemas.BENCH_SERVE_TOP_KEYS == frozenset(bench_drift.REQUIRED_SERVE_TOP_KEYS)
    assert schemas.BENCH_SERVE_CLASS_KEYS == frozenset(bench_drift.REQUIRED_SERVE_CLASS_KEYS)


def test_cache_key_grammar_matches_the_ports_measure():
    from repro_torch.core import measure

    key_tuple = ("cpu", "host", "float32", "BNT", 4, 128, 256, 512)
    key = measure._key_str(measure._normalize_mkey(key_tuple))
    assert schemas.parse_cache_key(key) == key_tuple == measure._parse_key(key)
    for bad in ("cpu|host|float32|NT|2|128|256|512", "not-a-key"):
        with pytest.raises(ValueError):
            schemas.parse_cache_key(bad)
    assert schemas.parse_config_key("default") is None
    assert schemas.parse_config_key("64x128x64") == (64, 128, 64)
    assert schemas.parse_config_key("16x32") == (16, 32)


# -- artifacts pass ------------------------------------------------------------------


def test_committed_port_artifacts_validate_clean():
    for rel in artifacts_lint.DEFAULT_TARGETS:
        path = os.path.join(REPO_ROOT, rel)
        assert os.path.isfile(path), rel
        assert artifacts_lint.sniff_kind(json.load(open(path))) in ("bench_kernels",
                                                                    "bench_serve")
        findings = artifacts_lint.validate_file(path, repo_root=REPO_ROOT)
        assert findings == [], [f.render() for f in findings]
    assert artifacts_lint.run(REPO_ROOT) == []


def _committed(name):
    return json.load(open(os.path.join(REPO_ROOT, "src", "repro_torch", "benchmarks", name)))


def _seeded_payload(rule, tmp_path):
    """(findings, context the rule must carry) of one seeded payload."""
    if rule == "AR201":
        path = tmp_path / "broken.json"
        path.write_text("{nope")
        return artifacts_lint.validate_file(str(path), "broken.json"), "read"
    if rule == "AR202":
        return artifacts_lint.validate_payload({"schema_version": 99, "entries": {}},
                                               "cache.json"), "schema_version:newer"
    if rule == "AR203":
        cache = {"schema_version": 5,
                 "entries": {"cpu|host|float32|NT|1|64|64|64": {"default": 0.5},
                             "garbage": {"default": 0.1}}}
        return artifacts_lint.validate_payload(cache, "cache.json"), "key:garbage"
    bad = _committed("BENCH_kernels.json")
    bad["rows"][0]["op"] = "ZZ"
    return artifacts_lint.validate_payload(bad, "seeded.json"), "row[0]:op"


@pytest.mark.parametrize("rule", ["AR201", "AR202", "AR203", "AR204"])
def test_each_artifact_rule_fires_on_a_seeded_payload(rule, tmp_path):
    findings, context = _seeded_payload(rule, tmp_path)
    assert (rule, context) in {(f.rule, f.context) for f in findings}, [
        f.render() for f in findings]


def test_kernel_sweep_rows_are_held_to_the_ports_schema():
    payload = _committed("BENCH_kernels.json")
    bad = copy.deepcopy(payload)
    bad["rows"][1].update(median_us=0.0, bound_by="flops", device_us=-1.0)
    bad["rows"].append(dict(bad["rows"][0]))
    del bad["rows"][2]["rel_err"]
    contexts = {f.context for f in artifacts_lint.validate_payload(bad, "x.json")}
    assert {"row[1]:median_us", "row[1]:bound_by", "row[1]:device_us", "row[2]:keys",
            f"row[{len(bad['rows']) - 1}]:duplicate"} <= contexts
    # where the sweep marks a winner, exactly one row of each cell carries it
    marked = copy.deepcopy(payload)
    cell0 = tuple(marked["rows"][0][x] for x in ("dtype", "op", "g", "m", "n", "k"))
    for row in marked["rows"]:
        row["best"] = tuple(row[x] for x in ("dtype", "op", "g", "m", "n", "k")) != cell0
    contexts = {f.context for f in artifacts_lint.validate_payload(marked, "x.json")}
    assert any(c.startswith("best:") and "NT" in c for c in contexts)
    missing = _committed("BENCH_serve.json")
    del missing["totals"]
    assert [f.context for f in artifacts_lint.validate_payload(missing, "s.json")] == \
        ["top:totals"]


def test_torch_free_passes_run_without_torch_or_jax():
    code = ("import sys; sys.path.insert(0, 'src'); sys.modules['torch'] = None; "
            "sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "from repro_torch.analysis.lint import main; "
            "rc = main(['--passes', 'artifacts,dispatch,concurrency']); "
            "assert sys.modules['torch'] is None; sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[artifacts, dispatch, concurrency]: 0 error(s)" in proc.stdout


def _port_artifacts(tmp_path):
    """A measurement cache and a selector artifact as the port writes them."""
    from repro_torch.core import gbdt, hardware, measure, selector

    cache = measure.MeasurementCache(str(tmp_path / "cache.json"))
    cache.put(("gpu", "H100", "bfloat16", "NT", 1, 64, 128, 256),
              {"XLA_NT": {"default": 1e-5}, "PALLAS_NT": {"default": 2e-5, "64x128x64": 3e-5}})
    cache.put(("gpu", "H100", "float32", "ATTN", 12, 3, 512, 64),
              {"UNFUSED_ATTN": {"default": 4e-5}, "FUSED_ATTN": {"default": 1e-5,
                                                                 "4x128": 2e-5}})
    cache.save()
    clf = gbdt.GBDTClassifier(n_estimators=2, max_depth=2).fit(np.eye(10),
                                                               np.array([1, -1] * 5))
    sel = selector.MTNNSelector(
        clf, hardware=hardware.H100, binary_pair=("XLA_NT", "PALLAS_TNN"),
        tile_tables={"NT": {"PALLAS_TNN": {"modal": "128x128x128",
                                           "by_shape": {"128x128x128": "128x64x64"}}}})
    sel.save(str(tmp_path / "selector.json"))
    return (json.loads((tmp_path / "cache.json").read_text()),
            json.loads((tmp_path / "selector.json").read_text()))


def _payload_cases(tmp_path):
    cache, selector = _port_artifacts(tmp_path)
    cases = {"cache": cache, "selector": selector}
    c = copy.deepcopy(cache)
    c["entries"]["garbage"] = {"default": 0.1}
    c["entries"]["cpu|host|float32|NT|2|8|8|8"] = {"default": 0.1}
    c["entries"]["cpu|host|float32|NN|1|8|8|8"] = {"X": {"12x": -1.0}, "Y": "slow", "Z": 0}
    c["entries"]["cpu|host|float32|TN|1|8|8|8"] = []
    cases["cache_seeded"] = c
    cases["cache_v1"] = {"schema_version": 1, "entries": {"cpu|host|float32|64|64|64":
                                                          {"XLA_NT": 0.5}}}
    cases["cache_v3"] = {"schema_version": 3, "entries": {"cpu|host|float32|BNT|8|8|8":
                                                          {"XLA_BNT": {"default": 0.5}}}}
    cases["cache_future"] = {"schema_version": 6, "entries": {}}
    cases["cache_version_type"] = {"schema_version": "5", "entries": {}}
    cases["cache_no_entries"] = {"schema_version": 5, "entries": []}
    s = copy.deepcopy(selector)
    s["mode"] = "weird"
    s["binary_pairs"]["ZZ"] = ["A", "B", "C"]
    s["tile_tables"]["NT"]["PALLAS_TNN"] = {"modal": "0x1", "by_shape": {"8x8": "1x2x3x4"}}
    s["tile_tables"]["QQ"] = {}
    s["tile_tables"]["NN"] = {"PALLAS_NN": 3}
    cases["selector_seeded"] = s
    s2 = copy.deepcopy(selector)
    del s2["binary_pairs"]
    s2["model"] = None
    cases["selector_no_pairs"] = s2
    s3 = copy.deepcopy(selector)
    s3["schema_version"] = 2
    s3["binary_pair"] = ["only-one"]
    cases["selector_v2"] = s3
    cases["selector_future"] = {**selector, "schema_version": 9}
    cases["unrecognised"] = {"hello": 1}
    return cases


def test_cache_and_selector_findings_equal_the_jax_packages(J, tmp_path):
    cases = _payload_cases(tmp_path)
    assert artifacts_lint.validate_payload(cases["cache"], "c.json") == []
    assert artifacts_lint.validate_payload(cases["selector"], "s.json") == []
    for label, payload in cases.items():
        mine = sorted((f.rule, f.context) for f in artifacts_lint.validate_payload(
            copy.deepcopy(payload), "x.json"))
        theirs = sorted((f.rule, f.context) for f in J.artifacts.validate_payload(
            copy.deepcopy(payload), "x.json"))
        assert mine == theirs, label
        assert artifacts_lint.sniff_kind(payload) == J.artifacts.sniff_kind(payload), label
        if label.endswith(("seeded", "future", "type", "entries", "pairs", "unrecognised")):
            assert mine, label


# -- contracts pass ----------------------------------------------------------------


def test_contracts_cover_every_registered_pair(J):
    report = contracts.check_contracts(repo_root=REPO_ROOT)
    assert report.findings == [], [f.render() for f in report.findings]
    mine = {(n, op) for n, c in pcand.CANDIDATES.items() for op in c.ops}
    assert set(report.pairs) == mine == set(J.candidates.candidate_op_pairs())
    assert report.cells >= 2 * len(mine) * len(contracts.SHAPE_GRID)


def test_contracts_detect_a_seeded_wrong_shape(seeded):
    def _bad(a, b):  # transposed output: (n, m) instead of (m, n)
        return a.new_zeros((b.shape[0], a.shape[0]))

    seeded("_BAD_SHAPE", _bad, sim_algo="NT_DIRECT", ops=("NT",))
    findings = contracts.check_contracts(shapes=((96, 160, 224, 1),)).findings
    assert [f.rule for f in findings if "_BAD_SHAPE" in f.context] == ["KC301"] * 2


def test_contracts_detect_a_meta_route_that_drifts_from_the_plain_one(seeded):
    def _drift(a, b):  # right on the meta route, f32 on the plain one
        out = a.new_empty((a.shape[0], b.shape[0]))
        return out if a.device.type == "meta" else out.float()

    seeded("_DRIFT", _drift, sim_algo="NT_DIRECT", ops=("NT",))
    findings = contracts.check_contracts(shapes=((96, 160, 224, 1),),
                                         dtypes=("bfloat16",)).findings
    assert [f.context for f in findings if "_DRIFT" in f.context] == [
        "contract:_DRIFT:NT:96x160x224x1:bfloat16:default:plain"]


@pytest.mark.parametrize("seed", ["off_plan", "split", "smem"])
def test_contracts_detect_a_seeded_plan_violation(seed, monkeypatch):
    from repro_torch.kernels import matmul_nn, tiling

    m, n, k = 96, 160, 224
    if seed == "off_plan":  # the autotune list names a config no route has
        real = tiling.shortlist_tile_configs
        monkeypatch.setattr(tiling, "shortlist_tile_configs",
                            lambda kernel, *a, **kw: real(kernel, *a, **kw) + ((64, 128, 100),))
        findings = contracts.check_contracts(shapes=((m, n, k, 1),), dtypes=("bfloat16",))
        assert {f.context for f in findings.findings if f.rule == "KC302"} >= {
            "tile:PALLAS_NT:NT:96x160x224x1:bfloat16:64x128x100"}
        return
    if seed == "split":  # a plan whose splits leave the last one empty
        plans = matmul_nn.nn_plans(m, n, k, torch.bfloat16)
        (cfg, (variant, bn, splits, per)) = next(p for p in plans if p[1][2] > 1)
        monkeypatch.setattr(tiling.matmul_nn, "nn_plans", lambda *a: (
            (cfg, (variant, bn, splits + 1, per)),))
        detail = "does not cover k"
    else:  # an instance past one block's shared memory
        monkeypatch.setattr(tiling, "wgmma_smem_bytes", lambda bn: tiling.SMEM_PER_BLOCK + 1)
        cfg = tiling.default_config("matmul_nn", m, n, k, 2)
        detail = "shared memory"
    problems = contracts.plan_problems("matmul_nn", m, n, k, 2, 1, [cfg])
    assert len(problems) == 1 and detail in problems[0][1], problems


def test_every_enumerated_plan_passes_kc302_on_a_wide_grid():
    from repro_torch.kernels import tiling

    for kernel in tiling.TUNABLE_KERNELS:
        for m, n, k, g in contracts.SHAPE_GRID + sanitize.ROUTE_SHAPES + (
                (1, 49152, 576, 1), (4096, 4096, 4096, 1), (3, 1000, 256, 24)):
            for dsize in (2, 4):
                configs = [c for c, _ in tiling.tile_plans(kernel, m, n, k, dsize, g)]
                assert contracts.plan_problems(kernel, m, n, k, dsize, g, configs) == [], (
                    kernel, m, n, k, dsize)


# -- numerics pass -------------------------------------------------------------------


def test_the_cuda_sources_and_plain_routes_lint_clean():
    from repro_torch.analysis.cache import SourceCache

    cache = SourceCache()
    findings = numerics.run(REPO_ROOT, cache=cache)
    assert findings == [], [f.render() for f in findings]
    assert cache.misses == len(numerics.cuda_sources(REPO_ROOT)) >= 9


def _source(name):
    return open(os.path.join(CSRC, name)).read()


@pytest.mark.parametrize("name,mutation,count", [
    # every wgmma of hopper.cuh accumulating in bf16
    ("hopper.cuh", (".f32.bf16.bf16 ", ".bf16.bf16.bf16 "), 5),
    # the flash kernel's three register-A wgmmas
    ("attention_fused.cu", (".f32.bf16.bf16 ", ".f16.bf16.bf16 "), 3),
    # mma.sync's C type, and its outputs in integer registers
    ("common.cuh", (".bf16.bf16.f32 ", ".bf16.bf16.bf16 "), 1),
    ("common.cuh", ('"+f"(d[0])', '"+r"(d[0])'), 1),
])
def test_nm401_sees_every_mma_string_of_the_sources(name, mutation, count):
    text = _source(name)
    assert mutation[0] in text
    findings = numerics.lint_cuda_source(name, name, text.replace(mutation[0], mutation[1]))
    assert [f.rule for f in findings] == ["NM401"] * count, [f.render() for f in findings]


@pytest.mark.parametrize("name,mutation,helper", [
    # the NT kernel's mma.sync accumulators, through common.cuh's mma_bf16
    ("matmul_nt.cu", ("float acc[NA][4];", "__nv_bfloat16 acc[NA][4];"), "mma_bf16"),
    # the NN kernel's wgmma accumulators, through hopper.cuh's wgmma_bf16
    ("matmul_nn.cu", ("float acc[BN / 2];", "T acc[BN / 2];"), "wgmma_bf16"),
])
def test_nm402_follows_the_mma_helpers_of_the_headers(name, mutation, helper):
    text = _source(name)
    assert text.count(mutation[0]) == 1
    helpers = set()
    for path, _ in numerics.cuda_sources(REPO_ROOT):
        helpers |= numerics._mma_helpers(numerics.strip_comments(open(path).read()))
    assert {"mma_bf16", "wgmma_bf16", "wgmma_rs"} <= helpers
    findings = numerics.lint_cuda_source(name, name, text.replace(*mutation), sorted(helpers))
    assert findings and {f.context for f in findings} == {f"accum:{name}:acc:{helper} D"}


SEEDED_CU = {
    "NM401": """
        __device__ void mma_h(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
          asm volatile("mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.f16 {%0, %1}, "
                       "{%2, %3, %4, %5}, {%6, %7}, {%0, %1};\\n"
                       : "+r"(d[0]), "+r"(d[1])
                       : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
        }
    """,
    "NM402": """
        template <typename T>
        __global__ void k(const float* __restrict__ x, T* out, int n) {
          __shared__ __nv_bfloat16 part[32];
          float good = 0.f;
          T sum = T(0);
          for (int i = 0; i < n; i += 32) {
            sum += x[i];
            part[i % 32] += __float2bfloat16(1.f) ;
            good = fmaf(x[i], x[i], good);
          }
          out[0] = sum;
        }
    """,
    "NM403": """
        __global__ void k(const float* x, __nv_bfloat16* out, float* f) {
          float acc = 0.f;
          acc += __bfloat162float(__float2bfloat16(x[0])) ;
          const __nv_bfloat16 h = __float2bfloat16(x[1]);
          f[0] = acc * h;
          f[1] = static_cast<__nv_bfloat16>(x[2]) + acc;
          out[0] = __float2bfloat16(acc);  // a store: fine
        }
    """,
}


@pytest.mark.parametrize("rule", sorted(SEEDED_CU))
def test_each_numerics_rule_fires_on_a_seeded_snippet(rule, tmp_path):
    path = tmp_path / "seeded.cu"
    path.write_text(textwrap.dedent(SEEDED_CU[rule]))
    findings = numerics.lint_cuda_source(str(path), "seeded.cu")
    got = sorted(f.rule for f in findings)
    want = {"NM401": ["NM401", "NM401"], "NM402": ["NM402", "NM402"],
            "NM403": ["NM403", "NM403"]}[rule]
    if rule == "NM402":  # sum is a template type; part a bf16 tile (and fed a downcast)
        assert {f.context for f in findings if f.rule == "NM402"} == {
            "accum:seeded.cu:sum:+=", "accum:seeded.cu:part:+="}
        got = [r for r in got if r == "NM402"]
    assert got == want, [f.render() for f in findings]


def test_numerics_flags_a_plain_route_that_multiplies_bf16(seeded):
    def _bf16_plain(a, b, block=None):  # no upcast: a bf16 product
        return torch.matmul(a, b.t())

    seeded("_NM_LEAK", _bf16_plain, sim_algo="NT_DIRECT", ops=("NT",), tunable=True,
           kernel="matmul_nt")
    findings = numerics.check_plain_routes(shapes=((96, 160, 224, 1),))
    contexts = sorted(f.context for f in findings)
    # the default plan and the top of the autotune list, each on the bf16 product
    assert len(contexts) == 2 and all(c.startswith("numerics:_NM_LEAK:NT:96x160x224x1:")
                                      and c.endswith(":plain") for c in contexts), contexts
    assert "numerics:_NM_LEAK:NT:96x160x224x1:default:plain" in contexts
    assert all("aten.mm on bfloat16/bfloat16" in f.message for f in findings)


def test_numerics_flags_cublas_reduced_precision_reduction(monkeypatch):
    assert numerics.check_backend_flags(REPO_ROOT) == []
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction",
                        True)
    (f,) = numerics.check_backend_flags(REPO_ROOT)
    assert f.rule == "NM401" and f.path == "src/repro_torch/__init__.py" and f.line > 1


# -- the poison sanitizer --------------------------------------------------------------


def test_sanitizer_is_clean_on_the_plain_routes():
    report = sanitize.sanitize_candidates(shapes=sanitize.grid(full=True), repo_root=REPO_ROOT)
    assert report.findings == [], [f.render() for f in report.findings[:10]]
    mine = {(n, op) for n, c in pcand.CANDIDATES.items() for op in c.ops}
    assert set(report.pairs) == mine | {("transpose", "T")}
    assert report.runs == 4 * report.cells and report.leaks == 0
    assert report.allocations == 0  # no allocator replay on the CPU


@pytest.mark.parametrize("where", ["tail", "head"])
def test_sanitizer_detects_a_seeded_read_past_the_view(seeded, where):
    from repro_torch.kernels import ref

    def _leak(a, b, block=None):
        # one element beyond the view: its last row runs on into the tail
        # (or its first starts in the head); 0 * x hides a finite x only
        m, k = a.shape
        off = a.storage_offset() + (0 if where == "tail" else -1)
        wide = a.as_strided((m, k + 1), (k, 1), off)
        return ref.matmul_nt(a, b) + (0.0 * wide.float().sum()).to(a.dtype)

    seeded("_PAD_LEAK", _leak, sim_algo="NT_DIRECT", ops=("NT",))
    report = sanitize.sanitize_candidates(shapes=((33, 31, 17, 1),), dtypes=("float32",),
                                          candidates=("_PAD_LEAK",))
    assert {f.context for f in report.findings} == {
        f"sanitize:_PAD_LEAK:NT:33x31x17x1:float32:default:{p}"
        for p in sanitize.DEFAULT_POISONS}
    assert report.leaks == 3 and all(f.rule == "NM404" for f in report.findings)


def test_sanitizer_detects_a_read_into_the_next_row(seeded):
    """A read past a row's end that lands in the next row's real data is
    finite, so no poison shows it; the f64 oracle does."""
    from repro_torch.kernels import ref

    def _skew(a, b, block=None):
        m, k = a.shape
        wide = a.as_strided((m - 1, k + 1), (k, 1), a.storage_offset())
        out = ref.matmul_nt(a, b)
        out[:m - 1] += wide[:, k:]  # each row's element k: the next row's first
        return out

    seeded("_ROW_SKEW", _skew, sim_algo="NT_DIRECT", ops=("NT",))
    report = sanitize.sanitize_candidates(shapes=((9, 7, 5, 1),), dtypes=("float32",),
                                          candidates=("_ROW_SKEW",))
    assert [f.context for f in report.findings] == [
        "sanitize:_ROW_SKEW:NT:9x7x5x1:float32:default:oracle"]


def test_lint_cli_runs_every_pass_and_the_sanitizer(capsys):
    from repro_torch.analysis.lint import PASSES, RULE_SECTIONS, main

    assert PASSES == ("dispatch", "registry", "artifacts", "contracts", "coverage", "numerics",
                      "concurrency")
    sections = {title: rules for title, _, rules in RULE_SECTIONS}
    assert sections["Artifact schemas"] == ("AR201", "AR202", "AR203", "AR204")
    assert sections["Kernel contracts"] == ("KC301", "KC302")
    assert sections["Numerics accumulation"] == ("NM401", "NM402", "NM403", "NM404")
    assert all(r in RULES for rules in sections.values() for r in rules)
    assert main(["--passes", "artifacts", "--sanitize", "--stats"]) == 0
    out = capsys.readouterr().out
    assert "pass sanitize:" in out and "[artifacts, sanitize]: 0 error(s)" in out


# -- on the card ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_sanitizer_on_the_card_finds_no_leak_over_every_plan(cuda):
    report = sanitize.sanitize_candidates(shapes=sanitize.grid(full=True), device=str(cuda),
                                          repo_root=REPO_ROOT)
    assert report.findings == [], [f.render() for f in report.findings[:20]]
    assert report.cells > 200 and report.runs == 4 * report.cells and report.leaks == 0
    assert report.allocations > 0 and report.unpoisoned == 0


# two bugs seeded into csrc/matmul.cu's FMA kernel, which the f32 NT and NN
# wrappers launch for unaligned k (129 x 127 x 65)
MUTATIONS = {
    # the A tile's k guard dropped: each row's load runs on into the next
    # row, and the last row's past the view; B's guarded zeros multiply it,
    # which hides a finite value and not a poisoned one
    "a_k_guard": ("a_s[kk][i] = (gm < m && gk < k)", "a_s[kk][i] = (gm < m)"),
    # the store reads C, fresh torch.empty memory, before writing it
    "reads_c": ("c[static_cast<size_t>(gm) * n + gn] = repro::from_float<T>(acc[i][j]);",
                "c[static_cast<size_t>(gm) * n + gn] = repro::from_float<T>(acc[i][j] + 0.f * "
                "repro::to_float(c[static_cast<size_t>(gm) * n + gn]));"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_sanitizer_on_the_card_catches_a_bug_seeded_into_a_kernel(cuda, mutation, tmp_path):
    """A copy of the package in a temporary directory, one kernel source
    broken, its library rebuilt there (the others copied): the sanitizer
    finds every poison leaking through both f32 wrappers."""
    import shutil

    from repro_torch.kernels import _build

    _build.build_all()
    src = tmp_path / "src"
    shutil.copytree(os.path.join(REPO_ROOT, "src", "repro_torch"), src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = src / "repro_torch" / "csrc" / "matmul.cu"
    old, new = MUTATIONS[mutation]
    assert cu.read_text().count(old) == 1
    cu.write_text(cu.read_text().replace(old, new))
    build = tmp_path / "build"
    build.mkdir()
    for lib in _build.build_dir().glob("lib*.so"):
        shutil.copy(lib, build)
    code = ("import json; from repro_torch.analysis import sanitize; "
            "r = sanitize.sanitize_candidates(shapes=sanitize.DEFAULT_SHAPES, "
            "dtypes=('float32',), candidates=('PALLAS_NT', 'PALLAS_NN'), device='cuda'); "
            "print(json.dumps({'leaks': r.leaks, 'unpoisoned': r.unpoisoned, "
            "'contexts': sorted(f.context for f in r.findings)}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env={**os.environ, "PYTHONPATH": str(src),
                                            "REPRO_TORCH_BUILD_DIR": str(build)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["contexts"] == sorted(
        f"sanitize:{name}:{op}:129x127x65x1:float32:64x64x32:{p}"
        for name, op in (("PALLAS_NT", "NT"), ("PALLAS_NN", "NN"))
        for p in sanitize.DEFAULT_POISONS), out
    assert out["leaks"] == 6 and out["unpoisoned"] == 0


@pytest.mark.gpu
def test_sanitizer_on_the_card_detects_a_read_of_an_unwritten_output(cuda, seeded):
    """A candidate that reads its fresh ``torch.empty`` output before it
    writes it: right on zero-filled memory, NaN on the replayed poison."""
    def _stale(a, b, block=None):
        c = torch.empty((a.shape[0], b.shape[0]), dtype=a.dtype, device=a.device)
        c += torch.matmul(a.float(), b.float().t()).to(a.dtype)
        return c

    seeded("_STALE_OUT", _stale, sim_algo="NT_DIRECT", ops=("NT",), tunable=True,
           kernel="matmul_nt")
    report = sanitize.sanitize_candidates(shapes=sanitize.DEFAULT_SHAPES,
                                          dtypes=("float32",), candidates=("_STALE_OUT",),
                                          device=str(cuda))
    leaked = {f.context.rsplit(":", 1)[-1] for f in report.findings}
    assert leaked == set(sanitize.DEFAULT_POISONS), [f.render() for f in report.findings]
    assert report.allocations > 0 and report.unpoisoned == 0


@pytest.mark.gpu
def test_sanitizer_on_the_card_detects_a_read_past_the_view(cuda, seeded):
    def _leak(a, b, block=None):
        m, k = a.shape
        wide = a.as_strided((m, k + 1), (k, 1), a.storage_offset())
        return (torch.matmul(a.float(), b.float().t())
                + 0.0 * wide.float().sum()).to(a.dtype)

    seeded("_PAD_LEAK", _leak, sim_algo="NT_DIRECT", ops=("NT",))
    report = sanitize.sanitize_candidates(shapes=sanitize.DEFAULT_SHAPES, dtypes=("bfloat16",),
                                          candidates=("_PAD_LEAK",), device=str(cuda))
    assert report.leaks == len(sanitize.DEFAULT_POISONS), [f.render() for f in report.findings]
