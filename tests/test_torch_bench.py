"""The port's benchmarks and examples (``repro_torch.benchmarks``,
``repro_torch.examples``) on the CPU, against the JAX package's
``benchmarks/`` where both read one dataset.

Every benchmark runs at a tiny grid and returns the JAX package's keys.
Figs. 2-3, Table IV and Table VIII read one measurement cache (numpy
timings from seed 0, NT records of {2^7..2^9}^3): the port builds its
dataset from the file, the JAX package's ``dataset_from_measurements``
builds its own, and the numbers must be equal.  No device time exists on
the CPU, and none is reported.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import benchmarks.paper_figures as jfigs  # noqa: E402
import benchmarks.paper_tables as jtables  # noqa: E402
from repro.core import measure as jmeasure  # noqa: E402
from repro.core.dataset import dataset_from_measurements as j_dataset  # noqa: E402
from repro_torch.benchmarks import (  # noqa: E402
    beyond_paper,
    common,
    kernel_sweep,
    paper_figures,
    paper_tables,
    policy_overhead,
    run,
)
from repro_torch.examples import collect_and_train_selector, quickstart  # noqa: E402

PAIR = common.CARD_PAIR
CANDS = {"NT": ("XLA_NT", "XLA_TNN", "PALLAS_NT", "PALLAS_TNN", "PALLAS_TNN_FUSED"),
         "NN": ("XLA_NN", "PALLAS_NN"), "TN": ("XLA_TN", "PALLAS_TN")}
TILES = {"PALLAS_NT": "64x128x64", "PALLAS_TNN": "128x128x64", "PALLAS_TNN_FUSED": "128x256x64",
         "PALLAS_NN": "128x64x64", "PALLAS_TN": "128x192x64"}


@pytest.fixture(scope="module")
def cache_path(tmp_path_factory):
    """A v5 cache of the port's candidates on this host, f32, over
    {2^7..2^9}^3: times from a seeded roofline-ish model with noise, so
    both arms of each pair win somewhere; kernel candidates also carry a
    tile key."""
    rng = np.random.RandomState(0)
    entries = {}
    for op, names in CANDS.items():
        for a in range(7, 10):
            for b in range(7, 10):
                for c in range(7, 10):
                    m, n, k = 2**a, 2**b, 2**c
                    base = 2.0 * m * n * k / 1e12 + 5e-6
                    times = {}
                    for name in names:
                        t = base * rng.uniform(0.6, 1.6)
                        times[name] = {"default": t}
                        if name in TILES:
                            times[name][TILES[name]] = t * rng.uniform(0.8, 1.2)
                    entries[f"cpu|host_cpu|float32|{op}|1|{m}|{n}|{k}"] = times
    path = tmp_path_factory.mktemp("bench") / "cache.json"
    path.write_text(json.dumps({"schema_version": 5, "entries": entries}))
    return str(path)


@pytest.fixture(autouse=True)
def no_files(monkeypatch):
    """Results are returned, not written: every save_json is a no-op."""
    for mod in (paper_figures, paper_tables, beyond_paper, policy_overhead, jfigs, jtables):
        monkeypatch.setattr(mod, "save_json", lambda *a, **k: None)
    common._GRIDS.clear()


@pytest.fixture
def jax_dataset(cache_path, monkeypatch):
    """Make the JAX package's benchmarks read the NT records of the same
    cache, through its own dataset_from_measurements."""
    jcache = jmeasure.MeasurementCache.load(cache_path)
    nt = jmeasure.MeasurementCache()
    for key, times in jcache.records():
        if key[3] == "NT":
            nt.put(key, times)
    ds = j_dataset(nt, pair=PAIR, dtype="float32")
    for mod in (jfigs, jtables):
        monkeypatch.setattr(mod, "analytic_dataset", lambda full=False: ds)
    return ds


KW = dict(device="cpu", dtype="float32")


def test_fig2_matches_the_reference_on_one_dataset(cache_path, jax_dataset):
    mine = paper_figures.fig2_winner_map(cache=cache_path, **KW)
    theirs = jfigs.fig2_winner_map()
    assert {k: mine[k] for k in theirs} == theirs
    assert mine["source"] == "measured" and mine["analytic"]["source"] == "analytic"
    assert set(mine["analytic"]) >= set(theirs)


def test_fig3_matches_the_reference_on_one_dataset(cache_path, jax_dataset):
    mine = paper_figures.fig3_tnn_vs_nt(cache=cache_path, **KW)
    theirs = jfigs.fig3_tnn_vs_nt()
    assert {hw: {k: mine[hw][k] for k in row} for hw, row in theirs.items()} == theirs
    assert mine["host_cpu"]["source"] == "measured"
    assert mine["h100"]["source"] == "analytic" and set(mine["h100"]) >= set(theirs["host_cpu"])


def test_table4_matches_the_reference_on_one_dataset(cache_path, jax_dataset):
    mine = paper_tables.table4_cv(cache=cache_path, **KW)
    theirs = jtables.table4_cv()
    assert {k: mine[k] for k in theirs} == theirs


def test_table8_matches_the_reference_on_one_dataset(cache_path, jax_dataset):
    mine = paper_tables.table8_selection(cache=cache_path, **KW)
    theirs = jtables.table8_selection()
    assert {k: mine[k] for k in theirs} == theirs


def test_fig1_returns_the_reference_keys_per_arm(cache_path):
    """The JAX package's measured arm times its host; the keys of each arm
    are compared."""
    mine = paper_figures.fig1_nn_vs_nt(cache=cache_path, **KW)
    assert set(mine["h100"]) >= {"hist", "frac_nn_wins", "frac_ge2"}
    assert mine["h100"]["source"] == "analytic"
    assert set(mine["measured"]) >= {"hist", "frac_nn_wins", "frac_ge2"}
    assert mine["measured"]["source"] == "measured" and mine["measured"]["n"] == 27
    assert set(mine["measured_nt_over_tnn"]["hist"]) == set(common.hist([1.0]))


def test_table6_and_fig4_return_the_reference_keys(cache_path, jax_dataset):
    t6 = paper_tables.table6_classifiers(cache=cache_path, **KW)
    theirs = jtables.table6_classifiers()
    assert set(t6) - {"_meta"} == set(theirs)
    for kind, row in theirs.items():
        assert set(t6[kind]) == set(row)
        assert t6[kind]["accuracy"] == row["accuracy"]  # one split, one seed
    f4 = paper_tables.fig4_train_size(cache=cache_path, **KW)
    j4 = jtables.fig4_train_size()
    assert {k: f4[k] for k in j4} == j4


def test_kway_returns_the_reference_keys(cache_path):
    out = beyond_paper.kway_selector(cache=cache_path, **KW)
    assert set(out) >= {"rows", "kway_report", "speedup_vs_xla"}
    assert set(out["rows"]) == {"always_xla_nt", "paper_binary_mtnn", "kway_regressor", "oracle"}
    assert out["kway_report"]["candidates"] == list(beyond_paper.NT_CANDIDATES)
    assert out["rows"]["kway_regressor"] >= 1.0


def test_blocksweep_rows_per_config():
    out = beyond_paper.kernel_block_sweep(device="cpu", shapes=((128, 96, 128),), reps=1)
    from repro_torch.kernels import tiling

    want = len(tiling.enumerate_tile_configs("matmul_nn", 128, 96, 128, 2)) + len(
        tiling.enumerate_tile_configs("matmul_tnn_fused", 128, 96, 128, 2))
    assert len(out["rows"]) == want
    assert sum(r["default"] for r in out["rows"]) == 2
    for row in out["rows"]:
        assert set(row) >= {"shape", "block", "smem_kib", "ai", "t_model_ms", "t_measured_ms"}
        assert 0 < row["smem_kib"] * 1024 <= 227 * 1024  # one Hopper block's most
    assert out["measured"].startswith("the plain version")


def test_policy_overhead_returns_the_reference_keys():
    out = policy_overhead.policy_overhead(**KW)
    for name in ("FixedPolicy", "ModelPolicy(binary)", "AnalyticPolicy", "CascadePolicy",
                 "AutotunePolicy(cold=measure)", "AutotunePolicy(warm-cache)"):
        assert set(out[name]) >= {"cold_ms", "warm_ms"}, name
    assert out["AutotunePolicy(warm-cache)"]["measured_shapes"] == 0
    assert out["AutotunePolicy(cold=measure)"]["measured_shapes"] == 27
    assert all(f"AnalyticPolicy[{op}]" in out for op in ("NT", "NN", "TN", "BNT", "BNN", "ATTN"))
    assert "_key_construction_overhead_ratio" in out
    assert all(row["device_ms"] is None for row in out["_dense_step_ms"].values())


def test_kernel_sweep_quick_finds_no_mismatch_against_f64():
    payload = kernel_sweep.sweep(shapes=kernel_sweep.QUICK_SHAPES[:2],
                                 batched=kernel_sweep.QUICK_BATCHED,
                                 attn=kernel_sweep.QUICK_ATTN[1:], dtypes=("bfloat16",),
                                 max_tile_configs=2, reps=1, device="cpu", verbose=False)
    rows = payload["rows"]
    assert rows and all(r["device_us"] is None and r["queued_us"] is None
                        and r["library_device_us"] is None for r in rows)
    assert {r["op"] for r in rows} == {"NT", "NN", "TN", "BNT", "BNN", "ATTN"}
    assert any(r["config"] != "default" for r in rows)
    assert all(r["rel_err"] < 1e-2 for r in rows)


def test_kernel_sweep_fails_on_a_wrong_kernel(monkeypatch):
    from repro_torch.kernels import ref

    monkeypatch.setattr(ref, "matmul_nn", lambda a, b: torch.matmul(a, b) * 1.01)
    with pytest.raises(AssertionError, match="mismatch"):
        kernel_sweep.sweep(shapes=((64, 64, 64),), batched=(), attn=(), dtypes=("float32",),
                           reps=1, device="cpu", verbose=False)


def test_run_harness_on_the_cpu(cache_path):
    assert run.main(["--device", "cpu", "--only", "fig2,table4", "--cache", cache_path]) == 0
    assert set(run.BENCHES) >= {"fig1", "fig2", "fig3", "table4", "table6", "fig4", "table8",
                                "table10", "kway", "policy_overhead", "blocksweep"}
    with pytest.raises(SystemExit):
        run.main(["--device", "cpu", "--only", "nope"])


def test_the_grid_is_measured_once_and_saved(tmp_path):
    path = str(tmp_path / "grid.json")
    first = common.card_cache("float32", "cpu", hi=7, cache=path)
    assert len(first) == 3 and common.card_cache("float32", "cpu", hi=7, cache=path) is first
    common._GRIDS.clear()
    again = common.card_cache("float32", "cpu", hi=7, cache=path)  # read from the file
    assert again is not first and dict(again.records()) == dict(first.records())


def test_examples_run_on_the_cpu(cache_path, tmp_path):
    out = quickstart.main(["--device", "cpu"])
    assert out["err"] < 1e-4 and out["grad_err"] < 1e-3
    art = tmp_path / "sel.json"
    res = collect_and_train_selector.main(["--from-cache", cache_path, "--dtype", "float32",
                                           "--out", str(art)])
    assert res["records"] == 81 and art.exists()
    payload = json.loads(art.read_text())
    assert payload["tile_tables"] == json.loads(json.dumps(res["tables"]))
    assert payload["tile_tables"]["NT"]["PALLAS_TNN"]["modal"] == TILES["PALLAS_TNN"]
