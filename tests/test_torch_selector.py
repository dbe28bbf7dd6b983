"""The port's selector stack against the JAX package's, on the same numpy
inputs: GBDT training, the analytic cost model, the analytic dataset,
measurement caches and the datasets built from them agree exactly; one
selector artifact gives the same decision names in both packages for all
six ops; the analytic and cascade policies pick the same names.  The
stated difference: the port's decisions carry ``config=None`` (its
candidates pick their own tiles).

A candidate that raises while it is measured fails its measurement: it
is retried, then left out of the result with its error recorded, and
never dispatched; a kernel that does not launch raises out of the
measurement.  On a card too (``gpu`` marker: skipped without CUDA).  jax is imported in a
fixture, so that test also runs where jax is not installed:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_selector.py``
"""

import dataclasses
import itertools
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import candidates as pcand  # noqa: E402
from repro_torch.core import dataset as pdataset  # noqa: E402
from repro_torch.core import engine as pengine  # noqa: E402
from repro_torch.core import gbdt as pgbdt  # noqa: E402
from repro_torch.core import hardware as phw  # noqa: E402
from repro_torch.core import measure as pmeasure  # noqa: E402
from repro_torch.core import policy as ppolicy  # noqa: E402
from repro_torch.core import selector as pselector  # noqa: E402
from repro_torch.core import simulate as psim  # noqa: E402
from repro_torch.core import train_model as ptrain  # noqa: E402
from repro_torch.core.opkey import OpKey  # noqa: E402


@pytest.fixture(scope="module")
def J():
    """The JAX package's side, imported here and not at module top, so the
    ``gpu`` test of this file also runs where jax is not installed."""
    pytest.importorskip("jax")
    from repro.core import candidates, dataset, features, gbdt, hardware, measure, opkey
    from repro.core import policy, selector, simulate, train_model

    return types.SimpleNamespace(cand=candidates, dataset=dataset, features=features,
                                 gbdt=gbdt, hw=hardware, measure=measure, opkey=opkey,
                                 policy=policy, selector=selector, sim=simulate,
                                 train=train_model)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def port_spec(spec) -> phw.HardwareSpec:
    """A port ``HardwareSpec`` with the field values of a reference one."""
    return phw.HardwareSpec(**dataclasses.asdict(spec))


def ref_spec(J, spec):
    return J.hw.HardwareSpec(**dataclasses.asdict(spec))


def op_keys():
    """A grid of OpKeys over all six ops, both element sizes, shapes from
    thin to past the 16 GiB OOM budget; batched ops at g 1 and 12."""
    sizes = (8, 128, 1000, 4096, 40000)
    out = []
    for op in ("NT", "NN", "TN", "BNT", "BNN", "ATTN"):
        gs = (1, 12) if op in ("BNT", "BNN", "ATTN") else (1,)
        for (m, n, k), dsize, g in itertools.product(
                itertools.product(sizes, repeat=3), (2, 4), gs):
            out.append((op, m, n, k, dsize, g))
    return out


def both_keys(J, row):
    return J.opkey.OpKey(*row), OpKey(*row)


# -- GBDT, the cost model and the analytic dataset ------------------------------


@pytest.fixture(scope="module")
def analytic(J):
    return J.dataset.collect_analytic(chips=[J.hw.TPU_V5E], lo=7, hi=11)


def test_gbdt_training_is_identical(J, analytic):
    ds = analytic
    theirs = J.gbdt.GBDTClassifier(n_estimators=8, max_depth=8).fit(ds.X, ds.y)
    mine = pgbdt.GBDTClassifier(n_estimators=8, max_depth=8).fit(ds.X, ds.y)
    assert json.dumps(mine.to_dict(), sort_keys=True) == json.dumps(theirs.to_dict(),
                                                                    sort_keys=True)
    np.testing.assert_array_equal(mine.predict(ds.X), theirs.predict(ds.X))
    reg_t = J.gbdt.GBDTRegressor().fit(ds.X, np.log(ds.times["TNN"]))
    reg_m = pgbdt.GBDTRegressor().fit(ds.X, np.log(ds.times["TNN"]))
    assert reg_m.to_dict() == reg_t.to_dict()


def test_cross_validation_and_selection_metrics_are_identical(J, analytic):
    assert ptrain.kfold_cv(analytic) == J.train.kfold_cv(analytic)
    pred = J.gbdt.GBDTClassifier().fit(analytic.X, analytic.y).predict(analytic.X)
    assert ptrain.selection_metrics(analytic, pred) == J.train.selection_metrics(analytic, pred)


def test_cross_validation_of_one_class_data_reports_the_missing_class_as_nan(analytic):
    """The JAX package's kfold_cv fails on data with one class, as a
    card's dataset can be where one arm wins every shape."""
    one = analytic.subset(np.where(analytic.y == 1)[0])
    cv = ptrain.kfold_cv(one)
    assert cv["total"] == cv["positive"] == {"min": 1.0, "max": 1.0, "avg": 1.0}
    assert all(np.isnan(v) for v in cv["negative"].values())


SIM_ALL = psim.SIM_ALGOS + psim.OP_SIM_ALGOS


@pytest.mark.parametrize("algo", SIM_ALL)
def test_simulate_time_is_identical(J, algo):
    assert SIM_ALL == J.sim.SIM_ALGOS + J.sim.OP_SIM_ALGOS
    mine = port_spec(J.hw.TPU_V5E)
    for (m, n, k), dsize, g, sigma in itertools.product(
            itertools.product((1, 100, 128, 700, 4096, 65536), repeat=3), (2, 4), (1, 24),
            (0.0, 0.03)):
        assert psim.simulate_time(mine, algo, m, n, k, dsize, sigma, g) == \
            J.sim.simulate_time(J.hw.TPU_V5E, algo, m, n, k, dsize, sigma, g)


@pytest.mark.parametrize("chip", ["tpu_v5e", "h100"])
def test_collect_analytic_is_identical(J, chip):
    if chip == "h100":
        mine, theirs = phw.H100, ref_spec(J, phw.H100)
    else:
        mine, theirs = port_spec(J.hw.TPU_V5E), J.hw.TPU_V5E
    a = pdataset.collect_analytic(chips=[mine], lo=7, hi=12)
    b = J.dataset.collect_analytic(chips=[theirs], lo=7, hi=12)
    np.testing.assert_array_equal(a.X, b.X)
    np.testing.assert_array_equal(a.y, b.y)
    np.testing.assert_array_equal(a.mnk, b.mnk)
    assert sorted(a.times) == sorted(b.times)
    for name in a.times:
        np.testing.assert_array_equal(a.times[name], b.times[name])


def test_the_port_knows_the_h100_and_no_tpu():
    assert list(phw.SIMULATED_CHIPS) == ["h100"]
    h = phw.H100
    assert (h.peak_tflops_bf16, h.peak_tflops_f32, h.mem_bw_gbps) == (989.0, 67.0, 3350.0)
    assert phw.device_spec("cpu") == phw.host_spec()
    assert set(phw.known_specs()) >= {"h100", "host_cpu"}


# -- measurement caches and measured datasets -----------------------------------


def _cache_entries(seed=0):
    """Random timings of every op's candidates at a few shapes, keyed as a
    host-CPU measurement."""
    rng = np.random.RandomState(seed)
    out = {}
    for op, cands in (("NT", ("XLA_NT", "XLA_TNN", "PALLAS_NT", "PALLAS_TNN")),
                      ("NN", ("XLA_NN", "PALLAS_NN")), ("TN", ("XLA_TN", "PALLAS_TN")),
                      ("BNT", ("XLA_BNT", "PALLAS_BNT")), ("BNN", ("XLA_BNN", "PALLAS_BNN")),
                      ("ATTN", ("UNFUSED_ATTN", "FUSED_ATTN"))):
        g = 12 if op in ("BNT", "BNN", "ATTN") else 1
        for m, n, k in itertools.product((128, 512, 2048), repeat=3):
            key = ("cpu", "host_cpu", "float32", op, g, m, n, k)
            out[key] = {c: {"default": float(rng.uniform(1e-5, 1e-3))} for c in cands}
    out[("cpu", "host_cpu", "bfloat16", "NT", 1, 64, 64, 64)] = {
        "XLA_NT": {"default": 1e-5}, "XLA_TNN": {"default": 2e-5}}
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_measurement_cache_files_load_in_both_and_give_one_dataset(J, tmp_path, writer):
    path = str(tmp_path / "cache.json")
    w_cls, r_cls = ((J.measure.MeasurementCache, pmeasure.MeasurementCache)
                    if writer == "jax" else
                    (pmeasure.MeasurementCache, J.measure.MeasurementCache))
    cache = w_cls(path)
    for key, times in _cache_entries().items():
        cache.put(key, times)
    cache.save()
    assert json.loads((tmp_path / "cache.json").read_text())["schema_version"] == 5
    back, same = r_cls.load(path), w_cls.load(path)
    assert list(back.records()) == list(same.records())
    mine = pdataset.dataset_from_measurements(
        pmeasure.MeasurementCache.load(path), pair=("XLA_NT", "PALLAS_TNN"))
    theirs = J.dataset.dataset_from_measurements(
        J.measure.MeasurementCache.load(path), pair=("XLA_NT", "PALLAS_TNN"))
    for f in ("X", "y", "mnk", "hw"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f))
    assert sorted(mine.times) == sorted(theirs.times)
    for name in mine.times:
        np.testing.assert_array_equal(mine.times[name], theirs.times[name])
    assert set(np.unique(mine.X[:, 8])) == {0.0, 1.0, 2.0, 3.0, 4.0, 5.0}


def test_measure_candidates_times_each_candidate_once_under_default():
    """Each candidate once under "default", then each config of its
    shortlist once (f32 NT at (96, 80, 64): the split plans of gemm_f32's
    tiled route for the direct and TNN arms; none for the others)."""
    times = pmeasure.measure_candidates(96, 80, 64, op="NT", device="cpu", reps=1)
    assert set(times) == {n for n, c in pcand.CANDIDATES.items() if "NT" in c.ops}
    hw = phw.device_spec(torch.device("cpu"))
    for name, cfgs in times.items():
        shortlist = pcand.get_candidate(name).config_space(96, 80, 64, 4, hardware=hw)
        assert list(cfgs) == ["default", *map(pmeasure.config_key, shortlist)], name
        assert all(t > 0 for t in cfgs.values())
    assert len(times["PALLAS_NT"]) > 1 and list(times["XLA_NT"]) == ["default"]
    attn = pmeasure.measure_candidates(8, 16, 32, op="ATTN", g=3, device="cpu", reps=1,
                                       dtype="bfloat16")
    assert set(attn) == {"UNFUSED_ATTN", "FUSED_ATTN"}


def test_measurement_oom_guard_skips_before_launch():
    tiny = dataclasses.replace(phw.H100, mem_gib=1e-6)
    called = []
    pcand.register_candidate("SPY_TNN", sim_algo="TNN", extra_memory=True)(
        lambda a, b: called.append(1) or a @ b.t())
    try:
        times = pmeasure.measure_candidates(32, 32, 32, hardware=tiny, device="cpu",
                                            candidates=("XLA_NT", "XLA_TNN", "SPY_TNN"))
    finally:
        pcand.unregister_candidate("SPY_TNN")
    assert set(times) == {"XLA_NT"} and not called


BOOM_CALLS = []


def _boom(a, b):
    BOOM_CALLS.append(1)
    pcand.get_candidate("PALLAS_NT").run(a, b)
    raise RuntimeError("kernel fault")


def _launch_refused(a, b):
    from repro_torch.kernels._build import KernelLaunchError

    raise KernelLaunchError("repro_matmul_nt failed to launch: kernel fault (cudaError 1)")


def _measure_with_a_failing_candidate(device):
    """A candidate that raises fails the measurement at its first try --
    never retried, never dropped in favour of the library arm; only an
    injected fault is retried and then left out."""
    from repro_torch.core.faults import inject_faults

    pcand.register_candidate("BOOM_NT", sim_algo="NT_DIRECT")(_boom)
    pcand.register_candidate("REFUSED_NT", sim_algo="NT_DIRECT")(_launch_refused)
    try:
        BOOM_CALLS.clear()
        attempts, failures = {}, {}
        with pytest.raises(RuntimeError, match="kernel fault"):
            pmeasure.measure_candidates(64, 64, 64, device=device,
                                        candidates=("XLA_NT", "BOOM_NT"), retries=2,
                                        retry_backoff_s=0.001, attempts=attempts,
                                        failures=failures)
        assert len(BOOM_CALLS) == 1 and not failures
        pol = ppolicy.AutotunePolicy(candidates=("XLA_NT", "BOOM_NT"), device=device)
        with pytest.raises(RuntimeError, match="kernel fault"):
            pol.select(OpKey("NT", 64, 64, 64, 4))
        assert len(pol.cache) == 0 and not pol.failures
        with pytest.raises(RuntimeError, match="kernel fault"):
            pmeasure.measure_candidates(64, 64, 64, device=device,
                                        candidates=("XLA_NT", "REFUSED_NT"))
        with inject_faults("raise:measure:cand=PALLAS_NT"):
            times = pmeasure.measure_candidates(64, 64, 64, device=device, tune=False,
                                                candidates=("XLA_NT", "PALLAS_NT"), retries=2,
                                                retry_backoff_s=0.001, attempts=attempts,
                                                failures=failures)
        assert set(times) == {"XLA_NT"} and attempts == {"XLA_NT": {"default": 1}}
        assert failures == {"PALLAS_NT": {"default": "InjectedFault: injected raise fault: "
                                                     "measurement of PALLAS_NT on op NT"}}
    finally:
        pcand.unregister_candidate("BOOM_NT")
        pcand.unregister_candidate("REFUSED_NT")


def test_a_candidate_that_raises_fails_the_measurement():
    _measure_with_a_failing_candidate("cpu")


@pytest.mark.gpu
def test_a_candidate_that_raises_on_the_card_fails_the_measurement(cuda):
    _measure_with_a_failing_candidate(cuda)
    times = pmeasure.measure_candidates(64, 64, 64, device=cuda)
    assert "PALLAS_NT" in times and "PALLAS_TNN" in times


def test_every_port_candidate_runs_on_both_platforms():
    """The selectors memoise per OpKey with no platform in the key; that
    holds while every candidate runs on the CPU and on the card."""
    for name, cand in pcand.CANDIDATES.items():
        assert set(cand.platforms) == {"cpu", "gpu"}, name


def test_candidate_fields_match_the_jax_registry(J):
    for name, cand in pcand.CANDIDATES.items():
        ref = J.cand.get_candidate(name)
        assert (cand.sim_algo, cand.distributed_safe, cand.extra_memory, cand.ops,
                cand.tunable, cand.arity, cand.config_arity) == \
            (ref.sim_algo, ref.distributed_safe, ref.extra_memory, ref.ops, ref.tunable,
             ref.arity, ref.config_arity), name
    assert set(pcand.CANDIDATES) == set(J.cand.CANDIDATES)


# -- one artifact, both packages --------------------------------------------------


def _binary_selector(J):
    """A reference binary selector trained on op-varied records: each
    (op, shape) labelled by the cost model's arms of its op's pair."""
    pairs = {"NT": ("NT_DIRECT", "TNN"), "NN": ("NN_DIRECT", "NN_DIRECT"),
             "TN": ("TN_DIRECT", "TN_VIA_NN"), "BNT": ("BNT_DIRECT", "NT_DIRECT"),
             "BNN": ("BNN_DIRECT", "NN_DIRECT"), "ATTN": ("ATTN_UNFUSED", "ATTN_FUSED")}
    hw = J.hw.TPU_V5E
    X, y = [], []
    for op, (m, n, k), g in itertools.product(
            pairs, itertools.product((128, 1024, 8192), repeat=3), (1, 8)):
        if g > 1 and op in ("NT", "NN", "TN"):
            continue
        t = [J.sim.simulate_time(hw, a, m, n, k, 2, 0.03, g) for a in pairs[op]]
        X.append(J.features.make_features(hw, m, n, k, op=op, g=g))
        y.append(1 if t[0] <= t[1] else -1)
    clf = J.gbdt.GBDTClassifier().fit(np.array(X), np.array(y))
    return J.selector.MTNNSelector(
        clf, hardware=hw, binary_pair=("XLA_NT", "PALLAS_TNN"),
        tile_tables={"NT": {"PALLAS_TNN": {"modal": "128x128x128",
                                           "by_shape": {"128x128x128": "64x64x64"}}}})


def _kway_selector(J, analytic):
    model, _ = J.train.train_kway_model(analytic, n_estimators=4, max_depth=4)
    return J.selector.MTNNSelector(model, hardware=J.hw.TPU_V5E, mode="kway")


@pytest.mark.parametrize("mode", ["binary", "kway"])
def test_one_artifact_gives_the_same_decisions_in_both(J, analytic, tmp_path, mode):
    sel = _binary_selector(J) if mode == "binary" else _kway_selector(J, analytic)
    path = str(tmp_path / "sel.json")
    sel.save(path)
    theirs = J.policy.ModelPolicy(J.selector.MTNNSelector.load(path))
    mine = ppolicy.ModelPolicy(pselector.MTNNSelector.load(
        path, hardware=port_spec(J.hw.TPU_V5E)))
    assert mine.selector.binary_pairs == theirs.selector.binary_pairs
    assert mine.selector.tile_tables == theirs.selector.tile_tables
    names = set()
    for row in op_keys():
        jk, pk = both_keys(J, row)
        d = mine.select(pk)
        assert d.name == theirs.select(jk).name, row
        assert d.config is None
        names.add(d.name)
    assert len(names) >= 6
    if mode == "binary":  # the grid reaches both arms of the NT pair
        assert {"XLA_NT", "PALLAS_TNN"} <= names
    assert mine.stats.calls == len(op_keys())


def test_an_artifact_round_trips_and_unknown_hardware_falls_back(J, tmp_path):
    path, again = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    _binary_selector(J).save(path)
    loaded = pselector.MTNNSelector.load(path)
    assert loaded.hardware == phw.H100  # tpu_v5e: no descriptor in the port
    loaded.save(again)
    a, b = (json.loads((tmp_path / name).read_text()) for name in ("a.json", "b.json"))
    a.pop("hardware"), b.pop("hardware")
    assert a == b
    assert loaded.tile_config_for("PALLAS_TNN", 4, "NT", (128, 128, 128)) is None


def test_old_artifact_schemas_migrate_as_in_the_jax_package(J, tmp_path):
    clf = J.gbdt.GBDTClassifier(n_estimators=2, max_depth=2).fit(
        np.eye(10), np.array([1, -1] * 5))
    v0 = {"mode": "binary", "hardware": "tpu_v5e", "model": clf.to_dict(),
          "tile_configs": {"PALLAS_TNN": "128x128x128"}}
    assert pselector._migrate_payload(dict(v0)) == J.selector._migrate_payload(dict(v0))
    path = tmp_path / "new.json"
    path.write_text(json.dumps({**v0, "schema_version": 6}))
    with pytest.raises(ValueError, match="newer"):
        pselector.MTNNSelector.load(str(path))


def test_corrupt_artifact_recovers_to_the_fallback_selector(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text("{not json")
    with pytest.warns(UserWarning, match="unreadable"):
        pol = pengine.policy_from_spec(f"model:{path}")
    assert (tmp_path / "bad.json.corrupt").exists()
    assert pol.selector.hardware == phw.H100
    assert pol.select(OpKey("NT", 64, 64, 64, 2)).name in ("XLA_NT", "XLA_TNN")


def test_selection_is_memoised_per_key(J):
    sel = pselector.MTNNSelector(
        J.gbdt.GBDTClassifier(n_estimators=2, max_depth=2).fit(
            np.eye(10), np.array([1, -1] * 5)))
    calls = []
    predict = sel.model.predict
    sel.model.predict = lambda x: calls.append(1) or predict(x)
    key = OpKey("NT", 64, 128, 256, 2)
    first = [sel.select(key) for _ in range(5)]
    assert len(set(first)) == 1 and len(calls) == 1 and sel.stats.calls == 5


# -- the analytic and cascade policies --------------------------------------------


@pytest.mark.parametrize("chip", ["tpu_v5e", "h100"])
def test_analytic_policy_picks_the_same_names(J, chip):
    if chip == "h100":
        mine_hw, ref_hw = phw.H100, ref_spec(J, phw.H100)
    else:
        mine_hw, ref_hw = port_spec(J.hw.TPU_V5E), J.hw.TPU_V5E
    mine = ppolicy.AnalyticPolicy(hardware=mine_hw)
    theirs = J.policy.AnalyticPolicy(hardware=ref_hw)
    for row in op_keys():
        jk, pk = both_keys(J, row)
        d = mine.select(pk)
        assert d.name == theirs.select(jk).name, row
        assert d.config is None
    assert mine.select(pk) == d  # the memo answers a repeat


@pytest.mark.parametrize("names", [["XLA_TNN", "XLA_NT"], ["PALLAS_TNN", "PALLAS_NT"],
                                   ["PALLAS_TN", "XLA_NT"], ["FUSED_ATTN", "PALLAS_BNT"]])
@pytest.mark.parametrize("distributed", [False, True])
def test_cascade_policy_picks_the_same_names(J, names, distributed):
    mine = ppolicy.CascadePolicy(names, hardware=port_spec(J.hw.TPU_V5E),
                                 distributed=distributed)
    theirs = J.policy.CascadePolicy(names, hardware=J.hw.TPU_V5E, distributed=distributed)
    for row in op_keys():
        jk, pk = both_keys(J, row)
        assert mine.select(pk) == theirs.select(jk), row


def test_autotune_policy_measures_once_and_persists(tmp_path):
    path = str(tmp_path / "tune.json")
    pol = pengine.policy_from_spec(f"autotune:{path}", device="cpu")
    key = OpKey("NT", 48, 40, 32, 4)
    d = pol.select(key)
    assert pol.select(key) == d and pol.n_measured == 1 and d.config is None
    again = pengine.policy_from_spec(f"autotune:{path}", device="cpu")
    assert again.select(key).name == d.name
    assert again.n_measured == 0 and len(again.cache) == 1
    off = ppolicy.AutotunePolicy(measure=False, device="cpu")
    assert off.select(key) == off.fallback.select(key) and off.n_fallbacks == 1
