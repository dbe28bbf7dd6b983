"""The port's fault tolerance against the JAX package's
(``tests/test_faults.py``'s classes): the chaos spec grammar, fault
scoping, the quarantine ledger and its policy integration, the fallback
chains, dispatch degradation, cache and artifact corruption recovery,
measurement retry, and a smoke serve under injected kernel faults.  The
same inputs go to both packages; parsed rules, fallback chains,
quarantine labels, fallback counts and greedy tokens must match exactly.

The port's own rule is pinned too: dispatch degrades only through an
injected fault, and a tile that is not a plan of its route sheds the
tile for the candidate's own plan and no further.  Every other error --
a kernel that does not build or does not launch (``KernelBuildError``,
``KernelLaunchError``), a device allocation failure, a bug -- raises out
of dispatch and of measurement with nothing quarantined, retried or
recorded.
"""

import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.configs.arch import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.arch import BlockCfg as JBlockCfg  # noqa: E402
from repro.core import candidates as jcandidates  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import measure as jmeasure  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.serving import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import engine, faults  # noqa: E402
from repro_torch.core import measure as measure_mod  # noqa: E402
from repro_torch.core.candidates import (  # noqa: E402
    CANDIDATES,
    DEFAULT_BY_OP,
    fallback_chain,
    get_candidate,
)
from repro_torch.core.engine import DispatchError, health_report, run_decision  # noqa: E402
from repro_torch.core.faults import (  # noqa: E402
    FaultRule,
    InjectedFault,
    InjectedOOM,
    InjectedTimeout,
    inject_faults,
    parse_chaos_spec,
)
from repro_torch.core.measure import MeasurementCache, measure_candidates  # noqa: E402
from repro_torch.core.opkey import OPS  # noqa: E402
from repro_torch.core.policy import (  # noqa: E402
    AnalyticPolicy,
    CascadePolicy,
    Decision,
    FixedPolicy,
)
from repro_torch.core.selector import MTNNSelector  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels._build import KernelBuildError, KernelLaunchError  # noqa: E402
from repro_torch.kernels.common import TileConfigError  # noqa: E402
from repro_torch.serving import RequestState, ServeEngine  # noqa: E402
from test_torch_lm import converted_params, to_port_cfg  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_ledger(monkeypatch):
    """Both ledgers are process-global by design (a failed kernel stays
    barred across policies): tests must not leak arms into each other,
    and each test sees the engines' warn-once warnings afresh."""
    monkeypatch.setattr(engine, "_WARNED", set())
    monkeypatch.setattr(jengine, "_WARNED", set())
    faults.clear_quarantine()
    jfaults.clear_quarantine()
    yield
    faults.clear_quarantine()
    jfaults.clear_quarantine()


def _rule_fields(rule):
    return (rule.mode, rule.target, rule.op, rule.p, rule.times, rule.after, rule.seconds,
            rule.seed, rule.cand, rule.is_plane, rule.describe())


def _ledger(mod):
    return [(e.name, e.op, e.config_key, e.label(), e.count) for e in mod.quarantine_entries()]


# -- chaos spec grammar -------------------------------------------------------

SPECS = [
    "raise:PALLAS_*",
    "raise:PALLAS_BNT.BNT",
    "corrupt:cache;delay:XLA_NT:s=0.01;raise:measure:cand=PALLAS_*:times=2:after=1:seed=3",
    "oom:A;timeout:B.NN:p=0.25:seed=9",
    " hang:FUSED_ATTN.ATTN:s=0.5 ; corrupt:artifact ",
    "raise:PALLAS_NT.NT;raise:FUSED_ATTN.ATTN",
]
MALFORMED = ["", "raise", "raise:", ":PALLAS_NT", "bogus:XLA_NT", "raise:XLA_NT:p=notafloat",
             "raise:XLA_NT:frobnicate=1", "raise:XLA_NT:times", "raise:.NT",
             "raise:XLA_NT:p=1.5"]


class TestChaosSpec:
    @pytest.mark.parametrize("spec", SPECS)
    def test_rules_match_the_jax_package(self, spec):
        mine, theirs = parse_chaos_spec(spec), jfaults.parse_chaos_spec(spec)
        assert [_rule_fields(r) for r in mine] == [_rule_fields(r) for r in theirs]

    def test_single_clause(self):
        (rule,) = parse_chaos_spec("raise:PALLAS_*")
        assert rule.mode == "raise"
        assert rule.target == "PALLAS_*" and rule.op == "*"
        assert rule.p == 1.0 and rule.times is None and rule.after == 0

    def test_op_qualified_target(self):
        (rule,) = parse_chaos_spec("raise:PALLAS_BNT.BNT")
        assert rule.target == "PALLAS_BNT" and rule.op == "BNT"
        assert rule.matches("PALLAS_BNT", "BNT")
        assert not rule.matches("PALLAS_BNT", "BNN")

    @pytest.mark.parametrize("spec", MALFORMED)
    def test_malformed_specs_raise_the_jax_packages_error(self, spec):
        with pytest.raises(ValueError, match="chaos|outside") as mine:
            parse_chaos_spec(spec)
        with pytest.raises(ValueError) as theirs:
            jfaults.parse_chaos_spec(spec)
        assert str(mine.value) == str(theirs.value)

    def test_times_and_after_fire_as_in_the_jax_package(self):
        (rule,) = parse_chaos_spec("raise:XLA_NT:times=2:after=1")
        (jrule,) = jfaults.parse_chaos_spec("raise:XLA_NT:times=2:after=1")
        fired = [rule.should_fire() for _ in range(5)]
        assert fired == [False, True, True, False, False]
        assert fired == [jrule.should_fire() for _ in range(5)]

    def test_seeded_probability_draws_as_in_the_jax_package(self):
        (rule,) = parse_chaos_spec("raise:XLA_NT:p=0.5:seed=7")
        (jrule,) = jfaults.parse_chaos_spec("raise:XLA_NT:p=0.5:seed=7")
        draws = [rule.should_fire() for _ in range(20)]
        assert draws == [jrule.should_fire() for _ in range(20)]
        assert any(draws) and not all(draws)


# -- fault scoping ------------------------------------------------------------


class TestInjectFaults:
    def test_raise_inside_scope_only(self):
        faults.check_candidate_fault("PALLAS_NT", "NT")  # no-op outside any scope
        with inject_faults("raise:PALLAS_NT"):
            with pytest.raises(InjectedFault, match="candidate PALLAS_NT on op NT"):
                faults.check_candidate_fault("PALLAS_NT", "NT")
            faults.check_candidate_fault("XLA_NT", "NT")  # glob excludes
        faults.check_candidate_fault("PALLAS_NT", "NT")  # scope exited

    def test_oom_and_timeout_modes(self):
        with inject_faults("oom:A;timeout:B"):
            with pytest.raises(InjectedOOM):
                faults.check_candidate_fault("A", "NT")
            with pytest.raises(InjectedTimeout):
                faults.check_candidate_fault("B", "NT")

    def test_nested_scopes_compose(self):
        with inject_faults("raise:A"):
            with inject_faults("raise:B"):
                assert len(faults.active_faults()) == 2
                for name in ("A", "B"):
                    with pytest.raises(InjectedFault):
                        faults.check_candidate_fault(name, "NT")
            assert len(faults.active_faults()) == 1
            faults.check_candidate_fault("B", "NT")

    def test_delay_sleeps(self):
        with inject_faults("delay:SLOW:s=0.02"):
            t0 = time.perf_counter()
            faults.check_candidate_fault("SLOW", "NT")
            assert time.perf_counter() - t0 >= 0.015

    def test_corrupt_on_read_mangles_as_the_jax_package_does(self):
        data = b'{"schema_version": 5, "entries": {}}'
        assert faults.corrupt_on_read("cache", data) == data
        with inject_faults("corrupt:cache"), jfaults.inject_faults("corrupt:cache"):
            mangled = faults.corrupt_on_read("cache", data)
            assert mangled == jfaults.corrupt_on_read("cache", data)
            assert mangled != data and len(mangled) < len(data)
            with pytest.raises(ValueError):
                json.loads(mangled.decode("utf-8", errors="replace"))
            assert faults.corrupt_on_read("artifact", data) == data  # other plane

    def test_accepts_rule_objects(self):
        rule = FaultRule(mode="raise", target="X")
        with inject_faults(rule):
            with pytest.raises(InjectedFault):
                faults.check_candidate_fault("X", "NN")
        with inject_faults([rule]):
            assert faults.active_faults() == (rule,)


# -- quarantine ledger --------------------------------------------------------


class TestQuarantine:
    def test_ledger_matches_the_jax_package(self):
        steps = [("PALLAS_NT", "NT", None), ("PALLAS_NT", "NT", None),
                 ("PALLAS_NN", "NN", (128, 128, 64)), ("FUSED_ATTN", "ATTN", (64, 64))]
        for mod in (faults, jfaults):
            e0 = mod.quarantine_epoch()
            for name, op, cfg in steps:
                mod.quarantine(name, op, cfg, RuntimeError("boom"))
            assert mod.quarantine_epoch() - e0 == 3  # a repeat only counts
        assert _ledger(faults) == _ledger(jfaults)
        probes = [("PALLAS_NT", "NT", None), ("PALLAS_NT", "NT", (128, 128, 128)),
                  ("PALLAS_NT", "NN", None), ("PALLAS_NN", "NN", None),
                  ("PALLAS_NN", "NN", (128, 128, 64)), ("FUSED_ATTN", "ATTN", (64, 64))]
        assert ([faults.is_quarantined(*p) for p in probes]
                == [jfaults.is_quarantined(*p) for p in probes]
                == [True, True, False, False, True, True])

    def test_epoch_bumps_on_new_entry_and_clear(self):
        e0 = faults.quarantine_epoch()
        faults.quarantine("A", "NT", None, RuntimeError("x"))
        e1 = faults.quarantine_epoch()
        assert e1 > e0
        faults.quarantine("A", "NT", None, RuntimeError("x"))  # repeat
        assert faults.quarantine_epoch() == e1
        faults.clear_quarantine()
        assert faults.quarantine_epoch() > e1
        assert not faults.quarantine_entries()

    def test_repeat_failures_keep_the_first_error(self):
        faults.quarantine("A", "NT", None, RuntimeError("first"))
        faults.quarantine("A", "NT", None, RuntimeError("second"))
        (entry,) = faults.quarantine_entries()
        assert entry.count == 2 and "first" in entry.error

    def test_quarantine_feeds_cascade_admissible_set(self):
        policy = CascadePolicy(["PALLAS_TNN_FUSED", "XLA_NT"])
        key = core.OpKey("NT", 128, 128, 128)
        assert policy.select(key).name == "PALLAS_TNN_FUSED"
        faults.quarantine("PALLAS_TNN_FUSED", "NT", None, RuntimeError("x"))
        assert policy.select(key).name == "XLA_NT"

    def test_analytic_policy_memo_invalidated_by_epoch(self):
        policy = AnalyticPolicy()
        key = core.OpKey("NT", 512, 512, 512)
        first = policy.select(key).name
        assert policy.select(key).name == first  # memo hit
        faults.quarantine(first, "NT", None, RuntimeError("x"))
        assert policy.select(key).name != first
        faults.clear_quarantine()
        assert policy.select(key).name == first  # re-admitted

    def test_selector_memo_invalidated_by_epoch(self):
        sel = core.default_selector()
        key = core.OpKey("NT", 4096, 4096, 4096, 2)
        first = sel.select(key)
        faults.quarantine(first, "NT", None, RuntimeError("x"))
        assert sel.select(key) != first
        faults.clear_quarantine()
        assert sel.select(key) == first


# -- fallback chains ----------------------------------------------------------


class TestFallbackChain:
    def test_chains_match_the_jax_package_for_every_candidate(self):
        names = [None] + sorted(CANDIDATES)
        assert set(CANDIDATES) <= set(jcandidates.CANDIDATES)
        for op in OPS:
            for name in names:
                assert fallback_chain(op, name) == jcandidates.fallback_chain(op, name), (op, name)

    def test_chain_terminates_at_default(self):
        for op, default in DEFAULT_BY_OP.items():
            assert fallback_chain(op)[-1] == default
            assert fallback_chain(op, default) == (default,)

    def test_chain_includes_binary_partner(self):
        assert fallback_chain("NN", "PALLAS_NN") == ("PALLAS_NN", "XLA_NN")
        assert fallback_chain("NT", "XLA_TNN") == ("XLA_TNN", "XLA_NT")
        assert fallback_chain("ATTN", "FUSED_ATTN") == ("FUSED_ATTN", "UNFUSED_ATTN")

    def test_unknown_op_rejected(self):
        with pytest.raises(ValueError):
            fallback_chain("XX")


def _operands(m=64, n=64, k=64, seed=0):
    rng = np.random.RandomState(seed)
    a, b = rng.randn(m, k).astype(np.float32), rng.randn(n, k).astype(np.float32)
    return a, b, torch.from_numpy(a), torch.from_numpy(b)


def _both_dispatch(spec, fixed, a, b, calls=1):
    """``calls`` NT dispatches of (a, b) under ``fixed`` and the chaos
    ``spec`` in both packages; returns the port's last output."""
    with core.use_policy(FixedPolicy(fixed)), inject_faults(spec):
        for _ in range(calls):
            out = core.dispatch("NT", torch.from_numpy(a), torch.from_numpy(b))
    with jcore.use_policy(jpolicy.FixedPolicy(fixed)), jfaults.inject_faults(spec):
        for _ in range(calls):
            jcore.dispatch("NT", jnp.asarray(a), jnp.asarray(b))
    return out


class TestEngineDegradation:
    def test_faulted_candidate_falls_back_as_the_jax_engine_does(self):
        a, b, *_ = _operands()
        with pytest.warns(UserWarning, match="quarantined"):
            out = _both_dispatch("raise:PALLAS_TNN_FUSED.NT", "PALLAS_TNN_FUSED", a, b, calls=3)
        np.testing.assert_allclose(out.numpy(), a @ b.T, rtol=1e-5, atol=1e-5 * 8)
        assert faults.is_quarantined("PALLAS_TNN_FUSED", "NT")
        assert _ledger(faults) == _ledger(jfaults)
        assert faults.fallback_counts() == jfaults.fallback_counts() == {
            ("NT", "PALLAS_TNN_FUSED", "XLA_NT"): 3}

    def test_quarantined_arm_skipped_without_injection(self):
        _, _, a, b = _operands(seed=1)
        faults.quarantine("PALLAS_TNN_FUSED", "NT", None, RuntimeError("x"))
        with core.use_policy(FixedPolicy("PALLAS_TNN_FUSED")):
            out = core.dispatch("NT", a, b)
        torch.testing.assert_close(out, a @ b.t())
        (entry,) = faults.quarantine_entries()
        assert entry.count == 1  # skipped, not re-attempted

    def test_tile_failure_degrades_to_default_tiling(self):
        _, _, a, b = _operands(m=128, n=128, k=128, seed=2)
        cfg = get_candidate("PALLAS_TNN_FUSED").config_space(128, 128, 128, dsize=4)[0]
        key = core.OpKey("NT", 128, 128, 128)
        with inject_faults("raise:PALLAS_TNN_FUSED.NT:times=1"):
            with pytest.warns(UserWarning, match="quarantined"):
                out = run_decision(key, Decision("PALLAS_TNN_FUSED", cfg), a, b)
        torch.testing.assert_close(out, a @ b.t(), rtol=1e-5, atol=1e-4)
        (entry,) = faults.quarantine_entries()
        assert entry.config_key is not None  # only the tile is barred
        assert not faults.is_quarantined("PALLAS_TNN_FUSED", "NT")
        label = f"PALLAS_TNN_FUSED@{entry.config_key}"
        assert faults.fallback_counts() == {("NT", label, "PALLAS_TNN_FUSED"): 1}

    def test_whole_chain_faulted_raises_dispatch_error(self):
        _, _, a, b = _operands(seed=3)
        with core.use_policy(FixedPolicy("XLA_NT")), inject_faults("raise:*.NT"):
            with pytest.raises(DispatchError, match="every arm"):
                with pytest.warns(UserWarning):
                    core.dispatch("NT", a, b)

    def test_terminal_arm_attempted_even_when_quarantined(self):
        _, _, a, b = _operands(seed=4)
        faults.quarantine("XLA_NT", "NT", None, RuntimeError("transient"))
        with core.use_policy(FixedPolicy("XLA_NT")):
            torch.testing.assert_close(core.dispatch("NT", a, b), a @ b.t())

    def test_injected_oom_degrades_the_attention_plan_to_unfused(self):
        rng = np.random.RandomState(5)
        q, k, v = (torch.from_numpy(rng.randn(2, s, 16).astype(np.float32) * 0.3)
                   for s in (5, 7, 7))
        with core.use_policy(FixedPolicy(by_op={"ATTN": "FUSED_ATTN"})):
            want = core.dispatch_attention(q, k, v, causal=True, q_start=2)
            with inject_faults("oom:FUSED_ATTN.ATTN"):
                with pytest.warns(UserWarning, match="InjectedOOM"):
                    got = core.dispatch_attention(q, k, v, causal=True, q_start=2)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        assert [e.label() for e in faults.quarantine_entries()] == ["FUSED_ATTN"]
        assert faults.fallback_counts() == {("ATTN", "FUSED_ATTN", "UNFUSED_ATTN"): 1}

    @pytest.mark.parametrize("error", [KernelBuildError, KernelLaunchError,
                                       torch.cuda.OutOfMemoryError, RuntimeError, ValueError])
    def test_kernel_build_and_launch_errors_are_never_quarantined(self, monkeypatch, error):
        """Nor is any error that was not injected: a real allocation failure
        or a wrapper bug is no fault to hide, and the ledger has no shape,
        so quarantining it would bar the kernel at every shape."""
        _, _, a, b = _operands(seed=6)

        def refused(*args, **kw):
            raise error("the card's path failed")

        monkeypatch.setattr(ops, "matmul_nt", refused)
        for policy in (FixedPolicy("PALLAS_NT"), AnalyticPolicy(candidates=("PALLAS_NT",))):
            with core.use_policy(policy):
                with pytest.raises(error, match="card's path"):
                    core.dispatch("NT", a, b)
        assert not faults.quarantine_entries() and not faults.fallback_counts()

    def test_tile_error_sheds_to_the_own_plan_and_no_further(self, monkeypatch):
        _, _, a, b = _operands(seed=8)

        def off_route(*args, block=None, **kw):
            raise TileConfigError(f"no plan {block}")

        monkeypatch.setattr(ops, "matmul_nt", off_route)
        key = core.OpKey("NT", 64, 64, 64)
        with pytest.warns(UserWarning, match="quarantined"):
            with pytest.raises(TileConfigError, match="no plan None"):
                run_decision(key, Decision("PALLAS_NT", (8, 128, 64)), a, b)
        assert _ledger(faults) == [("PALLAS_NT", "NT", "8x128x64", "PALLAS_NT@8x128x64", 1)]
        assert not faults.fallback_counts()

    def test_health_report_renders_rules_and_ledger(self):
        faults.quarantine("PALLAS_NT", "NT", None, RuntimeError("boom"))
        faults.record_fallback("NT", "PALLAS_NT", "XLA_NT")
        jfaults.quarantine("PALLAS_NT", "NT", None, RuntimeError("boom"))
        jfaults.record_fallback("NT", "PALLAS_NT", "XLA_NT")
        with inject_faults("raise:PALLAS_*"), jfaults.inject_faults("raise:PALLAS_*"):
            text = health_report()
            assert text == jengine.health_report()
        assert "1 armed rule" in text
        assert "PALLAS_NT" in text and "boom" in text
        assert "PALLAS_NT -> XLA_NT x1" in text

    def test_dispatch_report_mentions_quarantine(self):
        faults.quarantine("PALLAS_NT", "NT", None, RuntimeError("boom"))
        text = core.dispatch_report(FixedPolicy("XLA_NT"))
        assert "quarantined arms: 1 (PALLAS_NT)" in text


# -- cache / artifact corruption recovery -------------------------------------


def _seed_cache(path):
    cache = MeasurementCache(path)
    key = ("cpu", "host_cpu", "float32", "NT", 1, 64, 64, 64)
    cache.put(key, {"XLA_NT": {"default": 1e-5}}, attempts={"XLA_NT": {"default": 2}})
    cache.save()
    return key


class TestCacheRecovery:
    def test_truncated_json_strict_raises(self, tmp_path):
        p = str(tmp_path / "cache.json")
        _seed_cache(p)
        with open(p, "r+b") as fh:
            fh.truncate(os.path.getsize(p) // 2)
        with pytest.raises(ValueError):
            MeasurementCache.load(p)

    def test_truncated_json_recovers_empty_and_moves_aside(self, tmp_path):
        p = str(tmp_path / "cache.json")
        _seed_cache(p)
        with open(p, "r+b") as fh:
            fh.truncate(os.path.getsize(p) // 2)
        with pytest.warns(UserWarning, match="moved aside"):
            cache = MeasurementCache.load(p, recover=True)
        assert len(cache) == 0
        assert os.path.exists(p + ".corrupt") and not os.path.exists(p)
        cache.save()
        assert len(MeasurementCache.load(p)) == 0

    def test_rotten_entry_skipped_intact_entries_survive(self, tmp_path):
        p = str(tmp_path / "cache.json")
        key = _seed_cache(p)
        with open(p) as fh:
            payload = json.load(fh)
        payload["entries"]["not|a|valid|key"] = {"XLA_NT": {"default": 1.0}}
        with open(p, "w") as fh:
            json.dump(payload, fh)
        with pytest.raises(ValueError):
            MeasurementCache.load(p)
        with pytest.warns(UserWarning, match="skipped"):
            cache = MeasurementCache.load(p, recover=True)
        assert cache.get(key) == {"XLA_NT": {"default": 1e-5}}
        assert cache.get_attempts(key) == {"XLA_NT": {"default": 2}}

    def test_cache_files_with_attempts_load_in_both(self, tmp_path):
        mine, theirs = str(tmp_path / "mine.json"), str(tmp_path / "theirs.json")
        key = _seed_cache(mine)
        jc = jmeasure.MeasurementCache(theirs)
        jc.put(key, {"XLA_NT": {"default": 1e-5}}, attempts={"XLA_NT": {"default": 2}})
        jc.save()
        for path in (mine, theirs):
            assert MeasurementCache.load(path).get_attempts(key) == {"XLA_NT": {"default": 2}}
            assert jmeasure.MeasurementCache.load(path).get_attempts(key) == {
                "XLA_NT": {"default": 2}}

    def test_corrupt_plane_injection_triggers_recovery(self, tmp_path):
        p = str(tmp_path / "cache.json")
        _seed_cache(p)
        with inject_faults("corrupt:cache"):
            with pytest.warns(UserWarning, match="moved aside"):
                cache = MeasurementCache.load(p, recover=True)
        assert len(cache) == 0 and os.path.exists(p + ".corrupt")


class TestSelectorArtifactRecovery:
    @pytest.fixture(scope="class")
    def small_selector(self):
        ds = core.collect_analytic(lo=7, hi=10)
        clf, _ = core.train_paper_model(ds)
        return MTNNSelector(clf)

    def test_corrupt_artifact_strict_raises(self, tmp_path, small_selector):
        p = str(tmp_path / "sel.json")
        small_selector.save(p)
        with open(p, "w") as fh:
            fh.write('{"schema_version":')  # truncated mid-write
        with pytest.raises(ValueError):
            MTNNSelector.load(p)

    def test_corrupt_plane_injection_recovers_with_fallback_selector(
            self, tmp_path, small_selector):
        p = str(tmp_path / "sel.json")
        small_selector.save(p)
        with inject_faults("corrupt:artifact"):
            with pytest.warns(UserWarning, match="fallback selector"):
                sel = MTNNSelector.load(p, recover=True)
        assert os.path.exists(p + ".corrupt")
        assert sel.select(core.OpKey("NT", 256, 256, 256)) in core.CANDIDATES


# -- measurement retry --------------------------------------------------------


class TestMeasureRetry:
    def test_transient_fault_retried_and_attempts_match_the_jax_package(self):
        spec = "raise:measure:cand=XLA_NT:times=1"
        attempts, jattempts = {}, {}
        with inject_faults(spec):
            times = measure_candidates(32, 32, 32, candidates=["XLA_NT"], reps=1, warmup=0,
                                       retries=2, retry_backoff_s=0.001, attempts=attempts,
                                       device="cpu")
        with jfaults.inject_faults(spec):
            jmeasure.measure_candidates(32, 32, 32, candidates=["XLA_NT"], reps=1, warmup=0,
                                        retries=2, retry_backoff_s=0.001, attempts=jattempts)
        assert "XLA_NT" in times
        assert attempts == jattempts == {"XLA_NT": {"default": 2}}

    def test_persistent_fault_drops_candidate_not_run(self):
        attempts, failures = {}, {}
        with inject_faults("raise:measure:cand=XLA_NT"):
            times = measure_candidates(32, 32, 32, candidates=["XLA_NT", "XLA_TNN"], reps=1,
                                       warmup=0, retries=1, retry_backoff_s=0.001,
                                       attempts=attempts, failures=failures, device="cpu")
        assert "XLA_NT" not in times and "XLA_TNN" in times
        assert "XLA_NT" not in attempts
        assert failures == {"XLA_NT": {"default": "InjectedFault: injected raise fault: "
                                                  "measurement of XLA_NT on op NT"}}

    def test_keyboard_interrupt_never_swallowed(self, monkeypatch):
        def interrupting_bench(*a, **kw):
            raise KeyboardInterrupt

        monkeypatch.setattr(measure_mod, "bench_fn", interrupting_bench)
        with pytest.raises(KeyboardInterrupt):
            measure_candidates(32, 32, 32, candidates=["XLA_NT"], reps=1, retries=3,
                               device="cpu")

    def test_attempts_roundtrip_through_cache_file(self, tmp_path):
        p = str(tmp_path / "cache.json")
        key = ("cpu", "host_cpu", "float32", "NT", 1, 32, 32, 32)
        cache = MeasurementCache(p)
        cache.put(key, {"XLA_NT": {"default": 1e-5}}, attempts={"XLA_NT": {"default": 3}})
        cache.save()
        loaded = MeasurementCache.load(p)
        assert loaded.get_attempts(key) == {"XLA_NT": {"default": 3}}
        assert loaded.get_attempts(("cpu", "host_cpu", "float32", "NT", 1, 8, 8, 8)) is None


# -- serve loop under chaos ---------------------------------------------------

TINY = JArchConfig(  # tests/test_faults.py::TINY
    name="tiny-faults", family="dense", d_model=32, n_heads=2, n_kv=2, d_head=16, d_ff=64,
    vocab=64, segments=((2, (JBlockCfg("attn", "mlp"),)),), param_dtype="float32",
    compute_dtype="float32", attn_chunk=16, remat="none",
)
CHAOS = "raise:PALLAS_*"


class TestServeChaos:
    def test_serve_completes_on_fallback_as_the_jax_engine_does(self):
        """Every kernel arm fault-injected to raise, under policies that
        select them: every request finishes with the JAX engine's greedy
        tokens under the same spec, the quarantine holds the same arms and
        the same fallbacks were taken."""
        jparams, params = converted_params(TINY)
        by_op = {"BNT": ("PALLAS_BNT", None), "BNN": ("PALLAS_BNN", None),
                 "NT": ("PALLAS_NT", None)}
        rng = np.random.RandomState(11)
        prompts = [rng.randint(0, TINY.vocab, (n,)).astype(np.int32) for n in (4, 7)]
        mine = ServeEngine(to_port_cfg(TINY), params, n_slots=2, max_seq=32,
                           policies={"interactive": FixedPolicy(by_op=by_op)},
                           cache_dtype=torch.float32, device="cpu")
        theirs = JServeEngine(TINY, jparams, n_slots=2, max_seq=32,
                              policies={"interactive": jpolicy.FixedPolicy(by_op=by_op)},
                              cache_dtype=jnp.float32)
        with inject_faults(CHAOS):
            with pytest.warns(UserWarning, match="quarantined"):
                reqs = [mine.submit(p, max_new=5) for p in prompts]
                mine.run()
        with jfaults.inject_faults(CHAOS):
            with pytest.warns(UserWarning, match="quarantined"):
                jreqs = [theirs.submit(p, max_new=5) for p in prompts]
                theirs.run()
        health = mine.health()
        assert health["crashed_steps"] == 0 and health["finished"] == len(prompts)
        for req, jreq in zip(reqs, jreqs):
            assert req.state is RequestState.FINISHED
            assert req.generated == jreq.generated, f"rid={req.rid}"
        assert {(e.name, e.op) for e in faults.quarantine_entries()} == {
            (e.name, e.op) for e in jfaults.quarantine_entries()} == {
            ("PALLAS_BNT", "BNT"), ("PALLAS_BNN", "BNN"), ("PALLAS_NT", "NT")}
        # the JAX engine selects once per traced shape, the port per call:
        # the same fallbacks, not the same counts
        assert set(faults.fallback_counts()) == set(jfaults.fallback_counts())
