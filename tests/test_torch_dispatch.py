"""The port's dispatch engine against the JAX package's: the ``fixed:``
spec grammar builds the same tables, ``dispatch("NT")`` and
``dispatch_attention`` compute the same values under the same policies
(the JAX side runs its Pallas kernels in interpret mode; the port's
kernel arms run their plain versions on the CPU), and the dispatch
reports hold the same (op, candidate, tile) rows.

Tolerance: f32 throughout; GEMMs at ``tests/test_kernels.py::_tol``
(``1e-5*sqrt(k)``: sums in another order), attention at 1e-4 as in
``tests/test_attention_fused.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.candidates import (  # noqa: E402
    BINARY_PAIRS_BY_OP,
    DEFAULT_BY_OP,
    PAPER_PAIR,
    current_platform,
    get_candidate,
)
from repro_torch.core.opkey import OpKey  # noqa: E402
from repro_torch.core.policy import Decision, FixedPolicy, current_policy, use_policy  # noqa: E402

SPECS = [
    "fixed:XLA_NT",
    " fixed: XLA_TNN ",
    "fixed:PALLAS_NT@128x128x128",
    "fixed:PALLAS_TNN",
    "fixed:FUSED_ATTN@64x128",
    "fixed:nt=PALLAS_TNN,attn=fused",
    "fixed:nt=PALLAS_NT,attn=fused@16x32",
    "fixed:nt=XLA_TNN,nn=PALLAS_NN@64x64x64,tn=PALLAS_TN,bnt=XLA_BNT,bnn=XLA_BNN,attn=unfused",
    "fixed:attn=UNFUSED_ATTN",
]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("spec", SPECS)
def test_fixed_specs_build_the_same_tables(spec):
    mine, theirs = engine.policy_from_spec(spec), jengine.policy_from_spec(spec)
    assert mine.by_op == theirs.by_op
    assert (mine.name, mine.config) == (theirs.name, theirs.config)
    assert repr(mine) == repr(theirs)


@pytest.mark.parametrize("spec", [
    "fixed:PALLAS_TNN_FUSED", "fixed:nt=PALLAS_TNN_FUSED", "fixed:bnt=PALLAS_BNT",
    "fixed:bnn=PALLAS_BNN@64x64x64",
])
def test_unported_kernels_are_unknown_candidates(spec):
    jengine.policy_from_spec(spec)  # the JAX package has them
    with pytest.raises(KeyError, match="unknown candidate"):
        engine.policy_from_spec(spec)


@pytest.mark.parametrize("spec", ["model", "model:sel.json", "analytic", "cascade:XLA_NT",
                                  "autotune", "autotune:cache.json"])
def test_selector_specs_name_the_roadmap_item(spec):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.policy_from_spec(spec)


@pytest.mark.parametrize("spec", ["", "fixed:", "fixed:nt=", "fixed:qq=XLA_NT", "bogus",
                                  "fixed:PALLAS_NT@1x2"])
def test_malformed_specs_raise_value_error_in_both(spec):
    with pytest.raises(ValueError):
        jengine.policy_from_spec(spec)
    with pytest.raises(ValueError):
        engine.policy_from_spec(spec)


def test_registry_tables_are_restricted_to_registered_names():
    for op, name in DEFAULT_BY_OP.items():
        assert op in get_candidate(name).ops
    for op, pair in BINARY_PAIRS_BY_OP.items():
        assert all(op in get_candidate(n).ops for n in pair)
    assert PAPER_PAIR == ("XLA_NT", "XLA_TNN")
    assert set(BINARY_PAIRS_BY_OP) == {"NT", "NN", "TN", "ATTN"}


def test_no_policy_in_scope_is_an_error():
    with pytest.raises(RuntimeError, match="no dispatch policy"):
        current_policy()
    with pytest.raises(RuntimeError):
        engine.dispatch("NT", torch.zeros(2, 4), torch.zeros(3, 4))


def test_platform_comes_from_the_operand():
    assert current_platform(torch.zeros(1)) == "cpu"
    assert current_platform(torch.zeros(1, device="meta")) == "meta"


def test_op_mismatched_decision_runs_the_reference():
    class Bad:
        stats = None

        def select(self, key):
            return Decision("FUSED_ATTN", None)

    a, b = torch.randn(3, 4), torch.randn(5, 4)
    with pytest.warns(UserWarning, match="does not implement"):
        out = engine.dispatch("NT", a, b, policy=Bad())
    torch.testing.assert_close(out, a @ b.t())


@pytest.mark.parametrize("name", ["XLA_NT", "XLA_TNN", "PALLAS_NT", "PALLAS_TNN"])
def test_dispatch_nt_matches_jax(name):
    rng = np.random.RandomState(0)
    a = rng.randn(2, 63, 129).astype(np.float32)
    w = rng.randn(97, 129).astype(np.float32)
    want = jengine.dispatch("NT", jnp.asarray(a), jnp.asarray(w),
                            policy=jpolicy.FixedPolicy(name))
    pol = FixedPolicy(name)
    out = engine.dispatch("NT", torch.from_numpy(a), torch.from_numpy(w), policy=pol)
    assert out.shape == (2, 63, 97)
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-5, atol=1e-5 * 129**0.5)
    assert pol.stats.by_op == {"NT": {name: 1}}


@pytest.mark.parametrize("op,shapes", [("NN", ((5, 33), (33, 7))), ("TN", ((33, 5), (33, 7)))])
@pytest.mark.parametrize("kind", ["XLA", "PALLAS"])
def test_dispatch_backward_ops_match_jax(op, shapes, kind):
    rng = np.random.RandomState(1)
    a, b = (rng.randn(*s).astype(np.float32) for s in shapes)
    name = f"{kind}_{op}"
    want = jengine.dispatch(op, jnp.asarray(a), jnp.asarray(b), policy=jpolicy.FixedPolicy(name))
    out = engine.dispatch(op, torch.from_numpy(a), torch.from_numpy(b), policy=FixedPolicy(name))
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-5, atol=1e-5 * 33**0.5)


def test_dispatch_batched_matches_jax():
    rng = np.random.RandomState(2)
    a, b = rng.randn(2, 3, 5, 16).astype(np.float32), rng.randn(2, 3, 7, 16).astype(np.float32)
    pol = jpolicy.FixedPolicy("XLA_BNT")
    want = jengine.dispatch_batched("BNT", jnp.asarray(a), jnp.asarray(b), policy=pol)
    out = engine.dispatch_batched("BNT", torch.from_numpy(a), torch.from_numpy(b),
                                  policy=FixedPolicy("XLA_BNT"))
    assert out.shape == (2, 3, 5, 7)
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-5, atol=1e-4)


ATTN_CASES = {
    "none": dict(),
    "causal": dict(causal=True, q_start=40),
    "window": dict(causal=True, window=9, q_start=40),
    "folded": dict(causal=True, q_start=60, q_seg=12),
    "prefix": dict(causal=True, window=9, q_start=40, prefix_len=5),
    "softcap": dict(causal=True, q_start=40, softcap=20.0),
    "lengths": dict(),
}


@pytest.mark.parametrize("plan", ["fused", "unfused"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_dispatch_attention_matches_jax(plan, case):
    rng = np.random.RandomState(3)
    q = (rng.randn(2, 3, 24, 16) * 0.3).astype(np.float32)
    k = (rng.randn(2, 3, 72, 16) * 0.3).astype(np.float32)
    v = (rng.randn(2, 3, 72, 16) * 0.3).astype(np.float32)
    kw = dict(ATTN_CASES[case])
    jkw, tkw = dict(kw), dict(kw)
    if case == "lengths":
        lens = rng.randint(1, 73, size=(2, 3)).astype(np.int32)
        jkw["lengths"], tkw["lengths"] = jnp.asarray(lens), torch.from_numpy(lens)
    spec = f"fixed:attn={plan}"
    want = jengine.dispatch_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      policy=jengine.policy_from_spec(spec), **jkw)
    out = engine.dispatch_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), policy=engine.policy_from_spec(spec),
                                    **tkw)
    assert out.shape == (2, 3, 24, 16)
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("plan", ["fused", "unfused"])
def test_attention_row_without_keys_is_zero_in_both_plans(plan):
    """Query 0 sits before the first key: it sees no key in either plan,
    and comes out 0 (not the mean of V) from both."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, 1, s, 8).astype(np.float32)) for s in (2, 4, 4))
    out = engine.dispatch_attention(q, k, v, causal=True, q_start=0, k_start=1,
                                    policy=engine.policy_from_spec(f"fixed:attn={plan}"))
    assert torch.all(out[0, 0, 0] == 0) and torch.all(torch.isfinite(out))
    assert torch.all(out[0, 0, 1] != 0)


def _report_rows(text):
    rows = set()
    for line in text.splitlines()[2:]:
        parts = line.split()
        if len(parts) == 4 and parts[0] != "total":
            rows.add((parts[0], parts[1]))
    return rows


@pytest.mark.parametrize("spec", ["fixed:nt=PALLAS_TNN@64x64x64,attn=fused",
                                  "fixed:XLA_NT", "fixed:nt=PALLAS_NT,attn=fused@16x32"])
def test_dispatch_report_rows_match_jax(spec):
    rng = np.random.RandomState(4)
    x = rng.randn(6, 32).astype(np.float32)
    w = rng.randn(48, 32).astype(np.float32)
    q, k = (rng.randn(3, n, 16).astype(np.float32) for n in (4, 9))

    def drive(eng, arr, pol):
        with eng.use_policy(pol):
            eng.dispatch("NT", arr(x), arr(w))
            eng.dispatch_attention(arr(q), arr(k), arr(k), causal=True, q_start=5)
        return eng.dispatch_report(pol)

    mine = drive(engine, torch.from_numpy, engine.policy_from_spec(spec))
    theirs = drive(jengine, jnp.asarray, jengine.policy_from_spec(spec))
    assert _report_rows(mine) == _report_rows(theirs)
    assert _report_rows(mine)


def test_policy_scopes_nest_and_restore():
    outer, inner = FixedPolicy("XLA_NT"), FixedPolicy("PALLAS_NT")
    with use_policy(outer):
        with use_policy(inner):
            assert current_policy() is inner
        assert current_policy() is outer
        engine.dispatch("NT", torch.randn(2, 4), torch.randn(3, 4))
    assert outer.stats.calls == 1 and inner.stats.calls == 0


def test_every_call_is_counted():
    pol = FixedPolicy("XLA_NT")
    with use_policy(pol):
        for _ in range(3):
            engine.dispatch("NT", torch.randn(2, 4), torch.randn(3, 4))
    assert pol.stats.by_op == {"NT": {"XLA_NT": 3}} and pol.stats.calls == 3
    assert pol.select(OpKey("BNT", 2, 3, 4)).name == "XLA_BNT"
