"""The port's kernels against the JAX package's: each plain PyTorch
version (the CPU route of every wrapper) against the Pallas kernel in
interpret mode and against ``repro.kernels.ref``, on ragged shapes in f32
and bf16; and, on a card, each CUDA kernel against its plain version
(``gpu`` marker: skipped without CUDA).

Tolerances: GEMMs use ``tests/test_kernels.py::_tol`` (f32 ``1e-5*sqrt(k)``,
bf16 ``2e-2*sqrt(k)``: f32 sums in another order, bf16 output rounding);
the transpose is exact; attention uses ``tests/test_attention_fused.py``'s
bounds (f32 1e-4, bf16 2e-2).  Inputs come from numpy with a seed; bf16
inputs are f32 arrays rounded to bf16 the same way by both frameworks.

On a card the ``gpu`` tests run without jax, which a fixture imports for
the CPU tests only:
``PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels.py``
"""

import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.attention_fused import MaskParams, attention_fused  # noqa: E402
from repro_torch.kernels.common import LAUNCHES, reset_launches  # noqa: E402


@pytest.fixture(scope="module")
def J():
    """The JAX package's side, imported here and not at module top, so the
    ``gpu`` tests of this file also run where jax is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.attention_fused import MaskParams as JMask
    from repro.kernels.attention_fused import attention_fused as attention
    from repro.kernels.matmul_nn import matmul_nn as nn
    from repro.kernels.matmul_nt import matmul_nt as nt
    from repro.kernels.transpose import transpose

    return types.SimpleNamespace(jnp=jnp, ref=jref, Mask=JMask, attention=attention,
                                 nn=nn, nt=nt, transpose=transpose)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RAGGED = (1, 127, 129)
GEMM_SHAPES = ((1, 127, 129), (127, 129, 1), (129, 1, 127), (129, 129, 129))


def _tol(dtype_name, k):
    if dtype_name == "float32":
        return dict(rtol=1e-5, atol=1e-5 * max(1.0, k**0.5))
    return dict(rtol=2e-2, atol=2e-2 * max(1.0, k**0.5))


def _pair(J, x: np.ndarray, dtype_name: str):
    """The same numpy array as a JAX and a torch array of one dtype."""
    return J.jnp.asarray(x, getattr(J.jnp, dtype_name)), torch.from_numpy(x).to(DTYPES[dtype_name])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


# -- transpose ------------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("n,k", list(itertools.product(RAGGED, RAGGED)))
def test_transpose_plain_matches_pallas_exactly(J, n, k, dtype_name):
    x = np.random.RandomState(n * 1000 + k).randn(n, k).astype(np.float32)
    jb, tb = _pair(J, x, dtype_name)
    out = ops.transpose(tb)
    assert out.shape == (k, n) and out.dtype == tb.dtype and out.is_contiguous()
    np.testing.assert_array_equal(_np(out), _np(J.transpose(jb, interpret=True)))
    np.testing.assert_array_equal(_np(out), _np(J.ref.transpose(jb)))


# -- NN / NT / TNN / TN -----------------------------------------------------------


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_matmul_nn_plain_matches_pallas(J, m, n, k, dtype_name):
    rng = np.random.RandomState(m + 7 * n + 31 * k)
    (ja, ta), (jb, tb) = (_pair(J, rng.randn(*s).astype(np.float32), dtype_name)
                          for s in ((m, k), (k, n)))
    out = ops.matmul_nn(ta, tb)
    assert out.shape == (m, n) and out.dtype == ta.dtype
    np.testing.assert_allclose(_np(out), _np(J.nn(ja, jb, interpret=True)), **_tol(dtype_name, k))
    np.testing.assert_allclose(_np(out), _np(J.ref.matmul_nn(ja, jb)), **_tol(dtype_name, k))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_matmul_nt_and_tnn_plain_match_pallas(J, m, n, k, dtype_name):
    rng = np.random.RandomState(3 * m + n + 17 * k)
    (ja, ta), (jb, tb) = (_pair(J, rng.randn(*s).astype(np.float32), dtype_name)
                          for s in ((m, k), (n, k)))
    want = _np(J.nt(ja, jb, interpret=True))
    np.testing.assert_allclose(_np(J.ref.matmul_nt(ja, jb)), want, **_tol(dtype_name, k))
    for fn in (ops.matmul_nt, ops.matmul_tnn):
        out = fn(ta, tb)
        assert out.shape == (m, n) and out.dtype == ta.dtype
        np.testing.assert_allclose(_np(out), want, **_tol(dtype_name, k))


def test_matmul_tn_plain_matches_ref(J):
    rng = np.random.RandomState(5)
    (ja, ta), (jb, tb) = (_pair(J, rng.randn(*s).astype(np.float32), "float32")
                          for s in ((129, 127), (129, 1)))
    np.testing.assert_allclose(_np(ops.matmul_tn(ta, tb)), _np(J.ref.matmul_tn(ja, jb)),
                               **_tol("float32", 129))


@pytest.mark.parametrize("bad", [(0, 8, 8), (8, 8), (8, 8, 8.0), (True, 8, 8)])
def test_gemm_tile_configs_are_validated(bad):
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        ops.matmul_nt(a, a, block=bad)
    with pytest.raises(ValueError):
        ops.matmul_tnn(a, a, block=bad)


@pytest.mark.parametrize("make", [
    lambda: (torch.zeros(4, 8, dtype=torch.float16), torch.zeros(6, 8, dtype=torch.float16)),
    lambda: (torch.zeros(8, 4).t(), torch.zeros(6, 8)),  # non-contiguous
    lambda: (torch.zeros(4, 8), torch.zeros(6, 7)),  # contraction mismatch
    lambda: (torch.zeros(4, 8), torch.zeros(6, 8, dtype=torch.bfloat16)),
])
def test_wrappers_reject_what_the_kernel_does_not_take(make):
    a, b = make()
    with pytest.raises((TypeError, ValueError)):
        ops.matmul_nt(a, b)


def test_cpu_route_launches_nothing():
    reset_launches()
    a = torch.randn(4, 8)
    ops.matmul_tnn(a, torch.randn(6, 8))
    attention_fused(torch.randn(2, 3, 8), torch.randn(2, 5, 8), torch.randn(2, 5, 8))
    assert not any(LAUNCHES.values())


# -- fused attention -----------------------------------------------------------------

ATTN_SHAPES = ((1, 129, 257, 33), (2, 64, 200, 16), (3, 1, 96, 64))
MASKS = {  # the geometries of tests/test_attention_fused.py
    "none": lambda m, n: dict(),
    "causal": lambda m, n: dict(causal=True, q_start=n - m),
    "window": lambda m, n: dict(causal=True, window=max(1, n // 4), q_start=n - m),
    "folded": lambda m, n: dict(causal=True, q_start=n - max(1, m // 2), q_seg=max(1, m // 2)),
    "prefix": lambda m, n: dict(causal=True, window=max(1, n // 4), q_start=n - m,
                                prefix_len=max(1, n // 8)),
    "softcap": lambda m, n: dict(causal=True, q_start=n - m, softcap=20.0),
    "ragged_lengths": lambda m, n: dict(),
}


def _attn_operands(J, rng, g, m, n, dh, dtype_name):
    return [_pair(J, (rng.randn(*s) * 0.3).astype(np.float32), dtype_name)
            for s in ((g, m, dh), (g, n, dh), (g, n, dh))]


@pytest.mark.parametrize("g,m,n,dh", ATTN_SHAPES)
@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_attention_plain_matches_pallas(J, g, m, n, dh, mask_name):
    rng = np.random.RandomState(g * 100 + m + n)
    (jq, tq), (jk, tk), (jv, tv) = _attn_operands(J, rng, g, m, n, dh, "float32")
    kw = MASKS[mask_name](m, n)
    lengths = None
    if mask_name == "ragged_lengths":
        lengths = rng.randint(1, n + 1, size=g).astype(np.int32)
    want = J.attention(jq, jk, jv, None if lengths is None else J.jnp.asarray(lengths),
                       mask=J.Mask(**kw), interpret=True)
    out = attention_fused(tq, tk, tv, None if lengths is None else torch.from_numpy(lengths),
                          mask=MaskParams(**kw))
    assert out.shape == (g, m, dh) and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-4, atol=1e-4)


def test_attention_bf16_plain_matches_pallas(J):
    g, m, n, dh = 2, 64, 200, 16
    rng = np.random.RandomState(11)
    (jq, tq), (jk, tk), (jv, tv) = _attn_operands(J, rng, g, m, n, dh, "bfloat16")
    kw = dict(causal=True, window=50, q_start=n - m)
    want = J.attention(jq, jk, jv, mask=J.Mask(**kw), interpret=True)
    out = attention_fused(tq, tk, tv, mask=MaskParams(**kw))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(want), rtol=2e-2, atol=2e-2)


def test_attention_row_without_keys_is_zero():
    """The one stated difference from the Pallas kernel: a row that sees
    no key (only ever query padding) comes out 0, not a tiling-dependent
    mean."""
    q, k, v = torch.randn(1, 2, 8), torch.randn(1, 4, 8), torch.randn(1, 4, 8)
    out = attention_fused(q, k, v, mask=MaskParams(causal=True, q_start=0, k_start=1))
    assert torch.all(out[0, 0] == 0) and torch.all(torch.isfinite(out))


def test_attention_rejects_wide_heads_and_bad_tiles():
    x = torch.zeros(1, 2, 129)
    with pytest.raises(ValueError):
        attention_fused(x, x, x)
    y = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        attention_fused(y, y, y, block=(16, 32, 8))


# -- on the card: each CUDA kernel against its plain version ---------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k", [(1, 1), (127, 129), (1536, 576)])
def test_transpose_kernel_matches_plain_on_card(cuda, n, k, dtype):
    b = torch.randn(n, k, device=cuda).to(getattr(torch, dtype))
    assert torch.equal(ops.transpose(b), ref.transpose(b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES + ((8, 49152, 576), (64, 576, 1536)))
def test_gemm_kernels_match_plain_on_card(cuda, m, n, k, dtype):
    dt = getattr(torch, dtype)
    a, w = torch.randn(m, k, device=cuda).to(dt), torch.randn(n, k, device=cuda).to(dt)
    tol = _tol(dtype, k)
    torch.testing.assert_close(ops.matmul_nt(a, w).float(), ref.matmul_nt(a, w).float(), **tol)
    torch.testing.assert_close(ops.matmul_tnn(a, w).float(), ref.matmul_nt(a, w).float(), **tol)
    wt = w.t().contiguous()
    torch.testing.assert_close(ops.matmul_nn(a, wt).float(), ref.matmul_nn(a, wt).float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_attention_kernel_matches_plain_on_card(cuda, mask_name, dtype):
    g, m, n, dh = 3, 65, 200, 64
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(g, s, dh, device=cuda).mul(0.3).to(dt) for s in (m, n, n))
    lengths = torch.tensor([200, 77, 1], device=cuda) if mask_name == "ragged_lengths" else None
    mask = MaskParams(**MASKS[mask_name](m, n))
    want = ref.attention_fused(q, k, v, lengths if lengths is not None else
                               torch.full((g,), n, device=cuda), mask)
    bound = 1e-4 if dtype == "float32" else 2e-2
    torch.testing.assert_close(attention_fused(q, k, v, lengths, mask=mask).float(),
                               want.float(), rtol=bound, atol=bound)
