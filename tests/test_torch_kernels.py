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
from repro_torch.kernels.attention_fused import (  # noqa: E402
    NEG_INF,
    MaskParams,
    attention_fused,
    attention_plans,
    attention_variant,
    decode_split_plan,
    flash_f32_splits,
)
from repro_torch.kernels.common import (  # noqa: E402
    ATTENTION_ROUTES,
    GEMM_ROUTES,
    LAUNCHES,
    f32_plans,
    f32_route,
    f32_split,
    reset_launches,
)
from repro_torch.kernels.matmul_batched import batched_plan  # noqa: E402
from repro_torch.kernels.matmul_nn import nn_plan  # noqa: E402
from repro_torch.kernels.matmul_nt import nt_plans, nt_split, nt_workspace_shape  # noqa: E402
from repro_torch.kernels.matmul_tnn_fused import (  # noqa: E402
    tnn_fused_plans,
    tnn_fused_variant,
)


@pytest.fixture(scope="module")
def J():
    """The JAX package's side, imported here and not at module top, so the
    ``gpu`` tests of this file also run where jax is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels.attention_fused import MaskParams as JMask
    from repro.kernels.attention_fused import attention_fused as attention
    from repro.kernels.matmul_batched import matmul_bnn as bnn
    from repro.kernels.matmul_batched import matmul_bnt as bnt
    from repro.kernels.matmul_nn import matmul_nn as nn
    from repro.kernels.matmul_nt import matmul_nt as nt
    from repro.kernels.matmul_tnn_fused import matmul_tnn_fused as tnn_fused
    from repro.kernels.transpose import transpose

    return types.SimpleNamespace(jnp=jnp, ref=jref, Mask=JMask, attention=attention,
                                 nn=nn, nt=nt, transpose=transpose, tnn_fused=tnn_fused,
                                 bnt=bnt, bnn=bnn)


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


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_matmul_tnn_fused_plain_matches_pallas(J, m, n, k, dtype_name):
    rng = np.random.RandomState(5 * m + 3 * n + k)
    (ja, ta), (jb, tb) = (_pair(J, rng.randn(*s).astype(np.float32), dtype_name)
                          for s in ((m, k), (n, k)))
    out = ops.matmul_tnn_fused(ta, tb)
    assert out.shape == (m, n) and out.dtype == ta.dtype
    np.testing.assert_allclose(_np(out), _np(J.tnn_fused(ja, jb, interpret=True)),
                               **_tol(dtype_name, k))
    np.testing.assert_allclose(_np(out), _np(J.ref.matmul_tnn_fused(ja, jb)),
                               **_tol(dtype_name, k))


BATCHED_SHAPES = ((1, 1, 127, 129), (3, 127, 1, 33), (2, 65, 129, 17), (5, 3, 70, 64))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("g,m,n,k", BATCHED_SHAPES)
@pytest.mark.parametrize("op", ["bnt", "bnn"])
def test_matmul_batched_plain_matches_pallas(J, op, g, m, n, k, dtype_name):
    rng = np.random.RandomState(g + 7 * m + 3 * n + k)
    b_shape = (g, n, k) if op == "bnt" else (g, k, n)
    (ja, ta), (jb, tb) = (_pair(J, rng.randn(*s).astype(np.float32), dtype_name)
                          for s in ((g, m, k), b_shape))
    out = getattr(ops, f"matmul_{op}")(ta, tb)
    assert out.shape == (g, m, n) and out.dtype == ta.dtype
    np.testing.assert_allclose(_np(out), _np(getattr(J, op)(ja, jb, interpret=True)),
                               **_tol(dtype_name, k))
    np.testing.assert_allclose(_np(out), _np(getattr(J.ref, f"matmul_{op}")(ja, jb)),
                               **_tol(dtype_name, k))


@pytest.mark.parametrize("make", [
    lambda: (torch.zeros(2, 4, 8), torch.zeros(3, 6, 8)),  # batch mismatch
    lambda: (torch.zeros(2, 4, 8), torch.zeros(2, 6, 7)),  # contraction mismatch
    lambda: (torch.zeros(4, 8), torch.zeros(6, 8)),  # 2-D
    lambda: (torch.zeros(2, 8, 4).transpose(1, 2), torch.zeros(2, 6, 8)),  # a view
])
def test_batched_wrappers_reject_what_the_kernel_does_not_take(make):
    a, b = make()
    with pytest.raises((TypeError, ValueError)):
        ops.matmul_bnt(a, b)
    with pytest.raises((TypeError, ValueError)):
        ops.matmul_bnn(a, b.transpose(-1, -2).contiguous())
    with pytest.raises(ValueError):
        ops.matmul_bnt(torch.zeros(1, 2, 8), torch.zeros(1, 3, 8), block=(8, 8))


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
    with pytest.raises(ValueError):
        ops.matmul_tnn_fused(a, a, block=bad)


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
    ops.matmul_tnn_fused(a, torch.randn(6, 8))
    ops.matmul_bnt(torch.randn(2, 3, 8), torch.randn(2, 5, 8))
    ops.matmul_bnn(torch.randn(2, 3, 8), torch.randn(2, 8, 5))
    attention_fused(torch.randn(2, 3, 8), torch.randn(2, 5, 8), torch.randn(2, 5, 8))
    attention_fused(torch.randn(2, 3, 256), torch.randn(2, 5, 256), torch.randn(2, 5, 256))
    ops.matmul_nt(torch.randn(4, 8), torch.randn(6, 8))
    ops.matmul_nn(torch.randn(40, 8), torch.randn(8, 96))
    assert not any(LAUNCHES.values()) and not ATTENTION_ROUTES and not GEMM_ROUTES


# -- the CUDA kernels' launch choices (pure functions, checked here) -----------------


@pytest.mark.parametrize("dtype,m,n,k,a_ptr,b_ptr,want", [
    (torch.bfloat16, 2048, 49152, 576, 0, 0, ("wgmma", 256)),  # LM head: 24 waves, a tie
    (torch.bfloat16, 130, 49152, 576, 256, 512, ("wgmma", 256)),
    (torch.bfloat16, 2048, 1536, 576, 0, 0, ("wgmma", 192)),  # 128 tiles: one wave
    (torch.bfloat16, 2048, 576, 1536, 0, 0, ("wgmma", 96)),  # 96 tiles: one wave
    (torch.bfloat16, 2048, 192, 576, 0, 0, ("wgmma", 64)),
    (torch.bfloat16, 8, 1536, 576, 0, 0, ("wgmma", 64)),
    (torch.bfloat16, 8, 49152, 576, 0, 0, ("wgmma", 192)),
    (torch.bfloat16, 2048, 576, 129, 0, 0, ("mma_sync", None)),  # k % 8 != 0
    (torch.bfloat16, 2048, 576, 576, 2, 0, ("mma_sync", None)),  # A 2 bytes off
    (torch.bfloat16, 2048, 576, 576, 0, 8, ("mma_sync", None)),  # B 8 bytes off
    (torch.bfloat16, 4, 4, 0, 0, 0, ("mma_sync", None)),  # k = 0: no tensor map
    # f32: the as-stored FFMA kernel where k % 4 == 0 and both operands
    # are 16-byte aligned (128 x 128 tiles; 16 x 128 at m <= 16, 128 x 16
    # at n <= 64), the FMA kernel otherwise
    (torch.float32, 2048, 49152, 576, 0, 0, ("f32_tiled", None)),
    (torch.float32, 2048, 1536, 576, 0, 0, ("f32_tiled", None)),
    (torch.float32, 17, 65, 576, 0, 0, ("f32_tiled", None)),
    (torch.float32, 16, 65, 576, 0, 0, ("f32_skinny", None)),
    (torch.float32, 8, 1536, 576, 0, 0, ("f32_skinny", None)),
    (torch.float32, 1024, 8, 6144, 0, 0, ("f32_skinny", None)),  # grok-1's router
    (torch.float32, 2048, 64, 576, 0, 0, ("f32_skinny", None)),
    (torch.float32, 2048, 576, 129, 0, 0, ("fma", None)),  # k % 4 != 0
    (torch.float32, 2048, 576, 130, 0, 0, ("fma", None)),
    (torch.float32, 2048, 576, 576, 4, 0, ("fma", None)),  # A 4 bytes off
    (torch.float32, 8, 1536, 576, 0, 8, ("fma", None)),  # B 8 bytes off
    (torch.float32, 4, 4, 0, 0, 0, ("fma", None)),  # k = 0
])
def test_tnn_fused_variant_follows_shape_and_alignment(dtype, m, n, k, a_ptr, b_ptr, want):
    assert tnn_fused_variant(dtype, m, n, k, a_ptr, b_ptr) == want


@pytest.mark.parametrize("m,n,k,tile", [
    (2048, 49152, 576, (128, 128)), (2048, 1536, 576, (128, 128)), (2048, 576, 1536, (128, 128)),
    (8, 1536, 576, (16, 128)), (4, 8, 6144, (16, 128)), (1024, 8, 6144, (128, 16)),
    (1024, 384, 7168, (128, 128)), (17, 65, 4, (128, 128)), (1, 1, 4, (16, 128)),
    (1000, 3, 1000, (128, 16)),
])
def test_tnn_fused_f32_plans_list_the_cost_model_split_first(m, n, k, tile):
    """The f32 route's (config, plan) pairs: the tile of its route, the
    split of gemm_f32's cost model (``f32_split``) first, then 1, 2, 4, ...
    up to 32 splits, each covering every 16-deep k-step once and none
    empty; unaligned operands take the FMA kernel's one plan."""
    plans = tnn_fused_plans(m, n, k, torch.float32, True, 132)
    variant = "f32_tiled" if tile == (128, 128) else "f32_skinny"
    steps = -(-k // 16)
    assert plans[0][1] == (variant, tile, *f32_split(m, n, k, *tile, 132))
    for config, (v, t, splits, per) in plans:
        assert (v, t) == (variant, tile) and config == (*tile, 16 * per)
        assert 1 <= splits <= 32 and splits * per >= steps and (splits - 1) * per < steps
    assert len({c for c, _ in plans}) == len(plans)
    assert tnn_fused_plans(m, n, k, torch.float32, False, 132) == (
        ((64, 64, 32), ("fma", None, 1, 1)),)


@pytest.mark.parametrize("a_shape,b_shape,offset,block,route_name", [
    ((256, 576), (96, 576), 0, (64, 64, 32), "f32_tiled"),  # the FMA kernel's tile
    ((256, 576), (96, 576), 0, (16, 128, 576), "f32_tiled"),  # a skinny tile at m 256
    ((256, 576), (96, 576), 0, (128, 128, 100), "f32_tiled"),  # no multiple of 16
    ((256, 576), (96, 576), 0, (128, 128, 64), "f32_tiled"),  # 9 splits: not listed
    ((8, 576), (1536, 576), 0, (128, 128, 576), "f32_skinny"),
    ((1024, 6144), (8, 6144), 0, (16, 128, 384), "f32_skinny"),  # the m <= 16 tile at n 8
    ((256, 576), (96, 576), 1, (128, 128, 576), "fma"),  # A at an offset
    ((256, 578), (96, 578), 0, (128, 128, 576), "fma"),  # k % 4 != 0
])
def test_tnn_fused_f32_configs_off_the_list_raise(a_shape, b_shape, offset, block, route_name):
    a = torch.zeros(a_shape[0] * a_shape[1] + offset)[offset:].view(a_shape)
    b = torch.zeros(b_shape)
    with pytest.raises(ValueError, match=f"{route_name} route, has no plan"):
        ops.matmul_tnn_fused(a, b, block=block)


@pytest.mark.parametrize("m,n,k,want", [
    (4, 49152, 576, (1, 9)),  # 384 blocks fill 132 SMs: no split
    (8, 49152, 576, (1, 9)),
    (4, 192, 576, (9, 1)),  # 3 blocks: one split per k-block
    (4, 1536, 576, (9, 1)),
    (4, 576, 1536, (24, 1)),
    (64, 1536, 576, (3, 3)),  # partials capped at B's bytes: k // (2 m) = 4
    (64, 576, 1536, (12, 2)),
    (1, 1, 129, (3, 1)),
    (4, 4, 0, (1, 1)),
    (2048, 576, 1536, (2, 12)),  # 160 blocks: two splits
])
def test_nt_split_and_workspace(m, n, k, want):
    assert nt_split(m, n, k, 132) == want
    splits = want[0]
    assert nt_workspace_shape(m, n, k, 132) == ((splits, m, n) if splits > 1 else None)


def test_nt_split_covers_every_k_block_once():
    for m, n, k, sms in itertools.product((1, 4, 8, 63, 64, 65, 130, 2048),
                                          (1, 192, 576, 1536, 49152),
                                          (1, 8, 129, 576, 1536), (78, 132)):
        splits, per = nt_split(m, n, k, sms)
        nkb = -(-k // 64)
        assert splits >= 1 and per >= 1
        assert splits * per >= nkb and (splits - 1) * per < max(nkb, 1), (m, n, k, sms)


# The bf16 NN GEMMs of a train step (smollm-135m, 2048 tokens): the data
# gradients G . W, then stage 2 of the weight gradients transpose(G) . X.
NN_TRAIN_SHAPES = (
    (2048, 576, 576), (2048, 576, 192), (2048, 576, 1536), (2048, 1536, 576),
    (2048, 576, 49152),
    (576, 576, 2048), (192, 576, 2048), (1536, 576, 2048), (576, 1536, 2048),
    (49152, 576, 2048),
)


@pytest.mark.parametrize("m,n,k,a_ptr,b_ptr,dtype,want", [
    (2048, 576, 576, 0, 0, torch.bfloat16, "wgmma"),
    (2048, 576, 49152, 0, 0, torch.bfloat16, "wgmma"),
    (65, 200, 136, 0, 0, torch.bfloat16, "wgmma"),  # m just past the skinny kernel's 64
    (64, 1536, 576, 0, 0, torch.bfloat16, "skinny"),
    (8, 49152, 576, 256, 512, torch.bfloat16, "skinny"),
    (1, 96, 136, 0, 0, torch.bfloat16, "skinny"),
    (2048, 197, 576, 0, 0, torch.bfloat16, "fma"),  # n % 8 != 0: B's rows off 16 bytes
    (2048, 576, 129, 0, 0, torch.bfloat16, "fma"),  # k % 8 != 0
    (8, 576, 576, 2, 0, torch.bfloat16, "fma"),  # A 2 bytes off
    (2048, 576, 576, 0, 8, torch.bfloat16, "fma"),  # B 8 bytes off
    (4, 8, 0, 0, 0, torch.bfloat16, "fma"),  # k = 0: no tensor map
    (2048, 576, 576, 0, 0, torch.float32, "tiled"),  # f32 aligned: gemm_f32
])
def test_nn_variant_follows_shape_and_alignment(m, n, k, a_ptr, b_ptr, dtype, want):
    variant, bn, splits, per = nn_plan(m, n, k, dtype, a_ptr, b_ptr, 132)
    assert variant == want
    assert (bn in (64, 128, 192, 256)) == (variant == "wgmma")
    assert splits >= 1 and per >= 1
    if variant == "fma":
        assert (splits, per) == (1, 1)
    if variant == "skinny":
        assert (splits, per) == nt_split(m, n, k, 132)
    if dtype == torch.float32 and variant != "fma":
        assert (splits, per) == f32_split(m, n, k, *bn, 132)


SKINNY_ROWS, SKINNY_COLS, TILED, FMA = (("skinny", (16, 128)), ("skinny", (128, 16)),
                                       ("tiled", (128, 128)), ("fma", None))


@pytest.mark.parametrize("nt", [True, False])
@pytest.mark.parametrize("m,n,k,a_ptr,b_ptr,want_nt,want_nn", [
    (4, 8, 6144, 0, 0, SKINNY_ROWS, SKINNY_ROWS),  # grok-1's router at decode
    (1024, 8, 6144, 0, 0, SKINNY_COLS, SKINNY_COLS),  # ... at prefill: A streamed once
    (4, 384, 7168, 0, 0, SKINNY_ROWS, SKINNY_ROWS),  # kimi-k2's router at decode
    (1024, 384, 7168, 0, 0, TILED, TILED),
    (16, 576, 1536, 0, 0, SKINNY_ROWS, SKINNY_ROWS),
    (17, 576, 1536, 0, 0, TILED, TILED),
    (1000, 64, 1000, 0, 0, SKINNY_COLS, SKINNY_COLS),
    (1000, 68, 1000, 0, 0, TILED, TILED),
    (4096, 4096, 4096, 256, 512, TILED, TILED),
    (64, 130, 256, 0, 0, TILED, FMA),  # NN reads B's (k, n) rows as float4: n % 4
    (4, 130, 256, 0, 0, SKINNY_ROWS, FMA),
    (2048, 576, 576, 4, 0, FMA, FMA),  # A 4 bytes off
    (2048, 576, 576, 0, 8, FMA, FMA),  # B 8 bytes off
    (4, 576, 129, 0, 0, FMA, FMA),  # k % 4 != 0
    (4, 8, 0, 0, 0, FMA, FMA),  # k = 0
])
def test_f32_routes_follow_shape_and_alignment(nt, m, n, k, a_ptr, b_ptr, want_nt, want_nn):
    """The f32 NT and NN plans: gemm_f32's skinny tiles where m <= 16 or n
    <= 64, its 128 x 128 tile above, the FMA kernel for unaligned operands
    or a k (NN: or n) off a multiple of 4; the NT and NN wrappers list the
    same plans."""
    aligned = a_ptr % 16 == 0 and b_ptr % 16 == 0
    plans = f32_plans(m, n, k, nt, aligned, 132)
    variant, tile, splits, per = plans[0][1]
    assert (variant, tile) == (want_nt if nt else want_nn)
    assert f32_route(m, n, k, nt, aligned) == variant
    if nt:
        assert nt_plans(m, n, k, torch.float32, aligned, 132) == plans
    else:
        assert nn_plan(m, n, k, torch.float32, a_ptr, b_ptr, 132) == plans[0][1]
    if variant == "fma":
        assert (splits, per) == (1, 1) and len(plans) == 1
    else:
        assert (splits, per) == f32_split(m, n, k, *tile, 132)
        for config, (v, t, s, p) in plans:  # (bm, bn, k of a split)
            assert (v, t) == (variant, tile) and config == (*tile, 16 * p)
            assert s <= 32 and (s - 1) * p < -(-k // 16) <= s * p


@pytest.mark.parametrize("m,n,k,want", [
    (4, 8, 6144, (32, 12)),  # one tile: 32 splits, the most the reduce sums
    (1024, 8, 6144, (16, 24)),
    (1024, 384, 7168, (11, 41)),  # 24 tiles: two blocks per SM
    (4096, 4096, 4096, (1, 256)),  # 1024 tiles: no split
    (2048, 2048, 2048, (1, 128)),  # 256 tiles, about two waves: no split
    (128, 128, 128, (8, 1)),
    (4, 49152, 576, (1, 36)),  # 384 tiles of the LM head: no split
])
def test_f32_split_fills_the_card_where_tiles_cannot(m, n, k, want):
    variant, tile, _, _ = f32_plans(m, n, k, True, True, 132)[0][1]
    assert f32_split(m, n, k, *tile, 132) == want


def test_f32_split_covers_every_k_step_once():
    for m, n, k, sms in itertools.product((1, 4, 16, 17, 129, 1024, 4096),
                                          (1, 8, 64, 65, 384, 4096),
                                          (4, 16, 20, 576, 1000, 6144), (78, 132)):
        for bm, bn in ((16, 128), (128, 16), (128, 128)):
            splits, per = f32_split(m, n, k, bm, bn, sms)
            steps = -(-k // 16)
            assert 1 <= splits <= 32 and per >= 1
            assert (splits - 1) * per < steps <= splits * per, (m, n, k, sms, bm, bn)


@pytest.mark.parametrize("m,n,k,want", [
    (2048, 576, 49152, (192, 8, 96)),  # 48 tiles for 132 SMs, each walking 768 k-blocks
    (192, 576, 2048, (64, 4, 8)),  # the k/v weight gradient: 18 tiles
    (2048, 1536, 576, (192, 1, 9)),  # 128 tiles: one wave
    (49152, 576, 2048, (192, 1, 32)),  # 1152 tiles: no split
])
def test_nn_wgmma_plan_splits_where_tiles_cannot_fill_the_card(m, n, k, want):
    assert nn_plan(m, n, k, torch.bfloat16, 0, 0, 132)[1:] == want


def test_nn_split_covers_every_k_block_once():
    for m, n, k, sms in itertools.product((1, 8, 64, 65, 129, 192, 576, 2048, 49152),
                                          (8, 96, 200, 576, 1536, 49152),
                                          (8, 136, 192, 576, 2048, 49152), (78, 132)):
        variant, _, splits, per = nn_plan(m, n, k, torch.bfloat16, 0, 0, sms)
        assert variant in ("wgmma", "skinny")
        nkb = -(-k // 64)
        covered = [kb for s in range(splits) for kb in range(s * per, min(nkb, (s + 1) * per))]
        assert covered == list(range(nkb)), (m, n, k, sms)
        assert all(s * per < nkb for s in range(splits)), (m, n, k, sms)  # none empty


@pytest.mark.parametrize("dtype,g,m,n,k,nt,a_ptr,b_ptr,want", [
    (torch.float32, 24, 768, 256, 64, True, 0, 0, ("tiled", 1, 4)),  # logits, dP: 1152 tiles
    (torch.float32, 24, 256, 64, 768, False, 0, 0, ("tiled", 4, 12)),  # dK, dV: 96 tiles
    (torch.float32, 24, 768, 64, 256, False, 0, 0, ("tiled", 1, 16)),  # dQ: 288 tiles
    (torch.float32, 12, 3, 64, 512, False, 0, 0, ("tiled", 8, 4)),  # decode probs @ V
    (torch.float32, 1, 127, 129, 64, True, 0, 0, ("tiled", 1, 4)),  # BNT takes any n; 64 of k: no split
    (torch.float32, 1, 127, 129, 64, False, 0, 0, ("fma", 1, 1)),  # BNN's rows of 129 floats
    (torch.float32, 2, 65, 70, 63, True, 0, 0, ("fma", 1, 1)),  # k % 4 != 0
    (torch.float32, 24, 768, 256, 64, True, 4, 0, ("fma", 1, 1)),  # A 4 bytes off
    (torch.bfloat16, 24, 768, 64, 256, False, 0, 0, ("mma", 1, 1)),  # probs @ V, TNN policy
    (torch.bfloat16, 24, 768, 256, 64, True, 0, 0, ("mma", 1, 1)),
    (torch.bfloat16, 2, 65, 70, 68, True, 0, 0, ("fma", 1, 1)),  # k % 8 != 0
    (torch.bfloat16, 2, 65, 68, 64, False, 0, 0, ("fma", 1, 1)),  # BNN's n % 8 != 0
    (torch.bfloat16, 24, 768, 64, 256, False, 0, 2, ("fma", 1, 1)),  # B 2 bytes off
    (torch.bfloat16, 2, 4, 8, 0, True, 0, 0, ("fma", 1, 1)),  # k = 0
])
def test_batched_variant_follows_shape_and_alignment(dtype, g, m, n, k, nt, a_ptr, b_ptr, want):
    variant, _, splits, per = batched_plan(dtype, g, m, n, k, nt, a_ptr, b_ptr, 132)
    assert (variant, splits, per) == want


def test_batched_split_covers_every_k_step_once():
    for g, m, n, k, sms in itertools.product((1, 12, 24, 40000), (1, 3, 256, 768),
                                             (64, 256, 512), (4, 64, 256, 768, 4096),
                                             (78, 132)):
        variant, _, splits, per = batched_plan(torch.float32, g, m, n, k, False, 0, 0, sms)
        assert variant == "tiled"
        steps = -(-k // 16)
        assert splits * per >= steps and (splits - 1) * per < steps, (g, m, n, k, sms)
        assert g * splits <= 65535 and per >= min(4, steps), (g, m, n, k, sms)


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


WIDE_DHS = (112, 120, 256)  # h2o-danube-3-4b's 120, zamba2-7b's 112, gemma3's 256
WIDE_SHAPES = ((2, 40, 70), (3, 1, 96))  # (g, m, n): prefill-sized, decode


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("g,m,n", WIDE_SHAPES)
@pytest.mark.parametrize("dh", WIDE_DHS)
@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_attention_plain_matches_pallas_at_wide_heads(J, mask_name, dh, g, m, n, dtype_name):
    """The dense plain version at the head dims above 64 and 128 that the
    Pallas kernel pads to its 128 edge (112, 120) or takes whole (256).
    Tolerance: tests/test_kernels.py::_tol at k = dh (the logits' depth)."""
    rng = np.random.RandomState(dh + g * 10 + m + n)
    (jq, tq), (jk, tk), (jv, tv) = _attn_operands(J, rng, g, m, n, dh, dtype_name)
    kw = MASKS[mask_name](m, n)
    lengths = None
    if mask_name == "ragged_lengths":
        lengths = rng.randint(1, n + 1, size=g).astype(np.int32)
    want = J.attention(jq, jk, jv, None if lengths is None else J.jnp.asarray(lengths),
                       mask=J.Mask(**kw), interpret=True)
    out = attention_fused(tq, tk, tv, None if lengths is None else torch.from_numpy(lengths),
                          mask=MaskParams(**kw))
    assert out.shape == (g, m, dh) and out.dtype == DTYPES[dtype_name]
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype_name, dh))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("dh", WIDE_DHS)
@pytest.mark.parametrize("geom", ["mqa_prefix", "gqa_fold", "decode_fold"])
def test_attention_plain_matches_pallas_at_wide_head_geometries(J, geom, dh, dtype_name):
    """The model's geometries at the wide heads: paligemma's MQA fold of 8
    heads over a bidirectional prefix, gemma3's GQA fold of 2 under a
    causal window, and a decode step's folded group (m <= 16) over ragged
    lengths."""
    g, m, n, kw, lens = {
        "mqa_prefix": (1, 8 * 12, 12, dict(causal=True, prefix_len=4, q_seg=12), None),
        "gqa_fold": (2, 2 * 20, 36, dict(causal=True, window=9, q_start=16, q_seg=20), None),
        "decode_fold": (4, 8, 40, dict(), [40, 17, 1, 33]),
    }[geom]
    rng = np.random.RandomState(dh + m)
    (jq, tq), (jk, tk), (jv, tv) = _attn_operands(J, rng, g, m, n, dh, dtype_name)
    lengths = np.full(g, n, np.int32) if lens is None else np.asarray(lens, np.int32)
    want = J.attention(jq, jk, jv, J.jnp.asarray(lengths), mask=J.Mask(**kw), interpret=True)
    out = attention_fused(tq, tk, tv, torch.from_numpy(lengths), mask=MaskParams(**kw))
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype_name, dh))


def test_attention_row_without_keys_is_zero():
    """The one stated difference from the Pallas kernel: a row that sees
    no key (only ever query padding) comes out 0, not a tiling-dependent
    mean."""
    q, k, v = torch.randn(1, 2, 8), torch.randn(1, 4, 8), torch.randn(1, 4, 8)
    out = attention_fused(q, k, v, mask=MaskParams(causal=True, q_start=0, k_start=1))
    assert torch.all(out[0, 0] == 0) and torch.all(torch.isfinite(out))


@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_attention_plain_accumulates_in_f64_for_f64_inputs(mask_name):
    """The plain version on f64 inputs is the f64 reference the card tests
    and chip_smoke.py hold the f32 kernels to: an f64 result within f32
    rounding of its f32 result, and the same masking (NaN past ragged
    lengths never reaches it)."""
    rng = np.random.RandomState(5)
    g, m, n, dh = 3, 40, 70, 24
    q, k, v = (torch.from_numpy(rng.randn(g, s, dh) * 0.3) for s in (m, n, n))
    lengths = torch.tensor([70, 33, 1], dtype=torch.int32)
    for i, length in enumerate(lengths.tolist()):
        k[i, length:] = float("nan")
        v[i, length:] = float("nan")
    mask = MaskParams(**MASKS[mask_name](m, n))
    out64 = ref.attention_fused(q, k, v, lengths, mask)
    out32 = ref.attention_fused(q.float(), k.float(), v.float(), lengths, mask)
    assert out64.dtype == torch.float64 and torch.isfinite(out64).all()
    torch.testing.assert_close(out32.double(), out64, rtol=1e-5, atol=1e-6)


def test_attention_rejects_wide_heads_and_bad_tiles():
    x = torch.zeros(1, 2, 257)  # DH_MAX is 256
    with pytest.raises(ValueError):
        attention_fused(x, x, x)
    y = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError):
        attention_fused(y, y, y, block=(16, 32, 8))


@pytest.mark.parametrize("dtype,m,dh,aligned,want", [
    (torch.bfloat16, 1, 64, True, "decode_split"),
    (torch.bfloat16, 3, 64, True, "decode_split"),
    (torch.float32, 16, 128, True, "decode_split"),
    (torch.bfloat16, 16, 33, False, "decode_split"),
    (torch.bfloat16, 17, 64, True, "flash_mma"),
    (torch.bfloat16, 768, 64, True, "flash_mma"),
    (torch.bfloat16, 768, 128, True, "flash_mma"),
    (torch.bfloat16, 768, 16, True, "fma"),
    (torch.bfloat16, 768, 33, True, "fma"),
    (torch.bfloat16, 768, 64, False, "fma"),
    (torch.float32, 17, 64, True, "flash_f32"),
    (torch.float32, 768, 128, True, "flash_f32"),
    # the wide heads: split-KV at decode, the flash kernels above 16 rows
    # (112 and 120 on their 128-wide instances)
    (torch.bfloat16, 2, 256, True, "decode_split"),
    (torch.float32, 16, 256, True, "decode_split"),
    (torch.bfloat16, 8, 120, True, "decode_split"),
    (torch.bfloat16, 17, 256, True, "flash_mma"),
    (torch.bfloat16, 2048, 256, True, "flash_mma"),
    (torch.float32, 2048, 256, True, "flash_f32"),
    (torch.bfloat16, 2048, 120, True, "flash_mma"),
    (torch.bfloat16, 2048, 112, True, "flash_mma"),
    (torch.float32, 2048, 112, True, "flash_f32"),
    (torch.float32, 17, 120, True, "flash_f32"),
    (torch.bfloat16, 2048, 256, False, "fma"),  # unaligned: the FMA kernel
    (torch.bfloat16, 2048, 112, False, "fma"),
    (torch.bfloat16, 65, 120, False, "fma"),
    (torch.bfloat16, 2048, 96, True, "fma"),  # a head dim with no flash instance
    (torch.bfloat16, 2048, 200, True, "fma"),
    # f32: the flash kernel at its head dims on aligned operands above 16
    # rows; the FMA kernel at other head dims and on unaligned operands
    (torch.float32, 16, 64, True, "decode_split"),
    (torch.float32, 16, 256, False, "decode_split"),
    (torch.float32, 17, 256, True, "flash_f32"),
    (torch.float32, 17, 112, True, "flash_f32"),
    (torch.float32, 2048, 120, True, "flash_f32"),
    (torch.float32, 1000, 112, True, "flash_f32"),  # zamba2's exact-length prefill
    (torch.float32, 2048, 96, True, "fma"),
    (torch.float32, 2048, 200, True, "fma"),
    (torch.float32, 17, 16, True, "fma"),
    (torch.float32, 2048, 256, False, "fma"),
    (torch.float32, 2048, 112, False, "fma"),
    (torch.float32, 17, 64, False, "fma"),
])
def test_attention_variant_routes_by_dtype_and_shape(dtype, m, dh, aligned, want):
    assert attention_variant(dtype, 24, m, 256, dh, aligned) == want


@pytest.mark.parametrize("dtype,m,dh,aligned,tile,route_name", [
    (torch.float32, 17, 64, True, (64, 64), "flash_f32"),
    (torch.float32, 768, 128, True, (64, 64), "flash_f32"),
    (torch.float32, 1000, 112, True, (64, 64), "flash_f32"),
    (torch.float32, 2048, 120, True, (64, 64), "flash_f32"),
    (torch.float32, 2048, 256, True, (64, 32), "flash_f32"),  # two 32-key stages beside Q
    (torch.float32, 2048, 256, False, (16, 32), "fma"),
    (torch.float32, 2048, 96, True, (16, 32), "fma"),
    (torch.float32, 2048, 200, True, (16, 32), "fma"),
    (torch.bfloat16, 2048, 256, True, (64, 64), "flash_mma"),
])
def test_attention_plans_give_each_prefill_route_its_one_tile(dtype, m, dh, aligned, tile,
                                                              route_name):
    """Above 16 rows a route runs one tile (the f32 flash kernel's plan
    names its split of the key tiles); every other config raises on the
    CPU route too."""
    plan = ((route_name, flash_f32_splits(24, m, 256, dh, 132), None)
            if route_name == "flash_f32" else (route_name, 1, 1))
    assert attention_plans(dtype, 24, m, 256, dh, aligned) == ((tile, plan),)
    for bad in ((64, 64), (64, 32), (16, 32), (64, 128), (128, 64)):
        if bad == tile:
            continue
        q = torch.zeros(24 * m * dh + (0 if aligned else 1), dtype=dtype)
        q = q[(0 if aligned else 1):].view(24, m, dh)
        kv = torch.zeros(24, 256, dh, dtype=dtype)
        with pytest.raises(ValueError, match=f"{route_name} route, has no plan"):
            attention_fused(q, kv, kv, block=bad)


@pytest.mark.parametrize("g,m,n,dh,sms,want", [
    (4, 2048, 1024, 256, 132, 2),  # gemma3's prefill: 128 blocks, one an SM
    (2, 4096, 512, 256, 132, 2),  # paligemma's: 128 blocks
    (32, 1000, 1000, 112, 132, 1),  # zamba2's: 512 blocks, about four waves
    (16, 2048, 512, 120, 132, 1),
    (24, 768, 256, 64, 132, 1),  # a train step's forward: 288 blocks, two an SM
    (24, 768, 256, 128, 132, 1),
    (4, 17, 300, 64, 132, 2),  # few blocks: at most half the key tiles (5 of 64)
    (4, 17, 300, 256, 132, 4),  # at most 4 runs
    (3, 192, 64, 64, 132, 1),  # one key tile: nothing to split
    (4, 2048, 1024, 256, 78, 1),  # a smaller card: 128 blocks fill it
])
def test_flash_f32_splits_fill_the_card_from_the_shape(g, m, n, dh, sms, want):
    """The f32 flash kernel splits each q-block's key tiles only where the
    blocks fill less than two waves: a pure function of the shape and the
    SM count."""
    assert flash_f32_splits(g, m, n, dh, sms) == want


@pytest.mark.parametrize("g,n,sms,want", [
    (12, 512, 132, (16, 32)),  # the decode case of chip_smoke.py: 192 blocks
    (12, 80, 132, (3, 32)),  # the serve run's cache (max_seq 80)
    (1, 4096, 132, (64, 64)),  # at most 64 splits
    (4, 4096, 132, (64, 64)),
    (300, 64, 132, (1, 64)),  # slices enough to fill the card: one split, one launch
    (3, 1, 132, (1, 32)),
])
def test_decode_split_plan_fills_the_card(g, n, sms, want):
    assert decode_split_plan(g, n, sms) == want


def test_decode_split_plan_covers_every_key_once():
    for g, n, sms in itertools.product((1, 3, 12, 64, 500), (1, 31, 32, 33, 80, 511, 4097),
                                       (132, 114)):
        splits, per = decode_split_plan(g, n, sms)
        assert per >= 32 and per % 16 == 0 and splits <= 64
        assert (splits - 1) * per < n <= splits * per  # every key, no empty split


SPLIT_GEOMS = {  # (g, m, n, dh, mask, lengths): decode-sized rows, keys in runs
    "ragged": (3, 3, 200, 64, dict(), [200, 77, 1]),
    "causal": (2, 16, 150, 32, dict(causal=True, q_start=40), None),  # keys > 55 unseen
    "folded": (2, 12, 130, 16, dict(causal=True, q_start=126, q_seg=4), None),
}


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("per", [32, 48])
@pytest.mark.parametrize("geom", sorted(SPLIT_GEOMS))
def test_split_then_combine_matches_pallas(J, geom, per, dtype_name):
    """The decode kernel's split-KV arithmetic (per-split max, sum and
    V-dtype PV, then the combine) against the Pallas kernel."""
    g, m, n, dh, kw, lens = SPLIT_GEOMS[geom]
    rng = np.random.RandomState(per + n)
    (jq, tq), (jk, tk), (jv, tv) = _attn_operands(J, rng, g, m, n, dh, dtype_name)
    lengths = np.full(g, n, np.int32) if lens is None else np.asarray(lens, np.int32)
    want = J.attention(jq, jk, jv, J.jnp.asarray(lengths), mask=J.Mask(**kw), interpret=True)
    parts = ref.attention_split_partials(tq, tk, tv, torch.from_numpy(lengths),
                                         MaskParams(**kw), per)
    out = ref.attention_split_combine(*parts, DTYPES[dtype_name])
    assert out.dtype == DTYPES[dtype_name]
    bound = 1e-4 if dtype_name == "float32" else 2e-2
    np.testing.assert_allclose(_np(out), _np(want), rtol=bound, atol=bound)


def test_split_without_visible_keys_adds_exactly_zero():
    """A split in which a row sees no key leaves max NEG_INF, sum 0, acc 0,
    and the combine skips it: poisoning its partial changes no bit."""
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((4, 3, 16), (4, 200, 16), (4, 200, 16)))
    lengths = torch.tensor([200, 77, 1, 0], dtype=torch.int32)
    mx, sm, acc = ref.attention_split_partials(q, k, v, lengths, MaskParams(), per=32)
    assert mx.shape[0] == 7
    for s in range(1, 7):  # slice 2 (length 1) sees key 0 only; slice 3 none
        assert torch.all(mx[s, 2:] == NEG_INF)
        assert torch.all(sm[s, 2:] == 0) and torch.all(acc[s, 2:] == 0)
    out = ref.attention_split_combine(mx, sm, acc, torch.float32)
    sm2, acc2 = sm.clone(), acc.clone()
    sm2[1:, 2:], acc2[1:, 2:] = float("nan"), float("nan")
    assert torch.equal(ref.attention_split_combine(mx, sm2, acc2, torch.float32), out)
    assert torch.all(out[3] == 0)  # no key at all: exactly 0
    torch.testing.assert_close(out, ref.attention_fused(q, k, v, lengths, MaskParams()),
                               rtol=1e-6, atol=1e-6)


# -- on the card: each CUDA kernel against its plain version ---------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k", [(1, 1), (127, 129), (1536, 576)])
def test_transpose_kernel_matches_plain_on_card(cuda, n, k, dtype):
    b = torch.randn(n, k, device=cuda).to(getattr(torch, dtype))
    assert torch.equal(ops.transpose(b), ref.transpose(b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES + (
    (8, 49152, 576), (64, 576, 1536),
    # the serve path's projections at decode bucket 4 and prefill (split-k
    # at every width but the LM head), ragged m around the 64-row A tile,
    # k % 8 != 0, and a k that is no multiple of the 64-wide stage
    (1, 192, 576), (4, 576, 576), (4, 1536, 576), (4, 576, 1536), (4, 49152, 576),
    (63, 1536, 576), (64, 1536, 576), (65, 192, 1536), (130, 576, 129), (2048, 1536, 576),
    (65, 197, 136)))
def test_gemm_kernels_match_plain_on_card(cuda, m, n, k, dtype):
    dt = getattr(torch, dtype)
    a, w = torch.randn(m, k, device=cuda).to(dt), torch.randn(n, k, device=cuda).to(dt)
    tol = _tol(dtype, k)
    reset_launches()
    torch.testing.assert_close(ops.matmul_nt(a, w).float(), ref.matmul_nt(a, w).float(), **tol)
    assert LAUNCHES["matmul_nt"] == 1  # one call, split-k or not
    torch.testing.assert_close(ops.matmul_tnn(a, w).float(), ref.matmul_nt(a, w).float(), **tol)
    wt = w.t().contiguous()
    torch.testing.assert_close(ops.matmul_nn(a, wt).float(), ref.matmul_nn(a, wt).float(), **tol)
    assert LAUNCHES["transpose"] == 1 and LAUNCHES["matmul_nn"] == 2
    # an operand that starts one element past an aligned address takes the
    # NT kernel's scalar loads
    a_odd = torch.randn(m * k + 1, device=cuda).to(dt)[1:].view(m, k)
    torch.testing.assert_close(ops.matmul_nt(a_odd, w).float(), ref.matmul_nt(a_odd, w).float(),
                               **tol)
    assert LAUNCHES["matmul_nt"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("op,m,n,k", [
    ("transpose", 0, 262144, 2560),  # gemma3's LM head, (262144, 2560): 6.7e8 elements
    ("matmul_nt", 4, 262144, 2560),  # its decode logits
    ("matmul_nn", 4, 262144, 2560),
    ("matmul_tnn_fused", 4096, 262144, 2560),  # prefill-sized logits: 1.07e9 elements
    ("matmul_nn", 256000, 4608, 2048),  # gemma2's LM-head weight gradient: 1.18e9
    ("matmul_nn", 1024, 4608, 256000),  # its data gradient, k = 256000
])
def test_gemm_kernels_at_the_widest_products_on_card(cuda, op, m, n, k):
    """The kernels' index arithmetic near 2^31 elements, bf16: the widest
    operands and outputs of the ported architectures."""
    dt = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(0)
    if op == "transpose":
        b = torch.randn(n, k, device=cuda, generator=gen).to(dt)
        assert torch.equal(ops.transpose(b), ref.transpose(b))
        return
    a = torch.randn(m, k, device=cuda, generator=gen).to(dt)
    b = torch.randn(*((k, n) if op == "matmul_nn" else (n, k)), device=cuda, generator=gen).to(dt)
    want = (ref.matmul_nn if op == "matmul_nn" else ref.matmul_nt)(a, b)
    reset_launches()
    out = getattr(ops, op)(a, b)
    assert LAUNCHES[op] == 1
    torch.testing.assert_close(out.float(), want.float(), **_tol("bfloat16", k))


ROUTE_MS = (1, 3, 16, 17, 63, 64, 65, 129)  # around the split kernel's 16 and the 64-row block
ROUTE_DHS = (64, 128, 16, 33)  # the flash kernel's two, and two it leaves to the others


def _check_attention_on_card(q, k, v, lengths, mask, dtype):
    """One call against the plain version, one launch counted, and a second
    call giving the same bits."""
    bound = 1e-4 if dtype == "float32" else 2e-2
    g, m, dh = q.shape
    n = k.shape[1]
    full = torch.full((g,), n, device=q.device, dtype=torch.int32)
    reset_launches()
    out = attention_fused(q, k, v, lengths, mask=mask)
    variant = attention_variant(q.dtype, g, m, n, dh)
    assert LAUNCHES["attention_fused"] == 1 and ATTENTION_ROUTES == {(variant, dh): 1}
    want = ref.attention_fused(q, k, v, full if lengths is None else lengths, mask)
    torch.testing.assert_close(out.float(), want.float(), rtol=bound, atol=bound,
                               msg=lambda s: f"{variant}, m {m}, dh {dh}: {s}")
    assert torch.equal(attention_fused(q, k, v, lengths, mask=mask), out)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", ROUTE_MS)
@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_attention_kernel_matches_plain_on_card(cuda, mask_name, m, dtype):
    """Every route (decode_split at m <= 16, flash_mma for bf16 dh 64 and
    128, fma for the rest) at n = 200, no multiple of 64; ragged lengths
    include a slice of length 1, whose later splits see no key."""
    g, n = 3, 200
    dt = getattr(torch, dtype)
    lengths = (torch.tensor([200, 77, 1], device=cuda, dtype=torch.int32)
               if mask_name == "ragged_lengths" else None)
    mask = MaskParams(**MASKS[mask_name](m, n))
    for dh in ROUTE_DHS:
        q, k, v = (torch.randn(g, s, dh, device=cuda).mul(0.3).to(dt) for s in (m, n, n))
        _check_attention_on_card(q, k, v, lengths, mask, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,m,n,dh,kw", [
    (3, 144, 200, 64, dict(causal=True, q_start=152, q_seg=48)),  # folds inside a 64-row block
    (3, 144, 200, 128, dict(causal=True, q_start=152, q_seg=48)),
    (24, 768, 256, 64, dict(causal=True, q_seg=256)),  # a train step's forward
    (24, 768, 256, 128, dict(causal=True, q_seg=256)),
    (3, 192, 64, 64, dict(causal=True, q_seg=64)),  # a 64-token prefill
    (300, 3, 64, 64, dict()),  # decode with slices enough for one split
    (12, 3, 512, 64, dict()),  # decode, 16 splits
    (1, 16, 4096, 128, dict(causal=True, q_start=4000)),  # most splits see no key
])
def test_attention_shapes_match_plain_on_card(cuda, g, m, n, dh, kw, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(g, s, dh, device=cuda).mul(0.3).to(dt) for s in (m, n, n))
    lengths = torch.randint(1, n + 1, (g,), device=cuda, dtype=torch.int32)
    _check_attention_on_card(q, k, v, None, MaskParams(**kw), dtype)
    _check_attention_on_card(q, k, v, lengths, MaskParams(**kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [3, 65])
def test_attention_ignores_nan_beyond_lengths_on_card(cuda, m, dtype):
    """K and V beyond lengths are never read: NaN there gives a finite output."""
    g, n, dh = 3, 200, 64
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(g, s, dh, device=cuda).mul(0.3).to(dt) for s in (m, n, n))
    lengths = torch.tensor([200, 77, 1], device=cuda, dtype=torch.int32)
    for i, length in enumerate(lengths.tolist()):
        k[i, length:] = float("nan")
        v[i, length:] = float("nan")
    out = _check_attention_on_card(q, k, v, lengths, MaskParams(), dtype)
    assert torch.isfinite(out).all()


WIDE_ROUTE_MS = (1, 2, 8, 16, 17, 65)  # decode_split up to 16 rows; flash_mma (bf16), fma above


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", WIDE_ROUTE_MS)
@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_attention_wide_heads_match_plain_on_card(cuda, mask_name, m, dtype):
    """The 256-bound instances of the split and FMA kernels (dynamic shared
    memory; a bf16 key row spans the whole warp) at dh 256, and the
    128-bound ones at the ragged 112 and 120 (14 and 15 sixteen-byte
    chunks of 16 lanes: the lanes past them must add 0), every mask; above
    16 rows bf16 takes the flash kernel's 128- and 256-wide instances."""
    g, n = 3, 200
    dt = getattr(torch, dtype)
    lengths = (torch.tensor([200, 77, 1], device=cuda, dtype=torch.int32)
               if mask_name == "ragged_lengths" else None)
    mask = MaskParams(**MASKS[mask_name](m, n))
    for dh in WIDE_DHS:
        q, k, v = (torch.randn(g, s, dh, device=cuda).mul(0.3).to(dt) for s in (m, n, n))
        _check_attention_on_card(q, k, v, lengths, mask, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,m,n,dh,kw", [
    (16, 2, 2048, 256, dict()),  # gemma3 decode: batch 4 x 4 kv heads, fold 2, full cache
    (16, 2, 1024, 256, dict()),  # ... over a local layer's ring
    (4, 2048, 2048, 256, dict(causal=True, window=1024, q_start=1024, q_seg=1024)),  # local
    (4, 2048, 1024, 256, dict(causal=True, q_seg=1024)),  # gemma3 prefill, first chunk
    (2, 4096, 512, 256, dict(causal=True, prefix_len=256, q_seg=512)),  # paligemma, MQA 8
    (1, 16, 4096, 256, dict(causal=True, q_start=4000)),  # most splits see no key
    (8, 4, 1024, 120, dict()),  # h2o-danube-3-4b decode (fold 4)
    (8, 512, 512, 120, dict(causal=True, q_seg=128)),  # ... prefill
    (4, 4, 300, 112, dict()),
])
def test_attention_wide_head_shapes_match_plain_on_card(cuda, g, m, n, dh, kw, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(g, s, dh, device=cuda).mul(0.3).to(dt) for s in (m, n, n))
    lengths = torch.randint(1, n + 1, (g,), device=cuda, dtype=torch.int32)
    _check_attention_on_card(q, k, v, None, MaskParams(**kw), dtype)
    _check_attention_on_card(q, k, v, lengths, MaskParams(**kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [2, 16, 65])
@pytest.mark.parametrize("dh", WIDE_DHS)
def test_attention_wide_heads_ignore_nan_and_zero_unseen_rows_on_card(cuda, dh, m, dtype):
    """NaN in K and V beyond lengths is never read; a slice of length 0
    and the rows that see no key (k_start past their position) come out
    exactly 0."""
    g, n = 4, 300
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(g, s, dh, device=cuda).mul(0.3).to(dt) for s in (m, n, n))
    lengths = torch.tensor([300, 77, 1, 0], device=cuda, dtype=torch.int32)
    for i, length in enumerate(lengths.tolist()):
        k[i, length:] = float("nan")
        v[i, length:] = float("nan")
    out = _check_attention_on_card(q, k, v, lengths, MaskParams(), dtype)
    assert torch.isfinite(out).all() and torch.all(out[3] == 0)
    unseen = MaskParams(causal=True, q_start=0, k_start=1)  # row 0 sees no key
    out = _check_attention_on_card(q, k, v, lengths, unseen, dtype)
    assert torch.all(out[:, 0] == 0) and torch.isfinite(out).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES + (
    (2048, 192, 576), (8, 1536, 576), (130, 49152, 576), (2048, 576, 1536),
    # the training forward's LM head and MLP up (wgmma, BN 256 and 192),
    # ragged m around the 128-row tile, k % 8 != 0 (mma.sync), a k that is
    # no multiple of the 64-wide TMA box and an n that is no multiple of 8
    (2048, 49152, 576), (2048, 1536, 576), (1, 576, 576), (4, 49152, 576),
    (63, 1536, 576), (64, 192, 1536), (65, 576, 129), (65, 197, 136)))
def test_tnn_fused_kernel_matches_plain_on_card(cuda, m, n, k, dtype):
    dt = getattr(torch, dtype)
    a, w = torch.randn(m, k, device=cuda).to(dt), torch.randn(n, k, device=cuda).to(dt)
    reset_launches()
    out = ops.matmul_tnn_fused(a, w)
    assert LAUNCHES["matmul_tnn_fused"] == 1
    torch.testing.assert_close(out.float(), ref.matmul_nt(a, w).float(), **_tol(dtype, k))
    # an operand that starts one element past an aligned address takes the
    # mma.sync variant's scalar loads (bf16) or the FMA kernel (f32)
    a_odd = torch.randn(m * k + 1, device=cuda).to(dt)[1:].view(m, k)
    assert tnn_fused_variant(dt, m, n, k, a_odd.data_ptr(), w.data_ptr())[0] != "wgmma"
    torch.testing.assert_close(ops.matmul_tnn_fused(a_odd, w).float(),
                               ref.matmul_nt(a_odd, w).float(), **_tol(dtype, k))
    assert LAUNCHES["matmul_tnn_fused"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,m,n,k", BATCHED_SHAPES + ((24, 768, 256, 64), (24, 256, 64, 768),
                                                      (12, 3, 512, 64)))
def test_batched_kernels_match_plain_on_card(cuda, g, m, n, k, dtype):
    dt = getattr(torch, dtype)
    a = torch.randn(g, m, k, device=cuda).to(dt)
    b_nt = torch.randn(g, n, k, device=cuda).to(dt)
    b_nn = b_nt.transpose(1, 2).contiguous()
    reset_launches()
    tol = _tol(dtype, k)
    torch.testing.assert_close(ops.matmul_bnt(a, b_nt).float(), ref.matmul_bnt(a, b_nt).float(),
                               **tol)
    torch.testing.assert_close(ops.matmul_bnn(a, b_nn).float(), ref.matmul_bnn(a, b_nn).float(),
                               **tol)
    assert LAUNCHES["matmul_bnt"] == LAUNCHES["matmul_bnn"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", NN_TRAIN_SHAPES)
def test_nn_kernel_matches_plain_at_training_shapes_on_card(cuda, m, n, k):
    """The wgmma variant at every bf16 NN shape of a train step, the
    split-k ones included; a split sums in a fixed order, so a second call
    gives the same bits."""
    a = torch.randn(m, k, device=cuda).to(torch.bfloat16)
    b = torch.randn(k, n, device=cuda).to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert nn_plan(m, n, k, a.dtype, a.data_ptr(), b.data_ptr(), sms)[0] == "wgmma"
    reset_launches()
    out = ops.matmul_nn(a, b)
    assert LAUNCHES["matmul_nn"] == 1
    torch.testing.assert_close(out.float(), ref.matmul_nn(a, b).float(), **_tol("bfloat16", k))
    assert torch.equal(ops.matmul_nn(a, b), out)
    assert LAUNCHES["matmul_nn"] == 2


NN_EDGE_SHAPES = (
    # ragged m around the skinny kernel's 64 rows and the wgmma kernel's
    # 128, n a multiple of 8 but not of 64 (96, 200) or not of 8 (197), a k
    # that is no multiple of the 64-deep stage, and k = 49152 (split k)
    (1, 96, 136), (63, 200, 136), (64, 1536, 576), (65, 200, 136), (129, 96, 136),
    (65, 197, 136), (129, 200, 576), (8, 49152, 576), (1, 576, 49152), (129, 96, 49152),
)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,m,n,k", [
    (dt, m, n, k) for dt in ("float32", "bfloat16") for m, n, k in NN_EDGE_SHAPES
    if dt == "bfloat16" or k < 49152  # f32 is the unchanged FMA kernel
])
def test_nn_kernel_variants_match_plain_on_card(cuda, m, n, k, dtype):
    dt = getattr(torch, dtype)
    a, b = torch.randn(m, k, device=cuda).to(dt), torch.randn(k, n, device=cuda).to(dt)
    tol = _tol(dtype, k)
    reset_launches()
    torch.testing.assert_close(ops.matmul_nn(a, b).float(), ref.matmul_nn(a, b).float(), **tol)
    assert LAUNCHES["matmul_nn"] == 1
    # an operand that starts one element past an aligned address takes the
    # FMA kernel, chosen before the launch
    a_odd = torch.randn(m * k + 1, device=cuda).to(dt)[1:].view(m, k)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert nn_plan(m, n, k, dt, a_odd.data_ptr(), b.data_ptr(), sms)[0] == "fma"
    torch.testing.assert_close(ops.matmul_nn(a_odd, b).float(), ref.matmul_nn(a_odd, b).float(),
                               **tol)
    assert LAUNCHES["matmul_nn"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,m,n,k", [
    (2, 65, 70, 63),  # k % 4 != 0: the FMA kernel
    (12, 3, 64, 512), (12, 3, 512, 64),  # m = 3 (decode), split k at f32
    (1, 200, 96, 136),  # g = 1
    (24, 768, 256, 64), (24, 256, 64, 768), (24, 768, 64, 256),  # the main path
])
def test_batched_kernel_variants_match_plain_on_card(cuda, g, m, n, k, dtype):
    dt = getattr(torch, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    a = torch.randn(g, m, k, device=cuda).to(dt)
    a_odd = torch.randn(g * m * k + 1, device=cuda).to(dt)[1:].view(g, m, k)
    tol = _tol(dtype, k)
    for nt in (True, False):
        name = "matmul_bnt" if nt else "matmul_bnn"
        fn, want_fn = getattr(ops, name), getattr(ref, name)
        b = torch.randn(*((g, n, k) if nt else (g, k, n)), device=cuda).to(dt)
        variant = batched_plan(dt, g, m, n, k, nt, a.data_ptr(), b.data_ptr(), sms)[0]
        vec = 4 if dtype == "float32" else 8
        assert (variant == "fma") == (k % vec != 0 or (not nt and n % vec != 0))
        reset_launches()
        out = fn(a, b)
        torch.testing.assert_close(out.float(), want_fn(a, b).float(), **tol)
        assert torch.equal(fn(a, b), out)  # split k sums in a fixed order
        # one element off alignment: the FMA kernel
        assert batched_plan(dt, g, m, n, k, nt, a_odd.data_ptr(), b.data_ptr(),
                            sms)[0] == "fma"
        torch.testing.assert_close(fn(a_odd, b).float(), want_fn(a_odd, b).float(), **tol)
        assert LAUNCHES[name] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("spec", [
    "fixed:nt=PALLAS_TNN_FUSED,nn=PALLAS_NN,tn=PALLAS_TN,bnt=PALLAS_BNT,bnn=PALLAS_BNN,attn=fused",
    "fixed:nt=PALLAS_TNN,nn=PALLAS_NN,tn=PALLAS_TN,bnt=PALLAS_BNT,bnn=PALLAS_BNN,attn=unfused",
])
def test_training_gradients_on_card_match_the_cpu(cuda, spec):
    """The backward of CUDA tensors runs on the autograd engine's own
    thread: it must find the policy scope (and so launch the kernels),
    including in the recompute of checkpointed units.  f32, smoke size:
    the card's kernels against the CPU's plain versions, 1e-4 relative."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves

    cfg = smoke_config("smollm-135m").replace(remat="full")
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(0)),
             "labels": torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(1))}
    out = {}
    for dev in ("cpu", "cuda"):
        params = lm.init_lm(0, cfg, device=dev)
        reset_launches()
        out[dev] = loss_and_grads(cfg, params, {k: v.to(dev) for k, v in batch.items()},
                                  policy_from_spec(spec))
        if dev == "cuda":
            used = {k for k, v in LAUNCHES.items() if v}
            assert {"matmul_nn", "transpose", "matmul_bnt", "matmul_bnn"} <= used, LAUNCHES
    (loss_c, g_c), (loss_g, g_g) = out["cpu"], out["cuda"]
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=0)
    for a, b in zip(tree_leaves(g_g), tree_leaves(g_c)):
        assert float((a.cpu() - b).norm()) <= 1e-4 * float(b.norm()) + 1e-12


# -- on the card: the MoE, Mamba-2 and Zamba2 shapes ----------------------------

def _poisoned(shape, dtype, device, gen):
    """A seeded operand whose allocation runs on past its last element
    into NaN: a kernel that reads beyond the operand's extent and lets what
    it read reach a valid output (a k-tail zeroed by multiplying, say)
    gives NaN there."""
    n = int(np.prod(shape))
    buf = torch.full((n + 4096,), float("nan"), device=device, dtype=dtype)
    buf[:n] = torch.randn(n, device=device, generator=gen).to(dtype)
    return buf[:n].view(shape)


# (m, n, k): the Mamba blocks' skinny projections -- dt (n 80 for mamba2,
# 112 for zamba2) and B/C (n 128, 64) -- at decode bucket 4 and at exact
# ragged prefill lengths (777, 1000), and the training backward's GEMMs
# with those widths as k (data gradients) or m (the TN weight gradients'
# NN); in f32 the MoE routers (n 8 for grok-1, 384 for kimi-k2) and their
# gradients
MOE_SSM_GEMMS = {
    "bfloat16": ((4, 80, 2560), (777, 80, 2560), (1024, 80, 2560), (4, 128, 2560),
                 (777, 128, 2560), (4, 112, 3584), (1000, 112, 3584), (4, 64, 3584),
                 (1000, 64, 3584), (1024, 2560, 80), (80, 2560, 1024), (1024, 3584, 112),
                 (112, 3584, 1024), (64, 3584, 1000)),
    "float32": ((4, 8, 6144), (777, 8, 6144), (1024, 8, 6144), (4, 384, 7168),
                (1000, 384, 7168), (1024, 6144, 8), (8, 6144, 1024), (384, 7168, 1000)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,m,n,k", [(d, *s) for d, shapes in MOE_SSM_GEMMS.items()
                                          for s in shapes])
def test_gemm_kernels_at_the_moe_and_ssm_shapes_on_card(cuda, dtype, m, n, k):
    """Direct NT, TNN (transpose + NN), NN and fused TNN, one launch each,
    on NaN-poisoned operands, against the plain versions."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(m * 7 + n * 3 + k)
    a, w = _poisoned((m, k), dt, cuda, gen), _poisoned((n, k), dt, cuda, gen)
    wt = _poisoned((k, n), dt, cuda, gen)
    wt.copy_(w.t())
    tol = _tol(dtype, k)
    want_nt, want_nn = ref.matmul_nt(a, w).float(), ref.matmul_nn(a, wt).float()
    reset_launches()
    for name, out, want in (("nt", ops.matmul_nt(a, w), want_nt),
                            ("tnn", ops.matmul_tnn(a, w), want_nt),
                            ("nn", ops.matmul_nn(a, wt), want_nn),
                            ("tnn_fused", ops.matmul_tnn_fused(a, w), want_nt)):
        assert torch.isfinite(out).all(), name
        torch.testing.assert_close(out.float(), want, **tol, msg=lambda s: f"{name}: {s}")
    assert (LAUNCHES["matmul_nt"], LAUNCHES["transpose"], LAUNCHES["matmul_nn"],
            LAUNCHES["matmul_tnn_fused"]) == (1, 1, 2, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,m,n,dh,kw", [
    (32, 777, 777, 112, dict(causal=True, q_seg=777)),  # zamba2's exact prefills (fma)
    (32, 1000, 1000, 112, dict(causal=True, q_seg=1000)),
    (128, 1, 2048, 112, dict()),  # its decode: bucket 4 x 32 heads (decode_split)
    (8, 6144, 1024, 128, dict(causal=True, q_seg=1024)),  # grok-1: 8 kv, fold 6 (flash)
    (8, 6 * 777, 777, 128, dict(causal=True, q_seg=777)),
    (32, 8, 2048, 128, dict()),  # kimi-k2's decode: 4 x 8 kv, fold 8
])
def test_attention_at_the_moe_and_hybrid_shapes_on_card(cuda, g, m, n, dh, kw, dtype):
    """Every route of the new shapes, with NaN in K and V beyond ragged
    lengths (exact ones for the causal prefills, whose rows see every
    earlier key)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(g + m + n)
    q, k, v = (torch.randn(g, s, dh, device=cuda, generator=gen).mul(0.3).to(dt)
               for s in (m, n, n))
    if kw:
        lengths = torch.full((g,), n, device=cuda, dtype=torch.int32)
    else:
        lengths = torch.randint(1, n + 1, (g,), device=cuda, dtype=torch.int32, generator=gen)
        for i, length in enumerate(lengths.tolist()):
            k[i, length:] = float("nan")
            v[i, length:] = float("nan")
    out = _check_attention_on_card(q, k, v, lengths, MaskParams(**kw), dtype)
    assert torch.isfinite(out).all()


# -- on the card: the wide-head flash instances and the f32 GEMM ---------------------

FLASH_WIDE_MS = (17, 100, 200)  # no multiple of the 64-row block


@pytest.mark.gpu
@pytest.mark.parametrize("dh", WIDE_DHS)
@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_flash_at_wide_heads_matches_plain_on_card(cuda, mask_name, dh):
    """The flash kernel at d_head 112 and 120 (the 128-wide instance over
    rows of the true stride) and 256 (an instance of its own), every mask,
    m no multiple of 64, ragged lengths with NaN in K and V beyond them:
    the plain version's output, one launch on flash_mma, the same bits
    twice."""
    g, n = 3, 300
    gen = torch.Generator(device=cuda).manual_seed(dh)
    lengths = torch.tensor([300, 77, 1], device=cuda, dtype=torch.int32)
    for m in FLASH_WIDE_MS:
        q, k, v = (torch.randn(g, s, dh, device=cuda, generator=gen).mul(0.3).to(torch.bfloat16)
                   for s in (m, n, n))
        for i, length in enumerate(lengths.tolist()):
            k[i, length:] = float("nan")
            v[i, length:] = float("nan")
        assert attention_variant(q.dtype, g, m, n, dh) == "flash_mma"
        out = _check_attention_on_card(q, k, v, lengths, MaskParams(**MASKS[mask_name](m, n)),
                                       "bfloat16")
        assert torch.isfinite(out).all()


# The danube3 cells' attention (d_head 120, bf16, 32 query heads over 8 kv
# heads, the group of 4 folded over a chunk's rows): g, m, n, the mask, and
# whether each slot has its own valid length.
DANUBE_LAYOUTS = {
    # training: 8 sequences x 8 kv heads, the second 1024-row chunk of 2048
    "train_chunk": (64, 4 * 1024, 2048,
                    dict(causal=True, window=4096, q_start=1024, k_start=0, q_seg=1024), False),
    # one prompt right-padded to the 4096 bucket: its third chunk, whose rows
    # and keys past the prompt's 2500 tokens are the padding's
    "prefill_padded": (8, 4 * 1024, 3072, dict(causal=True, q_start=2048, k_start=0, q_seg=1024),
                       False),
    # decode over 32 slots of 4128 positions, each slot at its own length
    "decode_ragged": (256, 4, 4128, {}, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("layout", sorted(DANUBE_LAYOUTS))
def test_the_default_runs_the_danube_layouts_fused_as_the_unfused_plan_on_card(cuda, layout):
    """The default policy sends each of the danube3 cells' attention layouts
    to the fused kernel (one launch on flash_mma or decode_split, counted
    in ``attn.fused``), and its output holds to the unfused plan's (cuBLAS
    BNT and BNN, f32 softmax, probabilities rounded to bf16) in bf16 within
    the attention bound; K and V are NaN beyond each slot's length."""
    from repro_torch.core import spans
    from repro_torch.core.engine import dispatch_attention
    from repro_torch.core.policy import FixedPolicy

    g, m, n, kw, ragged = DANUBE_LAYOUTS[layout]
    dh = 120
    gen = torch.Generator(device=cuda).manual_seed(len(layout))
    q = (torch.randn(g, m, dh, device=cuda, generator=gen) * dh**-0.5).to(torch.bfloat16)
    k, v = (torch.randn(g, n, dh, device=cuda, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    lengths = None
    if ragged:
        per_slot = torch.randint(1, n + 1, (g // 8,), device=cuda, generator=gen)
        per_slot[:2] = torch.tensor([1, n], device=cuda)
        lengths = per_slot.repeat_interleave(8).to(torch.int32)
        for i, length in enumerate(lengths.tolist()):
            k[i, length:] = float("nan")
            v[i, length:] = float("nan")
    reset_launches()
    with spans.recording():
        out = dispatch_attention(q, k, v, lengths=lengths, **kw)
    variant = attention_variant(q.dtype, g, m, n, dh)
    assert variant == ("decode_split" if m <= 16 else "flash_mma")
    assert ATTENTION_ROUTES == {(variant, dh): 1} and LAUNCHES["attention_fused"] == 1
    assert spans.counter("attn.fused") == (0, 1) and spans.counter("attn.unfused") is None
    want = dispatch_attention(q, k, v, lengths=lengths, policy=FixedPolicy("UNFUSED_ATTN"), **kw)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2, atol=2e-2,
                               msg=lambda s: f"{layout}: {s}")


F32_SIDES = (1, 3, 17, 127, 129, 1000)


def _f32_gemm_on_card(a, b, nt, sms):
    """One f32 NT (``nt``) or NN call: one launch under the route its plan
    names, within tests/test_kernels.py::_tol of f64, and a split plan's
    second call the same bits.  Returns the route."""
    (m, k), n = a.shape, (b.shape[0] if nt else b.shape[1])
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    variant, _, splits, _ = f32_plans(m, n, k, nt, aligned, sms)[0][1]
    name = "matmul_nt" if nt else "matmul_nn"
    reset_launches()
    out = getattr(ops, name)(a, b)
    assert GEMM_ROUTES == {(name, variant, "float32"): 1} and LAUNCHES[name] == 1
    want = torch.matmul(a.double(), b.double().t() if nt else b.double())
    torch.testing.assert_close(out.double(), want, **_tol("float32", k),
                               msg=lambda msg: f"{name} {variant} {(m, n, k)}: {msg}")
    if splits > 1:
        assert torch.equal(getattr(ops, name)(a, b), out)
    return variant


@pytest.mark.gpu
@pytest.mark.parametrize("n", F32_SIDES)
@pytest.mark.parametrize("m", F32_SIDES)
def test_f32_gemm_matches_f64_on_card(cuda, m, n):
    """NT and NN in f32 at every pair of ragged sides and k 4, 129, 1000,
    on operands whose storage runs on into NaN: gemm_f32's skinny and tiled
    tiles, and the FMA kernel where k (NN: or n) is no multiple of 4."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for k in (4, 129, 1000):
        gen = torch.Generator(device=cuda).manual_seed(m * 31 + n * 7 + k)
        a = _poisoned((m, k), torch.float32, cuda, gen)
        w = _poisoned((n, k), torch.float32, cuda, gen)
        wt = _poisoned((k, n), torch.float32, cuda, gen)
        wt.copy_(w.t())
        for nt, b in ((True, w), (False, wt)):
            variant = _f32_gemm_on_card(a, b, nt, sms)
            assert (variant == "fma") == (k % 4 != 0 or (not nt and n % 4 != 0))


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [
    (4, 8, 6144), (1024, 8, 6144), (4, 384, 7168), (1024, 384, 7168),  # the MoE routers
    (4, 576, 1536), (64, 1536, 576),  # smollm in f32: decode, a 64-token prefill
    (1024, 1024, 4096), (2048, 2048, 2048),  # the selector's grid
])
def test_f32_gemm_at_the_router_and_grid_shapes_on_card(cuda, m, n, k):
    """The main-path f32 shapes against f64 (split plans the same bits
    twice); the same operands one float past an aligned address take the
    FMA kernel, chosen before the launch."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = _poisoned((m, k), torch.float32, cuda, gen)
    w = _poisoned((n, k), torch.float32, cuda, gen)
    wt = w.t().contiguous()
    for nt, b in ((True, w), (False, wt)):
        assert _f32_gemm_on_card(a, b, nt, sms) != "fma"
        a_odd = torch.empty(m * k + 1, device=cuda)[1:].view(m, k)
        a_odd.copy_(a)
        assert _f32_gemm_on_card(a_odd, b, nt, sms) == "fma"


# -- on the card: the fused TNN's f32 routes and the f32 flash attention -------------


def _tnn_f32_on_card(a, b, sms):
    """One f32 fused-TNN call: one launch under the route its plan names,
    within tests/test_kernels.py::_tol of f64, and a split plan's second
    call the same bits.  Returns the route."""
    (m, k), n = a.shape, b.shape[0]
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    variant, _, splits, _ = tnn_fused_plans(m, n, k, torch.float32, aligned, sms)[0][1]
    reset_launches()
    out = ops.matmul_tnn_fused(a, b)
    assert GEMM_ROUTES == {("matmul_tnn_fused", variant, "float32"): 1}
    assert LAUNCHES["matmul_tnn_fused"] == 1
    torch.testing.assert_close(out.double(), a.double() @ b.double().t(), **_tol("float32", k),
                               msg=lambda msg: f"{variant} {(m, n, k)}: {msg}")
    if splits > 1:
        assert torch.equal(ops.matmul_tnn_fused(a, b), out)
    return variant


@pytest.mark.gpu
@pytest.mark.parametrize("n", F32_SIDES)
@pytest.mark.parametrize("m", F32_SIDES)
def test_tnn_fused_f32_matches_f64_on_card(cuda, m, n):
    """The fused TNN in f32 at every pair of ragged sides and k 4, 130,
    1000, on operands whose storage runs on into NaN: the as-stored tiles
    (f32_tiled, f32_skinny), and the FMA kernel where k is no multiple of 4."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for k in (4, 130, 1000):
        gen = torch.Generator(device=cuda).manual_seed(m * 31 + n * 7 + k)
        a = _poisoned((m, k), torch.float32, cuda, gen)
        w = _poisoned((n, k), torch.float32, cuda, gen)
        variant = _tnn_f32_on_card(a, w, sms)
        want = "fma" if k % 4 else ("f32_skinny" if m <= 16 or n <= 64 else "f32_tiled")
        assert variant == want


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [
    (4, 8, 6144), (1024, 8, 6144), (4, 384, 7168), (1024, 384, 7168),  # the MoE routers
    (2048, 49152, 576), (2048, 1536, 576), (2048, 192, 576), (2048, 576, 1536),  # LM head, MLP, k/v
    (8, 1536, 576), (1024, 80, 2560),  # decode; mamba2's dt projection
    (1024, 1024, 1024), (4096, 4096, 4096),  # the selector's grid
])
def test_tnn_fused_f32_at_the_router_and_training_shapes_on_card(cuda, m, n, k):
    """The main-path f32 shapes against f64 (split plans the same bits
    twice); the same operands one float past an aligned address take the
    FMA kernel, chosen before the launch."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    gen = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = _poisoned((m, k), torch.float32, cuda, gen)
    w = _poisoned((n, k), torch.float32, cuda, gen)
    assert _tnn_f32_on_card(a, w, sms) != "fma"
    a_odd = torch.empty(m * k + 1, device=cuda)[1:].view(m, k)
    a_odd.copy_(a)
    assert _tnn_f32_on_card(a_odd, w, sms) == "fma"


FLASH_F32_DHS = (64, 112, 120, 128, 256)
FLASH_F32_MS = (17, 100, 200, 2048)  # around and past the 64-row block


@pytest.mark.gpu
@pytest.mark.parametrize("dh", FLASH_F32_DHS)
@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_flash_f32_matches_plain_and_f64_on_card(cuda, mask_name, dh):
    """The f32 flash kernel at every instance (112 and 120 on the 128-wide
    one), every mask (softcap and a fold boundary among them), ragged
    lengths with NaN in K and V beyond them and a slice of length 0: the
    plain version's output and f64's within 1e-4, one launch on
    flash_f32, the same bits twice; rows that see no key come out 0."""
    g, n = 4, 300
    gen = torch.Generator(device=cuda).manual_seed(dh)
    lengths = torch.tensor([300, 77, 1, 0], device=cuda, dtype=torch.int32)
    for m in FLASH_F32_MS:
        q, k, v = (torch.randn(g, s, dh, device=cuda, generator=gen).mul(0.3)
                   for s in (m, n, n))
        for i, length in enumerate(lengths.tolist()):
            k[i, length:] = float("nan")
            v[i, length:] = float("nan")
        assert attention_variant(q.dtype, g, m, n, dh) == "flash_f32"
        mask = MaskParams(**MASKS[mask_name](m, n))
        out = _check_attention_on_card(q, k, v, lengths, mask, "float32")
        assert ATTENTION_ROUTES == {("flash_f32", dh): 2}
        want = ref.attention_fused(q.double(), k.double(), v.double(), lengths, mask)
        torch.testing.assert_close(out.double(), want, rtol=1e-4, atol=1e-4,
                                   msg=lambda s: f"m {m}, dh {dh}: {s}")
        assert torch.isfinite(out).all() and torch.all(out[3] == 0)
    unseen = MaskParams(causal=True, q_start=0, k_start=1)  # row 0 sees no key
    out = _check_attention_on_card(q, k, v, lengths, unseen, "float32")
    assert torch.all(out[:, 0] == 0) and torch.isfinite(out).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dh", FLASH_F32_DHS)
def test_flash_f32_split_and_whole_agree_on_card(cuda, dh):
    """The same slices through the split plan (4 slices: too few q-blocks
    to fill the card) and the whole one (40 slices): both within the f32
    bound of the plain version and of each other, the split one the same
    bits twice."""
    g, m, n = 40, 2048, 1024
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    gen = torch.Generator(device=cuda).manual_seed(dh + 1)
    q, k, v = (torch.randn(g, s, dh, device=cuda, generator=gen).mul(0.3) for s in (m, n, n))
    mask = MaskParams(causal=True, window=700, q_seg=1024)
    assert flash_f32_splits(g, m, n, dh, sms) == 1 < flash_f32_splits(4, m, n, dh, sms)
    whole = _check_attention_on_card(q, k, v, None, mask, "float32")
    few = [x[:4].contiguous() for x in (q, k, v)]
    split = _check_attention_on_card(*few, None, mask, "float32")
    torch.testing.assert_close(split, whole[:4], rtol=1e-5, atol=1e-5)


# -- on the card: every tile config reaches its kernel ---------------------------


def _tailed(shape, dt, gen, device):
    """A contiguous operand whose storage runs on into NaN: a kernel that
    reads past its operand's last element poisons its output."""
    size = int(np.prod(shape))
    buf = torch.randn(size + 4096, device=device, generator=gen).to(dt)
    buf[size:] = float("nan")
    return buf[:size].view(shape)


def _bits(x):
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k", [(1, 1), (31, 33), (63, 65), (127, 129), (65, 4097),
                                 (1536, 576)])
def test_transpose_instances_are_bit_exact_on_card(cuda, n, k, dtype):
    """Every (b_rows, b_cols) instance, on ragged shapes whose storage runs
    on into NaN and with NaN inside: the same bits as ``.t().contiguous()``,
    one launch counted under the instance's key."""
    from repro_torch.kernels.common import CONFIG_LAUNCHES
    from repro_torch.kernels.tiling import TRANSPOSE_INSTANCES

    gen = torch.Generator(device=cuda).manual_seed(n * 7 + k)
    b = _tailed((n, k), getattr(torch, dtype), gen, cuda)
    b[0, k // 2] = float("nan")
    want = b.t().contiguous()
    for block in TRANSPOSE_INSTANCES:
        reset_launches()
        out = ops.transpose(b, block=block)
        assert torch.equal(_bits(out), _bits(want)), block
        assert CONFIG_LAUNCHES == {("transpose", f"{block[0]}x{block[1]}"): 1}


GEMM_CONFIG_SHAPES = {  # kernel: (g, m, n, k) cells on each route
    "matmul_nt": ((1, 4, 576, 576), (1, 8, 1536, 576), (1, 65, 197, 136), (1, 3, 77, 1000)),
    "matmul_nn": ((1, 4, 576, 1536), (1, 130, 576, 136), (1, 2048, 1536, 576),
                  (1, 65, 197, 136), (1, 300, 264, 1000)),
    "matmul_tnn_fused": ((1, 130, 576, 136), (1, 2048, 1536, 576), (1, 65, 197, 130)),
    "matmul_bnt": ((24, 768, 256, 64), (12, 3, 512, 64), (3, 65, 97, 40), (2, 70, 50, 1000)),
    "matmul_bnn": ((24, 256, 64, 768), (12, 3, 64, 512), (3, 65, 96, 40), (2, 70, 56, 1000)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", sorted(GEMM_CONFIG_SHAPES))
def test_gemm_configs_match_plain_on_card(cuda, kernel, dtype):
    """Every config of each route's space (``kernels/tiling.py``), on
    operands whose storage runs on into NaN, against the plain version:
    one launch per call, counted under the config."""
    from repro_torch.kernels import tiling
    from repro_torch.kernels.common import CONFIG_LAUNCHES, config_key

    dt = getattr(torch, dtype)
    fn = {"matmul_nt": ops.matmul_nt, "matmul_nn": ops.matmul_nn,
          "matmul_tnn_fused": ops.matmul_tnn_fused, "matmul_bnt": ops.matmul_bnt,
          "matmul_bnn": ops.matmul_bnn}[kernel]
    plain = {"matmul_nt": ref.matmul_nt, "matmul_nn": ref.matmul_nn,
             "matmul_tnn_fused": ref.matmul_tnn_fused, "matmul_bnt": ref.matmul_bnt,
             "matmul_bnn": ref.matmul_bnn}[kernel]
    for g, m, n, k in GEMM_CONFIG_SHAPES[kernel]:
        gen = torch.Generator(device=cuda).manual_seed(m + n + k)
        batched = kernel in ("matmul_bnt", "matmul_bnn")
        a_shape = (g, m, k) if batched else (m, k)
        b_shape = {"matmul_nn": (k, n), "matmul_bnt": (g, n, k), "matmul_bnn": (g, k, n)}.get(
            kernel, (n, k))
        a, b = _tailed(a_shape, dt, gen, cuda), _tailed(b_shape, dt, gen, cuda)
        want = plain(a, b).float()
        configs = tiling.enumerate_tile_configs(kernel, m, n, k, a.element_size(), g)
        assert configs, (kernel, g, m, n, k)
        for cfg in configs:
            reset_launches()
            out = fn(a, b, block=cfg)
            torch.testing.assert_close(out.float(), want, **_tol(dtype, k),
                                       msg=lambda s: f"{kernel} {(g, m, n, k)} @ {cfg}: {s}")
            assert CONFIG_LAUNCHES == {(kernel, config_key(cfg)): 1}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,m,n,dh,kw", [
    (12, 3, 512, 64, dict()),  # decode: every split of the keys
    (32, 8, 2048, 128, dict()),
    (16, 2, 2048, 256, dict()),
    (5, 16, 100, 40, dict()),
    (3, 192, 256, 64, dict(causal=True, q_seg=64)),  # flash (bf16) / fma: their one tile
    (4, 33, 70, 120, dict(causal=True, q_seg=33)),
])
def test_attention_configs_match_plain_on_card(cuda, g, m, n, dh, kw, dtype):
    """Every (bq, bk) of the route, with NaN in K and V beyond ragged
    lengths: the plain version's output, one launch per call."""
    from repro_torch.kernels.common import CONFIG_LAUNCHES, config_key
    from repro_torch.kernels.tiling import enumerate_tile_configs

    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(g * m + n)
    q, k, v = (torch.randn(g, s, dh, device=cuda, generator=gen).mul(0.3).to(dt)
               for s in (m, n, n))
    if kw:
        lengths = torch.full((g,), n, device=cuda, dtype=torch.int32)
    else:
        lengths = torch.randint(1, n + 1, (g,), device=cuda, dtype=torch.int32, generator=gen)
        for i, length in enumerate(lengths.tolist()):
            k[i, length:] = float("nan")
            v[i, length:] = float("nan")
    mask = MaskParams(**kw)
    want = ref.attention_fused(q, k, v, lengths, mask).float()
    rtol = 1e-4 if dtype == "float32" else 2e-2
    atol = rtol * float(want.pow(2).mean().sqrt())
    for cfg in enumerate_tile_configs("attention_fused", m, n, dh, q.element_size(), g):
        reset_launches()
        out = attention_fused(q, k, v, lengths, mask=mask, block=cfg)
        torch.testing.assert_close(out.float(), want, rtol=rtol, atol=atol,
                                   msg=lambda s: f"{cfg}: {s}")
        assert CONFIG_LAUNCHES == {("attention_fused", config_key(cfg)): 1}


@pytest.mark.gpu
def test_infeasible_configs_raise_before_launching_on_card(cuda):
    """A tile with no instance or plan raises ValueError and launches
    nothing: it never falls back to the default."""
    a16 = torch.randn(128, 576, device=cuda).to(torch.bfloat16)
    w16 = torch.randn(1536, 576, device=cuda).to(torch.bfloat16)
    q = torch.randn(4, 3, 64, device=cuda)
    reset_launches()
    cases = [
        lambda: ops.transpose(w16, block=(16, 16)),
        lambda: ops.matmul_nn(a16, w16.t().contiguous(), block=(64, 128, 64)),  # skinny tile, m 128
        lambda: ops.matmul_nn(a16, w16.t().contiguous(), block=(128, 96, 64)),  # no BN 96 instance
        lambda: ops.matmul_nt(a16[:4], w16, block=(8, 128, 100)),  # bk no multiple of 64
        lambda: ops.matmul_nt(a16[:4].contiguous(), w16, block=(8, 128, 1024)),  # empty split
        lambda: ops.matmul_tnn_fused(a16, w16, block=(128, 128, 64)),
        lambda: attention_fused(q, q, q, block=(4, 48)),  # 48 keys of 3: more than n
        lambda: attention_fused(q, q, q, block=(16, 32)),  # 3 rows take the 4-row instance
    ]
    for case in cases:
        with pytest.raises(ValueError):
            case()
    assert not any(LAUNCHES.values())
