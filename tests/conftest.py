"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests and benches must see
the single real CPU device (the 512-device override is dryrun-only)."""

import os
import zlib

import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card (CUDA); skips without one"
    )


def pytest_addoption(parser):
    """Deterministic test sharding for the CI tier-1 matrix: each shard
    keeps the tests whose node-id hashes onto its slot.  The hash is a
    stable CRC of the node id (not Python's randomized ``hash``), so the
    same test always lands on the same shard across runs and machines —
    the shards partition the suite exactly."""
    group = parser.getgroup("shard")
    group.addoption("--num-shards", type=int, default=1,
                    help="total number of shards splitting the suite")
    group.addoption("--shard-id", type=int, default=0,
                    help="which shard this run executes (0-based)")


def pytest_collection_modifyitems(config, items):
    num = config.getoption("--num-shards")
    if num <= 1:
        return
    shard = config.getoption("--shard-id")
    if not 0 <= shard < num:
        raise pytest.UsageError(
            f"--shard-id {shard} out of range for --num-shards {num}"
        )
    keep, drop = [], []
    for item in items:
        bucket = zlib.crc32(item.nodeid.encode()) % num
        (keep if bucket == shard else drop).append(item)
    items[:] = keep
    config.hook.pytest_deselected(items=drop)


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)


@pytest.fixture(scope="session")
def sanitize_report():
    """Opt-in poison-padding sanitizer sweep: every registered candidate
    run in interpret mode with NaN/±inf-poisoned padding (slow — several
    seconds of interpret-mode kernels).  Enable with REPRO_SANITIZE=1;
    skipped otherwise so the tier-1 wall time stays flat."""
    if not os.environ.get("REPRO_SANITIZE"):
        pytest.skip("poison-padding sanitizer sweep is opt-in "
                    "(set REPRO_SANITIZE=1)")
    from repro.analysis.sanitize import sanitize_candidates

    return sanitize_candidates()


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def tiny_hybrid_cfg():
    """One config exercising every block kind (attn local/global, mamba,
    shared-attn, moe) — used by the integration tests."""
    from repro.configs.arch import ArchConfig, BlockCfg, MoEConfig, SSMConfig

    return ArchConfig(
        name="tiny-test",
        family="hybrid",
        d_model=64,
        n_heads=4,
        n_kv=2,
        d_head=16,
        d_ff=128,
        vocab=100,
        segments=(
            (2, (BlockCfg("attn", "mlp", window=8), BlockCfg("attn", "mlp"))),
            (1, (BlockCfg("mamba", "none"), BlockCfg("shared_attn", "mlp"))),
            (1, (BlockCfg("attn", "moe"),)),
        ),
        moe=MoEConfig(d_model=64, d_ff=32, n_experts=4, top_k=2, group=16),
        ssm=SSMConfig(d_model=64, d_state=16, head_dim=16, chunk=8),
        attn_softcap=50.0,
        final_softcap=30.0,
        qk_norm=True,
        post_norm=True,
        param_dtype="float32",
        compute_dtype="float32",
        attn_chunk=16,
        remat="none",
    )
