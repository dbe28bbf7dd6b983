"""The port's dry run: one rank's step of a cell on meta tensors
(``launch/accounting.py``, ``launch/dryrun.py``).

  * ``lower_cell`` on smollm smoke at an abstract 2x4 mesh: status ok, and
    the per-device parameter bytes it records are the sum of the pieces'
    sizes the specs give;
  * on a 1x1 mesh, the dispatches it counts and their GEMM FLOPs equal
    what a real CPU step of the same config dispatches (the policy's
    dispatch report, and the engine's accounting hook on real tensors);
  * smollm-135m ``train_4k`` on the 16x16 mesh at full config runs on
    meta and fits an 80 GB card;
  * kimi-k2's ``decode_32k`` cell (its experts over ``model`` and the
    data axes) and mamba2's (its blocks split by head), both on 16x16,
    record ``ok`` through ``main``, with their collective bytes and
    ``fits_80gb``;
  * on grok-1 smoke under Adafactor at 2x2 the only reduce-scatters are
    FSDP's: each expert piece's gradient once a microbatch;
  * the ``optimized`` variant: smollm-135m ``train_4k`` records
    ``variant: "optimized"`` and gathers each layer's keys and values over
    the sequence (``gather_seq``), forward and recompute; the cell sees
    ``MIN_MODEL_DIM`` 1024, ``sp_attention`` where the heads do not divide
    ``model`` and ``zero1_grads``, and the knob is 0 again after it, even
    when it raises;
  * ``zero1_grads`` on gemma3 smoke at 2x1: ``accum`` times the
    reduce-scatter bytes, and accumulators half the size.
"""

import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.shapes import ShapeCell  # noqa: E402
from repro_torch.core.engine import account_dispatches, policy_from_spec  # noqa: E402
from repro_torch.distributed.sharding import local_shape, map_with_path, param_specs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.accounting import account_cell  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.steps import init_train_state, make_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402

KERNEL = ("fixed:nt=PALLAS_TNN_FUSED,nn=PALLAS_NN,tn=PALLAS_TN,bnt=PALLAS_BNT,"
          "bnn=PALLAS_BNN,attn=fused")
CELL = ShapeCell("train_small", 32, 8, "train")


def test_lower_cell_at_2x4_records_the_specs_param_bytes():
    cfg = smoke_config("smollm-135m")
    mesh = Mesh((2, 4), ("data", "model"))
    rec = dryrun.lower_cell("smollm-135m", CELL, mesh=mesh, cfg=cfg)
    assert rec["status"] == "ok" and rec["mesh"] == "2x4" and rec["accum"] == 4
    shapes = lm.init_lm(0, cfg, device="meta")
    want = []
    map_with_path(lambda _, t, s: want.append(
        math.prod(local_shape(t.shape, s, mesh)) * t.element_size()),
        shapes, param_specs(shapes, mesh))
    mem = rec["memory"]
    assert mem["param_bytes"] == sum(want)
    assert mem["argument_bytes"] == mem["param_bytes"] + mem["opt_bytes"] + mem["batch_bytes"]
    assert mem["peak_temp_bytes"] > 0 and mem["fits_80gb"]
    r = rec["roofline"]
    assert r["collective_bytes"] > 0 and set(r["collective_by_kind"]) >= {"all-reduce",
                                                                          "all-gather"}
    assert r["bottleneck"] in ("compute", "memory", "collective") and 0 < r["useful_ratio"]


def test_a_one_rank_cell_counts_what_a_real_step_dispatches():
    cfg = smoke_config("gemma3-4b")
    cell = ShapeCell("t", 16, 4, "train")
    costs = account_cell(cfg, cell, Mesh((1, 1), ("data", "model")), accum=1,
                         policy=policy_from_spec(KERNEL))
    seen = []

    def hook(key, operands, out):
        mult = 4 if key.op == "ATTN" else 2
        seen.append(mult * key.g * key.m * key.n * key.k)

    policy = policy_from_spec(KERNEL)
    step = make_train_step(cfg, policy=policy)
    state = init_train_state(cfg, lm.init_lm(0, cfg, device="cpu"))
    batch = {"tokens": torch.zeros((4, 16), dtype=torch.long),
             "labels": torch.ones((4, 16), dtype=torch.long)}
    with account_dispatches(hook):
        step(state, batch)
    assert costs["dispatches"] == len(seen) == policy.stats.calls
    assert costs["dispatch_flops"] == sum(seen) == costs["flops"]
    assert costs.get("coll_bytes", 0.0) == 0.0  # one rank: every group is of one


def test_smollm_train_4k_on_the_production_mesh_runs_on_meta():
    rec = dryrun.lower_cell("smollm-135m", "train_4k")
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["accum"] == 16
    assert rec["memory"]["fits_80gb"]
    r = rec["roofline"]
    assert r["model_flops"] == 6.0 * get_config("smollm-135m").active_param_count() * 256 * 4096
    assert all(r[k] > 0 for k in ("t_compute_s", "t_memory_s", "t_collective_s"))


def _main_cell(tmp_path, arch, shape):
    assert dryrun.main(["--arch", arch, "--shape", shape, "--out", str(tmp_path)]) == 0
    return json.loads((tmp_path / f"{arch}_{shape}_16x16.json").read_text())


def test_kimi_k2_cell_records_ok_with_its_collective_bytes(tmp_path):
    """Each rank holds 24 of the 384 experts and 1/16 of their d_ff, and
    gathers the d_ff whole a layer at a time: the gathers and the
    expert-parallel all-reduces are recorded."""
    rec = _main_cell(tmp_path, "kimi-k2-1t-a32b", "decode_32k")
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert isinstance(rec["memory"]["fits_80gb"], bool)
    kinds = rec["roofline"]["collective_by_kind"]
    assert kinds["all-gather"] > 0 and kinds["all-reduce"] > 0
    assert rec["roofline"]["t_collective_s"] > 0


def test_a_mamba_cell_at_16x16_records_ok_with_its_collective_bytes(tmp_path):
    """mamba2's 80 heads over 16 ranks: the gated norm's sums of squares
    and ``out``'s partial outputs are all-reduced."""
    rec = _main_cell(tmp_path, "mamba2-2.7b", "decode_32k")
    assert rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["memory"]["fits_80gb"]
    assert rec["roofline"]["collective_by_kind"]["all-reduce"] > 0


def test_fsdp_reduce_scatters_each_expert_piece_once_a_microbatch():
    """Adafactor reduce-scatters nothing, so every reduce-scatter of a
    grok-1 smoke train cell at 2x2 is an expert leaf's gradient leaving
    its FSDP gather: (S - 1) times the piece's bytes (S = 2 data ranks),
    once a microbatch."""
    cfg = smoke_config("grok-1-314b").replace(optimizer="adafactor")
    mesh = Mesh((2, 2), ("data", "model"))
    rec = dryrun.lower_cell("grok-1-314b", CELL, mesh=mesh, cfg=cfg)
    assert rec["status"] == "ok" and rec["accum"] == 4
    shapes = lm.init_lm(0, cfg, device="meta")
    pieces = []
    map_with_path(lambda names, t, s: pieces.append(
        math.prod(local_shape(t.shape, s, mesh)) * t.element_size())
        if "moe" in names and names[-1] != "w" else None,
        shapes, param_specs(shapes, mesh))
    assert len(pieces) == 3  # gate, up and down
    got = rec["roofline"]["collective_by_kind"]["reduce-scatter"]
    assert got == rec["accum"] * (2 - 1) * sum(pieces)


def test_an_optimized_smollm_train_4k_cell_gathers_keys_and_values_over_the_sequence():
    """The optimized variant: smollm's 9 heads do not divide 16, so its
    attention runs sequence-parallel, each layer gathering its keys and
    values whole over ``model`` (``gather_seq``) in the forward and again
    in the recompute; ``MIN_MODEL_DIM`` is 0 again after the cell."""
    from repro_torch.distributed import sharding
    from repro_torch.models import attention

    calls, gather = [], attention.gather_seq

    def counted(t, axes, dim):
        calls.append(tuple(t.shape))
        return gather(t, axes, dim)

    attention.gather_seq = counted
    try:
        rec = dryrun.lower_cell("smollm-135m", "train_4k", variant="optimized")
    finally:
        attention.gather_seq = gather
    assert rec["status"] == "ok" and rec["variant"] == "optimized" and rec["memory"]["fits_80gb"]
    assert sharding.MIN_MODEL_DIM == 0
    layers = get_config("smollm-135m").n_layers
    assert len(calls) == 2 * 2 * layers  # k and v, forward and recompute
    kinds = rec["roofline"]["collective_by_kind"]
    assert kinds["all-gather"] > 0 and kinds["reduce-scatter"] > 0


def test_min_model_dim_holds_for_an_optimized_cell_and_is_put_back_if_it_raises(monkeypatch):
    from repro_torch.distributed import sharding

    seen = []

    def fails(cfg, *a, **k):
        seen.append((sharding.MIN_MODEL_DIM, cfg.sp_attention, k["zero1_grads"]))
        raise RuntimeError("the cell fails")

    monkeypatch.setattr(dryrun, "account_cell", fails)
    with pytest.raises(RuntimeError, match="the cell fails"):
        dryrun.lower_cell("smollm-135m", CELL, mesh=Mesh((2, 4), ("data", "model")),
                          cfg=smoke_config("smollm-135m"), variant="optimized")
    assert seen == [(1024, False, True)]  # 4 heads divide 4: no sequence parallelism
    assert sharding.MIN_MODEL_DIM == 0
    with pytest.raises(ValueError, match="variant"):
        dryrun.lower_cell("smollm-135m", CELL, variant="fast")


def test_zero1_grads_counts_accum_reduce_scatters_and_sharded_accumulators():
    """gemma3 smoke at 2x1, accum 4: without ``zero1_grads`` the AdamW
    update reduce-scatters each leaf with a ZeRO-1 dim once a step; with
    it every microbatch does (``accum`` times the bytes) and the update
    none, the leaves without one are all-reduced once either way, and the
    f32 accumulators held beside the first microbatch's gradient shrink
    by half of the ZeRO-1 leaves' bytes."""
    from repro_torch.distributed.sharding import zero1_dim

    cfg = smoke_config("gemma3-4b")
    mesh = Mesh((2, 1), ("data", "model"))
    base, z1 = (account_cell(cfg, CELL, mesh, accum=4, policy=policy_from_spec(KERNEL),
                             zero1_grads=z) for z in (False, True))
    assert z1["coll_reduce-scatter"] == 4 * base["coll_reduce-scatter"] > 0
    assert z1["coll_all-reduce"] == base["coll_all-reduce"]
    shapes = lm.init_lm(0, cfg, device="meta")
    halved = []
    map_with_path(lambda _, t, s: halved.append(t.numel() * 4 // 2)
                  if zero1_dim(s, t.shape, mesh) is not None else None,
                  shapes, param_specs(shapes, mesh))
    assert halved and base["peak_temp_bytes"] - z1["peak_temp_bytes"] >= sum(halved) // 2
