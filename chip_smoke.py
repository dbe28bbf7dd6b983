#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints one JSON line; any failed check exits non-zero):

  1. device   the card's name and power limit, torch and CUDA versions
  2. build    nvcc builds every kernel from src/repro_torch/csrc
  3. kernels  each CUDA kernel against its plain PyTorch version at the
              serving shapes (attention also at d_head 256 and 120: gemma3's
              decode and windowed prefill, paligemma's MQA prefix prefill,
              h2o-danube's decode and prefill; phase 8b's shapes: the Mamba
              blocks' skinny dt and B/C projections at decode and exact
              prefill lengths and their training GEMMs in bf16, the MoE
              routers in f32, zamba2's attention at d_head 112 on the split
              and flash routes, grok-1's and kimi-k2's at 128; f32 NN and NT
              at the selector grid's 2^10..2^12 cubes), in f32 and bf16, with
              CUDA-event times of the kernel, the plain version and one
              library call (a yardstick only), the profiler's device time
              and the queued device time (calls back to back behind a sleep
              kernel, which the two-launch split plans need) of the kernel
              and the library call, the variant that ran, and the
              datasheet bound of the same work; every f32 GEMM (fused TNN
              included) also within tests/test_kernels.py::_tol of f64,
              and every f32 attention within its bound of an f64 version;
              the kernels redesigned for Hopper (bf16 NT and NN; fused TNN,
              batched and attention's flash routes in both dtypes; f32 NN
              and NT; attention's split-KV route) are timed beside the
              kernels they replaced, which must agree too
 3a. sanitize the poison sanitizer (src/repro_torch/analysis/sanitize.py,
              NM404) over its default grid -- the JAX package's ragged cell
              (129, 127, 65, g 3) and three ragged cells that reach the fast
              routes -- in f32 and bf16 with NaN, +inf and -inf: every plan of
              kernels/tiling.py of every kernel arm and of the transpose
              kernel runs on operands placed inside poisoned buffers and on a
              zero-filled twin, its output and workspace allocations replayed
              as poisoned (0xFF) blocks first; outputs bit-identical between
              the two, finite and within tests/test_kernels.py::_tol of f64.
              Fails on any finding, on any allocation that did not come back
              poisoned, on any plan never launched (counted per (kernel,
              config)), or past 60 s
 3b. gridspec every CUDA launch takes its grid from kernels/gridspec.py's
              declared spec: analysis/coverage.py's proof (KC310-KC315) on
              the card's own SM count, 0 findings and all eight tunable
              (candidate, op) pairs proven; each route launched from its spec
              on the sanitizer's poisoned output allocation writes every
              element and matches the plain version; and each non-persistent
              route, its spec function replaced for the call by one whose
              grid is a block short on the output's slowest axis, leaves
              exactly the blocks the proof names (KC313, KC310) poisoned and
              every other block bit-equal to the full grid's.  About 10 s
  4. serve    repro_torch.launch.serve.main on smollm-135m at full config
              in bf16: class interactive under fixed:nt=PALLAS_TNN,attn=fused,
              class bulk under fixed:nt=PALLAS_NT,attn=fused, then the same
              requests under fixed:XLA_NT (cuBLAS, unfused attention);
              every request must finish, no step may crash, every kernel
              must have launched, and first-token logits must agree with
              the cuBLAS run and sit no further from an f32 run of the
              same weights than twice the cuBLAS run does; a profiled
              decode step per policy, with every row at position 0 and
              again at max_seq - 1 (a full cache), gives the device's busy
              share
  5. exact    f32 at full width and 2 layers: greedy tokens of both kernel
              policies identical to fixed:XLA_NT, prefill attention on
              flash_f32
 5a. legacy   launch.serve --legacy (one fixed-batch prefill, then greedy
              decode against its cache) on smollm-135m at full config, batch
              4, 32-token prompts, 16 new, under the interactive kernel policy
              and fixed:XLA_NT in bf16 (the kernels launched, none under
              cuBLAS), then in f32 at 2 layers with an f32 cache: greedy
              tokens of the two identical
  6. imports  no jax in the process
  7. train    repro_torch.launch.train.main on smollm-135m at full config
              in bf16 (remat full, AdamW), batch 8 x seq 256, 6 steps, under
              the fused-TNN kernel policy, the TNN kernel policy with the
              unfused attention plan, and fixed:XLA_NT, from the same
              weights and batches: every loss finite, step-0 loss and
              grad norm of each kernel policy near cuBLAS's and no further
              from an f32 cuBLAS step than twice cuBLAS's distance, every
              kernel of the training path launched and none under cuBLAS;
              ms/step, tokens/s, launches per step and a profiled step's
              device busy share per policy; the profiled kernel-policy
              steps must run no FMA kernel the redesigns replaced, and the
              fused policy's must run the flash attention kernel
 7a. remat_dots  the fused train policy, 8 steps from phase 7's weights and
              batches, under remat="full" and remat="dots": step-0 loss and
              grad norm of "dots" within phase 7's gates of phase 7's run; no
              NT/NN/TN GEMM dispatched in the recompute (each replays the
              forward's output) and the NT dispatches saved equal those
              replayed; ms/step (median of steps 1-7) and peak memory of
              both (each over what was allocated before it)
  8. train_exact  f32 at full width and 2 layers: every gradient leaf of
              step 0 under both kernel policies within relative L2 1e-4 of
              fixed:XLA_NT's, and the losses of 3 steps within 1e-5; the
              fused TNN's f32_tiled route and flash_f32 launched
 8a. arch     the attention-only architectures.  gemma3-4b at full config
              (34 layers, d 2560, d_head 256, vocab 262144), bf16, through
              launch.serve.main under phase 4's class policies and then
              fixed:XLA_NT, 8 requests over 4 slots, --max-seq 2048, one
              request decoding past the local layers' 1024-slot ring: phase
              4's gates, and attention_fused launched on its decode_split
              and flash_mma routes at d_head 256; tokens/s, p50 decode ms
              and a profiled decode step's busy share per policy.  gemma3-4b
              in f32 at full width and one unit of each segment (10 layers):
              greedy tokens of both kernel policies identical to cuBLAS's,
              attention on the flash_f32 route at d_head 256 and never on
              the FMA kernel.
              gemma2-27b, h2o-danube-3-4b, paligemma-3b (vlm, prefix 256)
              and musicgen-large (frames) at full width and one segment
              unit of depth, bf16, batch 2 x seq 512: one forward and two
              train steps under the fused train policy and fixed:XLA_NT
              from the same weights and batches: logits within relative
              L2 5e-2, step-0 loss within 1e-2 and grad norm within 5e-2
 8b. moe_ssm  the MoE, Mamba-2 and hybrid architectures, weights drawn on
              a CUDA generator seeded 0.  ServeEngine serves mamba2-2.7b
              (64 layers) and zamba2-7b (81 blocks) at full config, and
              grok-1-314b (2 of 64 layers) and kimi-k2-1t-a32b (1 of 61
              layers, 384 experts) at full width, bf16, 8 requests of 1, 3,
              64, 200, 512, 777, 1000 and 1024 prompt tokens (the Mamba ones
              prefilled at those exact lengths), 32 new each, 4 slots,
              max_seq 2048, under phase 4's class policies and then
              fixed:XLA_NT: every request finishes, no step crashes, the
              attention routes zamba2 (decode_split and flash_mma at d_head
              112), grok-1 and kimi-k2 (flash_mma and decode_split at 128)
              must take, and grok-1's and kimi-k2's f32 routers gemm_f32's
              skinny route at decode; on the 1000-token prompt every
              block's increment under each kernel policy within relative L2
              5e-2 of cuBLAS's on the same input (over the tokens an MoE
              block routes alike, at most 5 % routed otherwise), and the
              first-token logits within 5e-2
              of cuBLAS's, or, for the random Mamba stacks, whose bf16 runs
              decorrelate from f32 whatever runs their GEMMs, phase 4's
              f32-distance gate; then f32 at one unit of each segment
              (mamba2 2 layers, zamba2 5+1 and 3 blocks, grok-1 1 layer;
              kimi-k2's f32 layer does not fit beside its buffers): greedy
              tokens of both kernel policies identical to cuBLAS's, f32
              attention on flash_f32 (zamba2 at d_head 112, grok-1 at 128)
              and never on the FMA kernel.  mamba2 (2 layers, AdamW),
              zamba2 (one unit of each segment, AdamW) and grok-1 (1 layer,
              Adafactor) at full width train as phase 8a's four do (grok's
              logits over the tokens routed alike; its f32 router's
              forward on the fused TNN's f32_skinny route, never its FMA
              kernel)
  9. selector  the paper's loop on the card: measure_candidates times every
              NT, NN and TN candidate in device time (calls queued back to
              back behind a sleep kernel) over {2^7..2^12}^3 (216 shapes per op;
              a cut of the paper's {2^7..2^16}^3, which
              `python -m repro_torch.benchmarks.table10_fcn --full` measures)
              in bf16 and in f32; per dtype the class balance, the 5-fold CV
              accuracy (paper Table IV), the share of the grid each arm wins,
              a GBDT trained on all of it (NT pair cuBLAS NT vs the paper's
              TNN, transpose kernel + NN kernel) and saved to
              build/selector_{bf16,f32}.json, loaded again with the same
              decisions over the grid, its selection metrics (speedup over
              always-cuBLAS, regret against the oracle) and a k-way model
              over the five NT candidates; for the 8 NT shapes where the
              two arms are closest, the profiler's device time beside the
              event time, and whether the label flips
 10. fcn      the paper's Table X: mnist-3h and synthetic-3h at their
              published widths, f32, batch 1024, 5 AdamW steps each under
              CaffeNT (fixed:XLA_NT) and CaffeMTNN (model:build/selector_f32.json)
              from the same weights and batches: every loss finite, step-0
              losses within 1e-5 and every step-0 gradient leaf within
              relative L2 1e-4; forward and backward ms, which arm each op
              ran, and the launches
 11. model_policy  repro_torch.launch.serve.main on smollm-135m at full
              config with no --policy (the default learned selector):
              every request finishes, no step crashes; launch.train.main for
              6 steps under model:build/selector_bf16.json with phase 7's
              gates against cuBLAS, ms/step and the dispatch report.  No
              check names a kernel here: the selector decides.
 12. tiles    the selector's tile dimension.  Every transpose instance
              ((b_rows, b_cols) in {32, 64}^2) bit-exact, and every config of
              each tunable kernel's space (kernels/tiling.py) within phase
              3's tolerances, at phase 3's main-path shape and one ragged
              shape per kernel, on operands whose storage runs on into NaN
              (attention: NaN beyond ragged lengths), one launch per call
              counted under the config; each config's event us, profiler
              device us and queued device us (calls back to back behind a
              sleep kernel) beside the default plan's.  measure_candidates(tune=True) in
              device time over NT/NN/TN on {2^7..2^10}^3 in bf16, the tile
              tables folded from it (which tile won against the default, and
              its gain), the transpose instances tuned at the LM head, and a
              k-way artifact over the three NT kernels with those tables:
              its ModelPolicy must launch the table's tuned config (counted
              per (kernel, config)).  smollm-135m at full config served under
              autotune: every request finishes and cold_misses() is 0 for
              every class after warmup
 12a. artifacts  the artifact pass (analysis/artifacts_lint.py) over the
              measurement caches and selector artifacts phases 9 and 12 wrote
              to build/ (measured_{bf16,f32}, selector_{bf16,f32},
              measured_bf16_tuned, selector_bf16_tuned_kway, autotune_smollm):
              each exists and validates clean against the port's schemas
 13. bench    python -m repro_torch.benchmarks.run --only fig1,fig2,fig3,
              table4,table6,fig4,table8,kway,policy_overhead,blocksweep on
              phase 9's f32 grid (build/measured_f32.json, not measured
              again), the dataset benchmarks again on its bf16 grid, and
              kernel_sweep --quick in f32 and bf16: every benchmark
              returns, no sweep cell disagrees with f64; each headline
              printed beside the paper's (GTX 1080 / Titan X)
 14. serve_load  python -m repro_torch.benchmarks.serve_load --full, in
              process: smollm-135m at full config, bf16, seed 0, 32 requests
              of 1-48 prompt tokens and 2-24 new, arriving 0-2 virtual steps
              apart, 8 slots, max_seq 96, interactive under autotune and bulk
              under analytic: every request finishes, no step crashes, no
              class measures after warmup; tokens/s and p50/p99 decode ms per
              class beside the card's name and power limit
 15. faults   the fault drill (healthy, first-fault and degraded ms per
              dispatch of fixed:PALLAS_TNN_FUSED at (256,512,384) f32 and the
              LM head (8,576)x(49152,576)^T bf16), then smollm-135m at full
              config through launch.serve.main under phase 4's class policies
              with --chaos "raise:PALLAS_NT.NT;raise:FUSED_ATTN.ATTN": every
              request finishes, no step crashes, exactly those two arms
              quarantined, neither kernel launched, first-token logits of both
              degraded policies within phase 4's gates of cuBLAS; the
              quarantine cleared and empty afterwards

 16. mesh     the port's distribution layer on the card.  16a: a one-rank
              NCCL process group: its all-reduce, all-gather, reduce-scatter
              and broadcast leave a tensor as it was, and so do the
              collective wrappers' own NCCL bodies (``*_in``) on it along
              dim 1 and the wrappers over a mesh of one rank;
              compressed_mean returns its input within half an int8 step.
              16b: two gloo ranks sharing the card (NCCL refuses two ranks
              on one device), each drawing the weights on a CUDA generator
              seeded 0, under phase 7's fused kernel policy with the step of
              tests/test_torch_distributed.py (lr 1e-3, warmup 1): first
              every wrapper on CUDA tensors over each axis of 2x1 and 1x2
              against the values of every rank's seeded input (sums within
              1e-5 of the f64 sum, the rest and compressed_mean exact), at
              a size gloo carries and at one that goes through CUDA IPC
              (collectives.py's route for ranks on one card: the gloo
              ranks of 16-18 keep their blocks out of expandable segments,
              and each must have run collectives there, none falling back);
              gemma3-4b at full width in two layers (one local, one global),
              bf16, batch 4 x 256, accum 2, 3 steps on meshes 2x1 and 1x2
              (ZeRO-1 over data, tensor parallelism over model, the
              vocabulary split), each step's loss within 1e-2 and grad norm
              within 5e-2 of the same run on one rank in this process;
              smollm-135m at full config on 1x2, 2 steps, whose 9 heads make
              every rank gather the q/k/v projections, step 0 against one
              rank's by the same gates; in f32, smollm-135m at full width in
              2 layers (phase 8's cut) on 2x1 (ZeRO-1's update) and gemma3-4b
              in one global layer on 1x2, 2 steps each: every leaf within
              relative L2 1e-4 of one rank's and each step's loss within
              1e-5; gemma3's f32 run then serves 4 requests, 8 new tokens
              each, under phase 4's class policies: every logits row it
              gathers within relative max error 1e-4 of one rank's and the
              greedy tokens identical.
              Launches are counted from 0 on each rank before its mesh runs
              and read before rank 0's one-rank references; the NT, fused
              TNN, NN, transpose and attention kernels must launch on every
              rank (their sum lands in launches_by_path["mesh"]).  The phase
              prints its seconds and must finish within 150 s.
              ``python3 chip_smoke.py --mesh-alone`` runs phases 16-18
              alone (after the build); ``--nccl-cards 4`` runs them alone on four
              cards: four NCCL ranks, a card each, with every run above on
              the 2x2 mesh (so every wrapper's NCCL body runs over groups of
              2 and 4)
 17. mesh_moe_ssm  the MoE, Mamba-2 and hybrid architectures on two gloo
              ranks sharing the card, each drawing the weights as in 16b,
              under phase 7's fused policy with 16b's step, batch 2 x 512:
              grok-1-314b at full width in one layer, bf16, 2 Adafactor
              steps at 1x2 (expert parallel, 4 experts a rank) and 2x1 (its
              experts' d_ff over data, gathered a layer at a time, FSDP);
              mamba2-2.7b at full width in two layers and zamba2-7b in one
              unit (5 Mamba blocks and the shared attention), bf16, 2 AdamW
              steps at 1x2 (the Mamba blocks split by head), then each one's
              f32 twin (the same weights in f32) trains 2 steps and serves 4
              requests of 8 tokens: every step's loss within 1e-2 and grad
              norm within 5e-2 of the same run on one rank in this process
              (run before the ranks start; a Mamba stack's step-0 grad norm
              may pass phase 8b's f32-distance gate against its f32 twin's
              instead: random Mamba stacks are chaotic in bf16), the f32
              twins' step-0 loss within 1e-5 and grad norm within 1e-4 (a
              later step by the bf16 gates: AdamW's first step moves a
              near-zero gradient's entry by lr in a direction rounding
              picks), the ranks' metrics equal, the f32 logits rows within 1e-4 and
              the greedy tokens identical.  Every rank launches the five kernels of
              16b; launches are counted from 0 before the runs and land in
              launches_by_path["mesh_moe_ssm"]; the phase must finish within
              150 s.  ``--mesh-alone`` and ``--nccl-cards 4`` run it after
              phase 16; with four cards it runs kimi-k2-1t-a32b at full
              width in one layer at 1x4 and 2x2 on NCCL ranks: its forward
              (under phase 4's bulk policy, direct NT) logits over the
              tokens every layer routes alike within relative L2 5e-2 of
              one rank's forward on card 0, at most 5 % of that forward's
              expert choices made otherwise, then 2 Adafactor steps whose
              metrics are equal on every rank and finite (one card cannot
              train that layer, so no one-rank training reference)
 18. mesh_optimized  the JAX package's optimized variant on the same two
              gloo ranks and step: smollm-135m at full width (9 heads, 3 kv
              heads) in 10 of its 30 layers, with sequence-parallel attention
              at MIN_MODEL_DIM 1024, bf16, batch 2 x 2048 (two 1024-row
              chunks, 512 rows of each a rank), 2 AdamW steps at 1x2, then
              its f32 twin at 2 layers serving 4 requests (their prefill
              sequence-parallel); gemma3-4b (16b's two layers, 4 x 256,
              accum 2, 3 steps) at 2x1 with zero1_grads: every step's loss
              within 1e-2 and grad norm within 5e-2 of one rank's (smollm,
              run first in this process) and of 16b's 2x1 run without
              zero1_grads (gemma3), the ranks' metrics equal, the f32 logits
              rows within 1e-4 of one rank's and the greedy tokens
              identical, each rank's f32 accumulators (measured as the step
              makes them) 1/data of the run without it but for the leaves
              that have no ZeRO-1 dim; then, outside the counts, each rank's
              attention_fused call of the second chunk at its q_start
              offset against the kernel's plain version (bf16 2e-2).  Every
              rank launches the five kernels of 16b (launches_by_path
              ["mesh_optimized"]); the phase must finish within 120 s.
              ``--mesh-alone`` and ``--nccl-cards 4`` run it after phase
              17; with four cards smollm runs at 1x4 and gemma3 at 4x1,
              both with and without zero1_grads on the NCCL ranks

Every phase's line carries the dispatch engine's fault ledger, its
``fallbacks`` and ``quarantined`` arms, and the run fails unless both are
empty (phase 15 reports what its injected faults did under keys of its
own and clears the ledger first): a kernel fault on the card must never
hide behind the cuBLAS arm.  Phases 9, 12 and 14 also fail if a
measurement took more than one try or left a candidate out.

The ``kernels`` line holds one row per kernel at a main-path shape, and one
per route of the flash kernel's wide-head instances (d_head 112, 120 and
256: gemma3's, zamba2's and h2o-danube's), of gemm_f32 and of the fused
TNN's f32 kernel (skinny and tiled), and of the f32 flash kernel's
instances (d_head 64, 128 and 256: a train step's forward, zamba2's and
gemma3's prefill), each with its launches by path.  The full results, every case included,
go to ``build/chip_smoke.json``.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit as nvidia-smi gives them.  Without a card, or
outside a checkout, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Datasheet peaks of one H100 SXM (dense): memory 3.35 TB/s; bf16 tensor
# cores 989 TFLOP/s; f32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# First-token logits, bf16, 30 layers of random weights.  Each bf16 run
# rounds every layer's activations (2^-9 relative) and the random network
# amplifies the differences: on an H100 (700 W) the kernel policies and
# the cuBLAS policy came out 1.9e-2 apart (relative L2).  The checks:
#   kernel policy vs cuBLAS policy  <= 5e-2 (a wrong kernel moves logits by O(1))
#   kernel policy's distance to an f32 run of the same weights
#                                   <= 2 x the cuBLAS policy's distance + 1e-3
# (the 1e-3 floor only matters when the served dtype is f32 itself)
LOGITS_REL_L2 = 5e-2
F32_DISTANCE_RATIO = 2.0
F32_DISTANCE_FLOOR = 1e-3

ARCH_ARGS = ["--arch", "smollm-135m", "--requests", "8", "--prompt-len", "64",
             "--gen", "16", "--slots", "4", "--seed", "0"]
KERNEL_POLICIES = {
    "interactive": "fixed:nt=PALLAS_TNN,attn=fused",
    "bulk": "fixed:nt=PALLAS_NT,attn=fused",
}
CUBLAS_POLICY = "fixed:XLA_NT"
KERNEL_SOURCES = {
    "transpose": ("src/repro_torch/csrc/transpose.cu", "src/repro/kernels/transpose.py:64"),
    "matmul_nn": ("src/repro_torch/csrc/matmul_nn.cu", "src/repro/kernels/matmul_nn.py:77"),
    "matmul_nt": ("src/repro_torch/csrc/matmul_nt.cu", "src/repro/kernels/matmul_nt.py:81"),
    "attention_fused": ("src/repro_torch/csrc/attention_fused.cu",
                        "src/repro/kernels/attention_fused.py:338"),
    "matmul_tnn_fused": ("src/repro_torch/csrc/matmul_tnn_fused.cu",
                         "src/repro/kernels/matmul_tnn_fused.py:90"),
    "matmul_bnt": ("src/repro_torch/csrc/matmul_batched.cu",
                   "src/repro/kernels/matmul_batched.py:124"),
    "matmul_bnn": ("src/repro_torch/csrc/matmul_batched.cu",
                   "src/repro/kernels/matmul_batched.py:124"),
}

# The kernels the serving policies name.
SERVE_KERNELS = ("transpose", "matmul_nn", "matmul_nt", "attention_fused")

# The bf16 NN GEMMs of a train step at 2048 tokens (batch 8 x seq 256):
# the data gradients G . W (q/o, k/v, MLP up, MLP down, LM head), then
# stage 2 of the weight gradients transpose(G) . X, as (m, n, k).
NN_TRAIN_SHAPES = (
    (2048, 576, 576), (2048, 576, 192), (2048, 576, 1536), (2048, 1536, 576),
    (2048, 576, 49152),
    (576, 576, 2048), (192, 576, 2048), (1536, 576, 2048), (576, 1536, 2048),
    (49152, 576, 2048),
)
# The FMA kernels the redesigned NN and batched kernels replaced, by the
# name prefix the profiler gives them: a profiled kernel-policy train step
# must run none of them.
REPLACED_FMA_KERNELS = ("matmul_kernel<__nv_bfloat16", "batched_kernel<",
                        "attention_kernel<__nv_bfloat16")
# The attention forward of a train step: batch 8 x 3 kv heads, 3 heads
# folded x 256 queries, 256 keys, causal.
TRAIN_ATTN_CASE = "train causal g=24 m=768 n=256 q_seg=256"
# gemma3-4b's prefill of a 1024-token chunk (4 kv heads, 2 heads folded,
# window 1024) and h2o-danube-3-4b's of 512 tokens (8 kv heads, 4 folded)
GEMMA3_PREFILL_CASE = "gemma3 prefill causal window=1024 g=4 m=2048 n=1024 q_seg=1024"
H2O_PREFILL_CASE = "h2o prefill causal g=16 m=2048 n=512 q_seg=512"
# zamba2-7b's exact-length prefill of 1000 tokens (32 heads, MHA, d_head
# 112) and grok-1's 1024-token prefill bucket (8 kv heads, 6 folded)
ZAMBA2_PREFILL_CASE = "zamba2 prefill causal g=32 m=1000 n=1000 q_seg=1000"
GROK_PREFILL_CASE = "grok prefill causal g=8 m=6144 n=1024 q_seg=1024"
# Causal cases whose library yardstick is SDPA on the unfolded heads (is_causal,
# the GQA group as heads over one kv head): the number of heads folded
UNFOLDED_HEADS = {TRAIN_ATTN_CASE: 3, GEMMA3_PREFILL_CASE: 2, H2O_PREFILL_CASE: 4,
                  ZAMBA2_PREFILL_CASE: 1, GROK_PREFILL_CASE: 6}

# f32 GEMM cases of phase 3 at the selector grid's cubes (2^10..2^12)
F32_GRID_SIDES = (1024, 2048, 4096)

# Training: smollm-135m at full config, bf16, remat full, AdamW.
DEVICE = "cuda"
TRAIN_BATCH, TRAIN_SEQ = 8, 256
TRAIN_ARGS = ["--arch", "smollm-135m", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
              "--steps", "6", "--seed", "0", "--log-every", "1", "--device", DEVICE]
TRAIN_POLICIES = {
    "fused": "fixed:nt=PALLAS_TNN_FUSED,nn=PALLAS_NN,tn=PALLAS_TN,bnt=PALLAS_BNT,"
             "bnn=PALLAS_BNN,attn=fused",
    "tnn": "fixed:nt=PALLAS_TNN,nn=PALLAS_NN,tn=PALLAS_TN,bnt=PALLAS_BNT,bnn=PALLAS_BNN,"
           "attn=unfused",
}
# The kernels those two policies name (the direct NT kernel is held by the
# serve phase: no training policy names it).
TRAIN_KERNELS = ("transpose", "matmul_nn", "attention_fused", "matmul_tnn_fused",
                 "matmul_bnt", "matmul_bnn")
# Step 0, bf16: a wrong kernel moves the loss and the gradient norm by
# O(1); bf16 rounding of 30 random layers moves them by well under these.
LOSS_REL = 1e-2
GRAD_NORM_REL = 5e-2
# train_exact, f32 at 2 layers: sums in another order only
EXACT_GRAD_REL_L2 = 1e-4
EXACT_LOSS_REL = 1e-5

# Phase 8a: gemma3-4b served at full config; prompts of 1..1500 tokens
# (seed 0 draws one of 1114, prefilled in the 2048 bucket and decoded past
# the 1024-slot ring of the local layers), 32 new tokens each.
GEMMA3_GEN = 32
GEMMA3_ARGS = ["--arch", "gemma3-4b", "--requests", "8", "--prompt-len", "1500",
               "--gen", str(GEMMA3_GEN), "--slots", "4", "--max-seq", "2048", "--seed", "0"]
GEMMA3_WINDOW = 1024
WIDE_DH = 256
# The other four at full width and one unit of each segment, trained.
ARCH_TRAIN = {  # arch: the depth it keeps of its full config
    "gemma2-27b": "2 of 46 layers (one local, global unit)",
    "h2o-danube-3-4b": "1 of 24 layers",
    "paligemma-3b": "1 of 18 layers",
    "musicgen-large": "1 of 48 layers",
}
ARCH_BATCH, ARCH_SEQ, ARCH_STEPS = 2, 512, 2
FORWARD_REL_L2 = 5e-2  # bf16 logits of a kernel policy against cuBLAS's

# Phase 8b: the MoE, SSM and hybrid architectures.  Prompt lengths: the
# conv cache's pad branch (1 < d_conv - 1 = 3), multiples of the SSD's
# 64-position chunk (64, 512, 1024) and the one-chunk fallback of a ragged
# length (200, 777, 1000); the bucketed MoE ones pad to multiples of 256.
MOE_SSM_PROMPTS = (1, 3, 64, 200, 512, 777, 1000, 1024)
MOE_SSM_GEN, MOE_SSM_SLOTS, MOE_SSM_MAX_SEQ, MOE_SSM_LEN_STEP = 32, 4, 2048, 256
F32_MAX_SEQ = max(MOE_SSM_PROMPTS) + MOE_SSM_GEN
LOGITS_PROMPT = 1000  # the prompt whose first-token logits are compared
MOE_SSM_SERVE = {  # arch: (repeats kept per segment, 0 for all; the cut; f32 repeats)
    "mamba2-2.7b": (0, None, 2),
    "zamba2-7b": (0, None, 1),
    "grok-1-314b": (2, "2 of 64 layers", 1),
    # no f32 run: one layer's f32 weights take 72.3 GiB of the card's 79.2,
    # and the interactive class's transposed f32 LM head (4.4 GiB) and a
    # prefill's buffers do not fit beside them
    "kimi-k2-1t-a32b": (1, "1 of 61 layers", 0),
}
# (route, d_head) that each served architecture's kernel-policy run must take
MOE_SSM_ROUTES = {"zamba2-7b": (("decode_split", 112), ("flash_mma", 112)),
                  "grok-1-314b": (("flash_mma", 128), ("decode_split", 128)),
                  "kimi-k2-1t-a32b": (("flash_mma", 128), ("decode_split", 128))}
# ... and each one's f32 run at cut depth (no run takes the FMA kernel)
MOE_SSM_F32_ROUTES = {"zamba2-7b": (("flash_f32", 112),),
                      "grok-1-314b": (("flash_f32", 128),)}
MOE_SSM_TRAIN = {  # arch: (repeats kept per segment, the cut); kimi-k2 needs more than one card
    "mamba2-2.7b": (2, "2 of 64 layers"),
    "zamba2-7b": (1, "9 of 81 blocks (one 5 Mamba + shared attention unit, 3 Mamba)"),
    "grok-1-314b": (1, "1 of 64 layers"),
}
NO_ATTENTION_KERNELS = ("transpose", "matmul_nn", "matmul_tnn_fused")  # mamba2's fused path
# Random Mamba stacks are chaotic in bf16: a kernel policy's run and
# cuBLAS's drift apart block by block from rounding alone, and at full
# depth cuBLAS's bf16 first-token logits lie as far from its own f32 run's
# as from a kernel policy's (relative L2 near 1), and at zamba2's 9 trained
# blocks its bf16 gradient norm more than GRAD_NORM_REL from f32's.  So
# each block's increment is held to LOGITS_REL_L2 on a shared input, and
# the logits and gradient norms of these two are held to phase 4's and 7's
# f32-distance gates wherever cuBLAS's own distance from f32 exceeds the
# plain bound (grok-1 and kimi-k2 have no f32 anchor: kimi's f32 weights
# would not fit beside its bf16 ones).
MOE_SSM_F32_ANCHOR = ("mamba2-2.7b", "zamba2-7b")
# An MoE router's top-k is discontinuous: a token whose k-th and next
# experts nearly tie goes elsewhere when bf16 rounding moves its router
# input, and its row of the block's output moves by O(1).  The block gate
# compares the tokens both runs route alike, and at most this share of a
# block's tokens may be routed otherwise.
MOE_REROUTED_SHARE = 0.05

# Phase 9: the selector's grid {2^lo..2^hi}^3, a cut of the paper's 2^7..2^16
# (the full grid: python -m repro_torch.benchmarks.table10_fcn --full).
SELECTOR_GRID = (7, 12)
SELECTOR_DTYPES = {"bfloat16": "bf16", "float32": "f32"}
CLOSE_PAIRS = 8  # NT shapes whose two arms are closest, timed on the device too
# Phase 12: the tuned measurement's grid {2^7..2^10}^3 in bf16, and the
# kernels whose tile spaces it holds against their plain versions: phase
# 3's main-path case (the contract row's) and one ragged shape each.
TUNED_GRID = (7, 10)
TILE_SHAPES = {  # kernel: ((g, m, n, k), ...) main path first; attention: (g, m, n, dh)
    "matmul_nt": ((1, 8, 49152, 576), (1, 5, 1531, 600)),
    "matmul_nn": ((1, 8, 49152, 576), (1, 130, 1032, 600)),
    "matmul_tnn_fused": ((1, 2048, 49152, 576), (1, 2047, 1000, 584)),
    "matmul_bnt": ((24, 768, 256, 64), (24, 700, 250, 68)),
    "matmul_bnn": ((24, 256, 64, 768), (24, 250, 68, 700)),
    "attention_fused": ((12, 3, 512, 64), (32, 8, 2000, 128)),
}
TILE_DTYPES = {"matmul_bnt": "float32", "matmul_bnn": "float32"}  # the contract rows' dtypes
TRANSPOSE_TILE_SHAPES = ((49152, 576), (1531, 577))
NT_KERNEL_CANDIDATES = ("PALLAS_NT", "PALLAS_TNN", "PALLAS_TNN_FUSED")
# Phase 13: the benchmarks it runs on phase 9's f32 grid, and the paper's
# numbers (GTX 1080 / Titan X, f32, Caffe) printed beside the card's.
BENCH_ONLY = "fig1,fig2,fig3,table4,table6,fig4,table8,kway,policy_overhead,blocksweep"
BENCH_BF16 = "fig1,fig2,fig3,table4,table6,fig4,table8,kway"

# Phase 10: the paper's Table X networks at their published widths, f32.
FCN_NETS = ("mnist-3h", "synthetic-3h")
FCN_BATCH, FCN_STEPS = 1024, 5


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def dispatch_health():
    """The dispatch engine's fault ledger: every fallback taken, as
    ``op:selected->executed``, and every quarantined arm, as ``op:label``."""
    from repro_torch.core import faults

    return {"fallbacks": {f"{op}:{sel}->{ex}": n
                          for (op, sel, ex), n in sorted(faults.fallback_counts().items())},
            "quarantined": [f"{e.op}:{e.label()}" for e in faults.quarantine_entries()]}


def emit_phase(row):
    """Print a phase's JSON line with ``dispatch_health()`` beside it, and
    fail the run on any fallback or quarantined arm: a kernel fault on the
    card must never hide behind the cuBLAS arm."""
    row = {**row, **dispatch_health()}
    emit(row)
    check(not row["fallbacks"] and not row["quarantined"],
          f"phase {row.get('phase')}: dispatch fell back {row['fallbacks']}, "
          f"quarantined {row['quarantined']}")
    return row


def check_measurement(label, cache, failures):
    """Phases 9 and 12: every (candidate, config) pair of a measurement ran
    at its first try, and none was left out; returns the most tries."""
    tries = [n for key, _ in cache.records()
             for per_cfg in (cache.get_attempts(key) or {}).values() for n in per_cfg.values()]
    check(len(tries) and max(tries) == 1,
          f"{label}: a measurement took {max(tries, default=None)} tries")
    check(not failures, f"{label}: measurements left out after failing: {failures}")
    return max(tries)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# Routes counted beside LAUNCHES under keys of their own: the flash kernel
# at the wide heads, gemm_f32's two routes (NN and NT), the fused TNN's two
# f32 routes, and the f32 flash kernel's instances by the head dims each
# takes.
WIDE_FLASH_DHS = (112, 120, 256)
F32_ROUTES = ("skinny", "tiled")
FLASH_F32_INSTANCES = {64: (64,), 128: (112, 120, 128), 256: (256,)}


def launch_counts():
    """LAUNCHES, and the launches of these routes: the flash kernel
    at d_head 112, 120 and 256 (``attention_flash_dh<dh>``), gemm_f32's
    skinny and tiled routes, NN and NT together (``matmul_f32_<route>``),
    the fused TNN's f32 routes (``tnn_fused_f32_<route>``) and the f32
    flash kernel's 64-, 128- and 256-wide instances
    (``attention_flash_f32_dh<width>``)."""
    from repro_torch.kernels.common import ATTENTION_ROUTES, GEMM_ROUTES, LAUNCHES

    out = dict(LAUNCHES)
    for dh in WIDE_FLASH_DHS:
        out[f"attention_flash_dh{dh}"] = ATTENTION_ROUTES.get(("flash_mma", dh), 0)
    for route in F32_ROUTES:
        out[f"matmul_f32_{route}"] = sum(GEMM_ROUTES.get((name, route, "float32"), 0)
                                         for name in ("matmul_nt", "matmul_nn"))
        out[f"tnn_fused_f32_{route}"] = GEMM_ROUTES.get(
            ("matmul_tnn_fused", f"f32_{route}", "float32"), 0)
    for width, dhs in FLASH_F32_INSTANCES.items():
        out[f"attention_flash_f32_dh{width}"] = sum(ATTENTION_ROUTES.get(("flash_f32", dh), 0)
                                                    for dh in dhs)
    return out


# -- phase 3 helpers ----------------------------------------------------------


def time_ms(fn, iters=30, warmup=5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, reps=20) -> float:
    """Median device ms of ``fn``'s calls queued back to back behind a sleep
    kernel (core/measure.py::bench_fn(queued=True)): the time of a plan of
    two launches, which the profiler may not see."""
    import torch

    from repro_torch.core.measure import bench_fn

    on_card = torch.empty(1, device=DEVICE)  # bench_fn finds the device from an operand
    return bench_fn(lambda _: fn(), on_card, reps=reps, queued=True) * 1e3


def dev_us(event) -> float:
    return getattr(event, "self_device_time_total", getattr(event, "self_cuda_time_total", 0.0))


def device_ms(fn, iters=20):
    """Mean device time of the kernels one call of ``fn`` launches, from
    torch.profiler: the host's launch cost, which ``time_ms`` includes when
    the host is slower than the card, left out; and the kernels' names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records no device event
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU and dev_us(e) > 0]
        total = sum(dev_us(e) for e in events)
        if total > 0:
            break
    return total / iters / 1e3, sorted({kernel_name(e.key) for e in events})


def kernel_name(key: str) -> str:
    """A profiler kernel name without its return type, namespaces of this
    repo's kernels and argument list (the last balanced parenthesis group,
    which may hold namespaced types), cut before torch's lambda suffixes."""
    name = key.replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += (name[i] == ")") - (name[i] == "(")
            if depth == 0:
                name = name[:i]
                break
    name = name.split("(", 1)[0].strip()
    return name[len("void "):] if name.startswith("void ") else (name or key)


def bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def tol(dtype_name: str, k: int):
    """tests/test_kernels.py::_tol: f32 1e-5*sqrt(k), bf16 2e-2*sqrt(k).
    The atol is scaled for unscaled randn operands, whose products have a
    standard deviation of sqrt(k)."""
    if dtype_name == "float32":
        return 1e-5, 1e-5 * max(1.0, k ** 0.5)
    return 2e-2, 2e-2 * max(1.0, k ** 0.5)


def compare(out, want, rtol, atol):
    diff = (out.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    return float(diff.max()), bool((diff <= limit).all())


def kernel_cases(torch):
    """(kernel, label, dtype, inputs) for every checked case, made on the card
    from a seeded generator."""
    from repro_torch.kernels.attention_fused import MaskParams

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = []
    for dt in (torch.bfloat16, torch.float32):
        for n, k in ((49152, 576), (1536, 576)):
            cases.append(("transpose", f"({n},{k})", dt, {"b": randn(n, k, dtype=dt)}))
        # decode LM head / MLP up at batch 8, a 64-token prefill, and every
        # projection of a decode step at bucket 4 (k/v, q/o, MLP down, LM head)
        for m, n, k in ((8, 49152, 576), (8, 1536, 576), (64, 1536, 576), (64, 576, 1536),
                        (4, 192, 576), (4, 576, 576), (4, 576, 1536), (4, 49152, 576)):
            a, w = randn(m, k, dtype=dt), randn(n, k, dtype=dt)  # unscaled: see tol()
            cases.append(("matmul_nt", f"({m},{k})x({n},{k})^T", dt, {"a": a, "b": w}))
            cases.append(("matmul_nn", f"({m},{k})x({k},{n})", dt,
                          {"a": a, "b": w.t().contiguous()}))
        # the training path: fused-TNN forwards at 2048 tokens (LM head, MLP
        # up, k/v, q/o, MLP down) and a decode shape; the attention
        # backward's batched contractions (batch 8 x 3 kv heads, 3 heads
        # folded x 256 queries, 256 keys, d_head 64) and the unfused decode
        # plan's (g 12, m 3, n 512)
        for m, n, k in ((2048, 49152, 576), (2048, 1536, 576), (2048, 192, 576),
                        (2048, 576, 576), (2048, 576, 1536), (8, 1536, 576)):
            cases.append(("matmul_tnn_fused", f"({m},{k})x({n},{k})^T", dt,
                          {"a": randn(m, k, dtype=dt), "b": randn(n, k, dtype=dt)}))
        for name, g, m, n, k in (("matmul_bnt", 24, 768, 256, 64),
                                 ("matmul_bnn", 24, 768, 64, 256),
                                 ("matmul_bnn", 24, 256, 64, 768),
                                 ("matmul_bnt", 12, 3, 512, 64),
                                 ("matmul_bnn", 12, 3, 64, 512)):
            b_shape = (g, n, k) if name == "matmul_bnt" else (g, k, n)
            label = (f"({g},{m},{k})x({g},{n},{k})^T" if name == "matmul_bnt"
                     else f"({g},{m},{k})x({g},{k},{n})")
            cases.append((name, label, dt, {"a": randn(g, m, k, dtype=dt),
                                            "b": randn(*b_shape, dtype=dt)}))
        # the backward's NN GEMMs of a train step at 2048 tokens: the data
        # gradients G . W, then stage 2 of the weight gradients transpose(G) . X
        for m, n, k in (NN_TRAIN_SHAPES if dt == torch.bfloat16 else ()):
            cases.append(("matmul_nn", f"({m},{k})x({k},{n})", dt,
                          {"a": randn(m, k, dtype=dt), "b": randn(k, n, dtype=dt)}))
        # attention: decode (split-KV), prefill, and a train step's forward
        # (flash for bf16), at d_head 64 and 128
        lens = torch.randint(1, 513, (12,), generator=gen, device="cuda", dtype=torch.int32)
        lens16 = torch.randint(1, 2049, (16,), generator=gen, device="cuda", dtype=torch.int32)
        lens32 = torch.randint(1, 1025, (32,), generator=gen, device="cuda", dtype=torch.int32)
        train_mask = MaskParams(causal=True, q_seg=256)
        geoms = [
            ("decode g=12 m=3 n=512 ragged", 12, 3, 512, 64, lens, MaskParams()),
            ("prefill causal g=3 m=192 n=64 q_seg=64", 3, 192, 64, 64, None,
             MaskParams(causal=True, q_seg=64)),
            ("window+prefix+softcap g=3 m=192 n=256 q_seg=64", 3, 192, 256, 64, None,
             MaskParams(causal=True, window=48, prefix_len=16, q_start=192,
                        q_seg=64, softcap=30.0)),
            (TRAIN_ATTN_CASE, 24, 768, 256, 64, None, train_mask),
            (TRAIN_ATTN_CASE + " dh=128", 24, 768, 256, 128, None, train_mask),
            ("decode g=12 m=3 n=512 ragged dh=128", 12, 3, 512, 128, lens, MaskParams()),
            # the wide heads: gemma3-4b's decode (batch 4 x 4 kv heads, fold 2)
            # over a full 2048-slot cache and its windowed prefill (fold 2 x
            # 1024 queries); paligemma-3b's prefill (batch 2, MQA fold 8 x 512
            # positions, 256 of them a bidirectional prefix); h2o-danube-3-4b's
            # decode (batch 4 x 8 kv heads, fold 4) and prefill at d_head 120
            ("decode g=16 m=2 n=2048 ragged dh=256", 16, 2, 2048, 256, lens16, MaskParams()),
            (GEMMA3_PREFILL_CASE, 4, 2048, 1024, 256, None,
             MaskParams(causal=True, window=1024, q_seg=1024)),
            ("paligemma prefill prefix=256 g=2 m=4096 n=512 q_seg=512 dh=256", 2, 4096, 512,
             256, None, MaskParams(causal=True, prefix_len=256, q_seg=512)),
            ("decode g=32 m=4 n=1024 ragged dh=120", 32, 4, 1024, 120, lens32, MaskParams()),
            (H2O_PREFILL_CASE, 16, 2048, 512, 120, None, MaskParams(causal=True, q_seg=512)),
        ]
        for label, g, m, n, dh, lengths, mask in geoms:
            cases.append(attention_case(torch, randn, label, g, m, n, dh, lengths, mask, dt))
    # phase 8b's shapes: the Mamba blocks' dt (n 80 mamba2, 112 zamba2) and
    # B/C (n 128, 64) projections at decode bucket 4 and exact prefill
    # lengths in bf16, and the MoE routers (n 8 grok-1, 384 kimi-k2) in f32
    bf, f32 = torch.bfloat16, torch.float32
    for dt, shapes in ((bf, ((4, 80, 2560), (777, 80, 2560), (1000, 112, 3584),
                             (1000, 64, 3584))),
                       (f32, ((4, 8, 6144), (1024, 8, 6144), (4, 384, 7168), (1024, 384, 7168)))):
        for m, n, k in shapes:
            a, w = randn(m, k, dtype=dt), randn(n, k, dtype=dt)
            cases.append(("matmul_nt", f"({m},{k})x({n},{k})^T", dt, {"a": a, "b": w}))
            cases.append(("matmul_nn", f"({m},{k})x({k},{n})", dt,
                          {"a": a, "b": w.t().contiguous()}))
    # their training: fused-TNN forwards at 2 x 512 tokens, the data gradient
    # with k = 80 and the TN weight gradient's NN with m = 80
    for m, n, k, dt in ((1024, 80, 2560, bf), (1024, 8, 6144, f32)):
        cases.append(("matmul_tnn_fused", f"({m},{k})x({n},{k})^T", dt,
                      {"a": randn(m, k, dtype=dt), "b": randn(n, k, dtype=dt)}))
    for m, n, k in ((1024, 2560, 80), (80, 2560, 1024)):
        cases.append(("matmul_nn", f"({m},{k})x({k},{n})", bf,
                      {"a": randn(m, k, dtype=bf), "b": randn(k, n, dtype=bf)}))
    # f32 NN and NT at the selector grid's cubes: gemm_f32's tiled route, the
    # NN one stage 2 of the f32 TNN arm (phase 9)
    for side in F32_GRID_SIDES:
        a, w = randn(side, side, dtype=f32), randn(side, side, dtype=f32)
        cases.append(("matmul_nt", f"({side},{side})x({side},{side})^T", f32, {"a": a, "b": w}))
        cases.append(("matmul_nn", f"({side},{side})x({side},{side})", f32,
                      {"a": a, "b": w.t().contiguous()}))
    # attention: zamba2's exact 1000-token prefill (32 heads, no fold) and its
    # decode (bucket 4 x 32 heads over 2048 slots) at d_head 112; grok-1's
    # 1024-token prefill (8 kv heads, fold 6) and kimi-k2's decode (4 x 8 kv
    # heads, fold 8) at 128
    lens128 = torch.randint(1, 2049, (128,), generator=gen, device="cuda", dtype=torch.int32)
    lens32 = torch.randint(1, 2049, (32,), generator=gen, device="cuda", dtype=torch.int32)
    for dt in (bf, f32):
        cases.append(attention_case(torch, randn, ZAMBA2_PREFILL_CASE + " dh=112", 32, 1000,
                                    1000, 112, None, MaskParams(causal=True, q_seg=1000), dt))
        cases.append(attention_case(torch, randn, "decode g=128 m=1 n=2048 ragged dh=112", 128,
                                    1, 2048, 112, lens128, MaskParams(), dt))
    cases.append(attention_case(torch, randn, GROK_PREFILL_CASE + " dh=128", 8, 6144, 1024, 128,
                                None, MaskParams(causal=True, q_seg=1024), bf))
    cases.append(attention_case(torch, randn, "decode g=32 m=8 n=2048 ragged dh=128", 32, 8,
                                2048, 128, lens32, MaskParams(), bf))
    return cases


def attention_case(torch, randn, label, g, m, n, dh, lengths, mask, dt):
    q = randn(g, m, dh, dtype=dt) * dh ** -0.5
    return ("attention_fused", label, dt, {
        "q": q, "k": randn(g, n, dh, dtype=dt), "v": randn(g, n, dh, dtype=dt),
        "lengths": lengths if lengths is not None else
        torch.full((g,), n, dtype=torch.int32, device="cuda"),
        "mask": mask, "heads": UNFOLDED_HEADS.get(label.split(" dh=")[0]),
    })


def run_case(torch, name, inp, dt):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.attention_fused import attention_fused
    from repro_torch.kernels.ops import (
        matmul_bnn,
        matmul_bnt,
        matmul_nn,
        matmul_nt,
        matmul_tnn_fused,
        transpose,
    )

    dname = str(dt).split(".")[-1]
    ds = torch.finfo(dt).bits // 8
    variant = None
    if name == "transpose":
        b = inp["b"]
        kern, plain, lib = (lambda: transpose(b)), (lambda: ref.transpose(b)), (lambda: b.t().contiguous())
        rtol, atol = 0.0, 0.0
        n, k = b.shape
        b_ms, by = bound(2 * n * k * ds, 0.0, dname)
    elif name in ("matmul_nn", "matmul_nt", "matmul_tnn_fused"):
        a, b = inp["a"], inp["b"]
        if name == "matmul_nt":
            kern, plain, lib = (lambda: matmul_nt(a, b)), (lambda: ref.matmul_nt(a, b)), \
                (lambda: torch.matmul(a, b.t()))
            n = b.shape[0]
            variant = nt_variant(torch, a, b)
        elif name == "matmul_tnn_fused":
            kern, plain, lib = (lambda: matmul_tnn_fused(a, b)), \
                (lambda: ref.matmul_tnn_fused(a, b)), (lambda: torch.matmul(a, b.t()))
            n = b.shape[0]
            variant = tnn_label(torch, a, b)
        else:
            kern, plain, lib = (lambda: matmul_nn(a, b)), (lambda: ref.matmul_nn(a, b)), \
                (lambda: torch.matmul(a, b))
            n = b.shape[1]
            variant = nn_label(torch, a, b)
        m, k = a.shape
        rtol, atol = tol(dname, k)
        b_ms, by = bound((m * k + k * n + m * n) * ds, 2.0 * m * n * k, dname)
    elif name in ("matmul_bnt", "matmul_bnn"):
        a, b = inp["a"], inp["b"]
        g, m, k = a.shape
        if name == "matmul_bnt":
            kern, plain, lib = (lambda: matmul_bnt(a, b)), (lambda: ref.matmul_bnt(a, b)), \
                (lambda: torch.bmm(a, b.transpose(1, 2)))
            n = b.shape[1]
        else:
            kern, plain, lib = (lambda: matmul_bnn(a, b)), (lambda: ref.matmul_bnn(a, b)), \
                (lambda: torch.bmm(a, b))
            n = b.shape[2]
        variant = batched_label(torch, a, b, name == "matmul_bnt")
        rtol, atol = tol(dname, k)
        b_ms, by = bound(g * (m * k + k * n + m * n) * ds, 2.0 * g * m * n * k, dname)
    else:
        q, k, v, lengths, mask = (inp[x] for x in ("q", "k", "v", "lengths", "mask"))
        g, m, dh = q.shape
        n = k.shape[1]
        kern = lambda: attention_fused(q, k, v, lengths, mask=mask)  # noqa: E731
        plain = lambda: ref.attention_fused(q, k, v, lengths, mask)  # noqa: E731
        variant = attention_label(torch, q, k, v)
        vis = ref.attention_visibility(mask, lengths, m, n)
        lib = None
        if inp["heads"]:  # the same function unfolded: heads x queries over one kv head
            h = inp["heads"]
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q.view(g, h, m // h, dh), k.view(g, 1, n, dh), v.view(g, 1, n, dh),
                is_causal=True, enable_gqa=True, scale=1.0)
        elif not mask.softcap:  # SDPA has no softcap: no library call computes it
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=vis, scale=1.0)
        # tests/test_attention_fused.py: f32 1e-4, bf16 2e-2, relative; the
        # atol is that share of the reference's RMS (outputs are weighted
        # means of V, far below 1)
        rtol = 1e-4 if dt == torch.float32 else 2e-2
        atol = rtol * float(plain().float().pow(2).mean().sqrt())
        kv_rows = int(vis.any(dim=1).sum())  # keys some query sees
        nbytes = (2 * g * m * dh + 2 * kv_rows * dh) * ds + 4 * g
        b_ms, by = bound(nbytes, 4.0 * dh * int(vis.sum()), dname)
    out, want = kern(), plain()
    torch.cuda.synchronize()
    err, ok = compare(out, want, rtol, atol)
    f64_err = None
    if dt == torch.float32 and name in ("matmul_nn", "matmul_nt", "matmul_tnn_fused"):
        a64, b64 = inp["a"].double(), inp["b"].double()  # _tol of f64, as in the tests
        f64_err, f64_ok = compare(out, a64 @ (b64 if name == "matmul_nn" else b64.t()),
                                  rtol, atol)
        ok = ok and f64_ok
    elif dt == torch.float32 and name == "attention_fused":  # the plain version in f64
        q64, k64, v64 = (inp[x].double() for x in ("q", "k", "v"))
        f64_err, f64_ok = compare(out, ref.attention_fused(q64, k64, v64, inp["lengths"],
                                                           inp["mask"]), rtol, atol)
        ok = ok and f64_ok
    prev = replaced_kernel(torch, name, inp, variant)
    prev_err = None
    if prev is not None:  # the replaced kernel must still agree, or its times mean nothing
        prev_err, prev_ok = compare(prev(), want, rtol, atol)
        ok = ok and prev_ok
    if lib is not None:
        lib_device_ms, lib_kernels = device_ms(lib)
        lib_err = (compare(lib().reshape(want.shape), want, rtol, atol)[0]
                   if name == "attention_fused" else None)
    else:
        lib_device_ms, lib_kernels, lib_err = None, None, None
    dev, kernels = device_ms(kern)
    return {
        "variant": variant, "err": err, "f64_err": f64_err, "ok": ok, "rtol": rtol,
        "atol": atol, "queued_ms": queued_ms(kern),
        "library_queued_ms": queued_ms(lib) if lib is not None else None,
        "ms": time_ms(kern), "plain_ms": time_ms(plain),
        "library_ms": time_ms(lib) if lib is not None else None,
        "device_ms": dev, "device_kernels": kernels,
        "library_device_ms": lib_device_ms, "library_kernels": lib_kernels,
        "library_err": lib_err,
        "replaced_ms": time_ms(prev) if prev is not None else None,
        "replaced_device_ms": device_ms(prev)[0] if prev is not None else None,
        "replaced_err": prev_err,
        "bound_ms": b_ms, "bound_by": by,
        "dh": inp["q"].shape[2] if name == "attention_fused" else None,
    }


def replaced_kernel(torch, name, inp, variant):
    """For the kernels redesigned for Hopper -- bf16 NT, fused TNN in both
    dtypes and NN, f32 NN and NT, batched in both dtypes, attention's
    split-KV and flash routes in both dtypes -- a call of the kernel each
    replaced (still built: the FMA kernels of csrc/matmul.cu,
    csrc/matmul_batched.cu and csrc/attention_fused.cu and the mma.sync
    and FMA variants of csrc/matmul_tnn_fused.cu), launched directly
    without the wrapper's checks; else None."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import launch_matmul

    if name == "attention_fused":
        return None if variant == "fma" else fma_attention(torch, inp)
    if name == "transpose":
        return None
    a, b = inp["a"], inp["b"]
    if name in ("matmul_bnt", "matmul_bnn"):
        (g, m, k), nt = a.shape, name == "matmul_bnt"
        n = b.shape[1] if nt else b.shape[2]

        from repro_torch.kernels.matmul_batched import batched_grid_specs

        grid = batched_grid_specs(g, m, n, k, nt, ("fma", None, 1, 1))[0].launch

        def fma_batched():
            c = torch.empty((g, m, n), dtype=a.dtype, device=a.device)
            _build.launch("matmul_batched", "repro_matmul_batched_fma", _build.ptr(a),
                          _build.ptr(b), _build.ptr(c), g, m, n, k, int(nt),
                          _build.dtype_code(a.dtype), *grid, _build.stream_of(a))
            return c

        return fma_batched
    if name not in ("matmul_nt", "matmul_tnn_fused", "matmul_nn"):
        return None
    if a.dtype == torch.float32 and variant.startswith("fma"):
        return None  # f32's FMA routes run the kernels they always ran
    m, k = a.shape
    if name == "matmul_nn":
        return lambda: launch_matmul(a, b, m, b.shape[1], k, b_stored_nk=False)
    n = b.shape[0]
    if name == "matmul_nt":
        return lambda: launch_matmul(a, b, m, n, k, b_stored_nk=True)

    from repro_torch.kernels.common import H100_SMS
    from repro_torch.kernels.matmul_tnn_fused import tnn_fused_grid_specs

    grid = tnn_fused_grid_specs(m, n, k, ("mma_sync", None, 1, 1), H100_SMS)[0].launch

    def replaced_tnn_fused():  # the mma.sync variant (bf16) or the FMA kernel (f32)
        c = torch.empty((m, n), dtype=a.dtype, device=a.device)
        _build.launch("matmul_tnn_fused", "repro_matmul_tnn_fused", _build.ptr(a),
                      _build.ptr(b), _build.ptr(c), m, n, k, _build.dtype_code(a.dtype),
                      *grid, _build.stream_of(a))
        return c

    return replaced_tnn_fused


def fma_attention(torch, inp):
    """A call of the FMA attention kernel on the case's inputs."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention_fused import attention_grid_specs

    q, k, v, lengths, mask = (inp[x] for x in ("q", "k", "v", "lengths", "mask"))
    g, m, dh = q.shape
    grid = attention_grid_specs(g, m, k.shape[1], dh, ("fma", 1, 1), mask)[0].launch

    def call():
        out = torch.empty_like(q)
        _build.launch("attention_fused", "repro_attention_fused_fma", _build.ptr(q),
                      _build.ptr(k), _build.ptr(v), _build.ptr(lengths), _build.ptr(out),
                      g, m, k.shape[1], dh, int(mask.causal), int(mask.window),
                      int(mask.q_start), int(mask.k_start), int(mask.prefix_len),
                      int(mask.q_seg), float(mask.softcap), _build.dtype_code(q.dtype),
                      *grid, _build.stream_of(q))
        return out

    return call


def attention_label(torch, q, k, v):
    """The attention kernel a call with these operands launches."""
    from repro_torch.kernels.attention_fused import attention_plans

    g, m, dh = q.shape
    n = k.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    variant, splits, per = attention_plans(q.dtype, g, m, n, dh,
                                           all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
                                           sms)[0][1]
    if variant == "decode_split":
        return f"decode_split, {splits} splits of {per} keys"
    if variant == "flash_f32" and splits > 1:
        return f"flash_f32, {splits} splits"
    return variant


def f32_label(torch, a, b, nt):
    """The f32 GEMM route a call with these operands launches."""
    from repro_torch.kernels.common import f32_plans

    (m, k), n = a.shape, (b.shape[0] if nt else b.shape[1])
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    variant, tile, splits, _ = f32_plans(m, n, k, nt, aligned, sms)[0][1]
    if variant == "fma":
        return "fma (matmul.cu)"
    label = f"{variant} f32 {tile[0]}x{tile[1]}"
    return f"{label}, split-k {splits}" if splits > 1 else label


def tnn_label(torch, a, b):
    """The fused TNN route a call with these operands launches."""
    from repro_torch.kernels.matmul_tnn_fused import tnn_fused_plans

    (m, k), n = a.shape, b.shape[0]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    variant, tile, splits, _ = tnn_fused_plans(m, n, k, a.dtype, aligned, sms)[0][1]
    if variant == "wgmma":
        return f"wgmma 128x{tile}"
    if variant in ("mma_sync", "fma"):
        return f"{variant} 64x64"
    label = f"{variant} {tile[0]}x{tile[1]}"
    return f"{label}, split-k {splits}" if splits > 1 else label


def nt_variant(torch, a, b):
    """The direct NT kernel a call with these operands launches."""
    from repro_torch.kernels.matmul_nt import nt_split

    if a.dtype == torch.float32:
        return f32_label(torch, a, b, True)
    m, k = a.shape
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits, _ = nt_split(m, b.shape[0], k, sms)
    return f"swap-AB mma.sync, split-k {splits}" if splits > 1 else "swap-AB mma.sync"


def nn_label(torch, a, b):
    """The NN kernel a call with these operands launches."""
    from repro_torch.kernels.matmul_nn import nn_plan

    if a.dtype == torch.float32:
        return f32_label(torch, a, b, False)
    (m, k), n = a.shape, b.shape[1]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    variant, bn, splits, _ = nn_plan(m, n, k, a.dtype, a.data_ptr(), b.data_ptr(), sms)
    label = {"wgmma": f"wgmma 128x{bn}", "skinny": "swap-AB mma.sync",
             "fma": "fma (matmul.cu)"}[variant]
    return f"{label}, split-k {splits}" if splits > 1 else label


def batched_label(torch, a, b, nt):
    """The batched kernel a call with these operands launches."""
    from repro_torch.kernels.matmul_batched import batched_plan

    g, m, k = a.shape
    n = b.shape[1] if nt else b.shape[2]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    variant, _, splits, _ = batched_plan(a.dtype, g, m, n, k, nt, a.data_ptr(), b.data_ptr(),
                                         sms)
    label = {"tiled": "tiled f32 64x64", "mma": "mma.sync 64x64", "fma": "fma"}[variant]
    return f"{label}, split-k {splits}" if splits > 1 else label


# -- phase 4/5 helpers --------------------------------------------------------


def serve(extra, args=ARCH_ARGS):
    from repro_torch.launch import serve as serve_mod

    return serve_mod.main(args + extra)


def kernel_policy_args():
    out = []
    for cls, spec in KERNEL_POLICIES.items():
        out += ["--class-policy", f"{cls}={spec}"]
    return out


def check_engine(engine, gen, label):
    from repro_torch.serving import RequestState

    h = engine.health()
    check(h["crashed_steps"] == 0, f"{label}: crashed_steps={h['crashed_steps']}")
    for r in engine.requests.values():
        check(r.state is RequestState.FINISHED and len(r.generated) == gen,
              f"{label}: request {r.rid} ended {r.state.value} with "
              f"{len(r.generated)}/{gen} tokens")


def p50_ms(engine, cls=None):
    lats = [t for r in engine.requests.values() if cls in (None, r.cls)
            for t in r.token_lat[1:]]
    return statistics.median(lats) * 1e3


def first_token_logits(torch, engine, policy_spec, prompt, dtype=None):
    """Last-position logits of ``prompt`` (bucket-padded or at its exact
    length, as the engine prefills it) under one policy; ``dtype`` recasts the engine's
    weights (the f32 anchor runs the same bf16-valued weights in f32)."""
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.core.policy import use_policy
    from repro_torch.models import lm

    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cast(v) for v in tree)
        return tree.to(dtype)

    params = engine.params if dtype is None else cast(engine.params)
    P = len(prompt)
    Lb = P if engine.exact_prefill else engine.buckets.bucket_len(P)
    padded = torch.zeros((1, Lb), dtype=torch.long, device=engine.device)
    padded[0, :P] = torch.as_tensor(prompt, device=engine.device)
    with use_policy(policy_from_spec(policy_spec)):
        logits, _ = lm.lm_prefill(params, engine.cfg, {"tokens": padded},
                                  max_seq=engine.max_seq, true_len=P)
    return logits[0, -1, : engine.cfg.vocab].float()


def busy_profile(torch, step, reps=5):
    """Host wall time of ``step`` (median of ``reps`` after one warmup) and
    the device time of its kernels from torch.profiler over one more run,
    so device busy share = device / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def synced():
        step()
        torch.cuda.synchronize()

    synced()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        synced()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        synced()

    # device-side events only: a CPU op's self device time repeats the time
    # of the kernels it launched, which are listed as events of their own
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and dev_us(e) > 0]
    kernel_ms = sum(dev_us(e) for e in events) / 1e3
    wall_ms = statistics.median(walls) * 1e3
    by_name = {}  # every kernel's device time, by its name without arguments
    for e in sorted(events, key=dev_us, reverse=True):
        short = kernel_name(e.key)
        by_name[short] = by_name.get(short, 0.0) + dev_us(e) / 1e3
    return {
        "wall_ms": wall_ms, "device_ms": kernel_ms,
        "device_busy_share": kernel_ms / wall_ms if kernel_ms else None,
        "kernels_ms": by_name,
        "kernel_keys": sorted({e.key for e in events}),  # full names, for the checks
    }


def decode_profile(torch, engine, cls, pos=0):
    """One bucketed decode step of ``cls`` (largest bucket, all rows on the
    null slot at position ``pos``: at 0 attention sees one key, at
    max_seq - 1 the full cache), profiled by ``busy_profile``."""
    bb = engine.buckets.decode_batches[-1]
    null = torch.full((bb,), engine.kv.null_slot, dtype=torch.long, device="cuda")
    zeros = torch.zeros((bb,), dtype=torch.long, device="cuda")
    at = torch.full((bb,), pos, dtype=torch.long, device="cuda")
    prof = busy_profile(torch, lambda: engine._decode_step(cls, zeros[:, None], null, at))
    prof.pop("kernel_keys")
    return {"batch": bb, "pos": pos, **prof}


def serve_gates_and_metrics(torch, eng_k, eng_x):
    """Phase 4's checks and numbers, for an engine that ran the kernel
    policies and one that ran cuBLAS on the same requests: first-token
    logits of each kernel policy within relative L2 LOGITS_REL_L2 of
    cuBLAS's and no further from an f32 run of the same weights than
    F32_DISTANCE_RATIO x cuBLAS's distance + F32_DISTANCE_FLOOR; a profiled
    decode step per policy at position 0 and at max_seq - 1 (the full
    cache); greedy agreement, tokens/s and p50 decode ms."""
    prompt = eng_k.requests[0].tokens
    ref_logits = first_token_logits(torch, eng_x, CUBLAS_POLICY, prompt)
    f32_logits = first_token_logits(torch, eng_x, CUBLAS_POLICY, prompt, torch.float32)
    to_ref, to_f32 = {}, {CUBLAS_POLICY: rel_l2(ref_logits, f32_logits)}
    for cls, spec in KERNEL_POLICIES.items():
        got = first_token_logits(torch, eng_k, spec, prompt)
        to_ref[spec], to_f32[spec] = rel_l2(got, ref_logits), rel_l2(got, f32_logits)
        check(to_ref[spec] <= LOGITS_REL_L2,
              f"first-token logits under {spec}: rel L2 {to_ref[spec]} > {LOGITS_REL_L2}")
        limit = F32_DISTANCE_RATIO * to_f32[CUBLAS_POLICY] + F32_DISTANCE_FLOOR
        check(to_f32[spec] <= limit,
              f"first-token logits under {spec} are {to_f32[spec]} from f32, beyond "
              f"{limit} (the cuBLAS policy's distance is {to_f32[CUBLAS_POLICY]})")
    profiles = {spec: decode_profile(torch, eng_k, cls) for cls, spec in KERNEL_POLICIES.items()}
    profiles[CUBLAS_POLICY] = decode_profile(torch, eng_x, "interactive")
    full = eng_k.max_seq - 1
    full_cache = {spec: decode_profile(torch, eng_k, cls, full)
                  for cls, spec in KERNEL_POLICIES.items()}
    full_cache[CUBLAS_POLICY] = decode_profile(torch, eng_x, "interactive", full)
    agree = {}
    for cls, spec in KERNEL_POLICIES.items():
        pairs = [(a, b) for r in eng_k.requests.values() if r.cls == cls
                 for a, b in zip(r.generated, eng_x.requests[r.rid].generated)]
        agree[spec] = sum(a == b for a, b in pairs) / len(pairs)
    n_tok = lambda e: sum(len(r.generated) for r in e.requests.values())  # noqa: E731
    return {
        "first_token_rel_l2": to_ref, "rel_l2_bound": LOGITS_REL_L2,
        "first_token_rel_l2_to_f32": to_f32, "decode_step_profile": profiles,
        "decode_step_profile_full_cache": full_cache,
        "greedy_agreement_vs_cublas": agree,
        "tokens_per_s": {"kernel_policies": n_tok(eng_k) / eng_k.run_seconds,
                         CUBLAS_POLICY: n_tok(eng_x) / eng_x.run_seconds},
        "p50_decode_ms": {**{spec: p50_ms(eng_k, cls) for cls, spec in KERNEL_POLICIES.items()},
                          CUBLAS_POLICY: p50_ms(eng_x)},
        "health": eng_k.health(),
    }


def check_identical_tokens(e_k, e_x, label):
    """Phase 5's gate: every request's greedy tokens under the kernel
    policies equal cuBLAS's."""
    for r in e_k.requests.values():
        check(r.generated == e_x.requests[r.rid].generated,
              f"{label} request {r.rid} ({r.cls}): tokens differ from {CUBLAS_POLICY}")


# -- phase 7/8 helpers --------------------------------------------------------


def rel(a, b):
    return abs(a - b) / abs(b)


def train(extra):
    from repro_torch.launch import train as train_mod

    return train_mod.main(TRAIN_ARGS + extra)


def train_batch(torch, cfg, step):
    """The launcher's batch ``step`` (``--seed 0``) on the card."""
    from repro_torch.data import make_train_batch

    return {k: torch.as_tensor(v, device=DEVICE).long()
            for k, v in make_train_batch(cfg, TRAIN_SEQ, TRAIN_BATCH, step, seed=0).items()}


def global_norm(torch, grads):
    from repro_torch.optim import tree_leaves

    return float(torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree_leaves(grads))))


def train_step_profile(torch, run):
    """One more train step of ``run`` (its policy, its final state, the next
    batch), profiled by ``busy_profile`` (3 timed repeats)."""
    from repro_torch.launch.steps import TrainStepConfig, make_train_step

    step_fn = make_train_step(run.cfg, TrainStepConfig(total_steps=len(run.times)),
                              policy=run.policy)
    batch = train_batch(torch, run.cfg, len(run.times))
    return busy_profile(torch, lambda: step_fn(run.state, batch), reps=3)


def phase_train(torch, card):
    """Phase 7; returns its row and each policy's kernel launches."""
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.kernels.common import reset_launches
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import lm
    from repro_torch.optim import tree_map

    runs, train_launches = {}, {}
    for spec in [*TRAIN_POLICIES.values(), CUBLAS_POLICY]:
        reset_launches()
        runs[spec] = train(["--policy", spec])
        train_launches[spec] = launch_counts()
    for spec, run in runs.items():
        check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                  for m in run.metrics), f"{spec}: a non-finite loss or grad norm")
    check(not any(train_launches[CUBLAS_POLICY].values()),
          f"cuBLAS training launched kernels: {train_launches[CUBLAS_POLICY]}")
    unused = [k for k in TRAIN_KERNELS
              if not any(train_launches[s][k] for s in TRAIN_POLICIES.values())]
    check(not unused, f"kernels of the training path never launched: {unused}")
    cfg = runs[CUBLAS_POLICY].cfg
    params32 = tree_map(lambda p: p.float(), lm.init_lm(0, cfg, device=DEVICE))
    _, g32 = loss_and_grads(cfg.replace(param_dtype="float32"), params32,
                            train_batch(torch, cfg, 0), policy_from_spec(CUBLAS_POLICY))
    gn32 = global_norm(torch, g32)
    del params32, g32
    x0 = runs[CUBLAS_POLICY].metrics[0]
    step0 = {spec: {"loss": r.metrics[0]["loss"], "grad_norm": r.metrics[0]["grad_norm"],
                    "loss_rel_vs_cublas": rel(r.metrics[0]["loss"], x0["loss"]),
                    "grad_norm_rel_vs_cublas": rel(r.metrics[0]["grad_norm"], x0["grad_norm"]),
                    "grad_norm_rel_vs_f32": rel(r.metrics[0]["grad_norm"], gn32)}
             for spec, r in runs.items()}
    for spec in TRAIN_POLICIES.values():
        row = step0[spec]
        check(row["loss_rel_vs_cublas"] <= LOSS_REL,
              f"{spec}: step-0 loss {row['loss']} vs cuBLAS {x0['loss']}")
        check(row["grad_norm_rel_vs_cublas"] <= GRAD_NORM_REL,
              f"{spec}: step-0 grad norm {row['grad_norm']} vs cuBLAS {x0['grad_norm']}")
        limit = F32_DISTANCE_RATIO * step0[CUBLAS_POLICY]["grad_norm_rel_vs_f32"] \
            + F32_DISTANCE_FLOOR
        check(row["grad_norm_rel_vs_f32"] <= limit,
              f"{spec}: step-0 grad norm is {row['grad_norm_rel_vs_f32']} from f32 "
              f"({gn32}), beyond {limit}")
    n_steps = len(runs[CUBLAS_POLICY].times)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    train_row = {
        "phase": "train", "card": card, "arch": cfg.name, "dtype": cfg.param_dtype,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": n_steps, "remat": cfg.remat,
        "f32_grad_norm": gn32, "step0": step0,
        "losses": {spec: [m["loss"] for m in r.metrics] for spec, r in runs.items()},
        "ms_per_step": {spec: statistics.median(r.times[1:]) * 1e3 for spec, r in runs.items()},
        "step_ms_all": {spec: [t * 1e3 for t in r.times] for spec, r in runs.items()},
        "tokens_per_s": {spec: tokens / statistics.median(r.times[1:])
                         for spec, r in runs.items()},
        "launches_per_step": {spec: {k: v / n_steps for k, v in train_launches[spec].items() if v}
                              for spec in TRAIN_POLICIES.values()},
        "dispatch_calls_per_step": {spec: r.policy.stats.calls / n_steps
                                    for spec, r in runs.items()},
    }
    train_row["step_profile"] = {spec: train_step_profile(torch, r) for spec, r in runs.items()}
    for spec in runs:
        keys = train_row["step_profile"][spec].pop("kernel_keys")
        if spec not in TRAIN_POLICIES.values():
            continue
        fma = [k[:160] for k in keys if any(p in k for p in REPLACED_FMA_KERNELS)]
        train_row["step_profile"][spec]["replaced_fma_kernels"] = fma
        check(not fma, f"{spec}: a profiled train step ran replaced FMA kernels: {fma}")
    check(any("attention_flash" in k for k in
              train_row["step_profile"][TRAIN_POLICIES["fused"]]["kernels_ms"]),
          "the fused policy's profiled train step ran no flash attention kernel")
    return train_row, train_launches


def phase_train_exact(torch):
    """Phase 8: f32 at full width and 2 layers."""
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves

    from repro_torch.kernels.common import reset_launches

    f32_args = ["--layers", "2", "--dtype", "float32", "--steps", "3"]
    specs = [*TRAIN_POLICIES.values(), CUBLAS_POLICY]
    reset_launches()
    runs = {spec: train(f32_args + ["--policy", spec]) for spec in TRAIN_POLICIES.values()}
    launches = launch_counts()  # the kernel policies' f32 steps
    for name in ("tnn_fused_f32_tiled", "attention_flash_f32_dh64"):
        check(launches[name] > 0, f"f32 training never launched {name}: {launches}")
    runs[CUBLAS_POLICY] = train(f32_args + ["--policy", CUBLAS_POLICY])
    losses = {spec: [m["loss"] for m in r.metrics] for spec, r in runs.items()}
    for spec in TRAIN_POLICIES.values():
        for a, b in zip(losses[spec], losses[CUBLAS_POLICY]):
            check(rel(a, b) <= EXACT_LOSS_REL,
                  f"f32 losses under {spec}: {losses[spec]} vs cuBLAS {losses[CUBLAS_POLICY]}")
    cfg = runs[CUBLAS_POLICY].cfg
    params = lm.init_lm(0, cfg, device=DEVICE)
    batch = train_batch(torch, cfg, 0)
    grads = {spec: loss_and_grads(cfg, params, batch, policy_from_spec(spec))[1]
             for spec in specs}
    worst = {}
    for spec in TRAIN_POLICIES.values():
        dists = [float((a - b).norm() / b.norm().clamp_min(1e-30))
                 for a, b in zip(tree_leaves(grads[spec]), tree_leaves(grads[CUBLAS_POLICY]))]
        worst[spec] = max(dists)
        check(worst[spec] <= EXACT_GRAD_REL_L2,
              f"f32 gradient under {spec}: a leaf is {worst[spec]} from cuBLAS's (rel L2)")
    return {"phase": "train_exact", "layers": 2, "dtype": "float32",
            "worst_leaf_rel_l2": worst, "losses": losses}, launches


# -- phase 8a helpers ---------------------------------------------------------


def device_batch(torch, batch):
    """A numpy train batch on the card: token ids as int64, frames and
    patches as the f32 the pipeline made (the model casts them)."""
    return {k: torch.as_tensor(v, device=DEVICE) if v.dtype.kind == "f"
            else torch.as_tensor(v, device=DEVICE).long() for k, v in batch.items()}


def arch_train(torch, arch, reduced, layers=1, gen=0, kernels=TRAIN_KERNELS, f32_anchor=False):
    """An architecture at full width and ``layers`` repeats of each segment
    (the cut ``reduced`` names), bf16: one forward and ARCH_STEPS train
    steps under the fused train policy and under cuBLAS, from the same
    weights (drawn by ``gen``, a generator or a CPU seed) and batches,
    with the optimizer its config names; every kernel of ``kernels`` must
    launch.  ``f32_anchor``: also the f32 step-0 gradient norm of the same
    weights under cuBLAS, and where cuBLAS's bf16 norm lies further from
    it than GRAD_NORM_REL, phase 7's f32-distance gate in place of the
    grad-norm gate.  Returns its row and the fused policy's launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.core.policy import use_policy
    from repro_torch.data import make_train_batch
    from repro_torch.kernels.common import ATTENTION_ROUTES, GEMM_ROUTES, reset_launches
    from repro_torch.launch.steps import (
        TrainStepConfig,
        init_train_state,
        loss_and_grads,
        make_train_step,
    )
    from repro_torch.models import lm
    from repro_torch.optim import tree_map

    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = full.replace(segments=tuple((min(count, layers), blocks)
                                      for count, blocks in full.segments))
    params = lm.init_lm(gen, cfg, device=DEVICE)
    batches = [device_batch(torch, make_train_batch(cfg, ARCH_SEQ, ARCH_BATCH, step))
               for step in range(ARCH_STEPS)]
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    fused = TRAIN_POLICIES["fused"]
    specs = (fused, CUBLAS_POLICY)
    logits, fwd_launches, fwd_routes, fwd_gemm = {}, {}, {}, {}
    for spec in specs:
        reset_launches()
        with torch.no_grad(), use_policy(policy_from_spec(spec)):
            logits[spec] = lm.lm_forward(params, cfg, batches[0]).float()
        fwd_launches[spec], fwd_routes[spec] = launch_counts(), dict(ATTENTION_ROUTES)
        fwd_gemm[spec] = dict(GEMM_ROUTES)
    # an MoE router sends a few near-tie tokens elsewhere under bf16
    # rounding: compare the rows of the tokens both runs route alike
    same = (~moe_rerouted(torch, cfg, params, batches[0]["tokens"], fused) if cfg.moe
            else torch.ones(logits[fused].shape[:2], dtype=torch.bool, device=DEVICE))
    rerouted = float(1 - same.float().mean())
    fwd_rel = rel_l2(logits[fused][same], logits[CUBLAS_POLICY][same])
    del logits  # before the optimizer's f32 moments: gemma2-27b's take 37 GB at the update
    runs = {}
    for spec in specs:
        torch.cuda.empty_cache()
        reset_launches()
        policy = policy_from_spec(spec)
        step_fn = make_train_step(cfg, TrainStepConfig(total_steps=ARCH_STEPS), policy=policy)
        state = init_train_state(cfg, params)
        metrics, times = [], []
        for batch in batches:
            t1 = time.perf_counter()
            state, m = step_fn(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})  # waits for the device
            times.append(time.perf_counter() - t1)
        del state
        routes = dict(fwd_routes[spec])  # the forward's and the train steps'
        for key, count in ATTENTION_ROUTES.items():
            routes[key] = routes.get(key, 0) + count
        gemm = dict(fwd_gemm[spec])
        for key, count in GEMM_ROUTES.items():
            gemm[key] = gemm.get(key, 0) + count
        runs[spec] = {"metrics": metrics, "step_ms": [t * 1e3 for t in times],
                      "launches": {k: fwd_launches[spec][k] + v
                                   for k, v in launch_counts().items()},
                      "attention_routes": {f"{v} dh{d}": c for (v, d), c in routes.items()},
                      "gemm_routes": {" ".join(key): c for key, c in gemm.items()}}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gn32, gn_to32 = None, None
    if f32_anchor:
        params32 = tree_map(lambda p: p.float(), params)
        _, g32 = loss_and_grads(cfg.replace(param_dtype="float32"), params32, batches[0],
                                policy_from_spec(CUBLAS_POLICY))
        gn32 = global_norm(torch, g32)
        gn_to32 = {spec: rel(run["metrics"][0]["grad_norm"], gn32) for spec, run in runs.items()}
        del params32, g32
    del params, batches
    torch.cuda.empty_cache()
    for spec, run in runs.items():
        check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                  for m in run["metrics"]), f"{arch} {spec}: a non-finite loss or grad norm")
    check(fwd_rel <= FORWARD_REL_L2, f"{arch}: forward logits rel L2 {fwd_rel} > {FORWARD_REL_L2}")
    check(rerouted <= MOE_REROUTED_SHARE, f"{arch}: {rerouted} of the tokens routed otherwise")
    x0, k0 = runs[CUBLAS_POLICY]["metrics"][0], runs[fused]["metrics"][0]
    loss_rel, gn_rel = rel(k0["loss"], x0["loss"]), rel(k0["grad_norm"], x0["grad_norm"])
    check(loss_rel <= LOSS_REL, f"{arch}: step-0 loss {k0['loss']} vs cuBLAS {x0['loss']}")
    if gn_to32 is None or gn_to32[CUBLAS_POLICY] <= GRAD_NORM_REL:
        check(gn_rel <= GRAD_NORM_REL,
              f"{arch}: step-0 grad norm {k0['grad_norm']} vs cuBLAS {x0['grad_norm']}")
    else:  # a random Mamba stack's bf16 gradients leave f32 whatever runs its GEMMs
        limit = F32_DISTANCE_RATIO * gn_to32[CUBLAS_POLICY] + F32_DISTANCE_FLOOR
        check(gn_to32[fused] <= limit, f"{arch}: step-0 grad norm {k0['grad_norm']} is "
                                       f"{gn_to32[fused]} from f32 ({gn32}), beyond {limit}")
    check(not any(runs[CUBLAS_POLICY]["launches"].values()),
          f"{arch}: cuBLAS training launched kernels: {runs[CUBLAS_POLICY]['launches']}")
    unused = [k for k in kernels if not runs[fused]["launches"][k]]
    check(not unused, f"{arch}: kernels of the fused training path never launched: {unused}")
    if cfg.moe:  # the f32 router's forward: the as-stored f32 kernel, never the FMA one
        gemm = runs[fused]["gemm_routes"]
        check(gemm.get("matmul_tnn_fused f32_skinny float32", 0) > 0
              and not gemm.get("matmul_tnn_fused fma float32", 0),
              f"{arch}: the f32 router's fused TNN did not run f32_skinny alone: {gemm}")
    row = {
        "arch": arch, "reduced": {"depth": reduced, "layers": cfg.n_layers},
        "optimizer": cfg.optimizer,
        "d_model": cfg.d_model, "d_head": cfg.d_head, "vocab": cfg.vocab,
        "input_mode": cfg.input_mode, "prefix_len": cfg.prefix_len,
        "batch": ARCH_BATCH, "seq": ARCH_SEQ, "forward_rel_l2": fwd_rel,
        "rerouted_share": rerouted,
        "step0_loss_rel_vs_cublas": loss_rel, "step0_grad_norm_rel_vs_cublas": gn_rel,
        "f32_grad_norm": gn32, "step0_grad_norm_rel_vs_f32": gn_to32,
        "peak_memory_gb": peak_gb, "init_seconds": init_s,
        "seconds": time.perf_counter() - t0,
        **{spec: {**run, "launches": {k: v for k, v in run["launches"].items() if v}}
           for spec, run in runs.items()},
    }
    return row, runs[fused]["launches"]


def phase_arch(torch, card):
    """Phase 8a; returns its row, and the launches of gemma3's kernel-policy
    serve run and of the four fused-policy training runs."""
    from repro_torch.kernels.common import ATTENTION_ROUTES, LAUNCHES, reset_launches

    t0 = time.perf_counter()
    reset_launches()
    eng_k = serve(kernel_policy_args(), GEMMA3_ARGS)
    serve_launches, routes = launch_counts(), dict(ATTENTION_ROUTES)
    cfg = eng_k.cfg
    check((cfg.n_layers, cfg.d_model, cfg.d_head, cfg.vocab) == (34, 2560, 256, 262144),
          f"gemma3-4b served at {cfg.n_layers} layers, d {cfg.d_model}, d_head {cfg.d_head}")
    check_engine(eng_k, GEMMA3_GEN, "gemma3-4b kernel policies")
    for kname in SERVE_KERNELS:
        check(serve_launches[kname] > 0, f"gemma3-4b: kernel {kname} was not launched")
    for variant in ("decode_split", "flash_mma"):
        check(routes.get((variant, WIDE_DH), 0) > 0,
              f"gemma3-4b: attention_fused never ran {variant} at d_head {WIDE_DH}: {routes}")
    wraps = [r.rid for r in eng_k.requests.values()
             if r.prompt_len + GEMMA3_GEN - 1 > GEMMA3_WINDOW]
    check(wraps, f"no gemma3-4b request decodes past the {GEMMA3_WINDOW}-slot ring")
    reset_launches()
    eng_x = serve(["--policy", CUBLAS_POLICY], GEMMA3_ARGS)
    check_engine(eng_x, GEMMA3_GEN, "gemma3-4b cuBLAS policy")
    check(not any(LAUNCHES.values()), f"gemma3-4b cuBLAS policy launched kernels: {LAUNCHES}")
    serve_part = {
        "arch": "gemma3-4b", "layers": cfg.n_layers, "dtype": cfg.param_dtype,
        "max_seq": eng_k.max_seq, "buckets": {"len_step": eng_k.buckets.len_step,
                                              "batch": list(eng_k.buckets.decode_batches)},
        "prompt_lens": [r.prompt_len for r in eng_k.requests.values()],
        "requests_past_ring": wraps, "launches": serve_launches,
        "attention_routes": {f"{v} dh{d}": c for (v, d), c in routes.items()},
        **serve_gates_and_metrics(torch, eng_k, eng_x),
    }
    del eng_k, eng_x
    torch.cuda.empty_cache()
    serve_s = time.perf_counter() - t0

    # f32, full width, one unit of each segment: identical greedy tokens
    f32 = ["--layers", "1", "--dtype", "float32"]
    reset_launches()
    e_k = serve(f32 + kernel_policy_args(), GEMMA3_ARGS)
    f32_routes, exact_launches = dict(ATTENTION_ROUTES), launch_counts()
    check(f32_routes.get(("flash_f32", WIDE_DH), 0) > 0,
          f"gemma3-4b f32: attention_fused never ran flash_f32 at d_head {WIDE_DH}: {f32_routes}")
    check(not any(count for (variant, _), count in f32_routes.items() if variant == "fma"),
          f"gemma3-4b f32: attention_fused ran the FMA kernel: {f32_routes}")
    e_x = serve(f32 + ["--policy", CUBLAS_POLICY], GEMMA3_ARGS)
    check_engine(e_k, GEMMA3_GEN, "gemma3-4b f32 kernel policies")
    check_engine(e_x, GEMMA3_GEN, "gemma3-4b f32 cuBLAS policy")
    check_identical_tokens(e_k, e_x, "gemma3-4b f32")
    exact_part = {"layers": e_k.cfg.n_layers, "dtype": "float32",
                  "requests": len(e_k.requests), "identical": True,
                  "attention_routes": {f"{v} dh{d}": c for (v, d), c in f32_routes.items()}}
    del e_k, e_x
    torch.cuda.empty_cache()
    exact_s = time.perf_counter() - t0 - serve_s

    train_rows, train_launches = {}, {name: 0 for name in launch_counts()}
    for arch, reduced in ARCH_TRAIN.items():
        train_rows[arch], launches = arch_train(torch, arch, reduced)
        for name, count in launches.items():
            train_launches[name] += count
    row = {"phase": "arch", "card": card, "serve": serve_part, "exact": exact_part,
           "train": train_rows, "seconds": time.perf_counter() - t0,
           "seconds_by_part": {"serve": serve_s, "exact": exact_s,
                               "train": time.perf_counter() - t0 - serve_s - exact_s}}
    return row, serve_launches, train_launches, exact_launches


# -- phase 8b helpers ---------------------------------------------------------


def moe_ssm_config(arch, repeats=0, dtype=None):
    """``arch``'s full config, each segment cut to ``repeats`` (0: whole),
    with params in ``dtype`` (None: the config's)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if repeats:
        cfg = cfg.replace(segments=tuple((min(count, repeats), blocks)
                                         for count, blocks in cfg.segments))
    return cfg.replace(param_dtype=dtype) if dtype else cfg


def serve_requests(torch, cfg, params, specs, max_seq=MOE_SSM_MAX_SEQ):
    """ServeEngine on ``params``: class policies from ``specs``, a warmup,
    then the MOE_SSM_PROMPTS requests (seed 0) across the classes in turn,
    drained.  Returns the engine."""
    import numpy as np

    from repro_torch.core.engine import policy_from_spec
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.buckets import default_buckets

    engine = ServeEngine(
        cfg, params, n_slots=MOE_SSM_SLOTS, max_seq=max_seq,
        policies={cls: policy_from_spec(spec) for cls, spec in specs.items()},
        bucket_spec=default_buckets(MOE_SSM_SLOTS, max_seq, len_step=MOE_SSM_LEN_STEP),
        cache_dtype=getattr(torch, cfg.param_dtype), device=DEVICE,
    )
    engine.warmup()
    rng = np.random.RandomState(0)
    classes = sorted(specs)
    for i, n in enumerate(MOE_SSM_PROMPTS):
        engine.submit(rng.randint(0, cfg.vocab, (n,)).astype(np.int32), max_new=MOE_SSM_GEN,
                      cls=classes[i % len(classes)])
    engine.run()
    return engine


def served_tokens(engine):
    n_tok = sum(len(r.generated) for r in engine.requests.values())
    return ({rid: list(r.generated) for rid, r in engine.requests.items()},
            n_tok / engine.run_seconds)


def moe_ssm_serve(torch, arch, gen):
    """One architecture of phase 8b served: the kernel policies, then
    cuBLAS on the same weights, then both in f32 at a cut depth.  Returns
    its row and the launches of the kernel-policy run and of its f32 run."""
    from repro_torch.kernels.common import ATTENTION_ROUTES, GEMM_ROUTES, LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.optim import tree_leaves

    repeats, reduced, f32_repeats = MOE_SSM_SERVE[arch]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = moe_ssm_config(arch, repeats)
    params = lm.init_lm(gen(), cfg, device=DEVICE)
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cublas = {cls: CUBLAS_POLICY for cls in KERNEL_POLICIES}

    reset_launches()
    eng = serve_requests(torch, cfg, params, KERNEL_POLICIES)
    launches, routes, gemm_routes = launch_counts(), dict(ATTENTION_ROUTES), dict(GEMM_ROUTES)
    check_engine(eng, MOE_SSM_GEN, f"{arch} kernel policies")
    has_attn = cfg.n_heads > 0
    for kname in SERVE_KERNELS if has_attn else SERVE_KERNELS[:3]:
        check(launches[kname] > 0, f"{arch}: kernel {kname} was not launched")
    for route in MOE_SSM_ROUTES.get(arch, ()):
        check(routes.get(route, 0) > 0, f"{arch}: attention_fused never ran {route}: {routes}")
    if cfg.moe:  # the f32 router under both classes: direct NT, and TNN's NN
        for name in ("matmul_nt", "matmul_nn"):
            check(gemm_routes.get((name, "skinny", "float32"), 0) > 0,
                  f"{arch}: the f32 router never ran {name}'s skinny route: {gemm_routes}")
    check(eng.exact_prefill == (arch in ("mamba2-2.7b", "zamba2-7b")),
          f"{arch}: exact_prefill is {eng.exact_prefill}")
    prompt = next(r.tokens for r in eng.requests.values() if r.prompt_len == LOGITS_PROMPT)
    logits = {spec: first_token_logits(torch, eng, spec, prompt)
              for spec in KERNEL_POLICIES.values()}
    blocks, rerouted = block_increments(torch, cfg, params, prompt)
    profiles = {spec: decode_profile(torch, eng, cls) for cls, spec in KERNEL_POLICIES.items()}
    tokens_k, tps_k = served_tokens(eng)
    p50 = {spec: p50_ms(eng, cls) for cls, spec in KERNEL_POLICIES.items()}
    del eng
    torch.cuda.empty_cache()

    reset_launches()
    eng = serve_requests(torch, cfg, params, cublas)
    check_engine(eng, MOE_SSM_GEN, f"{arch} cuBLAS policy")
    check(not any(LAUNCHES.values()), f"{arch} cuBLAS policy launched kernels: {LAUNCHES}")
    ref = first_token_logits(torch, eng, CUBLAS_POLICY, prompt)
    ref32 = (first_token_logits(torch, eng, CUBLAS_POLICY, prompt, torch.float32)
             if arch in MOE_SSM_F32_ANCHOR else None)
    profiles[CUBLAS_POLICY] = decode_profile(torch, eng, "interactive")
    tokens_x, tps_x = served_tokens(eng)
    p50[CUBLAS_POLICY] = p50_ms(eng)
    del eng, params
    torch.cuda.empty_cache()
    for spec, worst in blocks.items():
        check(worst <= LOGITS_REL_L2, f"{arch}: a block's increment under {spec} is {worst} "
                                      f"from cuBLAS's on the same input (rel L2)")
        check(rerouted[spec] <= MOE_REROUTED_SHARE,
              f"{arch}: {rerouted[spec]} of an MoE block's tokens routed otherwise under {spec}")
    dist = {spec: rel_l2(got, ref) for spec, got in logits.items()}
    to_f32 = ({spec: rel_l2(got, ref32) for spec, got in [*logits.items(), (CUBLAS_POLICY, ref)]}
              if ref32 is not None else None)
    for spec, d in dist.items():
        if to_f32 is None or to_f32[CUBLAS_POLICY] <= LOGITS_REL_L2:
            check(d <= LOGITS_REL_L2, f"{arch}: first-token logits under {spec}: rel L2 {d} > "
                                      f"{LOGITS_REL_L2}")
        else:  # the bf16 stack decorrelates from f32 whatever runs its GEMMs: phase 4's gate
            limit = F32_DISTANCE_RATIO * to_f32[CUBLAS_POLICY] + F32_DISTANCE_FLOOR
            check(to_f32[spec] <= limit, f"{arch}: first-token logits under {spec} are "
                                         f"{to_f32[spec]} from f32, beyond {limit}")
    pairs = [(a, b) for rid, toks in tokens_k.items() for a, b in zip(toks, tokens_x[rid])]
    serve_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    row = {
        "arch": arch, "layers": cfg.n_layers, "params": n_params, "d_model": cfg.d_model,
        "d_head": cfg.d_head, "vocab": cfg.vocab, "reduced": reduced and {
            "depth": reduced, "layers": cfg.n_layers},
        "exact_prefill": arch in ("mamba2-2.7b", "zamba2-7b"),
        "prompt_lens": list(MOE_SSM_PROMPTS), "gen": MOE_SSM_GEN,
        "launches": {k: v for k, v in launches.items() if v},
        "attention_routes": {f"{v} dh{d}": c for (v, d), c in routes.items()},
        "gemm_routes": {" ".join(key): c for key, c in gemm_routes.items()},
        "first_token_rel_l2": dist, "rel_l2_bound": LOGITS_REL_L2,
        "first_token_rel_l2_to_f32": to_f32, "worst_block_increment_rel_l2": blocks,
        "worst_block_rerouted_share": rerouted,
        "greedy_agreement_vs_cublas": sum(a == b for a, b in pairs) / len(pairs),
        "tokens_per_s": {"kernel_policies": tps_k, CUBLAS_POLICY: tps_x},
        "p50_decode_ms": p50, "decode_step_profile": profiles,
        "peak_memory_gb": peak_gb, "init_seconds": init_s, "serve_seconds": serve_s,
        "exact": None,
    }
    exact_launches = {}
    if f32_repeats:
        row["exact"], exact_launches = moe_ssm_exact(torch, arch, f32_repeats, gen)
    row["seconds"] = time.perf_counter() - t0
    return row, launches, exact_launches


def moe_ssm_exact(torch, arch, repeats, gen):
    """f32 at full width and ``repeats`` of each segment: greedy tokens of
    both kernel policies identical to cuBLAS's, attention on the routes of
    MOE_SSM_F32_ROUTES and never on the FMA kernel.  The cache holds the
    longest request (a 2048-token bucket's buffers are not needed).
    Returns its row and the kernel-policy run's launches."""
    from repro_torch.models import lm

    from repro_torch.kernels.common import ATTENTION_ROUTES, reset_launches

    cublas = {cls: CUBLAS_POLICY for cls in KERNEL_POLICIES}
    cfg32 = moe_ssm_config(arch, repeats, "float32")
    params = lm.init_lm(gen(), cfg32, device=DEVICE)
    reset_launches()
    eng = serve_requests(torch, cfg32, params, KERNEL_POLICIES, F32_MAX_SEQ)
    routes, launches = dict(ATTENTION_ROUTES), launch_counts()
    check_engine(eng, MOE_SSM_GEN, f"{arch} f32 kernel policies")
    for route in MOE_SSM_F32_ROUTES.get(arch, ()):
        check(routes.get(route, 0) > 0, f"{arch} f32: attention_fused never ran {route}: {routes}")
    check(not any(count for (variant, _), count in routes.items() if variant == "fma"),
          f"{arch} f32: attention_fused ran the FMA kernel: {routes}")
    tokens32, _ = served_tokens(eng)
    del eng
    torch.cuda.empty_cache()
    eng = serve_requests(torch, cfg32, params, cublas, F32_MAX_SEQ)
    check_engine(eng, MOE_SSM_GEN, f"{arch} f32 cuBLAS policy")
    for rid, r in eng.requests.items():
        check(r.generated == tokens32[rid],
              f"{arch} f32 request {rid} ({r.cls}): tokens differ from {CUBLAS_POLICY}")
    del eng, params
    torch.cuda.empty_cache()
    return {"layers": cfg32.n_layers, "dtype": "float32", "max_seq": F32_MAX_SEQ,
            "identical": True,
            "attention_routes": {f"{v} dh{d}": c for (v, d), c in routes.items()}}, launches


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def cublas_block_inputs(torch, cfg, params, tokens):
    """Every block of the model with its input in a cuBLAS run of
    ``tokens`` (B, S): yields (block kind, its params, its input); the next
    input is computed when the caller resumes."""
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.core.policy import use_policy
    from repro_torch.models.blocks import apply_block
    from repro_torch.models.layers import embed
    from repro_torch.models.lm import _index

    policy, shared = policy_from_spec(CUBLAS_POLICY), params.get("shared")
    x = embed(params["embed"], tokens, cfg.emb_scale)
    for (count, kinds), slot_params in zip(cfg.segments, params["segments"]):
        for i in range(count):
            for b, sp in zip(kinds, slot_params):
                p = _index(sp, i)
                yield b, p, x
                with torch.no_grad(), use_policy(policy):
                    x = apply_block(p, x, b, cfg, shared)


def block_increments(torch, cfg, params, prompt):
    """Every block of the served model run on cuBLAS's input to it (the
    prompt's activations, block by block under fixed:XLA_NT): per kernel
    policy, the largest relative L2 distance of a block's increment (its
    output less its input) from cuBLAS's over the tokens both route alike,
    and the largest share of an MoE block's tokens routed otherwise.
    Unlike the logits, neither compounds over the depth."""
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.core.policy import use_policy
    from repro_torch.models.blocks import apply_block

    policies = {spec: policy_from_spec(spec) for spec in (*KERNEL_POLICIES.values(),
                                                          CUBLAS_POLICY)}
    worst = {spec: 0.0 for spec in KERNEL_POLICIES.values()}
    rerouted = {spec: 0.0 for spec in KERNEL_POLICIES.values()}
    tokens = torch.as_tensor(prompt, device=DEVICE).long()[None]
    for b, p, x in cublas_block_inputs(torch, cfg, params, tokens):
        out, kept = {}, {}
        for spec, policy in policies.items():
            with torch.no_grad(), use_policy(policy):
                out[spec] = (apply_block(p, x, b, cfg, params.get("shared")) - x)[0]
                if b.ffn == "moe":
                    kept[spec] = moe_kept(torch, p, x, b, cfg)
        for spec in worst:
            same = torch.ones(x.shape[1], dtype=torch.bool, device=x.device)
            if kept:  # tokens whose kept experts differ: a routing flip
                same = (kept[spec] == kept[CUBLAS_POLICY]).all(dim=-1)
                rerouted[spec] = max(rerouted[spec], float(1 - same.float().mean()))
            worst[spec] = max(worst[spec], rel_l2(out[spec][same], out[CUBLAS_POLICY][same]))
    return worst, rerouted


def moe_rerouted(torch, cfg, params, tokens, spec):
    """(B, S) bool: the tokens some MoE block routes otherwise under
    ``spec`` than under cuBLAS, each block on cuBLAS's input to it."""
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.core.policy import use_policy

    pk, px = policy_from_spec(spec), policy_from_spec(CUBLAS_POLICY)
    out = torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    for b, p, x in cublas_block_inputs(torch, cfg, params, tokens):
        if b.ffn == "moe":
            with torch.no_grad(), use_policy(pk):
                kept = moe_kept(torch, p, x, b, cfg)
            with torch.no_grad(), use_policy(px):
                ref = moe_kept(torch, p, x, b, cfg)
            out |= (kept != ref).any(dim=-1).reshape(tokens.shape)
    return out


def moe_kept(torch, p, x, b, cfg):
    """(B * S, experts): which experts keep each token of an MoE block's
    input ``x`` (B, S, d) under the current policy -- the block's attention
    and router in the model's own functions, then its routing."""
    from repro_torch.core.engine import dispatch
    from repro_torch.models.attention import attention
    from repro_torch.models.blocks import _attn_cfg
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.moe import _route

    h = x + attention(p["attn"], rmsnorm(p["ln1"], x), _attn_cfg(b, cfg))
    xn = rmsnorm(p["ln2"], h)
    S, mc = x.shape[1], cfg.moe
    group = min(mc.group, S) if S % min(mc.group, S) == 0 else S
    logits = dispatch("NT", xn.reshape(-1, group, cfg.d_model).float(), p["moe"]["router"]["w"])
    dispatch_mask, _ = _route(logits, mc, mc.capacity(group))
    return dispatch_mask.sum(dim=-1).reshape(-1, mc.n_experts) > 0


def phase_moe_ssm(torch, card):
    """Phase 8b; returns its row and the launches of the kernel-policy serve
    runs, of the fused-policy training runs and of the f32 kernel-policy
    serve runs."""
    t0 = time.perf_counter()
    gen = lambda: torch.Generator(device=DEVICE).manual_seed(0)  # noqa: E731
    serve_rows, serve_launches = {}, {name: 0 for name in launch_counts()}
    exact_launches = dict(serve_launches)
    for arch in MOE_SSM_SERVE:
        serve_rows[arch], launches, f32_launches = moe_ssm_serve(torch, arch, gen)
        for name, count in launches.items():
            serve_launches[name] += count
        for name, count in f32_launches.items():
            exact_launches[name] += count
        emit_phase({"phase": "moe_ssm_serve", "arch": arch, **{
            k: serve_rows[arch][k] for k in ("first_token_rel_l2", "tokens_per_s", "seconds")}})
    serve_s = time.perf_counter() - t0
    train_rows, train_launches = {}, {name: 0 for name in launch_counts()}
    for arch, (repeats, reduced) in MOE_SSM_TRAIN.items():
        kernels = NO_ATTENTION_KERNELS if arch == "mamba2-2.7b" else TRAIN_KERNELS
        train_rows[arch], launches = arch_train(torch, arch, reduced, repeats, gen(), kernels,
                                                f32_anchor=arch in MOE_SSM_F32_ANCHOR)
        for name, count in launches.items():
            train_launches[name] += count
    row = {"phase": "moe_ssm", "card": card, "serve": serve_rows, "train": train_rows,
           "seconds": time.perf_counter() - t0,
           "seconds_by_part": {"serve": serve_s, "train": time.perf_counter() - t0 - serve_s}}
    return row, serve_launches, train_launches, exact_launches


# -- phase 9/10/11 helpers ----------------------------------------------------


def pick_metrics(ds, pred, pair_times):
    """Selection metrics of ``pred`` (+1: the op pair's direct arm, which is
    the library call for NT, NN and TN) on the records ``ds``: the paper's
    Table VII numbers, the speedup of the selected arm over always the
    library (mean of ratios and ratio of sums) and the regret against the
    pair's oracle."""
    import numpy as np

    from repro_torch.core import selection_metrics

    t_direct, t_alt = pair_times
    t_sel = np.where(pred == 1, t_direct, t_alt)
    t_best = np.minimum(t_direct, t_alt)
    return {
        **selection_metrics(ds, pred),
        "speedup_vs_library_mean": float(np.mean(t_direct / t_sel)),
        "speedup_vs_library_total": float(t_direct.sum() / t_sel.sum()),
        "regret_vs_oracle_mean": float(np.mean(t_sel / t_best) - 1.0),
        "regret_vs_oracle_total": float(t_sel.sum() / t_best.sum() - 1.0),
    }


def close_pairs(torch, ds, dtype_name, pair):
    """For the NT shapes where ``pair``'s two arms are closest in the grid's
    (queued device) time: both arms' profiler device time, and whether the
    label flips."""
    import numpy as np

    from repro_torch.core import get_candidate
    from repro_torch.core.features import OP_FEATURE

    nt = np.where(ds.X[:, 8] == OP_FEATURE["NT"])[0]
    gap = np.abs(np.log(ds.times["NT"][nt] / ds.times["TNN"][nt]))
    rows = []
    dt = getattr(torch, dtype_name)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for i in nt[np.argsort(gap, kind="stable")[:CLOSE_PAIRS]]:
        m, n, k = (int(v) for v in ds.mnk[i])
        a = torch.randn((m, k), generator=gen, device=DEVICE, dtype=dt)
        b = torch.randn((n, k), generator=gen, device=DEVICE, dtype=dt)
        device = tuple(device_ms(lambda c=get_candidate(name): c.run(a, b))[0]
                       for name in pair)
        grid = (float(ds.times["NT"][i]) * 1e3, float(ds.times["TNN"][i]) * 1e3)
        rows.append({"mnk": [m, n, k], "grid_ms": grid, "device_ms": device,
                     "label_grid": 1 if grid[0] <= grid[1] else -1,
                     "label_device": 1 if device[0] <= device[1] else -1})
    return rows


def phase_selector(torch, card, out_dir):
    """Phase 9; returns its row, the selector artifacts' paths and the
    launches of the measurement."""
    import numpy as np

    from repro_torch.benchmarks.common import CARD_PAIR, MEASURED_OPS, measure_grid
    from repro_torch.core import (
        MeasurementCache,
        MTNNSelector,
        dataset_from_measurements,
        device_spec,
        kfold_cv,
        paper_grid,
        train_kway_model,
        train_paper_model,
    )
    from repro_torch.core.opkey import OpKey
    from repro_torch.kernels.common import reset_launches

    hw = device_spec(DEVICE)
    lo, hi = SELECTOR_GRID
    row = {"phase": "selector", "card": card, "hardware": hw.name, "grid": [lo, hi],
           "pair": list(CARD_PAIR), "dtypes": {}}
    paths, launches = {}, {name: 0 for name in launch_counts()}
    for dtype, short in SELECTOR_DTYPES.items():
        t0 = time.perf_counter()
        reset_launches()
        # device time: below about 2^11 per side an event pair around one
        # call times the host's launch, not the kernels
        dropped = {}
        cache = measure_grid(MeasurementCache(str(out_dir / f"measured_{short}.json")), dtype,
                             lo, hi, device=DEVICE, queued=True, failures=dropped)
        for name, count in launch_counts().items():
            launches[name] += count
        cache.save()
        measure_s = time.perf_counter() - t0
        max_tries = check_measurement(f"selector {dtype} grid", cache, dropped)
        ds = dataset_from_measurements(cache, pair=CARD_PAIR, dtype=dtype)
        check(len(ds) == len(MEASURED_OPS) * (hi - lo + 1) ** 3,
              f"{dtype}: {len(ds)} records, expected every grid shape of every op")
        cv = kfold_cv(ds)
        clf, rep = train_paper_model(ds)
        sel = MTNNSelector(clf, hardware=hw, binary_pair=CARD_PAIR)
        paths[dtype] = out_dir / f"selector_{short}.json"
        sel.save(str(paths[dtype]))
        loaded = MTNNSelector.load(str(paths[dtype]))
        check(loaded.hardware == hw, f"{dtype}: the artifact resolved to {loaded.hardware}")
        dsize = torch.finfo(getattr(torch, dtype)).bits // 8
        keys = [OpKey(op, m, n, k, dsize) for op in MEASURED_OPS for m, n, k in paper_grid(lo, hi)]
        differ = [key for key in keys if sel.select(key) != loaded.select(key)]
        check(not differ, f"{dtype}: the loaded artifact decides {len(differ)} keys otherwise")
        pred = clf.predict(ds.X)
        ops = np.array([MEASURED_OPS[int(c)] for c in ds.X[:, 8]])
        per_op = {}
        for op in MEASURED_OPS:
            idx = np.where(ops == op)[0]
            sub = ds.subset(idx)
            per_op[op] = {
                "direct_wins": float((sub.y == 1).mean()),
                "selected_direct": float((pred[idx] == 1).mean()),
                **pick_metrics(sub, pred[idx], (sub.times["NT"], sub.times["TNN"])),
            }
        nt_cache = MeasurementCache()
        for key, times in cache.records():
            if key[3] == "NT":
                nt_cache.put(key, times)
        ds_nt = dataset_from_measurements(nt_cache, pair=CARD_PAIR, dtype=dtype)
        nt_names = sorted(c for c in ds_nt.times if c not in ("NT", "TNN"))
        _, kway = train_kway_model(ds_nt, candidates=nt_names)
        t_all = np.stack([ds_nt.times[c] for c in nt_names], axis=1)
        row["dtypes"][dtype] = {
            "records": len(ds), "class_counts": ds.class_counts(), "cv": cv,
            "in_sample_accuracy": rep["full_data_accuracy"],
            "selection": pick_metrics(ds, pred, (ds.times["NT"], ds.times["TNN"])),
            "per_op": per_op,
            "nt_fastest_share": {c: float((t_all.argmin(axis=1) == i).mean())
                                 for i, c in enumerate(nt_names)},
            # the share of the NT shapes where each kernel beats cuBLAS NT
            "nt_beats_cublas_share": {c: float((ds_nt.times[c] < ds_nt.times["XLA_NT"]).mean())
                                      for c in nt_names if c != "XLA_NT"},
            "kway_nt": {k: kway[k] for k in ("oracle_match", "mean_slowdown_vs_oracle",
                                             "mean_speedup_vs_worst")},
            "close_pairs": close_pairs(torch, ds, dtype, CARD_PAIR),
            "measure_seconds": measure_s, "artifact": str(paths[dtype].relative_to(ROOT)),
            "measure_max_tries": max_tries, "measure_dropped": dropped,
        }
    return row, paths, launches


def phase_fcn(torch, card, selector_f32):
    """Phase 10; returns its row and the launches of the training runs."""
    import numpy as np

    from repro_torch.benchmarks.table10_fcn import bench_phase
    from repro_torch.configs.fcn_paper import MNIST_FCNS, SYNTHETIC_FCNS
    from repro_torch.core.engine import dispatch_report, policy_from_spec
    from repro_torch.examples.train_fcn import make_fcn_step, synthetic_batch
    from repro_torch.kernels.common import reset_launches
    from repro_torch.models.fcn import fcn_loss_and_grads, init_fcn
    from repro_torch.optim import adamw_init, tree_leaves, warmup_cosine

    nets = {c.name: c for c in (*MNIST_FCNS.values(), *SYNTHETIC_FCNS.values())}
    specs = {"CaffeNT": CUBLAS_POLICY, "CaffeMTNN": f"model:{selector_f32}"}
    row = {"phase": "fcn", "card": card, "dtype": "float32", "batch": FCN_BATCH,
           "steps": FCN_STEPS, "nets": {}}
    launches = {name: 0 for name in launch_counts()}
    for net in FCN_NETS:
        cfg = nets[net]
        params0 = init_fcn(0, cfg, device=DEVICE)
        rng = np.random.RandomState(0)
        w_true = rng.randn(cfg.input_dim, 8).astype(np.float32)
        batches = [synthetic_batch(rng, cfg, FCN_BATCH, w_true, DEVICE)
                   for _ in range(FCN_STEPS)]
        out, step0 = {}, {}
        for arm, spec in specs.items():
            policy = policy_from_spec(spec, device=DEVICE)
            step0[arm] = fcn_loss_and_grads(params0, batches[0], policy)
            step_fn = make_fcn_step(policy, warmup_cosine(1e-4, warmup=2, total=FCN_STEPS))
            params, opt = params0, adamw_init(params0)
            policy.stats.reset()  # count the training steps' dispatches only
            reset_launches()
            losses, times = [], []
            for step, batch in enumerate(batches):
                t0 = time.perf_counter()
                params, opt, loss, _ = step_fn(params, opt, step, batch)
                losses.append(float(loss))  # waits for the device
                times.append(time.perf_counter() - t0)
            run_launches = launch_counts()
            for name, count in run_launches.items():
                launches[name] += count
            check(all(math.isfinite(x) for x in losses), f"{net} {arm}: losses {losses}")
            out[arm] = {
                "spec": spec, "losses": losses, "step_ms": [t * 1e3 for t in times],
                "ms_per_step": statistics.median(times[1:]) * 1e3,
                "by_op": {op: dict(v) for op, v in policy.stats.by_op.items()},
                "report": dispatch_report(policy).splitlines(),
                "launches": {k: v for k, v in run_launches.items() if v},
            }
            fwd_s, bwd_s = bench_phase(cfg, FCN_BATCH, policy, DEVICE)
            out[arm].update(fwd_ms=fwd_s * 1e3, bwd_ms=bwd_s * 1e3)
            del params, opt
        (l_nt, g_nt), (l_mt, g_mt) = step0["CaffeNT"], step0["CaffeMTNN"]
        loss_rel = rel(float(l_mt), float(l_nt))
        check(loss_rel <= EXACT_LOSS_REL, f"{net}: step-0 loss {float(l_mt)} vs {float(l_nt)}")
        worst = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                    for a, b in zip(tree_leaves(g_mt), tree_leaves(g_nt)))
        check(worst <= EXACT_GRAD_REL_L2,
              f"{net}: a step-0 gradient leaf is {worst} from CaffeNT's (rel L2)")
        row["nets"][net] = {"dims": list(cfg.dims), "step0_loss_rel": loss_rel,
                            "step0_worst_leaf_rel_l2": worst, **out}
        del params0, batches, step0, g_nt, g_mt
    return row, launches


def phase_model_policy(torch, card, selector_bf16, train_row):
    """Phase 11; returns its row and the launches of each run."""
    from repro_torch.core.engine import dispatch_report
    from repro_torch.kernels.common import reset_launches

    reset_launches()
    eng = serve([])  # no --policy: the default learned selector
    serve_launches = launch_counts()
    check_engine(eng, 16, "default policy")
    n_tok = sum(len(r.generated) for r in eng.requests.values())
    serve_part = {
        "tokens_per_s": n_tok / eng.run_seconds, "p50_decode_ms": p50_ms(eng),
        "health": eng.health(), "by_op": eng.class_dispatch_rows(),
        "reports": {cls: rep.splitlines() for cls, rep in eng.class_reports().items()},
        "launches": {k: v for k, v in serve_launches.items() if v},
    }
    del eng
    spec = f"model:{selector_bf16}"
    reset_launches()
    run = train(["--policy", spec])
    train_launches = launch_counts()
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in run.metrics),
          f"{spec}: a non-finite loss or grad norm")
    x0 = train_row["step0"][CUBLAS_POLICY]
    m0 = run.metrics[0]
    step0 = {"loss": m0["loss"], "grad_norm": m0["grad_norm"],
             "loss_rel_vs_cublas": rel(m0["loss"], x0["loss"]),
             "grad_norm_rel_vs_cublas": rel(m0["grad_norm"], x0["grad_norm"]),
             "grad_norm_rel_vs_f32": rel(m0["grad_norm"], train_row["f32_grad_norm"])}
    check(step0["loss_rel_vs_cublas"] <= LOSS_REL,
          f"{spec}: step-0 loss {m0['loss']} vs cuBLAS {x0['loss']}")
    check(step0["grad_norm_rel_vs_cublas"] <= GRAD_NORM_REL,
          f"{spec}: step-0 grad norm {m0['grad_norm']} vs cuBLAS {x0['grad_norm']}")
    limit = F32_DISTANCE_RATIO * x0["grad_norm_rel_vs_f32"] + F32_DISTANCE_FLOOR
    check(step0["grad_norm_rel_vs_f32"] <= limit,
          f"{spec}: step-0 grad norm is {step0['grad_norm_rel_vs_f32']} from f32, beyond {limit}")
    n_steps = len(run.times)
    row = {
        "phase": "model_policy", "card": card, "serve_default_policy": serve_part,
        "train": {"spec": spec, "steps": n_steps, "step0": step0,
                  "losses": [m["loss"] for m in run.metrics],
                  "ms_per_step": statistics.median(run.times[1:]) * 1e3,
                  "cublas_ms_per_step": train_row["ms_per_step"][CUBLAS_POLICY],
                  "report": dispatch_report(run.policy).splitlines(),
                  "launches_per_step": {k: v / n_steps for k, v in train_launches.items() if v}},
    }
    return row, serve_launches, train_launches


def nan_tailed(torch, shape, dt, gen):
    """A contiguous operand whose storage runs on into NaN."""
    size = math.prod(shape)
    buf = torch.randn(size + 4096, generator=gen, device=DEVICE).to(dt)
    buf[size:] = float("nan")
    return buf[:size].view(shape)


def tile_cases(torch):
    """(kernel, label, dtype, call(block), plain, tolerance, space) for
    every case whose tile space phase 12 sweeps."""
    from repro_torch.kernels import ref, tiling
    from repro_torch.kernels.attention_fused import MaskParams, attention_fused
    from repro_torch.kernels.ops import (
        matmul_bnn,
        matmul_bnt,
        matmul_nn,
        matmul_nt,
        matmul_tnn_fused,
        transpose,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(12)
    cases = []
    for n, k in TRANSPOSE_TILE_SHAPES:
        b = nan_tailed(torch, (n, k), torch.bfloat16, gen)
        b[0, 1] = float("nan")
        cases.append(("transpose", f"({n},{k})", "bfloat16",
                      lambda block, b=b: transpose(b, block=block), lambda b=b: ref.transpose(b),
                      (0.0, 0.0), tiling.TRANSPOSE_INSTANCES))
    fns = {"matmul_nt": (matmul_nt, ref.matmul_nt), "matmul_nn": (matmul_nn, ref.matmul_nn),
           "matmul_tnn_fused": (matmul_tnn_fused, ref.matmul_tnn_fused),
           "matmul_bnt": (matmul_bnt, ref.matmul_bnt), "matmul_bnn": (matmul_bnn, ref.matmul_bnn)}
    for kname, (fn, plain) in fns.items():
        dname = TILE_DTYPES.get(kname, "bfloat16")
        dt = getattr(torch, dname)
        for g, m, n, k in TILE_SHAPES[kname]:
            batched = kname in ("matmul_bnt", "matmul_bnn")
            a = nan_tailed(torch, (g, m, k) if batched else (m, k), dt, gen)
            b = nan_tailed(torch, {"matmul_nn": (k, n), "matmul_bnt": (g, n, k),
                                   "matmul_bnn": (g, k, n)}.get(kname, (n, k)), dt, gen)
            cases.append((kname, f"g={g} ({m},{n},{k})", dname,
                          lambda block, a=a, b=b, fn=fn: fn(a, b, block=block),
                          lambda a=a, b=b, plain=plain: plain(a, b), tol(dname, k),
                          tiling.enumerate_tile_configs(kname, m, n, k, a.element_size(), g)))
    for g, m, n, dh in TILE_SHAPES["attention_fused"]:
        q = torch.randn((g, m, dh), generator=gen, device=DEVICE).mul(dh ** -0.5).bfloat16()
        kv = [torch.randn((g, n, dh), generator=gen, device=DEVICE).bfloat16() for _ in range(2)]
        lengths = torch.randint(1, n + 1, (g,), generator=gen, device=DEVICE, dtype=torch.int32)
        for i, length in enumerate(lengths.tolist()):
            kv[0][i, length:] = float("nan")
            kv[1][i, length:] = float("nan")
        want = ref.attention_fused(q, kv[0], kv[1], lengths, MaskParams())
        cases.append(("attention_fused", f"decode g={g} m={m} n={n} dh={dh} ragged", "bfloat16",
                      lambda block, q=q, kv=kv, ln=lengths: attention_fused(
                          q, kv[0], kv[1], ln, block=block),
                      lambda want=want: want,
                      (2e-2, 2e-2 * float(want.float().pow(2).mean().sqrt())),
                      tiling.enumerate_tile_configs("attention_fused", m, n, dh, 2, g)))
    return cases


def tuned_gains(cache):
    """Per (op, candidate): the shapes whose fastest config is a tuned tile,
    which tiles won, and the device-time gain over the default plan."""
    import numpy as np

    out = {}
    for (_p, _hw, _dt, op, _g, m, n, k), times in cache.records():
        for name, cfgs in times.items():
            if "default" not in cfgs or len(cfgs) < 2:
                continue
            row = out.setdefault(f"{op} {name}", {"shapes": 0, "tile_wins": 0, "gains": [],
                                                  "tiles": {}})
            row["shapes"] += 1
            best = min(cfgs, key=cfgs.get)
            if best != "default":
                row["tile_wins"] += 1
                row["gains"].append(cfgs["default"] / cfgs[best])
                row["tiles"][best] = row["tiles"].get(best, 0) + 1
    for row in out.values():
        gains = row.pop("gains")
        row["median_gain"] = float(np.median(gains)) if gains else None
        row["max_gain"] = float(max(gains)) if gains else None
        row["top_tiles"] = dict(sorted(row["tiles"].items(), key=lambda kv: -kv[1])[:3])
        del row["tiles"]
    return out


def phase_tiles(torch, card, out_dir):
    """Phase 12; returns its row and the launches of its measurement and
    autotune serving run."""
    from repro_torch.benchmarks.common import measure_grid, op_dataset
    from repro_torch.core import (
        MeasurementCache,
        ModelPolicy,
        MTNNSelector,
        device_spec,
        get_candidate,
        train_kway_model,
    )
    from repro_torch.core.engine import dispatch, use_policy
    from repro_torch.core.measure import (
        bench_fn,
        measure_transpose_configs,
        tile_tables_from_cache,
    )
    from repro_torch.core.opkey import OpKey, shape_key
    from repro_torch.kernels.common import CONFIG_LAUNCHES, config_key, reset_launches

    row = {"phase": "tiles", "card": card, "cases": []}
    t0 = time.perf_counter()
    for kname, label, dname, call, plain, (rtol, atol), space in tile_cases(torch):
        want = plain()
        torch.cuda.synchronize()
        for block in [None, *space]:
            reset_launches()
            out = call(block)
            torch.cuda.synchronize()
            key = config_key(block)
            check(dict(CONFIG_LAUNCHES) == {(kname, key): 1},
                  f"{kname} {label} @ {key}: launches {dict(CONFIG_LAUNCHES)}")
            if kname == "transpose":
                bits = torch.int16 if out.element_size() == 2 else torch.int32
                ok, err = bool(torch.equal(out.view(bits), want.view(bits))), 0.0
            else:
                err, ok = compare(out, want, rtol, atol)
            check(ok, f"{kname} {label} @ {key}: max_abs_err {err} beyond {atol} / {rtol}")
            row["cases"].append({
                "kernel": kname, "case": label, "dtype": dname, "config": key, "err": err,
                "ms": time_ms(lambda b=block: call(b)),
                "device_ms": device_ms(lambda b=block: call(b))[0],
                # device time of 20 calls queued back to back behind a sleep
                # kernel (events between them; no profiler)
                "queued_ms": 1e3 * bench_fn(lambda _, b=block: call(b), want, reps=20,
                                            queued=True)})
    row["sweep_seconds"] = time.perf_counter() - t0

    hw = device_spec(DEVICE)
    lo, hi = TUNED_GRID
    t0 = time.perf_counter()
    reset_launches()
    dropped = {}
    cache = measure_grid(MeasurementCache(str(out_dir / "measured_bf16_tuned.json")), "bfloat16",
                         lo, hi, device=DEVICE, tune=True, queued=True, failures=dropped)
    measure_launches = launch_counts()
    cache.save()
    row["tuned_measure_seconds"] = time.perf_counter() - t0
    row["tuned_measure_max_tries"] = check_measurement("tuned bf16 grid", cache, dropped)
    tables = tile_tables_from_cache(cache, dtype="bfloat16")
    row["tuned_gains"] = tuned_gains(cache)
    row["tile_table_sizes"] = {f"{op} {name}": len(e["by_shape"])
                               for op, t in tables.items() for name, e in t.items()}
    row["transpose_tuned"] = {
        "shape": [49152, 576],
        "us": {ck: t * 1e6 for ck, t in measure_transpose_configs(
            49152, 576, "bfloat16", reps=10, device=DEVICE, queued=True).items()}}

    # a k-way artifact over the NT kernels, with the tables: its ModelPolicy
    # dispatches the tuned tile of the shape's table entry
    ds = op_dataset(cache, "NT", "bfloat16")
    kway, _ = train_kway_model(ds, candidates=list(NT_KERNEL_CANDIDATES))
    path = out_dir / "selector_bf16_tuned_kway.json"
    MTNNSelector(kway, hardware=hw, mode="kway", tile_tables=tables).save(str(path))
    policy = ModelPolicy.from_artifact(str(path))
    tuned = []
    for m, n, k in ((2 ** a, 2 ** b, 2 ** c) for a in range(lo, hi + 1)
                    for b in range(lo, hi + 1) for c in range(lo, hi + 1)):
        d = policy.select(OpKey("NT", m, n, k, 2))
        entry = tables.get("NT", {}).get(d.name, {}).get("by_shape", {}).get(shape_key((m, n, k)))
        if d.config is not None and entry == config_key(d.config):
            tuned.append(((m, n, k), d))
    check(tuned, "the tuned artifact's policy dispatches no shape at its table's tile")
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    for (m, n, k), d in tuned[:3]:
        a = torch.randn((m, k), generator=gen, device=DEVICE).bfloat16()
        b = torch.randn((n, k), generator=gen, device=DEVICE).bfloat16()
        reset_launches()
        with use_policy(policy):
            out = dispatch("NT", a, b)
        torch.cuda.synchronize()
        kernel = get_candidate(d.name).kernel
        check(CONFIG_LAUNCHES.get((kernel, config_key(d.config))) == 1,
              f"{d.label()} at {(m, n, k)}: launches {dict(CONFIG_LAUNCHES)}")
        err, ok = compare(out, a.float() @ b.float().t(), *tol("bfloat16", k))
        check(ok, f"{d.label()} at {(m, n, k)}: max_abs_err {err}")
    row["model_policy_tuned"] = {"shapes_at_tuned_tile": len(tuned),
                                 "grid_shapes": (hi - lo + 1) ** 3,
                                 "checked": [[list(s), d.label()] for s, d in tuned[:3]]}

    # smollm-135m served under autotune: warm after warmup
    at_path = out_dir / "autotune_smollm.json"
    if at_path.exists():
        at_path.unlink()
    reset_launches()
    t0 = time.perf_counter()
    eng = serve(["--policy", f"autotune:{at_path}"])
    serve_launches = launch_counts()
    check_engine(eng, 16, "autotune policy")
    misses = eng.cold_misses()
    check(set(misses.values()) == {0}, f"autotune serving measured after warmup: {misses}")
    tries = {c: check_measurement(f"autotune class {c}", p.cache, p.failures)
             for c, p in eng.policies.items()}
    row["autotune_serve"] = {"cold_misses": misses, "seconds": time.perf_counter() - t0,
                             "measure_max_tries": tries,
                             "measured_keys": {c: p.n_measured for c, p in eng.policies.items()},
                             "decisions": eng.class_dispatch_rows()}
    launches = {name: measure_launches[name] + serve_launches[name] for name in launch_counts()}
    return row, launches


SANITIZE_SECONDS = 60  # the sanitizer phase's budget on one card


def phase_sanitize(torch, card):
    """Phase 3a: the poison sanitizer (analysis/sanitize.py, NM404) on the
    card over its default grid (the JAX package's ragged cell and the
    ragged cells of the fast routes), both dtypes and the three poisons:
    every plan of every kernel arm and of the transpose kernel launched
    (counted per (kernel, config) against kernels/tiling.py's plans), no
    finding, and every output and workspace allocation of a kernel arm back
    from the allocator poisoned.  Its launches are a check's, not a main
    path's: the counts are reset after it."""
    from repro_torch.analysis import sanitize
    from repro_torch.kernels import tiling
    from repro_torch.kernels.common import (
        ATTENTION_ROUTES,
        CONFIG_LAUNCHES,
        GEMM_ROUTES,
        config_key,
        reset_launches,
    )

    shapes = sanitize.grid()
    dtypes = ("float32", "bfloat16")
    reset_launches()
    rep = sanitize.sanitize_candidates(shapes=shapes, dtypes=dtypes, device=DEVICE,
                                       repo_root=str(ROOT))
    launches, configs = launch_counts(), dict(CONFIG_LAUNCHES)
    routes = sorted({f"{k[0]} {k[1]} {k[2]}" for k in GEMM_ROUTES}
                    | {f"attention_fused {v} dh{dh}" for v, dh in ATTENTION_ROUTES})
    reset_launches()
    planned = {("transpose", config_key(c)) for c in tiling.TRANSPOSE_INSTANCES}
    for kernel in tiling.TUNABLE_KERNELS:
        grouped = kernel in ("matmul_bnt", "matmul_bnn", "attention_fused")
        for m, n, k, g in shapes:
            for dt in dtypes:
                dsize = torch.finfo(getattr(torch, dt)).bits // 8
                planned |= {(kernel, config_key(c)) for c, _ in tiling.tile_plans(
                    kernel, m, n, k, dsize, g if grouped else 1)}
    unlaunched = sorted(f"{kname}@{ck}" for kname, ck in planned
                        if not configs.get((kname, ck)))
    row = {"phase": "sanitize", "card": card, "shapes": [list(s) for s in shapes],
           "dtypes": list(dtypes), "poisons": list(rep.poisons), "cells": rep.cells,
           "runs": rep.runs, "plans": len(planned), "leaks": rep.leaks,
           "findings": [f.render() for f in rep.findings[:20]],
           "allocations": rep.allocations, "unpoisoned": rep.unpoisoned,
           "routes": routes, "launches": launches, "seconds": rep.seconds,
           "budget_seconds": SANITIZE_SECONDS}
    check(not rep.findings, f"sanitizer: {len(rep.findings)} findings, {rep.leaks} leaks: "
                            f"{row['findings']}")
    check(rep.allocations > 0 and rep.unpoisoned == 0,
          f"sanitizer: {rep.unpoisoned} of {rep.allocations} allocations did not come back "
          "poisoned from the allocator")
    check(not unlaunched, f"sanitizer: plans never launched: {unlaunched}")
    check(rep.seconds <= SANITIZE_SECONDS,
          f"sanitizer took {rep.seconds:.1f} s, over its {SANITIZE_SECONDS} s budget")
    return row


GRIDSPEC_SECONDS = 30  # phase 3b's limit; about 10 s expected


def phase_gridspec(torch, card):
    """Phase 3b: the declared grids (kernels/gridspec.py) and their proof
    (analysis/coverage.py) on the card: check_coverage on the card's SM
    count, then every route launched from its spec, and each non-persistent
    route on a grid one block short (coverage.launch_routes).  Its launches
    are a check's: the counts are reset after it."""
    from repro_torch.analysis import coverage
    from repro_torch.core.candidates import CANDIDATES
    from repro_torch.kernels.common import reset_launches, sm_count

    t0 = time.perf_counter()
    sms = sm_count(torch.cuda.current_device())
    rep = coverage.check_coverage(sms=sms, repo_root=str(ROOT))
    proof_s = time.perf_counter() - t0
    tunable = sorted((n, op) for n, c in CANDIDATES.items() for op in c.ops if c.tunable)
    reset_launches()
    t1 = time.perf_counter()
    routes = coverage.launch_routes(DEVICE, sms)
    launch_s = time.perf_counter() - t1
    reset_launches()
    seconds = time.perf_counter() - t0
    row = {"phase": "gridspec", "card": card, "sms": sms, "cells": rep.cells,
           "specs": rep.specs, "findings": [f.render() for f in rep.findings[:20]],
           "proven_pairs": [list(p) for p in sorted(rep.proven_pairs)],
           "proof_seconds": proof_s, "routes": routes, "launch_seconds": launch_s,
           "seconds": seconds, "budget_seconds": GRIDSPEC_SECONDS}
    check(not rep.findings, f"gridspec: {len(rep.findings)} findings: {row['findings']}")
    check(sorted(rep.proven_pairs) == tunable,
          f"gridspec: proven {sorted(rep.proven_pairs)}, tunable {tunable}")
    bad = [r for r in routes if not r["ok"]]
    check(not bad, f"gridspec: routes failed: {bad}")
    short = sum(not r[-1] for r in coverage.LAUNCH_ROUTES)
    check(sum(1 for r in routes if "short" in r) == short,
          f"gridspec: fewer than {short} routes ran a short grid")
    check(seconds <= GRIDSPEC_SECONDS,
          f"gridspec took {seconds:.1f} s, over its {GRIDSPEC_SECONDS} s limit")
    return row


def phase_artifacts(card, out_dir):
    """Phase 12a: the artifact pass (analysis/artifacts_lint.py) over the
    measurement caches and selector artifacts phases 9 and 12 wrote to
    build/: each must exist and validate clean against the schemas."""
    from repro_torch.analysis import artifacts_lint

    names = ("measured_bf16.json", "measured_f32.json", "selector_bf16.json",
             "selector_f32.json", "measured_bf16_tuned.json", "selector_bf16_tuned_kway.json",
             "autotune_smollm.json")
    t0 = time.perf_counter()
    paths = [str(out_dir / name) for name in names]
    findings = artifacts_lint.run(str(ROOT), targets=paths)
    kinds = {}
    for name, path in zip(names, paths):
        if os.path.exists(path):
            kinds[name] = artifacts_lint.sniff_kind(json.loads(Path(path).read_text()))
    row = {"phase": "artifacts", "card": card, "kinds": kinds,
           "findings": [f.render() for f in findings[:20]],
           "seconds": time.perf_counter() - t0}
    check(not findings, f"artifacts: {len(findings)} findings: {row['findings']}")
    check(set(kinds.values()) == {"cache", "selector"}, f"artifacts: kinds {kinds}")
    return row


def phase_bench(torch, card, out_dir):
    """Phase 13; returns its row and the launches of its benchmarks."""
    from repro_torch.benchmarks import kernel_sweep
    from repro_torch.benchmarks.run import run_benches
    from repro_torch.kernels.common import reset_launches

    reset_launches()
    t0 = time.perf_counter()
    results, failures = run_benches(BENCH_ONLY.split(","), full=False, device=DEVICE,
                                    dtype="float32", cache=str(out_dir / "measured_f32.json"),
                                    hi=None)
    check(not failures, f"benchmarks failed: {failures}")
    # the same dataset benchmarks on phase 9's bf16 grid, the dtype the LMs run
    results_bf16, failures = run_benches(BENCH_BF16.split(","), full=False, device=DEVICE,
                                         dtype="bfloat16",
                                         cache=str(out_dir / "measured_bf16.json"), hi=None)
    check(not failures, f"bf16 benchmarks failed: {failures}")
    bench_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sweep_json = out_dir / "bench" / "kernel_sweep.json"
    check(kernel_sweep.main(["--quick", "--json", str(sweep_json)]) == 0, "kernel_sweep failed")
    sweep = json.loads(sweep_json.read_text())
    launches = launch_counts()
    r = results
    fig3 = next(v for v in r["fig3"].values() if v["source"] == "measured")
    head = {
        "fig1 P_NN>P_NT share (cuBLAS)": (r["fig1"]["measured"]["frac_nn_wins"], "0.71 / 0.62"),
        "fig1 P_NN/P_NT >= 2 share": (r["fig1"]["measured"]["frac_ge2"], "~0.20"),
        "fig2 max speedup TNN over NT": (r["fig2"]["max_speedup_tnn_over_nt"], "4.7"),
        "fig2 max speedup NT over TNN": (r["fig2"]["max_speedup_nt_over_tnn"], "15.39"),
        "fig3 P_TNN/P_NT < 1 share": (fig3["frac_tnn_loses"], "0.415 / 0.43"),
        "table4 CV total avg": (r["table4"]["total"]["avg"], "0.9051"),
        **{f"table6 {kind} accuracy": (r["table6"][kind]["accuracy"], f"{p / 100:.4f}")
           for kind, p in (("gbdt", 90.51), ("dt", 87.84), ("svm-rbf", 81.66),
                           ("svm-poly", 77.68))},
        "fig4 full-data accuracy": (r["fig4"]["full_data_accuracy"], "0.9639"),
        **{f"table8 {k}": (r["table8"]["total"][k], str(v)) for k, v in
           (("mtnn_vs_nt", 54.03), ("mtnn_vs_tnn", 21.92), ("gow_avg", 76.23),
            ("lub_avg", -0.28))},
        "kway mean slowdown vs oracle": (r["kway"]["rows"]["kway_regressor"], "n/a"),
        "ModelPolicy warm select ms/call": (r["policy_overhead"]["ModelPolicy(binary)"]["warm_ms"],
                                            "0.005"),
    }
    rb = results_bf16
    fig3_bf16 = next(v for v in rb["fig3"].values() if v["source"] == "measured")
    head.update({
        "bf16 fig1 P_NN>P_NT share (cuBLAS)": (rb["fig1"]["measured"]["frac_nn_wins"],
                                               "0.71 / 0.62"),
        "bf16 fig3 P_TNN/P_NT < 1 share": (fig3_bf16["frac_tnn_loses"], "0.415 / 0.43"),
        "bf16 table4 CV total avg": (rb["table4"]["total"]["avg"], "0.9051"),
        "bf16 table8 mtnn_vs_nt": (rb["table8"]["total"]["mtnn_vs_nt"], "54.03"),
        "bf16 table8 mtnn_vs_tnn": (rb["table8"]["total"]["mtnn_vs_tnn"], "21.92"),
    })
    for name, (mine, paper) in head.items():
        print(f"[bench] {name}: {mine:.4f} on the card; paper {paper}", flush=True)
    row = {"phase": "bench", "card": card, "benchmarks": sorted(results),
           "bench_seconds": bench_s, "sweep_seconds": time.perf_counter() - t0,
           "sweep_cells": len(sweep["rows"]), "headlines": head,
           "results": results, "results_bf16": results_bf16}
    return row, launches


# -- phases 5a, 7a, 14 and 15: the fixed-batch path, remat="dots", serving
# load and fault tolerance -----------------------------------------------------

LEGACY_ARGS = ["--arch", "smollm-135m", "--legacy", "--batch", "4", "--prompt-len", "32",
               "--gen", "16", "--seed", "0", "--device", DEVICE]
LEGACY_KERNEL_POLICY = KERNEL_POLICIES["interactive"]
LEGACY_KERNELS = ("transpose", "matmul_nn", "attention_fused")  # what that policy names
REMAT_STEPS = 8  # ms/step is the median of steps 1-7: two steps read only the host's noise
SERVE_LOAD_REQUESTS = 32  # serve_load's non-quick trace
CHAOS_SPEC = "raise:PALLAS_NT.NT;raise:FUSED_ATTN.ATTN"
CHAOS_ARMS = {("PALLAS_NT", "NT"), ("FUSED_ATTN", "ATTN")}


def phase_legacy(torch, card):
    """Phase 5a: ``launch.serve --legacy`` on smollm-135m at full config
    (batch 4, 32-token prompts, 16 new) under the interactive kernel policy
    and cuBLAS, bf16; then f32 at 2 layers (f32 cache), where the greedy
    tokens of the two must be identical.  Returns its row and the kernel
    runs' launches."""
    import numpy as np

    from repro_torch.kernels.common import reset_launches

    t0 = time.perf_counter()
    runs, launches = {}, {}
    for label, extra in (("bf16", []), ("f32", ["--layers", "2", "--dtype", "float32",
                                                "--cache-dtype", "float32"])):
        for spec in (LEGACY_KERNEL_POLICY, CUBLAS_POLICY):
            reset_launches()
            t1 = time.perf_counter()
            gen = serve(extra + ["--policy", spec], LEGACY_ARGS)
            runs[(label, spec)] = (gen, time.perf_counter() - t1)
            launches[(label, spec)] = launch_counts()
            check(gen.shape == (4, 16) and int(gen.min()) >= 0 and int(gen.max()) < 49152,
                  f"legacy {label} {spec}: tokens {gen.shape} in [{gen.min()}, {gen.max()}]")
        check(all(launches[(label, LEGACY_KERNEL_POLICY)][k] > 0 for k in LEGACY_KERNELS),
              f"legacy {label}: kernels not launched: {launches[(label, LEGACY_KERNEL_POLICY)]}")
        check(not any(launches[(label, CUBLAS_POLICY)].values()),
              f"legacy {label}: cuBLAS launched kernels: {launches[(label, CUBLAS_POLICY)]}")
    f32_k, f32_x = runs[("f32", LEGACY_KERNEL_POLICY)][0], runs[("f32", CUBLAS_POLICY)][0]
    check(np.array_equal(f32_k, f32_x), "legacy f32: the kernel policy's greedy tokens differ "
          f"from cuBLAS's: {f32_k.tolist()} vs {f32_x.tolist()}")
    bf16_k, bf16_x = runs[("bf16", LEGACY_KERNEL_POLICY)][0], runs[("bf16", CUBLAS_POLICY)][0]
    row = {"phase": "legacy", "card": card, "arch": "smollm-135m", "batch": 4, "prompt_len": 32,
           "gen": 16, "policies": [LEGACY_KERNEL_POLICY, CUBLAS_POLICY],
           "bf16_greedy_agreement": float((bf16_k == bf16_x).mean()), "f32_identical": True,
           "run_seconds": {f"{label} {spec}": t for (label, spec), (_, t) in runs.items()},
           "seconds": time.perf_counter() - t0}
    kernel_launches = {name: sum(launches[(label, LEGACY_KERNEL_POLICY)][name]
                                 for label in ("bf16", "f32"))
                       for name in launch_counts()}
    return row, kernel_launches


def phase_remat_dots(torch, card, train_row):
    """Phase 7a: the fused train policy for REMAT_STEPS steps from phase
    7's weights and batches (seed 0, ``launch/steps.py``'s train step, as
    the launcher runs it) under remat="full" and remat="dots": step-0
    loss and grad norm of "dots" within phase 7's gates of phase 7's
    "full" run; under "dots" no NT/NN/TN GEMM runs in the recompute (the
    forward's outputs are replayed, counted by dispatch), and the NT
    dispatches saved are those "full" runs again; ms/step and peak
    memory of both, over what was allocated before each run (the previous
    run's state dropped first).  Returns its row and the "dots" run's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.kernels.common import reset_launches
    from repro_torch.launch.steps import TrainStepConfig, init_train_state, make_train_step
    from repro_torch.models import lm

    spec = TRAIN_POLICIES["fused"]
    t0 = time.perf_counter()
    metrics, times, nt, peak, counts, launches = {}, {}, {}, {}, {}, {}
    for remat in ("full", "dots"):
        cfg = get_config("smollm-135m").replace(remat=remat)
        policy = policy_from_spec(spec)
        step_fn = make_train_step(cfg, TrainStepConfig(total_steps=REMAT_STEPS), policy=policy)
        gc.collect()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine.REMAT_COUNTS.update(saved=0, replayed=0, recompute_gemms=0)
        reset_launches()
        state = init_train_state(cfg, lm.init_lm(0, cfg, device=DEVICE))
        metrics[remat], times[remat] = [], []
        for step in range(REMAT_STEPS):
            batch = train_batch(torch, cfg, step)
            t1 = time.perf_counter()
            state, m = step_fn(state, batch)
            metrics[remat].append({k: float(v) for k, v in m.items()})  # waits for the card
            times[remat].append(time.perf_counter() - t1)
        torch.cuda.synchronize()
        peak[remat] = (torch.cuda.max_memory_allocated() - start) / 2 ** 30
        del state, step_fn
        counts[remat] = dict(engine.REMAT_COUNTS)
        launches[remat] = launch_counts()
        nt[remat] = sum(policy.stats.by_op.get("NT", {}).values())
        check(all(math.isfinite(m["loss"]) for m in metrics[remat]),
              f"remat={remat}: a non-finite loss")
    ref = train_row["step0"][spec]
    d0 = metrics["dots"][0]
    check(rel(d0["loss"], ref["loss"]) <= LOSS_REL,
          f"remat=dots: step-0 loss {d0['loss']} vs remat=full's {ref['loss']}")
    check(rel(d0["grad_norm"], ref["grad_norm"]) <= GRAD_NORM_REL,
          f"remat=dots: step-0 grad norm {d0['grad_norm']} vs remat=full's {ref['grad_norm']}")
    dots = counts["dots"]
    check(dots["recompute_gemms"] == 0, f"remat=dots: the recompute dispatched GEMMs: {dots}")
    check(0 < dots["replayed"] <= dots["saved"], f"remat=dots: nothing replayed: {dots}")
    check(nt["full"] - nt["dots"] == dots["replayed"],
          f"remat=dots: NT dispatches {nt}, replayed {dots['replayed']}")
    row = {"phase": "remat_dots", "card": card, "policy": spec, "steps": REMAT_STEPS,
           "step0": {r: m[0] for r, m in metrics.items()},
           "step0_loss_rel_vs_phase7": rel(d0["loss"], ref["loss"]),
           "step0_grad_norm_rel_vs_phase7": rel(d0["grad_norm"], ref["grad_norm"]),
           "ms_per_step": {r: statistics.median(t[1:]) * 1e3 for r, t in times.items()},
           "step_ms_all": {r: [x * 1e3 for x in t] for r, t in times.items()},
           "peak_gib_over_start": peak, "remat_counts": dots, "nt_dispatches": nt,
           "matmul_tnn_fused_launches": {r: launches[r]["matmul_tnn_fused"] for r in launches},
           "seconds": time.perf_counter() - t0}
    check(launches["dots"]["matmul_tnn_fused"] < launches["full"]["matmul_tnn_fused"],
          f"remat=dots launched the fused TNN no fewer times: {row['matmul_tnn_fused_launches']}")
    return row, launches["dots"]


def phase_serve_load(torch, card, out_dir):
    """Phase 14: ``python -m repro_torch.benchmarks.serve_load --full`` in
    process: smollm-135m at full config, bf16, seed 0, 32 requests of 1-48
    prompt tokens and 2-24 new, 8 slots, max_seq 96, interactive under
    autotune (measured at warmup into build/) and bulk under analytic.
    Every request finishes, no step crashes, no class measures after
    warmup, every measurement runs at its first try.  Returns its row and
    launches."""
    from repro_torch.benchmarks import serve_load
    from repro_torch.kernels.common import reset_launches

    cache = out_dir / "serve_load_autotune.json"
    if cache.exists():
        cache.unlink()
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(cache)
    report_path = out_dir / "bench" / "serve_load.json"
    report_path.parent.mkdir(parents=True, exist_ok=True)
    reset_launches()
    t0 = time.perf_counter()
    rc = serve_load.main(["--full", "--device", DEVICE, "--seed", "0", "--out", str(report_path)])
    launches = launch_counts()
    seconds = time.perf_counter() - t0
    check(rc == 0, f"serve_load exited {rc}")
    report = json.loads(report_path.read_text())
    health = report["health"]
    check(health["finished"] == SERVE_LOAD_REQUESTS and health["crashed_steps"] == 0,
          f"serve_load: health {health}")
    check(set(report["cold_misses_after_warmup"].values()) == {0},
          f"serve_load: cold misses after warmup {report['cold_misses_after_warmup']}")
    for cls, m in report["measurement"].items():
        check(m["max_attempts"] in (None, 1) and not m["failures"],
              f"serve_load class {cls}: measurement {m}")
    check(report["measurement"]["interactive"]["max_attempts"] == 1,
          "serve_load: the autotune class measured nothing at warmup")
    row = {"phase": "serve_load", "card": card, "arch": report["arch"], "dtype": report["dtype"],
           "seed": report["seed"], "requests": SERVE_LOAD_REQUESTS, "slots": report["n_slots"],
           "max_seq": report["max_seq"], "trace": report["trace"], "warmup": report["warmup"],
           "totals": report["totals"], "cold_misses_after_warmup":
               report["cold_misses_after_warmup"],
           "classes": {cls: {k: c[k] for k in ("policy", "requests", "tokens", "p50_ms",
                                               "p99_ms", "mean_ms")}
                       for cls, c in report["classes"].items()},
           "tokens_per_s_by_class": {cls: c["tokens"] / report["totals"]["wall_s"]
                                     for cls, c in report["classes"].items()},
           "measurement": report["measurement"], "seconds": seconds}
    for cls, c in row["classes"].items():
        print(f"[serve_load] {cls}: {c['tokens']} tokens, p50 {c['p50_ms']:.2f} ms, "
              f"p99 {c['p99_ms']:.2f} ms; total {report['totals']['tokens_per_s']} tokens/s "
              f"on {card}", flush=True)
    return row, launches


def phase_faults(torch, card):
    """Phase 15: the fault drill on the card, then smollm-135m at full
    config served through launch.serve.main under phase 4's class
    policies with --chaos CHAOS_SPEC: every request finishes, no step
    crashes, the quarantine holds exactly the injected arms, neither the
    direct NT kernel nor the fused attention kernel launches, and the
    first-token logits of both (degraded) kernel policies pass phase 4's
    gates against cuBLAS; the quarantine is cleared and must be empty.
    Returns its row and launches."""
    from repro_torch.benchmarks import fault_drill
    from repro_torch.core import faults
    from repro_torch.kernels.common import reset_launches

    t0 = time.perf_counter()
    faults.clear_quarantine()
    reset_launches()
    drill = fault_drill.fault_drill(device=DEVICE)
    launches = launch_counts()
    for case in drill["cases"]:
        check(case["quarantined_arms"] == [f"NT:{fault_drill.CANDIDATE}"],
              f"fault drill {case['case']}: quarantined {case['quarantined_arms']}")
    check(len(drill["cases"]) == len(fault_drill.CASES), "the drill skipped a card case")
    drill_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    reset_launches()
    eng = serve(kernel_policy_args() + ["--chaos", CHAOS_SPEC])
    chaos_launches = launch_counts()
    check_engine(eng, 16, "chaos")
    arms = {(e.name, e.op) for e in faults.quarantine_entries()}
    check(arms == CHAOS_ARMS, f"chaos: quarantined {arms}, injected {CHAOS_ARMS}")
    check(chaos_launches["matmul_nt"] == 0 and chaos_launches["attention_fused"] == 0,
          f"chaos: a faulted kernel launched: {chaos_launches}")
    check(chaos_launches["transpose"] > 0 and chaos_launches["matmul_nn"] > 0,
          f"chaos: the interactive class's TNN kernels did not launch: {chaos_launches}")
    served_fallbacks = dict(dispatch_health()["fallbacks"])
    prompt = eng.requests[0].tokens
    ref_logits = first_token_logits(torch, eng, CUBLAS_POLICY, prompt)
    f32_logits = first_token_logits(torch, eng, CUBLAS_POLICY, prompt, torch.float32)
    to_ref, to_f32 = {}, {CUBLAS_POLICY: rel_l2(ref_logits, f32_logits)}
    for spec in KERNEL_POLICIES.values():
        got = first_token_logits(torch, eng, spec, prompt)
        to_ref[spec], to_f32[spec] = rel_l2(got, ref_logits), rel_l2(got, f32_logits)
        limit = F32_DISTANCE_RATIO * to_f32[CUBLAS_POLICY] + F32_DISTANCE_FLOOR
        check(to_ref[spec] <= LOGITS_REL_L2 and to_f32[spec] <= limit,
              f"chaos: first-token logits under {spec}: rel L2 {to_ref[spec]} to cuBLAS, "
              f"{to_f32[spec]} to f32 (limit {limit})")
    ledger = [{"op": e.op, "arm": e.label(), "failures": e.count, "error": e.error}
              for e in faults.quarantine_entries()]
    chaos_launches = launch_counts()  # the serve run and the logits' forwards
    check(chaos_launches["matmul_nt"] == 0 and chaos_launches["attention_fused"] == 0,
          f"chaos: a quarantined kernel launched for the logits: {chaos_launches}")
    faults.clear_quarantine()
    check(not faults.quarantine_entries() and not faults.fallback_counts(),
          "the quarantine did not clear")
    row = {"phase": "faults", "card": card, "drill": drill["cases"], "drill_seconds": drill_s,
           "chaos": {"spec": CHAOS_SPEC, "policies": KERNEL_POLICIES,
                     "quarantine": ledger, "fallbacks": served_fallbacks,
                     "health": eng.health(), "launches": {k: v for k, v in chaos_launches.items()
                                                          if v},
                     "first_token_rel_l2": to_ref, "first_token_rel_l2_to_f32": to_f32,
                     "tokens_per_s": sum(len(r.generated) for r in eng.requests.values())
                     / eng.run_seconds,
                     "seconds": time.perf_counter() - t1},
           "seconds": time.perf_counter() - t0}
    return row, {k: launches[k] + chaos_launches[k] for k in launches}


# -- phase 16: mesh ----------------------------------------------------------

# gemma3-4b at full width in two layers (one local, one global: the ring and
# the whole-sequence cache both), and in one global layer for the f32 checks
MESH_BATCH, MESH_SEQ, MESH_ACCUM, MESH_STEPS = 4, 256, 2, 3
MESH_SMOLLM_STEPS = 2
MESH_F32_STEPS = 2
# the step of tests/test_torch_distributed.py: an update large enough that a
# wrong mean, piece or gather shows in the next step's metrics and leaves
MESH_STEP = {"lr": 1e-3, "warmup": 1}
MESH_REQUESTS, MESH_GEN, MESH_PROMPT, MESH_MAX_SEQ = 4, 8, 48, 2048
MESH_LOGITS_REL = 1e-4  # f32 serving on a mesh against one rank: reduction order only
MESH_SUM_REL = 1e-5  # a collective's f32 sum against the f64 sum of its inputs
# the phase's limit: ZeRO-1 on 2x1 moves gemma3's ~0.9 B f32 gradients and
# bf16 params a step (on the card through CUDA IPC, collectives.py's route
# for gloo ranks that share one; gloo's own staging through the host and
# TCP took seconds a GB)
MESH_SECONDS = 150
MESH_KERNELS = ("matmul_nt", "matmul_tnn_fused", "matmul_nn", "transpose", "attention_fused")
# the meshes of each run: two gloo ranks sharing one card (16b), or four
# NCCL ranks a card each (``--nccl-cards 4``)
MESH_PLANS = {
    "gloo": {"backend": "gloo", "world": 2, "collectives": ((2, 1), (1, 2)),
             "gemma3": ((2, 1), (1, 2)), "smollm": (1, 2), "smollm_f32": (2, 1),
             "gemma3_f32": (1, 2)},
    "nccl": {"backend": "nccl", "world": 4, "collectives": ((2, 2),),
             "gemma3": ((2, 2),), "smollm": (2, 2), "smollm_f32": (2, 2),
             "gemma3_f32": (2, 2)},
}


def mesh_name(dm):
    return f"{dm[0]}x{dm[1]}"


def mesh_config(f32=False):
    """gemma3-4b at full width: one local and one global layer in bf16, one
    global layer in f32."""
    from repro_torch.configs import get_config

    cfg = get_config("gemma3-4b")
    local, glob = cfg.segments[0][1][0], cfg.segments[0][1][-1]
    if f32:
        return cfg.replace(segments=((1, (glob,)),), param_dtype="float32")
    return cfg.replace(segments=((1, (local, glob)),))


def mesh_params(torch, cfg):
    """``cfg``'s weights drawn on a CUDA generator seeded 0: the same on
    every process and card."""
    from repro_torch.models import lm

    return lm.init_lm(torch.Generator(device=DEVICE).manual_seed(0), cfg, device=DEVICE)


def mesh_train(torch, cfg, params, mesh, steps, batch, seq, accum, policy, sharded=False,
               zero1=False):
    """``steps`` train steps (MESH_STEP) of ``cfg`` from full ``params`` on
    ``mesh`` (None: one rank; ``sharded``: ``params`` are this rank's pieces
    already; ``zero1``: the sharded gradient accumulators), the launcher's
    batches (seed 0) cut to this rank's shard; returns (metrics, final
    state: this rank's pieces)."""
    from repro_torch.distributed.sharding import batch_specs, param_specs, shard
    from repro_torch.launch.steps import TrainStepConfig, init_train_state, make_train_step

    if mesh is not None and not sharded:
        params = shard(params, param_specs(params, mesh), mesh)
    state = init_train_state(cfg, params, mesh)
    del params  # the state holds them: each step's update may free the last ones
    step_fn = make_train_step(cfg, TrainStepConfig(accum=accum, total_steps=steps,
                                                   zero1_grads=zero1, **MESH_STEP),
                              policy=policy, mesh=mesh)
    metrics = []
    for i in range(steps):
        b = train_batch_of(torch, cfg, i, batch, seq)
        if mesh is not None:
            b = shard(b, batch_specs(b, mesh), mesh)
        state, m = step_fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def train_batch_of(torch, cfg, step, batch, seq):
    from repro_torch.data import make_train_batch

    return {k: torch.as_tensor(v, device=DEVICE).long()
            for k, v in make_train_batch(cfg, seq, batch, step, seed=0).items()}


class recorded_logits:
    """In the block, every logits tensor that ``lm.gather_logits`` returns
    (the serving engine's prefill and decode steps) is kept, its last
    position over the vocabulary, on the host, in ``self.rows``."""

    def __enter__(self):
        from repro_torch.models import lm

        self.lm, self.gather, self.rows = lm, lm.gather_logits, []

        def record(cfg, logits):
            out = self.gather(cfg, logits)
            self.rows.append(out[:, -1, :cfg.vocab].float().cpu())
            return out

        lm.gather_logits = record
        return self

    def __exit__(self, *exc):
        self.lm.gather_logits = self.gather


def logits_rel(torch, got, want):
    """The largest relative max error over matching logits rows, the
    padding rows' non-finite entries required to match."""
    check(len(got) == len(want), f"{len(got)} logits steps against one rank's {len(want)}")
    worst = 0.0
    for a, b in zip(got, want):
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        check(a.shape == b.shape and torch.equal(fa, fb),
              "logits rows differ in shape or in where they are finite")
        if fb.any():
            worst = max(worst, float((a[fb] - b[fb]).abs().max() / b[fb].abs().max()))
    return worst


def mesh_serve(torch, cfg, params, mesh):
    """MESH_REQUESTS seeded requests through ``ServeEngine`` under phase 4's
    class policies on ``mesh`` (None: one rank); returns their tokens and
    every logits row the engine gathered."""
    import numpy as np

    from repro_torch.core.engine import policy_from_spec
    from repro_torch.serving import ServeEngine

    engine = ServeEngine(cfg, params, n_slots=4, max_seq=MESH_MAX_SEQ,
                         policies={c: policy_from_spec(s) for c, s in KERNEL_POLICIES.items()},
                         cache_dtype=getattr(torch, cfg.param_dtype), device=DEVICE, mesh=mesh)
    engine.warmup()
    rng = np.random.RandomState(0)
    classes = sorted(KERNEL_POLICIES)
    for i in range(MESH_REQUESTS):
        prompt = rng.randint(0, cfg.vocab, (int(rng.randint(1, MESH_PROMPT + 1)),))
        engine.submit(prompt, max_new=MESH_GEN, cls=classes[i % len(classes)])
    with recorded_logits() as rec:
        engine.run()
    check_engine(engine, MESH_GEN, f"mesh {mesh!r} serving")
    tokens = [r.generated for r in sorted(engine.requests.values(), key=lambda r: r.rid)]
    return tokens, rec.rows


def leaf_rel_l2(torch, a_tree, b_tree):
    """(largest relative L2 distance over the leaves, that leaf's index)."""
    from repro_torch.optim import tree_leaves

    dists = [float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))
             for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree))]
    worst = max(range(len(dists)), key=dists.__getitem__)
    return dists[worst], worst


def mesh_collectives(torch, dm):
    """Every collective wrapper on CUDA tensors over each axis set of a
    ``dm`` mesh, against the value computed here from every rank's seeded
    input: sums within MESH_SUM_REL of the f64 sum (the group's reduction
    order), max, gathers, broadcasts and compressed_mean (the int8 payload
    summed, the scales' max) exact.  Two sizes: one below
    CARD_IPC_MIN_BYTES (gloo's own route) and one above it (the route of
    ranks sharing a card through CUDA IPC, where the ranks share one).
    Returns each sum's error."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(*dm)
    errs = {}
    for cols in (5, -(-C.CARD_IPC_MIN_BYTES // (6 * 8 * mesh.size * 4))):
        errs.update(mesh_collectives_at(torch, C, mesh, dm, cols))
    return errs


def mesh_collectives_at(torch, C, mesh, dm, cols):
    """``mesh_collectives`` on (6, 8 * ranks, ``cols``) f32 operands."""
    xs = [torch.randn(6, 8 * mesh.size, cols, generator=torch.Generator().manual_seed(r))
          for r in range(mesh.size)]
    mine = xs[mesh.rank].to(DEVICE)
    errs = {}
    for axes in (("data",), ("model",), ("data", "model")):
        S = mesh.axis_size(axes)
        if S == 1:
            continue
        name = f"{mesh_name(dm)} {'+'.join(axes)} x{cols}"
        group = next(g for g in mesh.group_ranks(axes) if mesh.rank in g)
        idx, part = mesh.axis_index(axes), xs[0].shape[1] // S
        total = sum(xs[r].double() for r in group)
        for label, got, want in (
                ("all_reduce", C.all_reduce(mine, axes, mesh=mesh), total),
                ("reduce_scatter", C.reduce_scatter(mine, axes, dim=1, mesh=mesh),
                 total.narrow(1, idx * part, part))):
            e = errs[f"{label} {name}"] = float((got.cpu().double() - want).abs().max()
                                                / total.abs().max())
            check(got.device == mine.device and e <= MESH_SUM_REL,
                  f"{label} {name}: relative error {e} against the f64 sum")
        check(torch.equal(
            C.all_reduce(mine, axes, op="max", mesh=mesh).cpu(),
            torch.stack([xs[r] for r in group]).amax(0)), f"all_reduce max {name}")
        check(torch.equal(C.all_gather(mine, axes, dim=1, mesh=mesh).cpu(),
                          torch.cat([xs[r] for r in group], dim=1)), f"all_gather {name}")
        check(torch.equal(C.broadcast(mine, axes, src=S - 1, mesh=mesh).cpu(), xs[group[-1]]),
              f"broadcast {name}")
        # quantized here on the card, as the ranks do: CUDA divides by a
        # Python scalar (the scale's / 127) through its reciprocal, so a
        # CPU scale may differ from the card's in the last bit
        qs = [C.quantize_int8(xs[r].to(DEVICE)) for r in group]
        want = C.dequantize_int8(sum(q.to(torch.int32) for q, _ in qs),
                                 torch.stack([s for _, s in qs]).amax(0),
                                 xs[0].shape, torch.float32).cpu() / S
        got = C.compressed_mean({"g": mine}, mesh, axes)["g"].cpu()
        check(torch.equal(got, want), f"compressed_mean {name}: off by "
              f"{float((got - want).abs().max())}")
    return errs


def rank_card(torch, spec, rank):
    """This rank's card: NCCL ranks take one each; gloo ranks share card 0
    and keep their blocks out of expandable segments, so that each can
    open the others' through CUDA IPC (distributed/collectives.py's route
    for ranks on one card; a segment's handle needs ``pidfd_open``, which
    the card's host may lack)."""
    if spec["backend"] == "nccl":
        torch.cuda.set_device(rank)
        return
    torch.cuda.set_device(0)
    torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def on_card_counts():
    from repro_torch.distributed.collectives import ON_CARD

    return dict(ON_CARD)


def on_card_gate(gate, phase, spec, r):
    """A gloo rank's large collectives went through CUDA IPC, none back to
    gloo for want of a handle."""
    if spec["backend"] == "gloo":
        gate(r["on_card"]["calls"] > 0 and r["on_card"]["gloo"] == 0,
             f"phase {phase} rank {r['rank']}: collectives on the card {r['on_card']}")


def mesh_rank(rank, world, store, out_dir, plan):
    """One rank of phase 16's ``plan`` (MESH_PLANS): gloo ranks share card
    0, NCCL ranks take a card each.  Writes its numbers and launch counts
    to ``out_dir/rank<rank>.json``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    spec = MESH_PLANS[plan]
    rank_card(torch, spec, rank)
    dist.init_process_group(spec["backend"], init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        row = mesh_rank_body(torch, rank, spec)
        row.update(dispatch_health(), on_card=on_card_counts())
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(row))


def mesh_rank_body(torch, rank, spec):
    """The mesh runs of one rank, its launches counted from 0 before them
    and read after them; then, on rank 0, the f32 runs again on one rank
    (outside the mesh and its counts) and their distances."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.distributed.sharding import param_specs, unshard
    from repro_torch.kernels.common import reset_launches
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm

    reset_launches()
    row = {"rank": rank, "collectives": {}}
    t0 = time.perf_counter()
    for dm in spec["collectives"]:
        row["collectives"].update(mesh_collectives(torch, dm))
    row["collectives_s"] = time.perf_counter() - t0
    policy = policy_from_spec(TRAIN_POLICIES["fused"])
    cfg = mesh_config()
    params = mesh_params(torch, cfg)
    for dm in spec["gemma3"]:
        mesh = make_local_mesh(*dm)
        t0 = time.perf_counter()
        metrics = mesh_train(torch, cfg, params, mesh, MESH_STEPS, MESH_BATCH, MESH_SEQ,
                             MESH_ACCUM, policy)[0]
        row[f"gemma3_{mesh_name(dm)}"] = {"metrics": metrics,
                                          "seconds": time.perf_counter() - t0}
        gc.collect()
        torch.cuda.empty_cache()
    del params
    smollm = get_config("smollm-135m")
    dm = spec["smollm"]
    t0 = time.perf_counter()
    metrics = mesh_train(torch, smollm, lm.init_lm(0, smollm, device=DEVICE),
                         make_local_mesh(*dm), MESH_SMOLLM_STEPS, TRAIN_BATCH, TRAIN_SEQ, 1,
                         policy)[0]
    row["smollm"] = {"mesh": mesh_name(dm), "metrics": metrics,
                     "seconds": time.perf_counter() - t0}

    runs = {}  # f32 run -> (cfg, full params, gathered leaves after the run, logits)
    # f32 at phase 8's depth: 2 layers (leaves after 2 AdamW steps follow
    # the gradients' rounding, which grows with depth)
    smollm32 = smollm.replace(segments=((2, smollm.segments[0][1]),), param_dtype="float32")
    for key, cfg32 in (("smollm_f32", smollm32), ("gemma3_f32", mesh_config(f32=True))):
        gc.collect()
        torch.cuda.empty_cache()
        dm = spec[key]
        mesh = make_local_mesh(*dm)
        params32 = mesh_params(torch, cfg32)
        t0 = time.perf_counter()
        metrics, state = mesh_train(torch, cfg32, params32, mesh, MESH_F32_STEPS, MESH_BATCH,
                                    MESH_SEQ, 1, policy)
        t1 = time.perf_counter()
        full = unshard(state["params"], param_specs(params32, mesh), mesh)
        del state
        row[key] = {"mesh": mesh_name(dm), "metrics": metrics, "train_s": t1 - t0,
                    "unshard_s": time.perf_counter() - t1}
        logits = None
        if key == "gemma3_f32":
            t1 = time.perf_counter()
            row[key]["tokens"], logits = mesh_serve(torch, cfg32, params32, mesh)
            row[key]["serve_s"] = time.perf_counter() - t1
        row[key]["seconds"] = time.perf_counter() - t0
        runs[key] = (cfg32, params32, full, logits)
    row["launches"] = launch_counts()  # the mesh runs only

    if rank == 0:  # one rank's runs of the same, outside the mesh
        for key, (cfg32, params32, full, logits) in runs.items():
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            metrics, state = mesh_train(torch, cfg32, params32, None, MESH_F32_STEPS,
                                        MESH_BATCH, MESH_SEQ, 1, policy)
            dist_, leaf = leaf_rel_l2(torch, full, state["params"])
            one = {"metrics": metrics, "worst_leaf_rel_l2": dist_, "worst_leaf": leaf}
            del state
            if logits is not None:
                one["tokens"], one_logits = mesh_serve(torch, cfg32, params32, None)
                one["logits_rel"] = logits_rel(torch, logits, one_logits)
            one["seconds"] = time.perf_counter() - t0
            row[f"{key}_one_rank"] = one
        runs.clear()
    return row


def mesh_one_rank_nccl(torch, out_dir):
    """Phase 16a: NCCL's collectives, the wrappers' NCCL bodies and the
    wrappers themselves over a one-rank group on the card."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_local_mesh

    dist.init_process_group("nccl", init_method=f"file://{out_dir / 'nccl_store'}", rank=0,
                            world_size=1)
    try:
        x = torch.randn(4099, device=DEVICE)
        for op in (lambda t: dist.all_reduce(t), lambda t: dist.broadcast(t, 0)):
            y = x.clone()
            op(y)
            check(torch.equal(y, x), "NCCL all_reduce/broadcast over one rank changed its input")
        g = torch.empty_like(x)
        dist.all_gather_into_tensor(g, x)
        dist.reduce_scatter_tensor(y, x)
        check(torch.equal(g, x) and torch.equal(y, x), "NCCL all_gather/reduce_scatter over "
              "one rank changed its input")
        world = dist.group.WORLD
        x3 = torch.randn(6, 10, 5, device=DEVICE)
        for label, got in (("all_reduce_in", collectives.all_reduce_in(x3, world)),
                           ("all_gather_in", collectives.all_gather_in(x3, world, 1, 1)),
                           ("reduce_scatter_in", collectives.reduce_scatter_in(x3, world, 1, 0,
                                                                               1)),
                           ("broadcast_in", collectives.broadcast_in(x3, world, 0))):
            check(got.device == x3.device and torch.equal(got, x3),
                  f"{label} over a one-rank NCCL group changed its input")
        mesh = make_local_mesh(1, 1)
        collectives.reset_stats()
        for fn in (lambda t: collectives.all_reduce(t, "data", mesh=mesh),
                   lambda t: collectives.all_gather(t, "model", mesh=mesh),
                   lambda t: collectives.reduce_scatter(t, "data", mesh=mesh),
                   lambda t: collectives.broadcast(t, "model", mesh=mesh)):
            check(torch.equal(fn(x), x), "a collective over a group of one changed its input")
        grads = {"a": torch.randn(64, 33, device=DEVICE), "b": torch.randn(4099, device=DEVICE)}
        got = collectives.compressed_mean(grads, mesh, ("data",))
        int8_err = {}
        for k, v in grads.items():
            err = float((got[k] - v).abs().max())
            scale = float(v.abs().max()) / 127.0
            int8_err[k] = err
            check(got[k].is_cuda and err <= 0.5 * scale + 1e-6,
                  f"compressed_mean {k}: error {err} beyond half an int8 step {0.5 * scale}")
        nccl_row = {"backend": dist.get_backend(), "int8_err": int8_err,
                    "recorded": collectives.STATS.count}
    finally:
        dist.destroy_process_group()
    return nccl_row


def phase_mesh(torch, card, plan="gloo"):
    """Phase 16: 16a the collectives on a one-rank NCCL group, then the
    ranks of ``plan`` (MESH_PLANS: 16b's two gloo ranks sharing the card,
    or four NCCL ranks a card each) against one rank's runs of the same
    weights and batches.  Returns its row and the ranks' summed launches."""
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.models import lm

    spec = MESH_PLANS[plan]
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    out_dir = ROOT / "build" / "mesh"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.iterdir():
        f.unlink()

    nccl_row = mesh_one_rank_nccl(torch, out_dir)  # 16a

    # the one-rank bf16 references, from the same weights and batches
    policy = policy_from_spec(TRAIN_POLICIES["fused"])
    cfg = mesh_config()
    t0 = time.perf_counter()
    ref = mesh_train(torch, cfg, mesh_params(torch, cfg), None, MESH_STEPS, MESH_BATCH,
                     MESH_SEQ, MESH_ACCUM, policy)[0]
    smollm = get_config("smollm-135m")
    smollm_ref = mesh_train(torch, smollm, lm.init_lm(0, smollm, device=DEVICE), None, 1,
                            TRAIN_BATCH, TRAIN_SEQ, 1, policy)[0]
    ref_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    # 16b: the plan's ranks
    t0 = time.perf_counter()
    mp.spawn(mesh_rank, args=(spec["world"], str(out_dir / "store"), str(out_dir), plan),
             nprocs=spec["world"], join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(spec["world"])]
    for r in ranks:
        check(not r["fallbacks"] and not r["quarantined"],
              f"mesh rank {r['rank']}: dispatch fell back {r['fallbacks']}, "
              f"quarantined {r['quarantined']}")
        for k in MESH_KERNELS:
            check(r["launches"][k] > 0, f"mesh rank {r['rank']} never launched {k}: "
                  f"{r['launches']}")
        on_card_gate(check, 16, spec, r)

    def same_on_every_rank(key):
        m0 = ranks[0][key]["metrics"]
        check(all(m0 == r[key]["metrics"] for r in ranks), f"{key}: the ranks' metrics differ")
        check(all(math.isfinite(m["loss"]) for m in m0), f"{key}: a non-finite loss")
        return m0

    gates = {}
    for dm in spec["gemma3"]:
        key = f"gemma3_{mesh_name(dm)}"
        m0 = same_on_every_rank(key)
        gates[key] = [{"loss_rel": rel(m["loss"], w["loss"]),
                       "grad_norm_rel": rel(m["grad_norm"], w["grad_norm"])}
                      for m, w in zip(m0, ref)]
        check(len(m0) == len(ref) and all(
            g["loss_rel"] <= LOSS_REL and g["grad_norm_rel"] <= GRAD_NORM_REL
            for g in gates[key]), f"{key}: steps {m0} vs one rank's {ref}")
    s0, w0 = same_on_every_rank("smollm")[0], smollm_ref[0]
    gates["smollm"] = {"loss_rel": rel(s0["loss"], w0["loss"]),
                       "grad_norm_rel": rel(s0["grad_norm"], w0["grad_norm"])}
    check(gates["smollm"]["loss_rel"] <= LOSS_REL
          and gates["smollm"]["grad_norm_rel"] <= GRAD_NORM_REL,
          f"smollm-135m {ranks[0]['smollm']['mesh']}: step 0 {s0} vs one rank's {w0}")
    for key in ("smollm_f32", "gemma3_f32"):
        m0, one = same_on_every_rank(key), ranks[0][f"{key}_one_rank"]
        gates[key] = {"worst_leaf_rel_l2": one["worst_leaf_rel_l2"],
                      "worst_leaf": one["worst_leaf"],
                      "loss_rel": [rel(m["loss"], w["loss"])
                                   for m, w in zip(m0, one["metrics"])]}
        check(one["worst_leaf_rel_l2"] <= EXACT_GRAD_REL_L2,
              f"{key} {ranks[0][key]['mesh']}: leaf {one['worst_leaf']} after "
              f"{MESH_F32_STEPS} steps is {one['worst_leaf_rel_l2']} from one rank's")
        check(max(gates[key]["loss_rel"]) <= EXACT_LOSS_REL,
              f"{key}: losses {m0} vs one rank's {one['metrics']}")
    one = ranks[0]["gemma3_f32_one_rank"]
    gates["gemma3_f32"]["logits_rel"] = one["logits_rel"]
    check(one["logits_rel"] <= MESH_LOGITS_REL,
          f"gemma3_f32 serving: logits {one['logits_rel']} from one rank's")
    check(all(r["gemma3_f32"]["tokens"] == one["tokens"] for r in ranks),
          f"gemma3_f32 serving: tokens {ranks[0]['gemma3_f32']['tokens']} vs one rank's "
          f"{one['tokens']}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    seconds = time.perf_counter() - t_start
    row = {"phase": "mesh", "card": card, "plan": plan, "seconds": seconds, "nccl": nccl_row,
           "one_rank_ref_s": ref_s, "spawn_s": spawn_s, "reference": ref,
           "smollm_reference": w0, "gates": gates,
           "ranks": [{k: v for k, v in r.items() if k != "launches"} for r in ranks],
           "launches_by_rank": [{k: v for k, v in r["launches"].items() if v} for r in ranks],
           "launches": launches}
    check(seconds <= MESH_SECONDS, f"phase 16 took {seconds:.0f} s, over {MESH_SECONDS} s")
    return row, launches


# -- phase 17: mesh_moe_ssm -----------------------------------------------------

# grok-1 at full width in one layer (bf16, Adafactor) at 1x2 (expert parallel,
# 4 experts a rank) and 2x1 (d_ff over data, FSDP); mamba2 at full width in
# two layers (phase 8b's cut) and zamba2 in one unit (5 Mamba blocks and the
# shared attention), bf16, AdamW, at 1x2, then their f32 twins serve; with
# --nccl-cards 4, kimi-k2 at full width in one layer at 1x4 and 2x2
MESH_MOE_BATCH, MESH_MOE_SEQ, MESH_MOE_STEPS = 2, 512, 2
MESH_MOE_SECONDS = 150
MESH_MOE_PLANS = {
    "gloo": {"backend": "gloo", "world": 2, "grok": ((1, 2), (2, 1)),
             "ssm": {"mamba2-2.7b": (1, 2), "zamba2-7b": (1, 2)}, "kimi": ()},
    "nccl": {"backend": "nccl", "world": 4, "grok": (), "ssm": {},
             "kimi": ((1, 4), (2, 2))},
}


def mesh_moe_config(arch, f32=False):
    """``arch`` at full width: grok-1 and kimi-k2 one layer, mamba2 two,
    zamba2 its first unit (5 Mamba blocks and the shared attention)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == "zamba2-7b":
        cfg = cfg.replace(segments=((1, cfg.segments[0][1]),))
    else:
        keep = 2 if arch == "mamba2-2.7b" else 1
        cfg = cfg.replace(segments=tuple((keep, blocks) for _, blocks in cfg.segments))
    return cfg.replace(param_dtype="float32") if f32 else cfg


def mesh_pieces(torch, cfg, mesh):
    """This rank's pieces of ``cfg``'s seeded weights (``mesh_params``); the
    whole tree is dropped as soon as it is cut."""
    from repro_torch.distributed.sharding import param_specs, shard

    full = mesh_params(torch, cfg)
    return shard(full, param_specs(full, mesh), mesh)


def routed_forward(torch, cfg, params, batch, mesh, policy):
    """``lm_forward``'s logits over the whole vocabulary (f32, on the host)
    and, per MoE layer, each token's chosen experts ((G, T, E) bool)."""
    from repro_torch.core.policy import use_policy
    from repro_torch.distributed.context import mesh_scope
    from repro_torch.models import lm, moe

    chosen, route = [], moe._route

    def record(logits, c, capacity):
        out = route(logits, c, capacity)
        chosen.append((out[0].sum(-1) > 0).cpu())
        return out

    moe._route = record
    try:
        with torch.no_grad(), use_policy(policy), mesh_scope(mesh):
            logits = lm.gather_logits(cfg, lm.lm_forward(params, cfg, batch))
    finally:
        moe._route = route
    return logits[..., :cfg.vocab].float().cpu(), chosen


def routed_alike_rel(torch, got, want):
    """(relative L2 distance of the logits over the tokens routed alike in
    every layer, the share of tokens routed otherwise, the share of
    ``want``'s expert choices that ``got`` does not make); ``got`` and
    ``want`` are ``routed_forward``'s, over the same tokens.  A top-k
    router makes k near-tie decisions a token, so the token share grows
    with k (kimi-k2's 8) for the same rounding; the choice share is the
    same measure for every k."""
    (lg, cg), (lw, cw) = got, want
    alike = torch.ones(lg.shape[:2], dtype=torch.bool)
    missed = chosen = 0
    for a, b in zip(cg, cw):
        alike &= (a == b).all(-1).reshape(lg.shape[:2])
        missed, chosen = missed + int((b & ~a).sum()), chosen + int(b.sum())
    dist_ = float((lg[alike] - lw[alike]).norm() / lw[alike].norm().clamp_min(1e-30))
    return dist_, 1.0 - float(alike.float().mean()), missed / max(chosen, 1)


def mesh_moe_rank(rank, world, store, out_dir, plan):
    """One rank of phase 17's ``plan`` (MESH_MOE_PLANS), as ``mesh_rank``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    spec = MESH_MOE_PLANS[plan]
    rank_card(torch, spec, rank)
    dist.init_process_group(spec["backend"], init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        row = mesh_moe_rank_body(torch, rank, spec, Path(out_dir))
        row.update(dispatch_health(), on_card=on_card_counts())
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(row))


def mesh_moe_rank_body(torch, rank, spec, out_dir):
    """The runs of one rank of phase 17, its launches counted from 0 before
    them and read after them; the one-rank references it holds its served
    logits and its forward against were saved to ``out_dir`` before the
    ranks started."""
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.distributed.sharding import batch_specs, shard
    from repro_torch.kernels.common import reset_launches
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import tree_map

    reset_launches()
    row = {"rank": rank}
    policy = policy_from_spec(TRAIN_POLICIES["fused"])
    forward_policy = policy_from_spec(KERNEL_POLICIES["bulk"])  # direct NT: matmul_nt

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30

    grok = mesh_moe_config("grok-1-314b")
    for dm in spec["grok"]:
        fresh()
        mesh = make_local_mesh(*dm)
        t0 = time.perf_counter()
        metrics = mesh_train(torch, grok, mesh_pieces(torch, grok, mesh), mesh,
                             MESH_MOE_STEPS, MESH_MOE_BATCH, MESH_MOE_SEQ, 1, policy,
                             sharded=True)[0]
        row[f"grok_{mesh_name(dm)}"] = {"metrics": metrics, "peak_gib": peak_gib(),
                                        "seconds": time.perf_counter() - t0}
    for arch, dm in spec["ssm"].items():
        fresh()
        mesh = make_local_mesh(*dm)
        cfg, cfg32 = mesh_moe_config(arch), mesh_moe_config(arch, f32=True)
        params = mesh_params(torch, cfg)
        t0 = time.perf_counter()
        metrics = mesh_train(torch, cfg, params, mesh, MESH_MOE_STEPS, MESH_MOE_BATCH,
                             MESH_MOE_SEQ, 1, policy)[0]
        params32 = tree_map(lambda t: t.float(), params)
        del params
        t1 = time.perf_counter()
        metrics32 = mesh_train(torch, cfg32, params32, mesh, MESH_MOE_STEPS, MESH_MOE_BATCH,
                               MESH_MOE_SEQ, 1, policy)[0]
        t2 = time.perf_counter()
        tokens, logits = mesh_serve(torch, cfg32, params32, mesh)
        del params32
        one = torch.load(out_dir / f"{arch}_logits.pt")
        row[arch] = {"mesh": mesh_name(dm), "metrics": metrics, "tokens": tokens,
                     "logits_rel": logits_rel(torch, logits, one), "train_s": t1 - t0,
                     "train_f32_s": t2 - t1, "serve_s": time.perf_counter() - t2,
                     "peak_gib": peak_gib()}
        row[f"{arch}_f32"] = {"metrics": metrics32}
    kimi = mesh_moe_config("kimi-k2-1t-a32b")
    for dm in spec["kimi"]:
        fresh()
        mesh = make_local_mesh(*dm)
        t0 = time.perf_counter()
        pieces = mesh_pieces(torch, kimi, mesh)
        batch = train_batch_of(torch, kimi, 0, MESH_MOE_BATCH, MESH_MOE_SEQ)
        got = routed_forward(torch, kimi, pieces, shard(batch, batch_specs(batch, mesh), mesh),
                             mesh, forward_policy)
        want_logits, want_chosen = torch.load(out_dir / "kimi_forward.pt")
        d, i = mesh.shape["data"], mesh.axis_index(("data",))
        rows, groups = want_logits.shape[0] // d, want_chosen[0].shape[0] // d
        dist_, rerouted, missed = routed_alike_rel(torch, got, (
            want_logits[i * rows:(i + 1) * rows], [c[i * groups:(i + 1) * groups]
                                                   for c in want_chosen]))
        del got
        metrics = mesh_train(torch, kimi, pieces, mesh, MESH_MOE_STEPS, MESH_MOE_BATCH,
                             MESH_MOE_SEQ, 1, policy, sharded=True)[0]
        row[f"kimi_{mesh_name(dm)}"] = {"metrics": metrics, "logits_rel_l2": dist_,
                                        "rerouted": rerouted, "choices_missed": missed,
                                        "peak_gib": peak_gib(),
                                        "seconds": time.perf_counter() - t0}
        del pieces
    row["launches"] = launch_counts()
    return row


def phase_mesh_moe_ssm(torch, card, plan="gloo"):
    """Phase 17: the one-rank references of ``plan`` (MESH_MOE_PLANS) in
    this process, then its ranks against them.  Returns its row and the
    ranks' summed launches."""
    import torch.multiprocessing as mp

    from repro_torch.core.engine import policy_from_spec
    from repro_torch.optim import tree_map

    spec = MESH_MOE_PLANS[plan]
    t_start = time.perf_counter()
    out_dir = ROOT / "build" / "mesh_moe_ssm"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.iterdir():
        f.unlink()

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()

    # the one-rank references, from the same weights and batches
    policy = policy_from_spec(TRAIN_POLICIES["fused"])
    refs = {}
    t0 = time.perf_counter()
    if spec["grok"]:
        fresh()
        grok = mesh_moe_config("grok-1-314b")
        refs["grok"] = mesh_train(torch, grok, mesh_params(torch, grok), None,
                                  MESH_MOE_STEPS, MESH_MOE_BATCH, MESH_MOE_SEQ, 1, policy)[0]
    for arch in spec["ssm"]:
        fresh()
        cfg, cfg32 = mesh_moe_config(arch), mesh_moe_config(arch, f32=True)
        params = mesh_params(torch, cfg)
        refs[arch] = mesh_train(torch, cfg, params, None, MESH_MOE_STEPS, MESH_MOE_BATCH,
                                MESH_MOE_SEQ, 1, policy)[0]
        # the f32 twin: the same weights in f32, trained and served
        params32 = tree_map(lambda t: t.float(), params)
        del params
        refs[f"{arch}_f32"] = mesh_train(torch, cfg32, params32, None, MESH_MOE_STEPS,
                                         MESH_MOE_BATCH, MESH_MOE_SEQ, 1, policy)[0]
        tokens, logits = mesh_serve(torch, cfg32, params32, None)
        refs[f"{arch}_tokens"] = tokens
        torch.save(logits, out_dir / f"{arch}_logits.pt")
        del params32
    if spec["kimi"]:
        fresh()
        kimi = mesh_moe_config("kimi-k2-1t-a32b")
        batch = train_batch_of(torch, kimi, 0, MESH_MOE_BATCH, MESH_MOE_SEQ)
        torch.save(routed_forward(torch, kimi, mesh_params(torch, kimi), batch, None,
                                  policy_from_spec(KERNEL_POLICIES["bulk"])),
                   out_dir / "kimi_forward.pt")
    ref_s = time.perf_counter() - t0
    fresh()

    t0 = time.perf_counter()
    mp.spawn(mesh_moe_rank, args=(spec["world"], str(out_dir / "store"), str(out_dir), plan),
             nprocs=spec["world"], join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(spec["world"])]
    failures = []  # every gate is read before the first failure is raised

    def gate(cond, msg):
        if not cond:
            failures.append(msg)

    for r in ranks:
        gate(not r["fallbacks"] and not r["quarantined"],
             f"phase 17 rank {r['rank']}: dispatch fell back {r['fallbacks']}, "
             f"quarantined {r['quarantined']}")
        for k in MESH_KERNELS:
            gate(r["launches"][k] > 0, f"phase 17 rank {r['rank']} never launched {k}: "
                 f"{r['launches']}")
        on_card_gate(gate, 17, spec, r)

    def same_on_every_rank(key):
        m0 = ranks[0][key]["metrics"]
        gate(all(m0 == r[key]["metrics"] for r in ranks), f"{key}: the ranks' metrics differ")
        gate(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in m0),
             f"{key}: a non-finite loss or grad norm {m0}")
        return m0

    def step_gates(key, m0, ref, gn32=None):
        """Phase 16's gates at every step; with ``gn32`` (a Mamba stack's
        f32 twin's step-0 norm), step 0's grad norm may pass phase 8b's
        f32-distance gate in their place: a random Mamba stack's bf16
        gradients leave f32 whatever runs them, one way on one rank and
        another on two."""
        g = [{"loss_rel": rel(m["loss"], w["loss"]),
              "grad_norm_rel": rel(m["grad_norm"], w["grad_norm"])} for m, w in zip(m0, ref)]
        gate(len(m0) == len(ref), f"{key}: {len(m0)} steps against one rank's {len(ref)}")
        for step, (x, m, w) in enumerate(zip(g, m0, ref)):
            gate(x["loss_rel"] <= LOSS_REL, f"{key} step {step}: loss {m} vs one rank's {w}")
            ok = x["grad_norm_rel"] <= GRAD_NORM_REL
            if step == 0 and gn32 is not None:
                x["f32_distance"] = {"mesh": rel(m["grad_norm"], gn32),
                                     "one_rank": rel(w["grad_norm"], gn32), "f32": gn32}
                limit = F32_DISTANCE_RATIO * x["f32_distance"]["one_rank"] + F32_DISTANCE_FLOOR
                ok = ok or x["f32_distance"]["mesh"] <= limit
            gate(ok, f"{key} step {step}: grad norm {m} vs one rank's {w}"
                 + (f", f32's {gn32}" if step == 0 and gn32 is not None else ""))
        return g

    def exact_gates(key, m0, ref):
        """The f32 twin against one rank's f32 run: at step 0 (the same
        weights, the gradients' reduction order alone) the loss within
        EXACT_LOSS_REL and the grad norm within EXACT_GRAD_REL_L2; later,
        phase 16's gates, since AdamW's first step moves every entry by
        up to lr whatever its gradient's size, and a near-zero gradient's
        sign is rounding (on an H100 zamba2's unit moves its step-1 loss by 4e-5)."""
        g = [{"loss_rel": rel(m["loss"], w["loss"]),
              "grad_norm_rel": rel(m["grad_norm"], w["grad_norm"])} for m, w in zip(m0, ref)]
        gate(len(m0) == len(ref) and all(
            x["loss_rel"] <= (LOSS_REL if step else EXACT_LOSS_REL)
            and x["grad_norm_rel"] <= (GRAD_NORM_REL if step else EXACT_GRAD_REL_L2)
            for step, x in enumerate(g)), f"{key}: f32 steps {m0} vs one rank's {ref}")
        return g

    gates = {}
    for dm in spec["grok"]:
        key = f"grok_{mesh_name(dm)}"
        gates[key] = step_gates(key, same_on_every_rank(key), refs["grok"])
    for arch in spec["ssm"]:
        f32_key = f"{arch}_f32"
        gates[arch] = {"steps": step_gates(arch, same_on_every_rank(arch), refs[arch],
                                           refs[f32_key][0]["grad_norm"]),
                       "f32_steps": exact_gates(f32_key, same_on_every_rank(f32_key),
                                                refs[f32_key]),
                       "logits_rel": ranks[0][arch]["logits_rel"]}
        gate(ranks[0][arch]["logits_rel"] <= MESH_LOGITS_REL,
             f"{arch} f32 serving: logits {ranks[0][arch]['logits_rel']} from one rank's")
        gate(all(r[arch]["tokens"] == refs[f"{arch}_tokens"] for r in ranks),
             f"{arch} f32 serving: tokens {ranks[0][arch]['tokens']} vs one rank's "
             f"{refs[arch + '_tokens']}")
    for dm in spec["kimi"]:
        key = f"kimi_{mesh_name(dm)}"
        same_on_every_rank(key)
        gates[key] = [{k: r[key][k] for k in ("logits_rel_l2", "rerouted", "choices_missed")}
                      for r in ranks]
        gate(all(g["logits_rel_l2"] <= LOGITS_REL_L2
                 and g["choices_missed"] <= MOE_REROUTED_SHARE for g in gates[key]),
             f"{key}: forward against one rank's {gates[key]}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    seconds = time.perf_counter() - t_start
    row = {"phase": "mesh_moe_ssm", "card": card, "plan": plan, "seconds": seconds,
           "one_rank_ref_s": ref_s, "spawn_s": spawn_s,
           "references": {k: v for k, v in refs.items() if not k.endswith("_tokens")},
           "gates": gates,
           "ranks": [{k: v for k, v in r.items() if k != "launches"} for r in ranks],
           "launches_by_rank": [{k: v for k, v in r["launches"].items() if v} for r in ranks],
           "launches": launches}
    gate(seconds <= MESH_MOE_SECONDS, f"phase 17 took {seconds:.0f} s, over {MESH_MOE_SECONDS} s")
    if failures:  # the row, for the record, before the first failure ends the run
        print(json.dumps(row), file=sys.stderr, flush=True)
    check(not failures, "; ".join(failures))
    return row, launches


# -- phase 18: mesh_optimized ----------------------------------------------------

# The JAX package's optimized variant on the same two gloo ranks and step:
# smollm-135m at full width (9 heads, 3 kv heads), depth cut to
# MESH_SP_LAYERS, with sequence-parallel attention at MIN_MODEL_DIM 1024
# (every attention projection whole: each rank projects its 512 rows of
# each 1024-row chunk and gathers the keys and values over the sequence),
# bf16, 2 x 2048, 2 AdamW steps; its f32 twin at 2 layers serving 4
# requests (prefill sequence-parallel); gemma3-4b (phase 16's two layers,
# 4 x 256, accum 2, 3 steps) with the sharded gradient accumulators, held
# against phase 16's run of the same without them.  --nccl-cards 4:
# smollm at 1x4 (9 heads over 4) and gemma3 at 4x1 (8 x 256), its run
# without zero1_grads made here.
MESH_SP_LAYERS = 10
MESH_SP_BATCH, MESH_SP_SEQ, MESH_SP_STEPS = 2, 2048, 2
MESH_SP_MIN_DIM = 1024
MESH_OPT_SECONDS = 120
MESH_OPT_PLANS = {
    "gloo": {"backend": "gloo", "world": 2, "smollm": (1, 2), "gemma3": (2, 1),
             "gemma3_batch": MESH_BATCH, "gemma3_plain": False},
    # 4x1 at accum 2 needs two sequences a rank
    "nccl": {"backend": "nccl", "world": 4, "smollm": (1, 4), "gemma3": (4, 1),
             "gemma3_batch": 2 * MESH_BATCH, "gemma3_plain": True},
}


def sp_config(f32=False):
    """smollm-135m at full width with sequence-parallel attention:
    MESH_SP_LAYERS layers in bf16, or 2 in f32."""
    from repro_torch.configs import get_config

    cfg = get_config("smollm-135m")
    layers = 2 if f32 else MESH_SP_LAYERS
    cfg = cfg.replace(segments=((layers, cfg.segments[0][1]),), sp_attention=True)
    return cfg.replace(param_dtype="float32") if f32 else cfg


def sp_offset_check(torch, cfg, mesh):
    """This rank's sequence-parallel attention call of the second query
    chunk -- its ``chunk/M`` rows of every head at ``q_start = chunk +
    r chunk/M``, against the chunk's whole key slab from position 0 --
    through the kernel and through its plain version, on seeded bf16
    inputs; outside the counted runs."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.attention_fused import MaskParams, attention_fused

    chunk, m = cfg.attn_chunk, mesh.shape["model"]
    rows = chunk // m
    r = mesh.axis_index("model")
    g, dh, n = MESH_SP_BATCH * cfg.n_kv, cfg.d_head, 2 * chunk
    gen = torch.Generator(device=DEVICE).manual_seed(18)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)

    q = randn(g, (cfg.n_heads // cfg.n_kv) * rows, dh) * dh ** -0.5
    k, v = randn(g, n, dh), randn(g, n, dh)
    lengths = torch.full((g,), n, dtype=torch.int32, device=DEVICE)
    mask = MaskParams(causal=True, q_start=chunk + r * rows, k_start=0, q_seg=rows)
    out = attention_fused(q, k, v, lengths, mask=mask)
    want = ref.attention_fused(q, k, v, lengths, mask)
    torch.cuda.synchronize()
    rtol = 2e-2  # phase 3's bf16 attention tolerance
    atol = rtol * float(want.float().pow(2).mean().sqrt())
    err, ok = compare(out, want, rtol, atol)
    return {"q_start": mask.q_start, "rows": rows, "g": g, "n": n, "variant":
            attention_label(torch, q, k, v), "max_abs_err": err, "atol": atol, "ok": ok}


def mesh_opt_rank(rank, world, store, out_dir, plan):
    """One rank of phase 18's ``plan`` (MESH_OPT_PLANS), as ``mesh_rank``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    spec = MESH_OPT_PLANS[plan]
    rank_card(torch, spec, rank)
    dist.init_process_group(spec["backend"], init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        row = mesh_opt_rank_body(torch, rank, spec, Path(out_dir))
        row.update(dispatch_health(), on_card=on_card_counts())
    finally:
        dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(row))


def mesh_opt_rank_body(torch, rank, spec, out_dir):
    """The runs of one rank of phase 18, its launches counted from 0 before
    them and read after them; then, outside the counts, the kernel at this
    rank's sequence-parallel offset.  The f32 twin's one-rank logits were
    saved to ``out_dir`` before the ranks started."""
    from repro_torch.core.engine import policy_from_spec
    from repro_torch.distributed.sharding import min_model_dim
    from repro_torch.kernels.common import reset_launches
    from repro_torch.launch import steps
    from repro_torch.launch.accounting import tree_bytes
    from repro_torch.launch.mesh import make_local_mesh

    reset_launches()
    row = {"rank": rank}
    policy = policy_from_spec(TRAIN_POLICIES["fused"])

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()

    sp_mesh = make_local_mesh(*spec["smollm"])
    with min_model_dim(MESH_SP_MIN_DIM):
        cfg = sp_config()
        t0 = time.perf_counter()
        metrics = mesh_train(torch, cfg, mesh_params(torch, cfg), sp_mesh, MESH_SP_STEPS,
                             MESH_SP_BATCH, MESH_SP_SEQ, 1, policy)[0]
        row["smollm_sp"] = {"mesh": mesh_name(spec["smollm"]), "metrics": metrics,
                            "seconds": time.perf_counter() - t0}
        fresh()
        cfg32 = sp_config(f32=True)
        t0 = time.perf_counter()
        tokens, logits = mesh_serve(torch, cfg32, mesh_params(torch, cfg32), sp_mesh)
        row["smollm_f32"] = {"tokens": tokens, "seconds": time.perf_counter() - t0,
                             "logits_rel": logits_rel(
                                 torch, logits, torch.load(out_dir / "smollm_f32_logits.pt"))}
    fresh()

    # gemma3-4b with zero1_grads: the accumulators the step makes, measured as made
    made, accumulators = [], steps.grad_accumulators

    def recorded(params, p_specs, mesh, zero1_grads):
        acc = accumulators(params, p_specs, mesh, zero1_grads)
        made.append(tree_bytes(acc))
        return acc

    cfg = mesh_config()
    mesh = make_local_mesh(*spec["gemma3"])
    runs = (True, False) if spec["gemma3_plain"] else (True,)
    steps.grad_accumulators = recorded
    try:
        for zero1 in runs:
            fresh()
            made.clear()
            t0 = time.perf_counter()
            metrics = mesh_train(torch, cfg, mesh_params(torch, cfg), mesh, MESH_STEPS,
                                 spec["gemma3_batch"], MESH_SEQ, MESH_ACCUM, policy,
                                 zero1=zero1)[0]
            row["gemma3_zero1" if zero1 else "gemma3_plain"] = {
                "mesh": mesh_name(spec["gemma3"]), "metrics": metrics,
                "accumulator_bytes": made[0], "seconds": time.perf_counter() - t0}
    finally:
        steps.grad_accumulators = accumulators
    row["accumulators"] = accumulator_bytes(torch, cfg, mesh)
    row["launches"] = launch_counts()  # the mesh runs only
    row["offset_check"] = sp_offset_check(torch, sp_config(), sp_mesh)
    return row


def accumulator_bytes(torch, cfg, mesh):
    """The f32 accumulator bytes of this rank's pieces of ``cfg`` on
    ``mesh`` without and with zero1_grads, and the bytes of the leaves that
    have no ZeRO-1 dim (which it accumulates whole), on meta tensors."""
    from repro_torch.distributed.sharding import map_with_path, param_specs, shard, zero1_dim
    from repro_torch.launch.accounting import tree_bytes
    from repro_torch.launch.steps import grad_accumulators
    from repro_torch.models import lm

    full = lm.init_lm(0, cfg, device="meta")
    p_specs = param_specs(full, mesh)
    pieces = shard(full, p_specs, mesh)
    no_dim = []
    map_with_path(lambda _, t, s: no_dim.append(t.numel() * 4)
                  if zero1_dim(s, t.shape, mesh) is None else None, pieces, p_specs)
    return {"without": tree_bytes(grad_accumulators(pieces, p_specs, mesh, False)),
            "with": tree_bytes(grad_accumulators(pieces, p_specs, mesh, True)),
            "no_zero1_dim": sum(no_dim)}


def phase_mesh_optimized(torch, card, mesh_row, plan="gloo"):
    """Phase 18: the one-rank references of ``plan`` (MESH_OPT_PLANS) in
    this process, then its ranks against them; gemma3's run without
    zero1_grads is phase 16's (``mesh_row``) on two gloo ranks, and the
    ranks' own on four NCCL cards.  Returns its row and the ranks' summed
    launches."""
    import torch.multiprocessing as mp

    from repro_torch.core.engine import policy_from_spec

    spec = MESH_OPT_PLANS[plan]
    t_start = time.perf_counter()
    out_dir = ROOT / "build" / "mesh_optimized"
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in out_dir.iterdir():
        f.unlink()
    gc.collect()
    torch.cuda.empty_cache()

    # the one-rank references, from the same weights and batches (no mesh:
    # sp_attention changes nothing there)
    policy = policy_from_spec(TRAIN_POLICIES["fused"])
    t0 = time.perf_counter()
    cfg = sp_config()
    sp_ref = mesh_train(torch, cfg, mesh_params(torch, cfg), None, MESH_SP_STEPS,
                        MESH_SP_BATCH, MESH_SP_SEQ, 1, policy)[0]
    cfg32 = sp_config(f32=True)
    ref_tokens, ref_logits = mesh_serve(torch, cfg32, mesh_params(torch, cfg32), None)
    torch.save(ref_logits, out_dir / "smollm_f32_logits.pt")
    ref_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mp.spawn(mesh_opt_rank, args=(spec["world"], str(out_dir / "store"), str(out_dir), plan),
             nprocs=spec["world"], join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(spec["world"])]
    failures = []  # every gate is read before the first failure is raised

    def gate(cond, msg):
        if not cond:
            failures.append(msg)

    for r in ranks:
        gate(not r["fallbacks"] and not r["quarantined"],
             f"phase 18 rank {r['rank']}: dispatch fell back {r['fallbacks']}, "
             f"quarantined {r['quarantined']}")
        for k in MESH_KERNELS:
            gate(r["launches"][k] > 0, f"phase 18 rank {r['rank']} never launched {k}: "
                 f"{r['launches']}")
        on_card_gate(gate, 18, spec, r)
        gate(r["offset_check"]["ok"], f"phase 18 rank {r['rank']}: attention_fused at "
             f"q_start {r['offset_check']['q_start']} against its plain version "
             f"{r['offset_check']}")

    def same_on_every_rank(key):
        m0 = ranks[0][key]["metrics"]
        gate(all(m0 == r[key]["metrics"] for r in ranks), f"{key}: the ranks' metrics differ")
        gate(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) for m in m0),
             f"{key}: a non-finite loss or grad norm {m0}")
        return m0

    def step_gates(key, m0, ref):
        """Phase 16's gates at every step."""
        g = [{"loss_rel": rel(m["loss"], w["loss"]),
              "grad_norm_rel": rel(m["grad_norm"], w["grad_norm"])} for m, w in zip(m0, ref)]
        gate(len(m0) == len(ref) and all(x["loss_rel"] <= LOSS_REL
                                         and x["grad_norm_rel"] <= GRAD_NORM_REL for x in g),
             f"{key}: steps {m0} vs {ref}")
        return g

    gates = {"smollm_sp": step_gates("smollm_sp", same_on_every_rank("smollm_sp"), sp_ref)}
    f32 = ranks[0]["smollm_f32"]
    gates["smollm_f32"] = {"logits_rel": [r["smollm_f32"]["logits_rel"] for r in ranks]}
    gate(all(r["smollm_f32"]["logits_rel"] <= MESH_LOGITS_REL for r in ranks),
         f"smollm f32 sequence-parallel serving: logits {gates['smollm_f32']} from one rank's")
    gate(all(r["smollm_f32"]["tokens"] == ref_tokens for r in ranks),
         f"smollm f32 sequence-parallel serving: tokens {f32['tokens']} vs one rank's "
         f"{ref_tokens}")
    if spec["gemma3_plain"]:
        plain = same_on_every_rank("gemma3_plain")
    else:
        plain = mesh_row["ranks"][0][f"gemma3_{mesh_name(spec['gemma3'])}"]["metrics"]
    gates["gemma3_zero1"] = step_gates("gemma3_zero1", same_on_every_rank("gemma3_zero1"), plain)
    for r in ranks:
        acc, made = r["accumulators"], r["gemma3_zero1"]["accumulator_bytes"]
        d = spec["gemma3"][0]
        want = (acc["without"] - acc["no_zero1_dim"]) // d + acc["no_zero1_dim"]
        gate(made == acc["with"] == want and acc["with"] < acc["without"],
             f"phase 18 rank {r['rank']}: zero1 accumulators {made} bytes (computed "
             f"{acc['with']}), want {want}: 1/{d} of {acc['without']} but "
             f"{acc['no_zero1_dim']} kept whole")
        if spec["gemma3_plain"]:
            gate(r["gemma3_plain"]["accumulator_bytes"] == acc["without"],
                 f"phase 18 rank {r['rank']}: accumulators without zero1 "
                 f"{r['gemma3_plain']['accumulator_bytes']}, computed {acc['without']}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    seconds = time.perf_counter() - t_start
    row = {"phase": "mesh_optimized", "card": card, "plan": plan, "seconds": seconds,
           "one_rank_ref_s": ref_s, "spawn_s": spawn_s, "sp_reference": sp_ref,
           "gemma3_reference": plain, "gates": gates,
           "ranks": [{k: v for k, v in r.items() if k != "launches"} for r in ranks],
           "launches_by_rank": [{k: v for k, v in r["launches"].items() if v} for r in ranks],
           "launches": launches}
    gate(seconds <= MESH_OPT_SECONDS, f"phase 18 took {seconds:.0f} s, over "
         f"{MESH_OPT_SECONDS} s")
    if failures:  # the row, for the record, before the first failure ends the run
        print(json.dumps(row), file=sys.stderr, flush=True)
    check(not failures, "; ".join(failures))
    return row, launches


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on the card (one card: every "
                                 "phase).")
    ap.add_argument("--mesh-alone", action="store_true",
                    help="run phases 16, 17 and 18 alone: two gloo ranks sharing the card")
    ap.add_argument("--nccl-cards", type=int, choices=(MESH_PLANS["nccl"]["world"],),
                    help="run phases 16, 17 and 18 alone, with NCCL ranks a card each "
                         "(phase 16 on the 2x2 mesh, 17 kimi-k2 at 1x4 and 2x2, 18 "
                         "smollm-135m at 1x4 and gemma3-4b at 4x1)")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke.py: src/repro_torch not found beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # phase 8b holds kimi-k2's 72 GiB of f32 weights on an 80 GB card:
    # segments that grow in place keep the allocator's fragments usable
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card (torch.cuda.is_available() is False); "
              "this script measures the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    out_dir = ROOT / "build"  # git-ignored; the full results land here
    out_dir.mkdir(exist_ok=True)
    results = {}
    t_start = time.perf_counter()

    # 1. device
    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit_phase({"phase": "device", "nvidia_smi": card, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = []  # "<library> <kernel>: Used N registers, ..." per compiled kernel
    for src in _build.SOURCES:
        log = _build.library_path(src).with_suffix(".log")
        kernel = "?"
        for ln in log.read_text().splitlines() if log.exists() else ():
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1] if "'" in ln else ln.strip()
            elif "Used" in ln:
                ptxas.append(f"{src} {kernel}: {ln.split(':', 1)[-1].strip()}")
    emit_phase({"phase": "build", "seconds": build_s, "sources": list(_build.SOURCES),
          "ptxas": ptxas})

    if args.mesh_alone or args.nccl_cards:
        check(torch.cuda.device_count() >= (args.nccl_cards or 1),
              f"--nccl-cards {args.nccl_cards}: {torch.cuda.device_count()} cards present")
        plan = "nccl" if args.nccl_cards else "gloo"
        mesh_row, _ = phase_mesh(torch, card, plan=plan)
        emit_phase(mesh_row)
        moe_mesh_row, _ = phase_mesh_moe_ssm(torch, card, plan=plan)
        emit_phase(moe_mesh_row)
        opt_row, _ = phase_mesh_optimized(torch, card, mesh_row, plan=plan)
        emit_phase(opt_row)
        (out_dir / f"chip_smoke_mesh_{plan}.json").write_text(json.dumps(
            {"mesh": mesh_row, "mesh_moe_ssm": moe_mesh_row, "mesh_optimized": opt_row},
            indent=1))
        check("jax" not in sys.modules, "jax was imported")
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0

    # 3. kernels vs plain
    t0 = time.perf_counter()
    rows = []
    for kname, label, dt, inp in kernel_cases(torch):
        r = run_case(torch, kname, inp, dt)
        r.update(kernel=kname, case=label, dtype=str(dt).split(".")[-1])
        rows.append(r)
        check(r["ok"], f"{kname} {label} {r['dtype']}: max_abs_err {r['err']} "
                       f"beyond atol {r['atol']} / rtol {r['rtol']}")
    emit_phase({"phase": "kernels", "card": card, "cases": rows, "seconds": time.perf_counter() - t0})
    results["kernel_cases"] = rows

    # 3a. sanitize: every plan on poisoned memory, no leak
    sanitize_row = emit_phase(phase_sanitize(torch, card))
    results["sanitize"] = sanitize_row

    # 3b. gridspec: the declared grids proven, and run as declared
    results["gridspec"] = emit_phase(phase_gridspec(torch, card))

    # 4. serve smollm-135m, full config, bf16
    reset_launches()
    eng_k = serve(kernel_policy_args())
    launches = launch_counts()
    check_engine(eng_k, 16, "kernel policies")
    for kname in SERVE_KERNELS:
        check(launches[kname] > 0, f"kernel {kname} was not launched on the serve path")
    reset_launches()
    eng_x = serve(["--policy", CUBLAS_POLICY])
    check_engine(eng_x, 16, "cuBLAS policy")
    check(not any(LAUNCHES.values()), f"cuBLAS policy launched kernels: {LAUNCHES}")

    serve_row = {"phase": "serve", "card": card, "arch": "smollm-135m", "dtype": "bfloat16",
                 "launches": launches, **serve_gates_and_metrics(torch, eng_k, eng_x)}
    emit_phase(serve_row)
    results["serve"] = serve_row
    del eng_k, eng_x

    # 5. exact: f32, full width, 2 layers -> identical greedy tokens
    f32 = ["--layers", "2", "--dtype", "float32"]
    reset_launches()
    e_k = serve(f32 + kernel_policy_args())
    exact_launches = launch_counts()
    check(exact_launches["attention_flash_f32_dh64"] > 0,
          f"f32 serving never launched the f32 flash kernel: {exact_launches}")
    e_x = serve(f32 + ["--policy", CUBLAS_POLICY])
    check_engine(e_k, 16, "f32 kernel policies")
    check_engine(e_x, 16, "f32 cuBLAS policy")
    check_identical_tokens(e_k, e_x, "f32")
    emit_phase({"phase": "exact", "layers": 2, "dtype": "float32",
                "requests": len(e_k.requests), "identical": True})
    del e_k, e_x

    # 5a. legacy: the fixed-batch prefill + greedy decode path
    legacy_row, legacy_launches = phase_legacy(torch, card)
    emit_phase(legacy_row)
    results["legacy"] = legacy_row

    # 6. imports
    check("jax" not in sys.modules, "jax was imported")

    # 7. train smollm-135m, full config, bf16
    train_row, train_launches = phase_train(torch, card)
    emit_phase(train_row)
    results["train"] = train_row

    # 7a. remat="dots" against remat="full" under the fused policy
    dots_row, dots_launches = phase_remat_dots(torch, card, train_row)
    emit_phase(dots_row)
    results["remat_dots"] = dots_row

    # 8. train_exact: f32, full width, 2 layers
    exact_row, train_exact_launches = phase_train_exact(torch)
    emit_phase(exact_row)
    results["train_exact"] = exact_row

    # 8a. arch: gemma3-4b served at full config; the other four trained
    arch_row, arch_serve_launches, arch_train_launches, arch_exact_launches = phase_arch(
        torch, card)
    emit_phase(arch_row)
    results["arch"] = arch_row

    # 8b. moe_ssm: mamba2 and zamba2 served at full config, grok-1 and kimi-k2
    # at full width; three of them trained
    moe_row, moe_serve_launches, moe_train_launches, moe_exact_launches = phase_moe_ssm(
        torch, card)
    emit_phase(moe_row)
    results["moe_ssm"] = moe_row

    # 9. selector: measure, train, save, load, select
    selector_row, artifacts, selector_launches = phase_selector(torch, card, out_dir)
    emit_phase(selector_row)
    results["selector"] = selector_row

    # 10. fcn: the paper's Table X, CaffeNT against CaffeMTNN
    fcn_row, fcn_launches = phase_fcn(torch, card, artifacts["float32"])
    emit_phase(fcn_row)
    results["fcn"] = fcn_row

    # 11. model_policy: the default selector serving, the card's selector training
    mp_row, mp_serve_launches, mp_train_launches = phase_model_policy(
        torch, card, artifacts["bfloat16"], train_row)
    emit_phase(mp_row)
    results["model_policy"] = mp_row

    # 12. tiles: every config reaches its kernel; tuned tables; autotune warm
    tiles_row, tiles_launches = phase_tiles(torch, card, out_dir)
    emit_phase(tiles_row)
    results["tiles"] = tiles_row

    # 12a. artifacts: phases 9 and 12's caches and selectors against the schemas
    artifacts_row = emit_phase(phase_artifacts(card, out_dir))
    results["artifacts"] = artifacts_row

    # 13. bench: the paper's figures and tables on the card, the kernel sweep
    bench_row, bench_launches = phase_bench(torch, card, out_dir)
    emit_phase({k: v for k, v in bench_row.items() if not k.startswith("results")})
    results["bench"] = bench_row

    # 14. serve_load: the seeded serving traffic at full config
    load_row, load_launches = phase_serve_load(torch, card, out_dir)
    emit_phase(load_row)
    results["serve_load"] = load_row

    # 15. faults: the drill, and serving with kernel arms fault-injected
    faults_row, faults_launches = phase_faults(torch, card)
    emit_phase(faults_row)
    results["faults"] = faults_row

    # 16. mesh: collectives on a one-rank NCCL group; two gloo ranks training
    # and serving on the card against one rank
    mesh_row, mesh_launches = phase_mesh(torch, card)
    emit_phase(mesh_row)
    results["mesh"] = mesh_row

    # 17. mesh_moe_ssm: grok-1, mamba2 and zamba2 on two gloo ranks on the card
    moe_mesh_row, moe_mesh_launches = phase_mesh_moe_ssm(torch, card)
    emit_phase(moe_mesh_row)
    results["mesh_moe_ssm"] = moe_mesh_row

    # 18. mesh_optimized: sequence-parallel attention and zero1_grads on two
    # gloo ranks on the card
    opt_row, opt_launches = phase_mesh_optimized(torch, card, mesh_row)
    emit_phase(opt_row)
    results["mesh_optimized"] = opt_row
    check("jax" not in sys.modules, "jax was imported")

    # the contract line: one row per kernel at a main-path shape; launches
    # are the sum over the paths: the serve path's kernel-policy run and its
    # f32 run (phase 5), the two kernel-policy training runs and their f32
    # runs (phase 8), gemma3's kernel-policy serve run, its f32 run and the
    # four architectures' fused-policy training runs, phase 8b's four
    # kernel-policy serve runs, their f32 runs and three fused-policy
    # training runs, the selector's
    # measurements, the FCN runs, the runs under the learned policies, phase
    # 12's tuned measurement and autotune serving run, phase 13's
    # benchmarks, phase 5a's two kernel-policy legacy runs, phase 7a's
    # remat="dots" steps, phase 14's serving load, phase 15's drill and
    # fault-injected serving run, phase 16b's two ranks, phase 17's two
    # ranks and phase 18's two ranks (each counted from 0).  The wide-head flash instances and
    # gemm_f32's routes have rows of their own: the flash kernel at each
    # wide head (gemma3's, zamba2's and h2o-danube's prefill) and gemm_f32's
    # two routes (grok-1's router at decode; stage 2 of the f32 TNN arm at a
    # grid cube), their launches counted apart (launch_counts) and their
    # error the largest of their route's cases.
    contract = {  # row: (kernel, case, dtype)
        "matmul_nt": ("matmul_nt", "(8,576)x(49152,576)^T", "bfloat16"),
        "matmul_nn": ("matmul_nn", "(8,576)x(576,49152)", "bfloat16"),
        "transpose": ("transpose", "(49152,576)", "bfloat16"),
        "attention_fused": ("attention_fused", "decode g=12 m=3 n=512 ragged", "bfloat16"),
        "matmul_tnn_fused": ("matmul_tnn_fused", "(2048,576)x(49152,576)^T", "bfloat16"),
        "matmul_bnt": ("matmul_bnt", "(24,768,64)x(24,256,64)^T", "float32"),
        "matmul_bnn": ("matmul_bnn", "(24,256,768)x(24,768,64)", "float32"),
        "attention_flash_dh256": ("attention_fused", GEMMA3_PREFILL_CASE, "bfloat16"),
        "attention_flash_dh112": ("attention_fused", ZAMBA2_PREFILL_CASE + " dh=112", "bfloat16"),
        "attention_flash_dh120": ("attention_fused", H2O_PREFILL_CASE, "bfloat16"),
        "matmul_f32_skinny": ("matmul_nt", "(4,6144)x(8,6144)^T", "float32"),
        "matmul_f32_tiled": ("matmul_nn", "(2048,2048)x(2048,2048)", "float32"),
        "tnn_fused_f32_skinny": ("matmul_tnn_fused", "(1024,6144)x(8,6144)^T", "float32"),
        "tnn_fused_f32_tiled": ("matmul_tnn_fused", "(2048,576)x(49152,576)^T", "float32"),
        "attention_flash_f32_dh64": ("attention_fused", TRAIN_ATTN_CASE, "float32"),
        "attention_flash_f32_dh128": ("attention_fused", ZAMBA2_PREFILL_CASE + " dh=112",
                                      "float32"),
        "attention_flash_f32_dh256": ("attention_fused", GEMMA3_PREFILL_CASE, "float32"),
    }
    routes = {  # row: whether a case ran its route
        **{f"attention_flash_dh{dh}": (lambda r, dh=dh: r["variant"] == "flash_mma"
                                       and r["dh"] == dh) for dh in WIDE_FLASH_DHS},
        **{f"matmul_f32_{route}": (lambda r, route=route: r["variant"].startswith(
            f"{route} f32")) for route in F32_ROUTES},
        **{f"tnn_fused_f32_{route}": (lambda r, route=route: r["kernel"] == "matmul_tnn_fused"
                                      and r["variant"].startswith(f"f32_{route}"))
           for route in F32_ROUTES},
        **{f"attention_flash_f32_dh{w}": (lambda r, dhs=dhs: r["variant"].startswith("flash_f32")
                                          and r["dh"] in dhs)
           for w, dhs in FLASH_F32_INSTANCES.items()},
    }
    kernels = []
    for cname, (kname, case, dtype) in contract.items():
        row = next(r for r in rows if r["kernel"] == kname and r["case"] == case
                   and r["dtype"] == dtype)
        source, replaces = KERNEL_SOURCES[kname]
        if cname.startswith("matmul_f32"):
            source = "src/repro_torch/csrc/matmul.cu"
        on_route = routes.get(cname, lambda r: True)
        check(on_route(row), f"{cname}: its case {case} ran {row['variant']}")
        by_path = {"serve": launches.get(cname, 0),
                   "exact": exact_launches[cname],
                   "train": sum(train_launches[s][cname] for s in TRAIN_POLICIES.values()),
                   "train_exact": train_exact_launches[cname],
                   "arch_serve": arch_serve_launches[cname],
                   "arch_exact": arch_exact_launches[cname],
                   "arch_train": arch_train_launches[cname],
                   "moe_ssm_serve": moe_serve_launches[cname],
                   "moe_ssm_exact": moe_exact_launches[cname],
                   "moe_ssm_train": moe_train_launches[cname],
                   "selector_measure": selector_launches[cname],
                   "fcn": fcn_launches[cname],
                   "model_policy_serve": mp_serve_launches[cname],
                   "model_policy_train": mp_train_launches[cname],
                   "tiles": tiles_launches[cname],
                   "bench": bench_launches[cname],
                   "legacy": legacy_launches[cname],
                   "remat_dots": dots_launches[cname],
                   "serve_load": load_launches[cname],
                   "faults": faults_launches[cname],
                   "mesh": mesh_launches[cname],
                   "mesh_moe_ssm": moe_mesh_launches[cname],
                   "mesh_optimized": opt_launches[cname]}
        if cname in routes:
            check(sum(by_path.values()) > 0, f"{cname}: no main path launched it")
        kernels.append({
            "name": cname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["err"] for r in rows if r["kernel"] == kname and on_route(r)),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "device_ms": row["device_ms"], "queued_ms": row["queued_ms"],
            "library_queued_ms": row["library_queued_ms"], "shape": case,
            "dtype": dtype, "variant": row["variant"], "f64_err": row["f64_err"],
            "replaced_ms": row["replaced_ms"], "replaced_device_ms": row["replaced_device_ms"],
        })
    results["kernels"] = kernels
    results["card"] = card
    results["seconds"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
