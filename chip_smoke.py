#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases (each prints one JSON line; any failed check exits non-zero):

  1. device   the card's name and power limit, torch and CUDA versions
  2. build    nvcc builds every kernel from src/repro_torch/csrc
  3. kernels  each CUDA kernel against its plain PyTorch version at the
              serving shapes, in f32 and bf16, with CUDA-event times of the
              kernel, the plain version and one library call (a yardstick
              only), and the datasheet bound of the same work
  4. serve    repro_torch.launch.serve.main on smollm-135m at full config
              in bf16: class interactive under fixed:nt=PALLAS_TNN,attn=fused,
              class bulk under fixed:nt=PALLAS_NT,attn=fused, then the same
              requests under fixed:XLA_NT (cuBLAS, unfused attention);
              every request must finish, no step may crash, every kernel
              must have launched, and first-token logits must agree with
              the cuBLAS run and sit no further from an f32 run of the
              same weights than twice the cuBLAS run does; a profiled
              decode step per policy gives the device's busy share
  5. exact    f32 at full width and 2 layers: greedy tokens of both kernel
              policies identical to fixed:XLA_NT
  6. imports  no jax in the process

The full results, every case included, go to ``build/chip_smoke.json``.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit as nvidia-smi gives them.  Without a card, or
outside a checkout, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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
    "matmul_nn": ("src/repro_torch/csrc/matmul.cu", "src/repro/kernels/matmul_nn.py:77"),
    "matmul_nt": ("src/repro_torch/csrc/matmul.cu", "src/repro/kernels/matmul_nt.py:81"),
    "attention_fused": ("src/repro_torch/csrc/attention_fused.cu",
                        "src/repro/kernels/attention_fused.py:338"),
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


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
        # decode LM head / MLP up at batch 8, and a 64-token prefill
        for m, n, k in ((8, 49152, 576), (8, 1536, 576), (64, 1536, 576), (64, 576, 1536)):
            a, w = randn(m, k, dtype=dt), randn(n, k, dtype=dt)  # unscaled: see tol()
            cases.append(("matmul_nt", f"({m},{k})x({n},{k})^T", dt, {"a": a, "b": w}))
            cases.append(("matmul_nn", f"({m},{k})x({k},{n})", dt,
                          {"a": a, "b": w.t().contiguous()}))
        lens = torch.randint(1, 513, (12,), generator=gen, device="cuda", dtype=torch.int32)
        geoms = [
            ("decode g=12 m=3 n=512 ragged", 12, 3, 512, lens, MaskParams()),
            ("prefill causal g=3 m=192 n=64 q_seg=64", 3, 192, 64, None,
             MaskParams(causal=True, q_seg=64)),
            ("window+prefix+softcap g=3 m=192 n=256 q_seg=64", 3, 192, 256, None,
             MaskParams(causal=True, window=48, prefix_len=16, q_start=192,
                        q_seg=64, softcap=30.0)),
        ]
        for label, g, m, n, lengths, mask in geoms:
            q = randn(g, m, 64, dtype=dt) * 0.125
            cases.append(("attention_fused", label, dt, {
                "q": q, "k": randn(g, n, 64, dtype=dt), "v": randn(g, n, 64, dtype=dt),
                "lengths": lengths if lengths is not None else
                torch.full((g,), n, dtype=torch.int32, device="cuda"),
                "mask": mask,
            }))
    return cases


def run_case(torch, name, inp, dt):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.attention_fused import attention_fused
    from repro_torch.kernels.ops import matmul_nn, matmul_nt, transpose

    dname = str(dt).split(".")[-1]
    ds = torch.finfo(dt).bits // 8
    if name == "transpose":
        b = inp["b"]
        kern, plain, lib = (lambda: transpose(b)), (lambda: ref.transpose(b)), (lambda: b.t().contiguous())
        rtol, atol = 0.0, 0.0
        n, k = b.shape
        b_ms, by = bound(2 * n * k * ds, 0.0, dname)
    elif name in ("matmul_nn", "matmul_nt"):
        a, b = inp["a"], inp["b"]
        if name == "matmul_nt":
            kern, plain, lib = (lambda: matmul_nt(a, b)), (lambda: ref.matmul_nt(a, b)), \
                (lambda: torch.matmul(a, b.t()))
            n = b.shape[0]
        else:
            kern, plain, lib = (lambda: matmul_nn(a, b)), (lambda: ref.matmul_nn(a, b)), \
                (lambda: torch.matmul(a, b))
            n = b.shape[1]
        m, k = a.shape
        rtol, atol = tol(dname, k)
        b_ms, by = bound((m * k + k * n + m * n) * ds, 2.0 * m * n * k, dname)
    else:
        q, k, v, lengths, mask = (inp[x] for x in ("q", "k", "v", "lengths", "mask"))
        g, m, dh = q.shape
        n = k.shape[1]
        kern = lambda: attention_fused(q, k, v, lengths, mask=mask)  # noqa: E731
        plain = lambda: ref.attention_fused(q, k, v, lengths, mask)  # noqa: E731
        vis = ref.attention_visibility(mask, lengths, m, n)
        lib = None
        if not mask.softcap:  # SDPA has no softcap: no library call computes it
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
    return {
        "err": err, "ok": ok, "rtol": rtol, "atol": atol,
        "ms": time_ms(kern), "plain_ms": time_ms(plain),
        "library_ms": time_ms(lib) if lib is not None else None,
        "bound_ms": b_ms, "bound_by": by,
    }


# -- phase 4/5 helpers --------------------------------------------------------


def serve(extra):
    from repro_torch.launch import serve as serve_mod

    return serve_mod.main(ARCH_ARGS + extra)


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
    """Last-position logits of ``prompt`` (bucket-padded, as the engine
    prefills it) under one policy; ``dtype`` recasts the engine's
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
    padded = torch.zeros((1, engine.buckets.bucket_len(P)), dtype=torch.long, device="cuda")
    padded[0, :P] = torch.as_tensor(prompt, device="cuda")
    with use_policy(policy_from_spec(policy_spec)):
        logits, _ = lm.lm_prefill(params, engine.cfg, {"tokens": padded},
                                  max_seq=engine.max_seq, true_len=P)
    return logits[0, -1, : engine.cfg.vocab].float()


def decode_profile(torch, engine, cls):
    """One bucketed decode step of ``cls`` (largest bucket, all rows on the
    null slot): host wall time, and the device time of its kernels from
    torch.profiler, so device busy share = device / wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    bb = engine.buckets.decode_batches[-1]
    null = torch.full((bb,), engine.kv.null_slot, dtype=torch.long, device="cuda")
    zeros = torch.zeros((bb,), dtype=torch.long, device="cuda")

    def step():
        engine._decode_step(cls, zeros[:, None], null, zeros)
        torch.cuda.synchronize()

    step()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: a CPU op's self device time repeats the time
    # of the kernels it launched, which are listed as events of their own
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and dev_us(e) > 0]
    device_ms = sum(dev_us(e) for e in events) / 1e3
    wall_ms = statistics.median(walls) * 1e3
    top = sorted(events, key=dev_us, reverse=True)[:6]
    return {
        "batch": bb, "wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if device_ms else None,
        "top_kernels_ms": {e.key[:60]: dev_us(e) / 1e3 for e in top},
    }


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke.py: src/repro_torch not found beside this script; run it "
              "from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
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
    emit({"phase": "device", "nvidia_smi": card, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. build
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = []
    for src in _build.SOURCES:
        log = _build.library_path(src).with_suffix(".log")
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines() if "Used" in ln]
    emit({"phase": "build", "seconds": build_s, "sources": list(_build.SOURCES),
          "ptxas": ptxas})

    # 3. kernels vs plain
    rows = []
    for kname, label, dt, inp in kernel_cases(torch):
        r = run_case(torch, kname, inp, dt)
        r.update(kernel=kname, case=label, dtype=str(dt).split(".")[-1])
        rows.append(r)
        check(r["ok"], f"{kname} {label} {r['dtype']}: max_abs_err {r['err']} "
                       f"beyond atol {r['atol']} / rtol {r['rtol']}")
    emit({"phase": "kernels", "card": card, "cases": rows})
    results["kernel_cases"] = rows

    # 4. serve smollm-135m, full config, bf16
    reset_launches()
    eng_k = serve(kernel_policy_args())
    launches = dict(LAUNCHES)
    check_engine(eng_k, 16, "kernel policies")
    for kname, count in launches.items():
        check(count > 0, f"kernel {kname} was not launched on the serve path")
    reset_launches()
    eng_x = serve(["--policy", CUBLAS_POLICY])
    check_engine(eng_x, 16, "cuBLAS policy")
    check(not any(LAUNCHES.values()), f"cuBLAS policy launched kernels: {LAUNCHES}")

    prompt = eng_k.requests[0].tokens
    ref_logits = first_token_logits(torch, eng_x, CUBLAS_POLICY, prompt)
    f32_logits = first_token_logits(torch, eng_x, CUBLAS_POLICY, prompt, torch.float32)
    dist = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    rel, to_f32 = {}, {CUBLAS_POLICY: dist(ref_logits, f32_logits)}
    for cls, spec in KERNEL_POLICIES.items():
        got = first_token_logits(torch, eng_k, spec, prompt)
        rel[spec], to_f32[spec] = dist(got, ref_logits), dist(got, f32_logits)
        check(rel[spec] <= LOGITS_REL_L2,
              f"first-token logits under {spec}: rel L2 {rel[spec]} > {LOGITS_REL_L2}")
        limit = F32_DISTANCE_RATIO * to_f32[CUBLAS_POLICY] + F32_DISTANCE_FLOOR
        check(to_f32[spec] <= limit,
              f"first-token logits under {spec} are {to_f32[spec]} from f32, beyond "
              f"{limit} (the cuBLAS policy's distance is {to_f32[CUBLAS_POLICY]})")
    profiles = {spec: decode_profile(torch, eng_k, cls) for cls, spec in KERNEL_POLICIES.items()}
    profiles[CUBLAS_POLICY] = decode_profile(torch, eng_x, "interactive")
    agree = {}
    for cls, spec in KERNEL_POLICIES.items():
        pairs = [(a, b) for r in eng_k.requests.values() if r.cls == cls
                 for a, b in zip(r.generated, eng_x.requests[r.rid].generated)]
        agree[spec] = sum(a == b for a, b in pairs) / len(pairs)
    n_tok = lambda e: sum(len(r.generated) for r in e.requests.values())  # noqa: E731
    serve_row = {
        "phase": "serve", "card": card, "arch": "smollm-135m", "dtype": "bfloat16",
        "launches": launches, "first_token_rel_l2": rel, "rel_l2_bound": LOGITS_REL_L2,
        "first_token_rel_l2_to_f32": to_f32, "decode_step_profile": profiles,
        "greedy_agreement_vs_cublas": agree,
        "tokens_per_s": {"kernel_policies": n_tok(eng_k) / eng_k.run_seconds,
                         CUBLAS_POLICY: n_tok(eng_x) / eng_x.run_seconds},
        "p50_decode_ms": {**{spec: p50_ms(eng_k, cls) for cls, spec in KERNEL_POLICIES.items()},
                          CUBLAS_POLICY: p50_ms(eng_x)},
        "health": eng_k.health(),
    }
    emit(serve_row)
    results["serve"] = serve_row
    del eng_k, eng_x

    # 5. exact: f32, full width, 2 layers -> identical greedy tokens
    f32 = ["--layers", "2", "--dtype", "float32"]
    e_k = serve(f32 + kernel_policy_args())
    e_x = serve(f32 + ["--policy", CUBLAS_POLICY])
    check_engine(e_k, 16, "f32 kernel policies")
    check_engine(e_x, 16, "f32 cuBLAS policy")
    for r in e_k.requests.values():
        check(r.generated == e_x.requests[r.rid].generated,
              f"f32 request {r.rid} ({r.cls}): tokens differ from {CUBLAS_POLICY}")
    emit({"phase": "exact", "layers": 2, "dtype": "float32",
          "requests": len(e_k.requests), "identical": True})

    # 6. imports
    check("jax" not in sys.modules, "jax was imported")

    # the contract line: one row per kernel, main-path shape in bf16
    contract = {"matmul_nt": "(8,576)x(49152,576)^T", "matmul_nn": "(8,576)x(576,49152)",
                "transpose": "(49152,576)", "attention_fused": "decode g=12 m=3 n=512 ragged"}
    kernels = []
    for kname, case in contract.items():
        row = next(r for r in rows if r["kernel"] == kname and r["case"] == case
                   and r["dtype"] == "bfloat16")
        source, replaces = KERNEL_SOURCES[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname],
            "max_abs_err": max(r["err"] for r in rows if r["kernel"] == kname),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": case,
            "dtype": "bfloat16",
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
