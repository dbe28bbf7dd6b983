"""PyTorch + CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The port serves the same decoder LMs through the same policy-scoped
dispatch engine; every Pallas kernel on its path is a CUDA C++ kernel
under ``csrc/``, built with nvcc at first use (``kernels/_build.py``).
It imports torch and numpy only -- never jax, never ``repro``.

Entry points (``init_lm``, ``ServeEngine``, ``python -m
repro_torch.launch.serve``) run on the card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version instead.

Numerics, stated once for the whole port: f32 matrix products run in
full f32 (no TF32 in cuBLAS or cuDNN), and bf16 products reduce in f32.
The f32 parity bound of ``1e-5 * sqrt(k)`` the tests hold does not
survive TF32's 10-bit mantissa.
"""

from __future__ import annotations

# torch is optional at the package level so the torch-free tooling (the
# artifact, dispatch and concurrency passes of repro_torch.analysis) runs
# on checkouts without the accelerator stack; every compute module still
# imports torch directly.
try:
    import torch
except ImportError:
    torch = None

if torch is not None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.  Asking for CUDA on a
    machine without a card raises: the port never carries on on the CPU
    behind the caller's back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch.cuda.is_available() "
            "is False (no CUDA card or a CPU-only torch build); pass "
            "device='cpu' to run the plain PyTorch versions"
        )
    return dev
