"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface, ``build/repro_torch/lib<name>-<hash>.so`` under the checkout
(the directory is git-ignored; ``REPRO_TORCH_BUILD_DIR`` moves it).  The
hash covers the source, the shared headers and the nvcc flags, so an
edited source rebuilds and an unchanged one loads at once.  Nothing is
built at import: the first CUDA launch calls ``build_all``, which starts
one nvcc per missing library, all at once, and waits for them.  A missing
nvcc or a failed one raises ``KernelBuildError`` (with nvcc's output).

Calling convention: every pointer and the stream go as ``c_void_p`` (a
bare Python int would be cut to 32 bits), ints as ``c_int``; each entry
point returns ``cudaGetLastError()`` and ``launch`` raises
``KernelLaunchError`` when that is not 0.  The dispatch engine's fallback
chain re-raises both and quarantines neither: a kernel that does not
build or launch is a fault of the card's path, never a reason to run the
library arm in its place.  Kernels allocate nothing: the wrappers allocate outputs with
``torch.empty``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

__all__ = ["SOURCES", "KernelBuildError", "KernelLaunchError", "build_all", "build_dir",
           "library_path", "launch", "ptr", "stream_of", "dtype_code"]


class KernelBuildError(RuntimeError):
    """The kernels could not be built: no nvcc, or nvcc failed."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry point returned a non-zero ``cudaError``."""

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("transpose", "matmul", "matmul_nt", "attention_fused", "matmul_tnn_fused",
           "matmul_batched", "matmul_nn")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# csrc/common.cuh::DType holds the same table.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every entry point ends in its launch's grid -- (gx, gy, gz), a persistent
# kernel's programs, a split's second launch -- then the stream: the grids
# of the wrapper's specs (kernels/gridspec.py).
_G3 = [_I] * 3
_SIGNATURES = {
    "transpose": {"repro_transpose": [_P, _P] + [_I] * 5 + _G3 + [_P]},
    "matmul": {"repro_matmul": [_P, _P, _P] + [_I] * 5 + _G3 + [_P],
               "repro_matmul_f32": [_P] * 4 + [_I] * 8 + _G3 + [_I, _P]},
    "attention_fused": {
        "repro_attention_fused_fma": [_P] * 5 + [_I] * 10 + [_F, _I] + _G3 + [_P],
        "repro_attention_fused_flash": [_P] * 5 + [_I] * 10 + [_F] + _G3 + [_P],
        "repro_attention_fused_flash_f32": [_P] * 6 + [_I] * 10 + [_F, _I] + _G3 + _G3 + [_P],
        "repro_attention_fused_decode": ([_P] * 6 + [_I] * 10 + [_F, _I, _I, _I] + _G3 + _G3
                                         + [_P]),
    },
    "matmul_nt": {"repro_matmul_nt": [_P] * 4 + [_I] * 5 + _G3 + [_I, _P]},
    "matmul_tnn_fused": {
        "repro_matmul_tnn_fused": [_P, _P, _P] + [_I] * 4 + _G3 + [_P],
        "repro_matmul_tnn_fused_wgmma": [_P, _P, _P] + [_I] * 5 + [_P],
        "repro_matmul_tnn_fused_f32": [_P] * 4 + [_I] * 7 + _G3 + [_I, _P],
    },
    "matmul_batched": {
        "repro_matmul_batched_fma": [_P] * 3 + [_I] * 6 + _G3 + [_P],
        "repro_matmul_batched_f32": [_P] * 4 + [_I] * 7 + _G3 + [_I, _P],
        "repro_matmul_batched_bf16": [_P] * 3 + [_I] * 5 + _G3 + [_P],
    },
    "matmul_nn": {
        "repro_matmul_nn_wgmma": [_P] * 4 + [_I] * 8 + [_P],
        "repro_matmul_nn_skinny": [_P] * 4 + [_I] * 5 + _G3 + [_I, _P],
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}  # guarded-by: _LOCK


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> the checkout root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found (looked at $NVCC, PATH and $CUDA_HOME/bin): the "
        "port's CUDA kernels are compiled from csrc/ at first use"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_digest(name)}.so"


def _compile_missing() -> None:
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    procs = []
    for name in todo:
        target = library_path(name)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, target, tmp, cmd, proc))
    errors = []
    for name, target, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(
                f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{log}"
            )
        else:
            os.replace(tmp, target)
    if errors:
        raise KernelBuildError("\n\n".join(errors))


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def build_all() -> None:
    """Compile every missing kernel library (in parallel) and load all."""
    with _LOCK:
        if len(_LIBS) == len(SOURCES):
            return
        _compile_missing()
        for name in SOURCES:
            _LIBS.setdefault(name, _load(name))


def launch(name: str, fn: str, *args) -> None:
    """Call entry point ``fn`` of library ``name``; raise if the launch
    was refused (the kernel then never ran)."""
    if name not in _LIBS:
        build_all()
    lib = _LIBS[name]
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise KernelLaunchError(f"{fn} failed to launch: {msg} (cudaError {rc})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def dtype_code(dtype: torch.dtype) -> int:
    return DTYPE_CODES[dtype]
