"""Matrix products of the plain reference, in float32 with TF32 off, or
in a lower precision for the controls: ``tf32`` rounds both operands to
TF32's 10-bit mantissa (round to nearest even), ``fp8`` casts them to
float8 e4m3 with one scale per tensor (amax to 448).  Products then run
in float32, so each control is the float32 reference with its operands
rounded as the lower-precision hardware path would round them.  The
backward of a product rounds the incoming gradient and the saved
operands the same way.  Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import torch

__all__ = ["PRECISIONS", "FAULTS", "mode", "set_f32_math", "quantize", "mm", "linear"]

PRECISIONS = ("f32", "tf32", "fp8")
# faults planted in the reference put in the program's place, as a control:
# ``half_batch`` trains on the first half of each step's rows, the mean over those
FAULTS = {"half_batch": 0.5}


def mode(name: str):
    """(precision, share of each batch's rows) of a control ``name``: a
    precision, or a planted fault computed in float32."""
    if name in FAULTS:
        return "f32", FAULTS[name]
    if name in PRECISIONS:
        return name, 1.0
    raise ValueError(f"unknown control {name!r}; one of {PRECISIONS + tuple(FAULTS)}")


FP8_MAX = 448.0


def set_f32_math() -> None:
    """Full float32 products on the card: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def quantize(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` (float32) as the ``precision`` path would hold it."""
    if precision == "f32":
        return x
    if precision == "tf32":
        return _round_tf32(x)
    if precision == "fp8":
        return _round_fp8(x)
    raise ValueError(f"unknown precision {precision!r}; one of {PRECISIONS}")


class _QuantMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, precision):
        qa, qb = quantize(a, precision), quantize(b, precision)
        ctx.precision = precision
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = quantize(g.contiguous(), ctx.precision)
        da = torch.matmul(qg, qb.transpose(-1, -2)) if ctx.needs_input_grad[0] else None
        db = None
        if ctx.needs_input_grad[1]:
            db = torch.matmul(qa.transpose(-1, -2), qg)
            while db.dim() > qb.dim():  # a broadcast operand: sum its gradient
                db = db.sum(0)
        return da, db, None


def mm(a: torch.Tensor, b: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """``a @ b`` in float32 (``torch.matmul`` broadcasting), its operands
    rounded to ``precision``."""
    if precision == "f32":
        return torch.matmul(a, b)
    return _QuantMM.apply(a, b, precision)


def linear(x: torch.Tensor, w: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """``x @ w^T`` for a weight stored (out, in)."""
    lead = x.shape[:-1]
    return mm(x.reshape(-1, x.shape[-1]), w.t(), precision).reshape(*lead, w.shape[0])
