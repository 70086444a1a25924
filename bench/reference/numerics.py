"""Operand rounding of the references' matrix products.

The references compute in float32 with TF32 off (:func:`exact_f32`). The
controls run the same code with the operands of every product rounded to
a lower precision first, the step below the one a configuration states:
TF32's 10-bit mantissa below float32, fp8 (e4m3, per-row scale) below
bfloat16. The rounding is explicit, so a control reads the same on the
CPU as on the card.
"""
from __future__ import annotations

import contextlib

import torch


def f32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per row of the last axis (the
    row's largest magnitude maps to 448), back in float32."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


CASTS = {"float32": f32, "tf32": tf32, "fp8": fp8}


def mm(a: torch.Tensor, b: torch.Tensor, cast=f32) -> torch.Tensor:
    """a @ b in float32 after ``cast`` of both operands (the weight is
    cast along its input axis, so fp8 scales each output column)."""
    return cast(a) @ cast(b.float().transpose(-1, -2)).transpose(-1, -2)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the block (matmul and cuDNN), restored after."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
