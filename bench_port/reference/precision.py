"""Rounding to the precisions a control computes in.

A control is the reference computed one precision below the configuration's
(float32 for float64; TF32 for float32 with TF32 off).  TF32 is what the
tensor cores take as input: a float32 with its mantissa cut to 10 bits,
products summed in float32.  Rounding the operands of every matrix product explicitly gives
that arithmetic whatever routine cuBLAS picks for the shape (a GEMV, for
one, never uses the tensor cores)."""

import torch


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to nearest, ties away from zero, to TF32's
    10-bit mantissa, kept in float32."""
    if t.dtype != torch.float32:
        raise TypeError(f"TF32 rounding takes float32, got {t.dtype}")
    bits = t.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32).view_as(t)


#: The dtype a precision computes in (TF32 rounds float32 operands).
WORKING_DTYPE = {"float64": torch.float64, "float32": torch.float32, "tf32": torch.float32}


def rounding(precision: str):
    """The operand rounding of a precision: ``None`` for the stated one."""
    if precision in ("float32", "float64"):
        return None
    if precision == "tf32":
        return round_tf32
    raise ValueError(f"unknown precision {precision!r}")
