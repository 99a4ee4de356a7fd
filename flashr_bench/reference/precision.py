"""The precision a reference computation runs in.

The reference runs in float64.  The control is the same code one step below
what the configurations state (float32 with TF32 off): float32 whose every
product takes its operands rounded to TF32, as the tensor cores round them
(10 explicit mantissa bits, round to nearest).  The rounding is applied
explicitly, so the control reads the same on any device and never depends
on a library's TF32 switch.
"""
from __future__ import annotations

import dataclasses

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to TF32 (the low 13 mantissa bits cleared,
    rounding half away from zero, as ``cvt.rna.tf32.f32`` does)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    dtype: torch.dtype
    round_operands: bool

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.dtype)

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` cast to this precision as the operand of a product."""
        t = t.to(self.dtype)
        return tf32(t) if self.round_operands else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.operand(a) @ self.operand(b)


REFERENCE = Precision("float64", torch.float64, False)
CONTROL = Precision("tf32", torch.float32, True)
