"""The products of the plain reference, in the precision it is asked for.

``Arith()`` multiplies in float32 with TF32 off, the precision the
configurations state.  ``Arith(tf32=True)`` is the benchmark's control:
every product's operands rounded to TF32 (8 exponent bits, 10 mantissa
bits, round to nearest even) and accumulated in float32, which is what a
TF32 tensor-core product computes.  The rounding is written out, so the
control gives the same numbers on the CPU and on the card.
"""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + (0xFFF + lsb)) & ~0x1FFF
    return rounded.view(torch.float32)


class Arith:
    """Matrix products of the reference (``mm`` is ``torch.matmul``)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = round_tf32(a.float()), round_tf32(b.float())
        return torch.matmul(a, b)
