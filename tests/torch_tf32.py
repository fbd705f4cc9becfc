"""The fp32 kernels' split-TF32 products, emulated on the CPU: each fp32
operand rounded to TF32 as the kernels' tensor-core code rounds it, for
the closed-form rounding tests of K2's and K4's fp32 backward."""
import torch


def tf32(x):
    """fp32 ``x`` rounded to TF32 as the kernels round it: to nearest on
    the bits (ties away from zero), the 13 low mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_product(eq, a, b, passes):
    """``torch.einsum(eq, a, b)`` of fp32 operands as the kernels' tensor
    cores compute it, each operand split as x = hi + lo with hi = tf32(x)
    and lo = tf32(x - hi): split-TF32 (``passes=3``) sums a_lo b_hi +
    a_hi b_lo + a_hi b_hi; one TF32 product (``passes=1``) is a_hi b_hi.
    Products of TF32 values are exact in fp32, so only the sums round."""
    ah, bh = tf32(a), tf32(b)
    out = torch.einsum(eq, ah, bh)
    if passes == 3:
        al, bl = tf32(a - ah), tf32(b - bh)
        out = torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + out
    return out
