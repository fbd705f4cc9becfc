"""Gradient compression (``repro/training/compression.py`` in PyTorch).

Two schemes, applied to each gradient leaf before the data-parallel
all-reduce:

* ``int8``: per-tensor symmetric int8 quantization.  The all-reduce then
  moves 4x fewer bytes; in the step it is modelled as quantize ->
  dequantize, so the numerics run end to end.
* ``topk``: keep the largest 10% entries per tensor (by magnitude),
  zeroing the rest; the threshold is ``torch.topk``'s k-th value, as
  ``jax.lax.top_k``'s.
"""
from __future__ import annotations

import torch


def _int8_qdq(g):
    if g.ndim == 0:
        return g
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(g.dtype) * scale


def _topk_mask(g, frac: float = 0.1):
    if g.numel() <= 16 or g.ndim == 0:
        return g
    k = max(1, int(g.numel() * frac))
    thresh = torch.topk(g.abs().reshape(-1), k).values[-1]
    return torch.where(g.abs() >= thresh, g, torch.zeros_like(g))


def compress_decompress(grads: dict, method: str = "int8") -> dict:
    """Each gradient (name -> tensor) compressed and restored."""
    fn = {"int8": _int8_qdq, "topk": _topk_mask}[method]
    return {n: fn(g) for n, g in grads.items()}


def compressed_bytes(grads: dict, method: str) -> int:
    """Collective payload bytes after compression (for roofline deltas)."""
    total = 0
    for g in grads.values():
        if method == "int8":
            total += g.numel() + 4
        elif method == "topk":
            k = max(1, int(g.numel() * 0.1))
            total += k * 8          # value + index
        else:
            total += g.numel() * 4
    return total
