"""Plain PyTorch versions of the kernels in csrc/ (the allclose targets).

Each follows its JAX oracle in ``repro/kernels/ref.py`` line for line:
softmax and normalisation run in fp32 and the result is cast back to the
input's dtype.  The wrappers in :mod:`repro_torch.kernels.ops` run these
for CPU tensors only; on the card they are what the kernels are held to.
"""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = False):
    """q: (B, Sq, H, d); k/v: (B, Sk, KV, d). fp32 softmax."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    group = h // kv
    k = torch.repeat_interleave(k, group, dim=2)
    v = torch.repeat_interleave(v, group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (d ** 0.5)
    if causal:
        mask = torch.tril(torch.ones((sq, k.shape[1]), dtype=torch.bool,
                                     device=q.device),
                          diagonal=k.shape[1] - sq)
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def adaln_ref(x, shift=None, scale=None, gate=None, residual=None, *,
              ln: bool = True, eps: float = 1e-6):
    """adaLN-Zero modulate, matching csrc/adaln.cu's variants.

    x/residual: (B, N, D); shift/scale/gate: (B, D).
    Full form returns residual + gate * (LN(x) * (1 + scale) + shift);
    omit gate/residual for the pre-branch modulated norm, omit
    shift/scale with ``ln=False`` for the bare gated residual.
    """
    out = x.float()
    if ln:
        mu = out.mean(-1, keepdim=True)
        var = ((out - mu) ** 2).mean(-1, keepdim=True)
        out = (out - mu) * torch.rsqrt(var + eps)
    if shift is not None:
        out = out * (1.0 + scale.float()[:, None]) + shift.float()[:, None]
    if gate is not None:
        out = residual.float() + gate.float()[:, None] * out
    return out.to(x.dtype)


def splice_attention_ref(q, k_stale, v_stale, k_fresh, v_fresh, *,
                         offset: int, causal: bool = False):
    """Materialize-then-attend version of the §11 cache-splice kernel:
    overwrite rows [offset, offset+L) of the stale snapshot with the
    fresh local shard, then run plain attention."""
    n = k_fresh.shape[1]
    k = k_stale.clone()
    v = v_stale.clone()
    k[:, offset:offset + n] = k_fresh.to(k.dtype)
    v[:, offset:offset + n] = v_fresh.to(v.dtype)
    return attention_ref(q, k, v, causal=causal)
