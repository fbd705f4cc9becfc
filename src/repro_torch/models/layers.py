"""Shared model building blocks: the subset of ``repro/models/layers.py``
that the DiT serving path and the Mamba2 LM path use, in PyTorch.

Parameters are ``nn.Module`` attributes named after the JAX tree keys and
kept in the JAX einsum layouts (``wq`` is (d, H, hd), ``wo`` is
(H, hd, d)), so :func:`repro_torch.convert.load_jax_params` copies a JAX
tree in without reshaping.  Attention always goes through the kernel
wrappers in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Parameter creation (the JAX package's pspec / pzeros / pones)
# ---------------------------------------------------------------------------


def pspec(shape, generator, device, scale=None) -> nn.Parameter:
    """Normal(0, scale) draw; scale defaults to fan_in ** -0.5 with the
    JAX package's fan-in rule (all leading axes)."""
    if scale is None:
        fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
        scale = max(fan_in, 1) ** -0.5
    val = torch.randn(shape, generator=generator, device=device)
    return nn.Parameter(scale * val, requires_grad=False)


def pzeros(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, device=device), requires_grad=False)


def pones(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(shape, device=device), requires_grad=False)


# ---------------------------------------------------------------------------
# Normalization and rotary embeddings
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device) -> nn.Parameter:
    return pones((d,), device)


def rmsnorm(w, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    ang = positions[..., None].float() * freqs             # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def project(x, w):
    """(B, S, d) x (d, H, hd) -> contiguous (B, S, H, hd)."""
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).unflatten(-1,
                                                                 w.shape[1:])


def project_out(a, w):
    """(B, S, H, hd) x (H, hd, d) -> (B, S, d)."""
    return a.flatten(-2) @ w.to(a.dtype).reshape(-1, w.shape[-1])


class Attention(nn.Module):
    """Parameters of one attention layer (``attention_init``)."""

    def __init__(self, cfg: ModelConfig, d_model: int | None = None, *,
                 generator, device):
        super().__init__()
        d = d_model or cfg.d_model
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.wq = pspec((d, h, hd), generator, device)
        self.wk = pspec((d, kv, hd), generator, device)
        self.wv = pspec((d, kv, hd), generator, device)
        self.wo = pspec((h, hd, d), generator, device)


def attention_apply(p: Attention, x, cfg: ModelConfig, *, causal=True,
                    positions=None, kv_x=None, use_rope=True):
    """Full self-attention within ``x``, or cross-attention to ``kv_x``
    (no rope on the keys), through the flash-attention kernel."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = project(x, p.wq)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    if kv_x is not None:                              # cross attention
        k, v = project(kv_x, p.wk), project(kv_x, p.wv)
        out = ops.attention(q, k, v, causal=False)
    else:                                             # full self-attn
        k, v = project(x, p.wk), project(x, p.wv)
        if use_rope:
            k = apply_rope(k, positions, cfg.rope_theta)
        out = ops.attention(q, k, v, causal=causal)
    return project_out(out, p.wo)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    """``swiglu_init``: gate/up (d, dff), down (dff, d)."""

    def __init__(self, d: int, dff: int, *, generator, device):
        super().__init__()
        self.w_gate = pspec((d, dff), generator, device)
        self.w_up = pspec((d, dff), generator, device)
        self.w_down = pspec((dff, d), generator, device)


def swiglu_apply(p: SwiGLU, x):
    g = x @ p.w_gate.to(x.dtype)
    u = x @ p.w_up.to(x.dtype)
    return (F.silu(g) * u) @ p.w_down.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """``embedding_init``: token table, plus an unembedding when the
    embeddings are not tied (kept so the JAX tree maps one to one)."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        self.tok = pspec((cfg.vocab_size, cfg.d_model), generator, device,
                         scale=1.0)
        if not cfg.tie_embeddings:
            self.unembed = pspec((cfg.d_model, cfg.vocab_size), generator,
                                 device)


def embed(p: Embedding, tokens, cfg: ModelConfig, dtype):
    out = p.tok.to(dtype)[tokens]
    if cfg.tie_embeddings:
        out = out * (cfg.d_model ** 0.5)
    return out


def unembed(p: Embedding, x, cfg: ModelConfig):
    """fp32 logits: the weight is cast to x's dtype and the product is
    accumulated and returned in fp32, as JAX's ``preferred_element_type``
    does (a bf16 x bf16 product is exact in fp32)."""
    w = p.unembed if hasattr(p, "unembed") else p.tok.T
    return x.float() @ w.to(x.dtype).float()
