"""Shared model building blocks: the part of ``repro/models/layers.py``
that the DiT serving path and the decoder LMs (dense, SWA, hybrid, SSM)
use, in PyTorch.  MLA and MoE are a later slice.

Parameters are ``nn.Module`` attributes named after the JAX tree keys and
kept in the JAX einsum layouts (``wq`` is (d, H, hd), ``wo`` is
(H, hd, d)), so :func:`repro_torch.convert.load_jax_params` copies a JAX
tree in without reshaping.  Full (uncached, unwindowed) attention always
goes through the flash-attention kernel wrapper
(:func:`repro_torch.kernels.ops.attention`); windowed and cached
attention run :func:`sdpa`'s plain tensor ops, as the JAX package runs
its jnp ``sdpa`` there.

Attention caches are written in place: a cached call stores the new
keys and values into ``cache["k"]``/``cache["v"]`` (index copies at
device-side positions, no host sync) and returns a cache that holds the
same tensors with ``len`` advanced.  The JAX package returns updated
copies; in place, a decode step does not copy every layer's cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


def resolve_device(device) -> torch.device:
    """``device`` or, by default, the card; without CUDA the caller must
    ask for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the model on the CPU (the kernels' plain "
                           "versions)")
    return device


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


def stacked(one: dict, lead: tuple) -> dict:
    """Each leaf of ``one`` repeated along new leading axes ``lead`` (a
    per-layer cache stacked in the JAX layout)."""
    return {k: v.expand(lead + v.shape).clone() for k, v in one.items()}


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


def repeat_kv(k, n_rep: int):
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd)."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd) \
        .reshape(b, s, kv * n_rep, hd)


def sdpa(q, k, v, *, causal: bool, window: int = 0, q_offset=0,
         kv_len=None, bias=None):
    """Scaled dot-product attention over (B, S, H, hd) tensors, as plain
    tensor ops: scores in fp32, masked to -1e30 in fp32 score space,
    softmax in fp32, probabilities cast to q's dtype before PV (as JAX's
    ``sdpa`` does).

    ``window``   > 0 -> sliding-window mask (keys within `window` of query).
    ``q_offset``     -> absolute position of q[0] (an int or a 0-d tensor).
    ``kv_len``       -> optional (B,) valid key lengths (decode caches).
    """
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (hd ** -0.5)
    qpos = torch.arange(sq, device=q.device) + q_offset          # (sq,)
    kpos = torch.arange(sk, device=q.device)                     # (sk,)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores.masked_fill_(~mask[None, None], -1e30)
    if kv_len is not None:
        valid = kpos[None, :] < kv_len[:, None]                  # (B, sk)
        scores.masked_fill_(~valid[:, None, None], -1e30)
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(q.dtype))


def _full_attention(q, k, v, *, causal: bool):
    """Full (uncached, unwindowed) attention: always the flash-attention
    kernel (its plain version for CPU tensors).  The JAX package chooses
    by ``cfg.use_pallas``; the port has one path."""
    return ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal)


def _cache_write(cache, rows, k, v):
    """Store k/v (B, s, KV, hd) into the cache's rows ``rows`` (a device
    index tensor, so no host sync), in place."""
    cache["k"].index_copy_(1, rows, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, rows, v.to(cache["v"].dtype))


def attention_apply(p: Attention, x, cfg: ModelConfig, *, causal=True,
                    window=0, positions=None, cache=None, kv_x=None,
                    use_rope=True, sp_decode: bool = False):
    """Returns (out, new_cache).

    Training/prefill: ``cache=None`` -> attends within ``x``.
    Decode: ``cache={"k","v","len"}`` -> store x's kv into the cache (in
    place) and attend to it.  A cache of exactly ``window`` rows is the
    SWA ring buffer: a prefill installs its last ``window`` keys at slots
    ``pos % window``, a decode step writes one slot and attends to the
    ``min(len + 1, window)`` valid ones.
    Cross-attention: ``kv_x`` provides the key/value sequence (no cache;
    the JAX package's precomputed cross-kv comes with the encdec slice).
    """
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = project(x, p.wq)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    if kv_x is not None:                              # cross attention
        k, v = project(kv_x, p.wk), project(kv_x, p.wv)
        out = _full_attention(q, k, v, causal=False)
        new_cache = None
    elif cache is None:                               # full self-attn
        k, v = project(x, p.wk), project(x, p.wv)
        if use_rope:
            k = apply_rope(k, positions, cfg.rope_theta)
        if window:                    # SWA keeps the masked plain path
            out = sdpa(q, k, v, causal=causal, window=window)
        else:
            out = _full_attention(q, k, v, causal=causal)
        new_cache = None
    else:                                             # cached decode/prefill
        k_new, v_new = project(x, p.wk), project(x, p.wv)
        if use_rope:
            k_new = apply_rope(k_new, positions, cfg.rope_theta)
        cache_len = cache["len"]                      # (B,) int32
        k_all, v_all = cache["k"], cache["v"]
        rows = torch.arange(s, device=x.device)
        if window and k_all.shape[1] == window:       # ring buffer (SWA)
            if s > 1:
                # windowed prefill: attend within the new sequence under the
                # window mask, then install the last min(s, W) keys into the
                # ring at slots (pos % W).  Assumes prefill starts at len=0.
                out = sdpa(q, k_new, v_new, causal=True, window=window)
                last = min(s, window)
                _cache_write(cache, rows[s - last:] % window,
                             k_new[:, s - last:], v_new[:, s - last:])
            else:
                _cache_write(cache, cache_len[0] % window + rows, k_new,
                             v_new)
                # ring decode: slots < min(len+1, W) valid; keys are stored
                # pre-rotated at absolute positions so scores stay correct.
                valid = torch.clamp(cache_len + s, max=window)
                out = sdpa(q, k_all, v_all, causal=False, kv_len=valid)
        elif sp_decode and s == 1 and not window:
            raise NotImplementedError(
                "sp_decode (flash decoding over a sequence-sharded cache) "
                "needs a device mesh: the port of repro.sharding is a later "
                "slice")
        else:
            _cache_write(cache, cache_len[0] + rows, k_new, v_new)
            out = sdpa(q, k_all, v_all, causal=True, q_offset=cache_len[0],
                       kv_len=cache_len + s, window=window)
        new_cache = {"k": k_all, "v": v_all, "len": cache_len + s}
    return project_out(out, p.wo), new_cache


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
