"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), in PyTorch.

Port of ``repro/models/encdec.py``.  The conv audio frontend is a stub,
as in the reference: the caller passes precomputed frame embeddings
(B, frontend_seq, d_model).  The encoder is bidirectional; the decoder
has causal self-attention and cross-attention to the encoder's output.
A prefill computes each layer's cross K/V once from the encoder output
and stores it in the cache's ``cross`` rows; every decode step reads it
from there.

The JAX package scans the stacked ``enc_blocks`` and ``dec_blocks``;
here each is a ``ModuleList`` (:func:`repro_torch.convert.load_jax_params`
loads the stacked leaves one layer an index).  The caches keep the JAX
layout, every leaf with a leading layer axis, and are written in place:
a layer reads and writes a view of its row, which is contiguous, so the
flash-attention kernel takes the cross K/V without a copy.

K2 (``ops.attention``) runs the encoder's self-attention, every
cross-attention (prefill and decode) and, in :func:`forward`, the
decoder's causal self-attention; cached decoder self-attention runs the
plain ``sdpa``, as the JAX model does.

Entry points build on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import resolve_device
from repro_torch.sharding import constrain


class EncBlock(nn.Module):
    """``_enc_block_init``: pre-norm self-attention + SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln_attn = L.rmsnorm_init(cfg.d_model, device)
        self.attn = L.Attention(cfg, **kw)
        self.ln_mlp = L.rmsnorm_init(cfg.d_model, device)
        self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, **kw)


class DecBlock(nn.Module):
    """``_dec_block_init``: causal self-attention, cross-attention to the
    encoder output, SwiGLU MLP, each pre-norm."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln_self = L.rmsnorm_init(cfg.d_model, device)
        self.self_attn = L.Attention(cfg, **kw)
        self.ln_cross = L.rmsnorm_init(cfg.d_model, device)
        self.cross_attn = L.Attention(cfg, **kw)
        self.ln_mlp = L.rmsnorm_init(cfg.d_model, device)
        self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, **kw)


class EncDec(nn.Module):
    """``init``: embedding, encoder and decoder stacks, their final norms.
    Weights are drawn from ``generator`` (one on ``device``; seed 0 by
    default)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = L.default_generator(device)
        kw = dict(generator=generator, device=device)
        self.embed = L.Embedding(cfg, **kw)
        self.enc_blocks = nn.ModuleList(
            EncBlock(cfg, **kw) for _ in range(cfg.num_encoder_layers))
        self.dec_blocks = nn.ModuleList(
            DecBlock(cfg, **kw) for _ in range(cfg.num_layers))
        self.ln_enc = L.rmsnorm_init(cfg.d_model, device)
        self.ln_final = L.rmsnorm_init(cfg.d_model, device)


def init(cfg: ModelConfig, *, generator=None, device=None) -> EncDec:
    return EncDec(cfg, generator=generator, device=device)


def encode(model: EncDec, frames, cfg: ModelConfig):
    """frames: (B, S_enc, d) precomputed frontend embeddings (stub)."""
    positions = torch.arange(frames.shape[1], device=frames.device)[None, :]
    h = frames
    for p in model.enc_blocks:
        a = L.rmsnorm(p.ln_attn, h, cfg.norm_eps)
        a, _ = L.attention_apply(p.attn, a, cfg, causal=False,
                                 positions=positions)
        h = h + a
        m = L.rmsnorm(p.ln_mlp, h, cfg.norm_eps)
        h = h + L.swiglu_apply(p.mlp, m)
    return L.rmsnorm(model.ln_enc, h, cfg.norm_eps)


def _dec_block_apply(p: DecBlock, x, enc_out, cfg: ModelConfig, positions,
                     cache=None):
    """cache: {"self": kv-cache, "cross": precomputed cross-kv or None}."""
    h = L.rmsnorm(p.ln_self, x, cfg.norm_eps)
    self_c = cache["self"] if cache is not None else None
    a, new_self = L.attention_apply(p.self_attn, h, cfg, causal=True,
                                    positions=positions, cache=self_c)
    x = x + a
    h = L.rmsnorm(p.ln_cross, x, cfg.norm_eps)
    cross_c = cache["cross"] if cache is not None else None
    a, new_cross = L.attention_apply(p.cross_attn, h, cfg,
                                     positions=positions, kv_x=enc_out,
                                     cache=cross_c, use_rope=False)
    x = x + a
    h = L.rmsnorm(p.ln_mlp, x, cfg.norm_eps)
    new_cache = None
    if cache is not None:
        new_cache = {"self": new_self, "cross": new_cross}
    return x + L.swiglu_apply(p.mlp, h), new_cache


def _layer(cache: dict, i: int) -> dict:
    """Layer ``i``'s views of a stacked cache's leaves."""
    return {k: v[i] for k, v in cache.items()}


def _scan_dec(model: EncDec, caches, x, enc_out, cfg: ModelConfig, positions,
              *, fill_cross: bool = False):
    """Walk the decoder stack.  With ``fill_cross`` (a prefill) each
    layer's cross K/V is computed from ``enc_out`` and stored into the
    cache's ``cross`` row; otherwise a cache's ``cross`` rows are read.
    Returns (x, new_caches)."""
    lens = []
    for i, p in enumerate(model.dec_blocks):
        x = constrain(x, "act_batch", "act_seq", None)
        c = None
        if caches is not None:
            c = {"self": _layer(caches["self"], i),
                 "cross": None if fill_cross else _layer(caches["cross"], i)}
        x, nc = _dec_block_apply(p, x, enc_out, cfg, positions, c)
        if nc is None:
            continue
        lens.append(nc["self"]["len"])
        if fill_cross:
            for key in ("k", "v"):
                caches["cross"][key][i].copy_(nc["cross"][key])
    if caches is None:
        return x, None
    # self k/v and the cross rows were written in place
    return x, {"self": {**caches["self"], "len": torch.stack(lens)},
               "cross": caches["cross"]}


def forward(model: EncDec, tokens, frames, cfg: ModelConfig, *,
            remat: str = "none", dtype=torch.bfloat16):
    """Teacher-forced logits (B, S, V) in fp32, and a zero aux loss.
    frames: the stub frontend's embeddings.  ``remat`` is taken and
    unused, as in the JAX package."""
    enc_out = encode(model, frames.to(dtype), cfg)
    x = L.embed(model.embed, tokens, cfg, dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _ = _scan_dec(model, None, x, enc_out, cfg, positions)
    x = L.rmsnorm(model.ln_final, x, cfg.norm_eps)
    return L.unembed(model.embed, x, cfg), torch.zeros((), device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Per decoder layer: the self-attention K/V of ``max_len`` rows and
    the cross K/V of ``frontend_seq`` rows, stacked on a leading layer
    axis."""
    device = resolve_device(device)
    kv, hd = cfg.num_kv_heads, cfg.head_dim

    def zeros(rows):
        return torch.zeros((batch, rows, kv, hd), dtype=dtype, device=device)
    one = {
        "self": {"k": zeros(max_len), "v": zeros(max_len),
                 "len": torch.zeros((batch,), dtype=torch.int32,
                                    device=device)},
        "cross": {"k": zeros(cfg.frontend_seq), "v": zeros(cfg.frontend_seq)},
    }
    return {name: L.stacked(sub, (cfg.num_layers,))
            for name, sub in one.items()}


def prefill(model: EncDec, tokens, frames, cache, cfg: ModelConfig, *,
            dtype=torch.bfloat16):
    """Encoder forward + decoder prompt prefill (fills the self and cross
    caches).  Returns (logits of the last position (B, 1, V), cache)."""
    enc_out = encode(model, frames.to(dtype), cfg)
    x = L.embed(model.embed, tokens, cfg, dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, new_caches = _scan_dec(model, cache, x, enc_out, cfg, positions,
                              fill_cross=True)
    x = L.rmsnorm(model.ln_final, x, cfg.norm_eps)
    return L.unembed(model.embed, x[:, -1:], cfg), new_caches


def decode_step(model: EncDec, tokens, cache, pos, cfg: ModelConfig, *,
                dtype=torch.bfloat16):
    """One decode step against the cached cross K/V. tokens (B, 1); pos
    (B,) absolute positions.  Returns (logits (B, 1, V), cache)."""
    x = L.embed(model.embed, tokens, cfg, dtype)
    positions = pos[:, None]
    # enc_out is unused when the cross cache is populated
    dummy_enc = torch.zeros((tokens.shape[0], 1, cfg.d_model), dtype=dtype,
                            device=x.device)
    x, new_caches = _scan_dec(model, cache, x, dummy_enc, cfg, positions)
    x = L.rmsnorm(model.ln_final, x, cfg.norm_eps)
    return L.unembed(model.embed, x, cfg), new_caches
