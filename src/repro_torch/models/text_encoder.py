"""Lightweight text conditioning encoder for the DiT pipeline: a small
bidirectional transformer (``repro/models/text_encoder.py`` in PyTorch).
It is the "encode" trajectory task; its attention runs through the
flash-attention kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import pones


def encoder_config(cond_dim: int, vocab: int = 32000) -> ModelConfig:
    return ModelConfig(
        name="text-encoder", family="dense", num_layers=4,
        d_model=cond_dim, num_heads=8, num_kv_heads=8,
        head_dim=cond_dim // 8, d_ff=cond_dim * 4, vocab_size=vocab)


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        self.ln_attn = pones((cfg.d_model,), device)
        self.attn = L.Attention(cfg, generator=generator, device=device)
        self.ln_mlp = pones((cfg.d_model,), device)
        self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, generator=generator,
                            device=device)


class TextEncoder(nn.Module):
    """``text_encoder.init``: weights drawn from ``generator``."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        self.embed = L.Embedding(cfg, generator=generator, device=device)
        self.blocks = nn.ModuleList(
            EncoderBlock(cfg, generator=generator, device=device)
            for _ in range(cfg.num_layers))
        self.ln_final = pones((cfg.d_model,), device)


def encode(model: TextEncoder, tokens, cfg: ModelConfig,
           dtype=torch.bfloat16):
    """tokens: (B, Lt) -> embeddings (B, Lt, cond_dim)."""
    x = L.embed(model.embed, tokens, cfg, dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for blk in model.blocks:
        a = L.rmsnorm(blk.ln_attn, x, cfg.norm_eps)
        x = x + L.attention_apply(blk.attn, a, cfg, causal=False,
                                  positions=positions)
        m = L.rmsnorm(blk.ln_mlp, x, cfg.norm_eps)
        x = x + L.swiglu_apply(blk.mlp, m)
    return L.rmsnorm(model.ln_final, x, cfg.norm_eps)
