"""VAE decoder for the DiT pipeline (``repro/models/vae.py`` in PyTorch).

latent (B, F, h, w, C) -> pixels (B, F, 8h, 8w, 3) via three stride-2
upsample stages, each a 3x3 convolution in unfold-matmul form followed by
a 2x pixel shuffle.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import pspec


class VAE(nn.Module):
    """``vae.init``: weights drawn from ``generator``."""

    def __init__(self, cfg: ModelConfig, hidden: int = 128, *, generator,
                 device):
        super().__init__()
        c_in = cfg.dit.in_channels
        # each stage: 3x3 conv (as unfold-matmul) producing 4x channels
        # for 2x pixel-shuffle upsample
        self.in_proj = pspec((c_in, hidden), generator, device)
        self.up1 = pspec((9 * hidden, 4 * hidden), generator, device)
        self.up2 = pspec((9 * hidden, 4 * hidden), generator, device)
        self.up3 = pspec((9 * hidden, 4 * 3), generator, device)


def _conv3x3(x, w):
    """x: (B, H, W, C); w: (9*C, C_out) — unfold 3x3 then matmul."""
    b, h, wd, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    patches = torch.stack([xp[:, i:i + h, j:j + wd] for i in range(3)
                           for j in range(3)], dim=-2)     # (B,H,W,9,C)
    return patches.reshape(b, h, wd, 9 * c) @ w


def _pixel_shuffle(x):
    """(B, H, W, 4*C) -> (B, 2H, 2W, C)."""
    b, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h, w, 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c)


def decode(model: VAE, latents, cfg: ModelConfig):
    """latents: (B, F, h, w, C) -> (B, F, 8h, 8w, 3) in [-1, 1]."""
    b, f, h, w, c = latents.shape
    x = latents.reshape(b * f, h, w, c).float()
    x = x @ model.in_proj.float()
    for w_up in (model.up1, model.up2, model.up3):
        x = _conv3x3(F.silu(x), w_up.float())
        x = _pixel_shuffle(x)
    return torch.tanh(x).reshape(b, f, 8 * h, 8 * w, 3)
