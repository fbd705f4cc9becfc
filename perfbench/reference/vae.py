"""Plain PyTorch VAE decoder: the benchmark's frozen copy of the port's
stand-in decoder (a latent projection, then three stages of a 3x3
convolution and a 2x pixel shuffle, then tanh), in float32.  ``sizes``
is the ``vae`` section of a configuration file with the latent
channels."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.arith import Arith


def param_specs(sizes: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    c, h = sizes["in_channels"], sizes["hidden"]
    return {"in_proj": ((c, h), "fan_in"),
            "up1": ((9 * h, 4 * h), "fan_in"),
            "up2": ((9 * h, 4 * h), "fan_in"),
            "up3": ((9 * h, 12), "fan_in")}


def conv3x3(x, w, ar: Arith):
    """x: (N, H, W, C), zero padded; w: (9*C, C_out), taps row-major."""
    n, h, wd, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = torch.stack([xp[:, i:i + h, j:j + wd] for i in range(3)
                        for j in range(3)], dim=-2)
    return ar.mm(taps.reshape(n, h, wd, 9 * c), w)


def pixel_shuffle(x):
    """(N, H, W, 4*C) -> (N, 2H, 2W, C)."""
    n, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, 2 * h, 2 * w, c)


def decode(params: dict, latents, ar: Arith = Arith()):
    """latents: (B, F, h, w, C) -> pixels (B, F, 8h, 8w, 3) in [-1, 1]."""
    b, f, h, w, c = latents.shape
    x = ar.mm(latents.reshape(b * f, h, w, c).float(), params["in_proj"])
    for name in ("up1", "up2", "up3"):
        x = pixel_shuffle(conv3x3(F.silu(x), params[name], ar))
    return torch.tanh(x).reshape(b, f, 8 * h, 8 * w, 3)
