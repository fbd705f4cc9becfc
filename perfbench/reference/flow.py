"""Rectified-flow sampling as the served requests run it, and a request's
own inputs, worked out again from its id.

A request's prompt tokens and initial noise are drawn on the host from
its id: the first 8 hex digits of the id's SHA-1 seed a CPU
``torch.Generator`` for the tokens, and that seed plus one the noise.
The initial latent is the noise times the first sigma (in float64, then
float32)."""
from __future__ import annotations

import hashlib

import numpy as np
import torch

PROMPT_LEN = 77


def flow_sigmas(num_steps: int, shift: float = 3.0) -> np.ndarray:
    """Shifted linear schedule, sigma in (0, 1]."""
    t = np.linspace(1.0, 1.0 / num_steps, num_steps)
    return (shift * t) / (1 + (shift - 1) * t)


def sigma_pair(num_steps: int, step: int) -> tuple[float, float]:
    """(sigma at ``step``, sigma after it; 0 after the last step)."""
    s = flow_sigmas(num_steps)
    return float(s[step]), (float(s[step + 1]) if step + 1 < num_steps
                            else 0.0)


def flow_step(x, v, sigma_now: float, sigma_next: float):
    """Euler step: x + (sigma_next - sigma_now) v."""
    return x + (sigma_next - sigma_now) * v


def timestep(sigma: float) -> float:
    return float(sigma) * 1000.0


def request_seed(request_id: str) -> int:
    return int(hashlib.sha1(request_id.encode()).hexdigest()[:8], 16)


def prompt_tokens(request_id: str, vocab: int) -> torch.Tensor:
    """(1, 77) int64 prompt tokens of the request."""
    gen = torch.Generator().manual_seed(request_seed(request_id))
    return torch.randint(0, vocab, (1, PROMPT_LEN), generator=gen)


def initial_latent(request_id: str, n_tokens: int, patch_dim: int,
                   num_steps: int) -> torch.Tensor:
    """(n_tokens, patch_dim) float32 noisy latent the request starts at."""
    gen = torch.Generator().manual_seed(request_seed(request_id) + 1)
    noise = torch.randn((n_tokens, patch_dim), generator=gen).numpy()
    return torch.from_numpy(
        (noise * flow_sigmas(num_steps)[0]).astype(np.float32))
