"""Diffusion schedules: rectified-flow (Euler) sampling used by the
serving pipeline, plus a DDIM-style variance-preserving option."""
from __future__ import annotations

import numpy as np


def flow_sigmas(num_steps: int, shift: float = 3.0) -> np.ndarray:
    """Shifted linear sigma schedule (SD3/Wan-style), sigma in (0, 1]."""
    t = np.linspace(1.0, 1.0 / num_steps, num_steps)
    return (shift * t) / (1 + (shift - 1) * t)


def flow_step(x, v, sigma_now: float, sigma_next: float):
    """Euler step for rectified flow: x' = x + (sigma_next - sigma_now)*v."""
    return x + (sigma_next - sigma_now) * v


def timestep_of_sigma(sigma: float) -> float:
    return float(sigma) * 1000.0
