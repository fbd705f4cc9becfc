"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def _load() -> dict[str, ModelConfig]:
    from repro_torch.configs import (deepseek_v2_236b, dit_models,
                                     gemma3_12b, mamba2_1_3b, minitron_8b,
                                     mistral_large_123b, mixtral_8x7b,
                                     paligemma_3b, whisper_medium, yi_6b,
                                     zamba2_7b)
    cfgs = [
        mistral_large_123b.CONFIG,
        gemma3_12b.CONFIG,
        yi_6b.CONFIG,
        minitron_8b.CONFIG,
        deepseek_v2_236b.CONFIG,
        mixtral_8x7b.CONFIG,
        mamba2_1_3b.CONFIG,
        paligemma_3b.CONFIG,
        whisper_medium.CONFIG,
        zamba2_7b.CONFIG,
        dit_models.DIT_IMAGE,
        dit_models.DIT_VIDEO,
    ]
    return {c.name: c for c in cfgs}


_REGISTRY: dict[str, ModelConfig] | None = None


def get_config(name: str) -> ModelConfig:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _load()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs(include_dit: bool = True) -> list[str]:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _load()
    names = sorted(_REGISTRY)
    if not include_dit:
        names = [n for n in names if not n.startswith("dit-")]
    return names


ASSIGNED_ARCHS = [
    "mistral-large-123b", "gemma3-12b", "yi-6b", "minitron-8b",
    "deepseek-v2-236b", "mixtral-8x7b", "mamba2-1.3b", "paligemma-3b",
    "whisper-medium", "zamba2-7b",
]
