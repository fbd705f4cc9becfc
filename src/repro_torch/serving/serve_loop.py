"""serve_step / prefill_step factories per architecture.

Port of ``repro/serving/serve_loop.py`` for the families the port has
(``ssm``; the rest raise through :func:`repro_torch.models.get_model`).
The steps take the model module where the JAX steps take ``params``, and
run under ``torch.inference_mode()``.  ``dtype`` is the activation dtype
(bf16, the JAX default).  The dry-run ``ShapeDtypeStruct`` spec
functions (``input_specs``, ``cache_specs``) wait for the port of
``launch/``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model


def make_serve_step(cfg: ModelConfig, *, dtype=torch.bfloat16):
    model = get_model(cfg)

    def serve_step(module, tokens, cache, pos):
        with torch.inference_mode():
            return model.decode_step(module, tokens, cache, pos, cfg,
                                     dtype=dtype)
    return serve_step


def make_prefill_step(cfg: ModelConfig, *, dtype=torch.bfloat16):
    model = get_model(cfg)

    def prefill_step(module, tokens, cache):
        with torch.inference_mode():
            return model.prefill(module, tokens, cache, cfg, dtype=dtype)
    return prefill_step
