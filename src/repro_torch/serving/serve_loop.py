"""serve_step / prefill_step factories per architecture.

Port of ``repro/serving/serve_loop.py`` for every LM family (``dit``
has no prefill or decode step: its factories raise ``ValueError``; a DiT
request is served by ``repro_torch.serving.engine.ServingEngine``).  The steps take
the model module where the JAX steps take ``params``, and run under
``torch.inference_mode()``.  ``dtype`` is the activation dtype (bf16,
the JAX default).  ``mla_absorbed`` picks MLA's absorbed decode
(``dense``/``moe``/``vlm``), and ``sp_decode`` flash decoding over a
sequence-sharded cache under
:func:`repro_torch.sharding.activation_sharding` with a ``"model"``
axis (without one, the plain cached decode, as in JAX).  The dry-run
``ShapeDtypeStruct`` spec functions (``input_specs``, ``cache_specs``)
wait for the port of ``launch/dryrun.py``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model


def _lm(cfg: ModelConfig):
    if cfg.family == "dit":
        raise ValueError("the dit family has no prefill or decode step: a "
                         "DiT request is served by repro_torch.serving."
                         "engine.ServingEngine")
    return get_model(cfg)


def make_serve_step(cfg: ModelConfig, *, dtype=torch.bfloat16,
                    mla_absorbed: bool = False, sp_decode: bool = False):
    model = _lm(cfg)
    kw = {}
    if cfg.family in ("dense", "moe", "vlm"):
        kw = {"mla_absorbed": mla_absorbed, "sp_decode": sp_decode}

    def serve_step(module, tokens, cache, pos):
        with torch.inference_mode():
            return model.decode_step(module, tokens, cache, pos, cfg,
                                     dtype=dtype, **kw)
    return serve_step


def make_prefill_step(cfg: ModelConfig, *, dtype=torch.bfloat16):
    model = _lm(cfg)

    if cfg.family == "encdec":
        def prefill_step(module, tokens, frames, cache):
            with torch.inference_mode():
                return model.prefill(module, tokens, frames, cache, cfg,
                                     dtype=dtype)
    elif cfg.family == "vlm":
        def prefill_step(module, tokens, patches, cache):
            with torch.inference_mode():
                return model.prefill(module, tokens, patches, cache, cfg,
                                     dtype=dtype)
    else:
        def prefill_step(module, tokens, cache):
            with torch.inference_mode():
                return model.prefill(module, tokens, cache, cfg, dtype=dtype)
    return prefill_step
