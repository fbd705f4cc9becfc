"""PaliGemma-style VLM backbone (arXiv:2407.07726), in PyTorch.

Port of ``repro/models/vlm.py``.  The SigLIP vision frontend is a STUB, as
in the JAX package: the caller provides precomputed patch embeddings
(B, frontend_seq, d_model), prepended to the text-token embeddings
through the transformer's ``extra_embeds`` hook.  Attention is causal
over all positions (the JAX package's approximation of prefix-LM
attention; decode behaves the same).  Reuses the transformer stack.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

init = T.init
init_cache = T.init_cache
decode_step = T.decode_step


def forward(model: T.Transformer, tokens, patches, cfg: ModelConfig, *,
            remat: str = "none", dtype=torch.bfloat16):
    """patches: (B, frontend_seq, d) precomputed patch embeddings (stub)."""
    return T.forward(model, tokens, cfg, remat=remat, dtype=dtype,
                     extra_embeds=patches)


def prefill(model: T.Transformer, tokens, patches, cache, cfg: ModelConfig,
            *, dtype=torch.bfloat16):
    return T.prefill(model, tokens, cache, cfg, dtype=dtype,
                     extra_embeds=patches)
