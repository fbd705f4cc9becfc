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
axis (without one, the plain cached decode, as in JAX).

The dry run's input specs (``input_specs``, ``cache_specs``) are
``meta`` tensors, the port's ``ShapeDtypeStruct``: shapes and dtypes,
no memory.  ``decode_*`` / ``long_*`` cells run :func:`make_serve_step`
(one new token against a seq_len-deep cache), ``prefill_*`` cells
:func:`make_prefill_step`, ``train_*`` cells the train step on
``train_loop.synth_batch(..., as_specs=True)``:
``python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
--mesh 2,2 --device cpu``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
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


# ---------------------------------------------------------------------------
# Abstract inputs (meta tensors, no allocation) for the dry run
# ---------------------------------------------------------------------------

def _specs_of(tree):
    """``tree`` with each tensor leaf replaced by a ``meta`` tensor of its
    shape and dtype (nested dicts, lists and tuples; other leaves kept)."""
    if isinstance(tree, dict):
        return {k: _specs_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_specs_of(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16):
    """The family's ``init_cache`` on ``meta``."""
    return _lm(cfg).init_cache(cfg, batch, max_len, dtype=dtype,
                               device="meta")


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict[str, Any]:
    """``meta`` stand-ins for every model input of a dry-run cell, keyed
    by the step's argument names (the module excluded: the dry run
    builds it on ``meta``)."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        from repro_torch.training.train_loop import synth_batch
        return {"batch": synth_batch(cfg, b, s, as_specs=True)}

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    if cell.kind == "prefill":
        # the VLM prefill prepends frontend patch tokens: the text prompt
        # is seq_len - frontend_seq long, so the cache fills to seq_len
        s_txt = s - cfg.frontend_seq if cfg.family == "vlm" else s
        out: dict[str, Any] = {
            "tokens": spec((b, s_txt), torch.int32),
            "cache": cache_specs(cfg, b, _cache_len(cfg, cell)),
        }
        if cfg.family == "encdec":
            # prefill = audio-encoder forward (stub frames) + decoder prefill
            out["frames"] = spec((b, cfg.frontend_seq, cfg.d_model),
                                 torch.float32)
        if cfg.family == "vlm":
            out["patches"] = spec((b, cfg.frontend_seq, cfg.d_model),
                                  torch.float32)
        return out
    # decode: one new token, cache of depth seq_len
    return {
        "tokens": spec((b, 1), torch.int32),
        "cache": cache_specs(cfg, b, _cache_len(cfg, cell)),
        "pos": spec((b,), torch.int32),
    }


def _cache_len(cfg: ModelConfig, cell: ShapeCell) -> int:
    # prefill cells size the cache to hold the prompt; decode cells hold
    # seq_len of history
    return cell.seq_len
