"""Decoder-only LM covering the dense, MoE, MLA and SWA (local:global)
families, in PyTorch.

Port of ``repro/models/transformer.py``.  The JAX package scans its
layers (``jax.lax.scan``) over *super-blocks*, one parameter subtree per
position of the local:global period; here the stack is a ``ModuleList``
of super-blocks, each a ``ModuleDict`` of its ``pos{i}`` blocks, walked
by a Python loop, so :func:`repro_torch.convert.load_jax_params` loads
the JAX tree (``blocks`` stacked along a leading super-block axis) one
to one.  MoE configs keep their first ``num_dense_layers`` blocks dense
as ``dense_{i}`` before the stack (DeepSeek-V2 has one).  The caches
keep the JAX layout too: each leaf of ``cache["blocks"]["pos{i}"]``
carries a leading super-block axis, and the K/V (or, under MLA, latent
and rope-key) leaves are written in place
(:mod:`repro_torch.models.layers`).

The uncached forward's full attention goes through the flash-attention
kernel (causal); windowed layers, MLA (plain einsums in both packages),
prefill and decode run plain tensor ops, as the JAX model does.  Decode
steps run the MoE with exact capacity (no drops).  The forward takes
JAX's ``remat`` (``"none"``, ``"full"`` or ``"selective"``, per
super-block; :func:`repro_torch.models.layers.remat`).  Each super-block
starts with the JAX model's sharding constraint
(:func:`repro_torch.sharding.constrain`: ``x`` itself without a mesh).

Entry points build on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import MLA, SWA, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import resolve_device
from repro_torch.sharding import constrain


# ---------------------------------------------------------------------------
# Single transformer block
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """``block_init``: pre-norm attention (MLA where the config says) and
    a SwiGLU MLP, or with ``moe`` the MoE layer."""

    def __init__(self, cfg: ModelConfig, *, moe: bool, generator, device):
        super().__init__()
        kw = dict(generator=generator, device=device)
        self.ln_attn = L.rmsnorm_init(cfg.d_model, device)
        self.ln_mlp = L.rmsnorm_init(cfg.d_model, device)
        self.attn = (L.MLA(cfg, **kw) if cfg.attention == MLA
                     else L.Attention(cfg, **kw))
        if moe:
            self.moe = L.MoE(cfg, **kw)
        else:
            self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, **kw)


def block_apply(p: Block, x, cfg: ModelConfig, *, window: int, positions,
                cache=None, mla_absorbed: bool = False,
                moe_exact: bool = False, sp_decode: bool = False):
    """Returns (x, new_cache, aux_loss)."""
    h = L.rmsnorm(p.ln_attn, x, cfg.norm_eps)
    if cfg.attention == MLA:
        attn_out, new_cache = L.mla_apply(
            p.attn, h, cfg, positions=positions, cache=cache,
            absorbed=mla_absorbed)
    else:
        attn_out, new_cache = L.attention_apply(
            p.attn, h, cfg, causal=True, window=window, positions=positions,
            cache=cache, sp_decode=sp_decode)
    x = x + attn_out
    h = L.rmsnorm(p.ln_mlp, x, cfg.norm_eps)
    if hasattr(p, "moe"):
        mlp_out, aux = L.moe_apply(p.moe, h, cfg, exact=moe_exact)
    else:
        mlp_out = L.swiglu_apply(p.mlp, h)
        aux = torch.zeros((), device=x.device)
    return x + mlp_out, new_cache, aux


# ---------------------------------------------------------------------------
# Layer-stack plans: how blocks are grouped
# ---------------------------------------------------------------------------

def _stack_plan(cfg: ModelConfig) -> dict:
    """Describes the stack:
      {"period": p, "n_super": n, "windows": [w per position],
       "moe": [bool per position], "prefix_dense": int}
    """
    if cfg.local_global != (0, 0):
        lg_l, lg_g = cfg.local_global
        period = lg_l + lg_g
        assert cfg.num_layers % period == 0, "local:global must tile layers"
        windows = [cfg.window] * lg_l + [0] * lg_g
        return {"period": period, "n_super": cfg.num_layers // period,
                "windows": windows, "moe": [False] * period,
                "prefix_dense": 0}
    window = cfg.window if cfg.attention == SWA else 0
    if cfg.moe is not None:
        nd = cfg.moe.num_dense_layers
        return {"period": 1, "n_super": cfg.num_layers - nd,
                "windows": [window], "moe": [True], "prefix_dense": nd}
    return {"period": 1, "n_super": cfg.num_layers, "windows": [window],
            "moe": [False], "prefix_dense": 0}


class Transformer(nn.Module):
    """``init``: embedding, ``dense_{i}`` prefix blocks, the super-block
    stack and the final norm.  Weights are drawn from ``generator`` (one
    on ``device``; seed 0 by default)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = L.default_generator(device)
        plan = _stack_plan(cfg)
        kw = dict(generator=generator, device=device)
        self.embed = L.Embedding(cfg, **kw)
        self.ln_final = L.rmsnorm_init(cfg.d_model, device)
        for i in range(plan["prefix_dense"]):
            setattr(self, f"dense_{i}", Block(cfg, moe=False, **kw))
        self.blocks = nn.ModuleList(
            nn.ModuleDict({f"pos{pos}": Block(cfg, moe=plan["moe"][pos], **kw)
                           for pos in range(plan["period"])})
            for _ in range(plan["n_super"]))


def init(cfg: ModelConfig, *, generator=None, device=None) -> Transformer:
    return Transformer(cfg, generator=generator, device=device)


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def _block_cache(cfg: ModelConfig, batch: int, max_len: int, window: int,
                 dtype, device=None):
    device = resolve_device(device)
    if cfg.attention == MLA:
        m = cfg.mla
        return {
            "c": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                             device=device),
            "kr": torch.zeros((batch, max_len, 1, m.qk_rope_head_dim),
                              dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device),
        }
    size = min(window, max_len) if window else max_len
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, size, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, size, kv, hd), dtype=dtype, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    plan = _stack_plan(cfg)
    caches: dict[str, Any] = {}
    for i in range(plan["prefix_dense"]):
        caches[f"dense_{i}"] = _block_cache(
            cfg, batch, max_len, plan["windows"][0] if cfg.attention == SWA
            else 0, dtype, device)
    caches["blocks"] = {
        f"pos{pos}": L.stacked(_block_cache(cfg, batch, max_len,
                                          plan["windows"][pos], dtype,
                                          device), (plan["n_super"],))
        for pos in range(plan["period"])}
    return caches


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def _super_block(sup, x, cfg: ModelConfig, plan, positions):
    """One uncached super-block. Returns (x, aux)."""
    aux = torch.zeros((), device=x.device)
    x = constrain(x, "act_batch", "act_seq", None)
    for pos in range(plan["period"]):
        x, _, a = block_apply(sup[f"pos{pos}"], x, cfg,
                              window=plan["windows"][pos], positions=positions)
        aux = aux + a
    return x, aux


def _scan_blocks(model: Transformer, caches, x, cfg: ModelConfig, plan,
                 positions, mla_absorbed: bool = False,
                 moe_exact: bool = False, sp_decode: bool = False,
                 remat: str = "none"):
    """Walk the super-block stack. Returns (x, new_caches, aux_sum).
    Uncached (the forward), each super-block under ``remat``; cached
    (prefill, decode), each layer with its cache."""
    aux = torch.zeros((), device=x.device)
    if caches is None:
        fn = L.remat(_super_block, remat)
        for sup in model.blocks:
            x, a = fn(sup, x, cfg, plan, positions)
            aux = aux + a
        return x, None, aux
    lens = {f"pos{pos}": [] for pos in range(plan["period"])}
    for i, sup in enumerate(model.blocks):
        x = constrain(x, "act_batch", "act_seq", None)
        for pos in range(plan["period"]):
            key = f"pos{pos}"
            c = {k: v[i] for k, v in caches["blocks"][key].items()}
            x, nc, a = block_apply(sup[key], x, cfg,
                                   window=plan["windows"][pos],
                                   positions=positions, cache=c,
                                   mla_absorbed=mla_absorbed,
                                   moe_exact=moe_exact, sp_decode=sp_decode)
            aux = aux + a
            lens[key].append(nc["len"])
    # k/v (MLA: c/kr) were written in place through the per-layer views
    new = {key: {**caches["blocks"][key], "len": torch.stack(lens[key])}
           for key in lens}
    return x, new, aux


def _embed(model: Transformer, tokens, cfg: ModelConfig, dtype,
           extra_embeds):
    x = L.embed(model.embed, tokens, cfg, dtype)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(dtype), x], dim=1)
    return x


def forward(model: Transformer, tokens, cfg: ModelConfig, *,
            remat: str = "none", dtype=torch.bfloat16, extra_embeds=None):
    """Teacher-forced logits (B, S, V) in fp32, and the aux loss.

    ``extra_embeds``: optional (B, S_front, d) modality-frontend embeddings
    prepended to the token embeddings (the VLM's patch stub).
    """
    plan = _stack_plan(cfg)
    x = _embed(model, tokens, cfg, dtype, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux_total = torch.zeros((), device=x.device)
    for i in range(plan["prefix_dense"]):
        x, _, a = block_apply(getattr(model, f"dense_{i}"), x, cfg,
                              window=0, positions=positions)
        aux_total = aux_total + a
    x, _, aux = _scan_blocks(model, None, x, cfg, plan, positions,
                             remat=remat)
    x = L.rmsnorm(model.ln_final, x, cfg.norm_eps)
    return L.unembed(model.embed, x, cfg), aux_total + aux


def prefill(model: Transformer, tokens, cache, cfg: ModelConfig, *,
            dtype=torch.bfloat16, extra_embeds=None):
    """Run the full sequence, filling ``cache``. Returns (logits of the
    last position (B, 1, V), cache)."""
    plan = _stack_plan(cfg)
    x = _embed(model, tokens, cfg, dtype, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    new_caches: dict[str, Any] = {}
    for i in range(plan["prefix_dense"]):
        x, nc, _ = block_apply(getattr(model, f"dense_{i}"), x, cfg,
                               window=0, positions=positions,
                               cache=cache[f"dense_{i}"])
        new_caches[f"dense_{i}"] = nc
    x, new_caches["blocks"], _ = _scan_blocks(model, cache, x, cfg, plan,
                                              positions)
    x = L.rmsnorm(model.ln_final, x, cfg.norm_eps)
    return L.unembed(model.embed, x[:, -1:], cfg), new_caches


def decode_step(model: Transformer, tokens, cache, pos, cfg: ModelConfig, *,
                dtype=torch.bfloat16, mla_absorbed: bool = False,
                sp_decode: bool = False):
    """One decode step. tokens (B, 1); pos (B,) absolute positions.  The
    MoE runs with exact capacity; ``mla_absorbed`` picks MLA's absorbed
    decode.

    Returns (logits (B, 1, V), cache)."""
    plan = _stack_plan(cfg)
    x = L.embed(model.embed, tokens, cfg, dtype)
    positions = pos[:, None]
    new_caches: dict[str, Any] = {}
    for i in range(plan["prefix_dense"]):
        x, nc, _ = block_apply(getattr(model, f"dense_{i}"), x, cfg,
                               window=0, positions=positions,
                               cache=cache[f"dense_{i}"],
                               mla_absorbed=mla_absorbed, sp_decode=sp_decode)
        new_caches[f"dense_{i}"] = nc
    x, new_caches["blocks"], _ = _scan_blocks(
        model, cache, x, cfg, plan, positions, mla_absorbed=mla_absorbed,
        moe_exact=True, sp_decode=sp_decode)
    x = L.rmsnorm(model.ln_final, x, cfg.norm_eps)
    return L.unembed(model.embed, x, cfg), new_caches
