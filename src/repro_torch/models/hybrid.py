"""Zamba2-style hybrid: a Mamba2 backbone plus one SHARED attention block
applied every ``shared_attn_every`` SSM layers, its parameters reused
(arXiv:2411.15242), in PyTorch.

Port of ``repro/models/hybrid.py``.  The JAX package scans groups of
(``shared_attn_every`` stacked Mamba2 layers + one shared-attention
application); here ``mamba_groups`` is a ``ModuleList`` of groups, each a
``ModuleList`` of :class:`repro_torch.models.ssm.SSDBlock`, so the JAX
tree's (n_groups, k, ...) leaves load one to one
(:func:`repro_torch.convert.load_jax_params`).  The Mamba2 layers are the
port's ``ssm.ssd_block_apply``, whose prefill and forward run K4; the
shared block is ``transformer.block_apply``, whose uncached forward runs
K2 causal.  Its KV caches are per application (stacked over groups,
written in place); remainder Mamba2 layers run at the tail.

Entry points build on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.layers import resolve_device
from repro_torch.sharding import constrain


def _group_plan(cfg: ModelConfig):
    k = cfg.shared_attn_every
    n_groups = cfg.num_layers // k
    tail = cfg.num_layers - n_groups * k
    return k, n_groups, tail


class Hybrid(nn.Module):
    """``init``: embedding, the Mamba2 groups, the shared attention block,
    the tail layers and the final norm.  Weights are drawn from
    ``generator`` (one on ``device``; seed 0 by default)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = L.default_generator(device)
        k, n_groups, tail = _group_plan(cfg)
        kw = dict(generator=generator, device=device)
        self.embed = L.Embedding(cfg, **kw)
        self.mamba_groups = nn.ModuleList(
            nn.ModuleList(S.SSDBlock(cfg, **kw) for _ in range(k))
            for _ in range(n_groups))
        self.shared_attn = T.Block(cfg, moe=False, **kw)
        self.ln_final = L.rmsnorm_init(cfg.d_model, device)
        for i in range(tail):
            setattr(self, f"tail_{i}", S.SSDBlock(cfg, **kw))


def init(cfg: ModelConfig, *, generator=None, device=None) -> Hybrid:
    return Hybrid(cfg, generator=generator, device=device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    k, n_groups, tail = _group_plan(cfg)
    ssm_one = S.ssd_block_cache(cfg, batch, dtype, device)
    attn_one = T._block_cache(cfg, batch, max_len, 0, dtype, device)
    cache: dict[str, Any] = {
        "mamba_groups": L.stacked(ssm_one, (n_groups, k)),
        "shared_kv": L.stacked(attn_one, (n_groups,)),
    }
    for i in range(tail):
        cache[f"tail_{i}"] = S.ssd_block_cache(cfg, batch, dtype, device)
    return cache


def _scan_groups(model: Hybrid, caches, x, cfg: ModelConfig, positions):
    """Each group's Mamba2 layers, then the shared block, with their
    caches.  Returns (x, (new Mamba2 caches, new shared K/V caches))."""
    m_new, a_lens = [], []
    for g, group in enumerate(model.mamba_groups):
        x = constrain(x, "act_batch", "act_seq", None)
        m_new.append([])
        for j, blk in enumerate(group):
            c = {key: v[g, j] for key, v in caches["mamba_groups"].items()}
            x, nc = S.ssd_block_apply(blk, x, cfg, cache=c)
            m_new[-1].append(nc)
        a_c = {key: v[g] for key, v in caches["shared_kv"].items()}
        x, nac, _ = T.block_apply(model.shared_attn, x, cfg, window=0,
                                  positions=positions, cache=a_c)
        a_lens.append(nac["len"])
    mamba = {key: torch.stack([torch.stack([c[key] for c in grp])
                               for grp in m_new])
             for key in m_new[0][0]}
    # the shared block's k/v were written in place through the views
    shared = {"k": caches["shared_kv"]["k"], "v": caches["shared_kv"]["v"],
              "len": torch.stack(a_lens)}
    return x, (mamba, shared)


def _apply_tail(model: Hybrid, caches, x, cfg: ModelConfig):
    _, _, tail = _group_plan(cfg)
    new = {}
    for i in range(tail):
        c = caches[f"tail_{i}"] if caches is not None else None
        x, nc = S.ssd_block_apply(getattr(model, f"tail_{i}"), x, cfg,
                                  cache=c)
        new[f"tail_{i}"] = nc
    return x, new


def _group(model: Hybrid, g: int, x, cfg: ModelConfig, positions):
    """One group's Mamba2 layers, then the shared block, uncached."""
    x = constrain(x, "act_batch", "act_seq", None)
    for blk in model.mamba_groups[g]:
        x, _ = S.ssd_block_apply(blk, x, cfg)
    return T.block_apply(model.shared_attn, x, cfg, window=0,
                         positions=positions)[0]


def forward(model: Hybrid, tokens, cfg: ModelConfig, *, remat: str = "none",
            dtype=torch.bfloat16):
    """Teacher-forced logits (b, s, vocab) in fp32, and the zero aux loss.
    ``remat="full"`` recomputes each group in the backward (JAX's
    ``jax.checkpoint`` of the group), K4's and K2's forwards among it; the
    SSD differentiates through K4's backward kernel (``ops.ssd_bwd``)."""
    x = L.embed(model.embed, tokens, cfg, dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    fn = L.remat(_group, "full" if remat == "full" else "none")
    for g in range(len(model.mamba_groups)):
        x = fn(model, g, x, cfg, positions)
    x, _ = _apply_tail(model, None, x, cfg)
    x = L.rmsnorm(model.ln_final, x, cfg.norm_eps)
    return L.unembed(model.embed, x, cfg), torch.zeros((), device=x.device)


def _step(model: Hybrid, x, cache, cfg: ModelConfig, positions):
    x, (mamba, shared) = _scan_groups(model, cache, x, cfg, positions)
    x, new_tail = _apply_tail(model, cache, x, cfg)
    x = L.rmsnorm(model.ln_final, x, cfg.norm_eps)
    return x, {"mamba_groups": mamba, "shared_kv": shared, **new_tail}


def prefill(model: Hybrid, tokens, cache, cfg: ModelConfig, *,
            dtype=torch.bfloat16):
    x = L.embed(model.embed, tokens, cfg, dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, new_cache = _step(model, x, cache, cfg, positions)
    return L.unembed(model.embed, x[:, -1:], cfg), new_cache


def decode_step(model: Hybrid, tokens, cache, pos, cfg: ModelConfig, *,
                dtype=torch.bfloat16):
    x = L.embed(model.embed, tokens, cfg, dtype)
    x, new_cache = _step(model, x, cache, cfg, pos[:, None])
    return L.unembed(model.embed, x, cfg), new_cache
