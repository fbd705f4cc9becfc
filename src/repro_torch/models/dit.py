"""Latent Diffusion Transformer (DiT, arXiv:2212.09748): the serving
path of ``repro/models/dit.py`` in PyTorch.

adaLN-Zero blocks with self-attention over latent tokens and
cross-attention to text conditioning (PixArt-style).  Every LN/modulate
and gated-residual site goes through the fused adaLN kernel, every
attention through the flash-attention kernel, and a §11 cache hit through
the splice-attention kernel (:mod:`repro_torch.kernels.ops`).

Token layout: latents (B, F, H, W, C) -> patchify p x p spatial ->
(B, F*(H/p)*(W/p), p*p*C) -> linear embed -> N tokens.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.layers import pspec, pzeros

# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep embedding. t: (B,) float in [0, 1000]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def pos_embedding(n_tokens: int, dim: int, device=None):
    """1D sincos position embedding over flattened latent tokens."""
    pos = torch.arange(n_tokens, dtype=torch.float32, device=device)
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=device) / half)
    args = pos[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ---------------------------------------------------------------------------
# adaLN-Zero modulate, always through the fused kernel
# ---------------------------------------------------------------------------

def _mod_norm(x, shift=None, scale=None):
    """LN (+ shift/scale modulate) in one fused pass."""
    return ops.fused_adaln(x, shift, scale)


def _gated_residual(residual, gate, branch):
    """residual + gate[:, None] * branch in one fused pass."""
    return ops.fused_adaln(branch, gate=gate, residual=residual, ln=False)


def _split_mods(c, w, b, n: int):
    """silu(c) @ w + b split into ``n`` contiguous (B, D) pieces."""
    mods = F.silu(c) @ w.to(c.dtype) + b.to(c.dtype)
    return [m.contiguous() for m in mods.chunk(n, dim=-1)]


# ---------------------------------------------------------------------------
# Parameters (the JAX tree: blocks.{i}.attn.wq, ..., final_out)
# ---------------------------------------------------------------------------

class DiTBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        d = cfg.d_model
        self.attn = L.Attention(cfg, generator=generator, device=device)
        self.cross = L.Attention(cfg, generator=generator, device=device)
        self.mlp = L.SwiGLU(d, cfg.d_ff, generator=generator, device=device)
        # adaLN-Zero: 6*d modulation from conditioning; zero-init output
        self.ada_w = pzeros((d, 6 * d), device)
        self.ada_b = pzeros((6 * d,), device)


class DiT(nn.Module):
    """``dit.init``: weights drawn from ``generator`` at cfg's shapes."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        dc = cfg.dit
        d = cfg.d_model
        patch_in = dc.patch_size * dc.patch_size * dc.in_channels
        self.x_embed = pspec((patch_in, d), generator, device)
        self.t_mlp1 = pspec((256, d), generator, device)
        self.t_mlp2 = pspec((d, d), generator, device)
        self.txt_proj = pspec((dc.cond_dim, d), generator, device)
        self.blocks = nn.ModuleList(
            DiTBlock(cfg, generator=generator, device=device)
            for _ in range(cfg.num_layers))
        self.final_ada_w = pzeros((d, 2 * d), device)
        self.final_ada_b = pzeros((2 * d,), device)
        self.final_out = pzeros((d, patch_in), device)


def patchify(latents, patch: int):
    """(B, F, H, W, C) -> (B, F*(H/p)*(W/p), p*p*C)."""
    b, f, h, w, c = latents.shape
    x = latents.reshape(b, f, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, f * (h // patch) * (w // patch), patch * patch * c)


def unpatchify(tokens, shape, patch: int):
    b, f, h, w, c = shape
    x = tokens.reshape(b, f, h // patch, w // patch, patch, patch, c)
    x = x.permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, f, h, w, c)


# ---------------------------------------------------------------------------
# Sequence-parallel forward (paper's SP layout, executed over GFC)
# ---------------------------------------------------------------------------

def forward_sp_tokens(model: DiT, tok_shard, t, txt_embeds, cfg: ModelConfig,
                      *, pos_offset: int, n_total: int, kv_gather,
                      dtype=torch.float32):
    """Denoiser forward over a TOKEN SHARD under sequence parallelism.

    tok_shard: (B, N_local, patch_dim) — this rank's patchified tokens.
    kv_gather(k, v, layer) -> (K, V) gathers key/value over the token axis
    across the execution group (identity at SP1), or returns a
    :class:`ops.SplicedKV` on a §11 cache hit, which the splice kernel
    attends over without materializing the spliced K/V.

    Returns the velocity prediction for the local token shard
    (B, N_local, patch_dim).
    """
    x = tok_shard.to(dtype) @ model.x_embed.to(dtype)
    pe = pos_embedding(n_total, cfg.d_model, x.device).to(dtype)
    x = x + pe[pos_offset:pos_offset + x.shape[1]][None]

    t_emb = timestep_embedding(t, 256)
    c = t_emb @ model.t_mlp1.to(dtype)
    c = F.silu(c) @ model.t_mlp2.to(dtype)
    txt = txt_embeds.to(dtype) @ model.txt_proj.to(dtype)
    c = c + txt.mean(dim=1)

    for i, blk in enumerate(model.blocks):
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = _split_mods(c, blk.ada_w,
                                                       blk.ada_b, 6)
        h = _mod_norm(x, sh_a, sc_a)
        ap = blk.attn
        q, k, v = L.project(h, ap.wq), L.project(h, ap.wk), L.project(h, ap.wv)
        kv = kv_gather(k, v, i)                     # GFC all-gather (axis=1)
        if isinstance(kv, ops.SplicedKV):           # §11 hit, fused splice
            attn = ops.splice_attention(q, kv.k_stale, kv.v_stale,
                                        kv.k_fresh, kv.v_fresh,
                                        offset=kv.offset)
        else:                                       # sharded-Q / full-KV
            attn = ops.attention(q, *kv, causal=False)
        x = _gated_residual(x, g_a, L.project_out(attn, ap.wo))

        h = _mod_norm(x)
        x = x + L.attention_apply(blk.cross, h, cfg, causal=False, kv_x=txt,
                                  use_rope=False)

        h = _mod_norm(x, sh_m, sc_m)
        x = _gated_residual(x, g_m, L.swiglu_apply(blk.mlp, h))

    sh, sc = _split_mods(c, model.final_ada_w, model.final_ada_b, 2)
    x = _mod_norm(x, sh, sc)
    return x @ model.final_out.to(dtype)
