"""Latent Diffusion Transformer (DiT, arXiv:2212.09748):
``repro/models/dit.py`` in PyTorch.

adaLN-Zero blocks with self-attention over latent tokens and
cross-attention to text conditioning (PixArt-style).  Every LN/modulate
and gated-residual site goes through the fused adaLN kernel, every
attention through the flash-attention kernel, and a §11 cache hit through
the splice-attention kernel (:mod:`repro_torch.kernels.ops`).  Two
forwards: ``forward_sp_tokens`` (the serving path, a token shard under
sequence parallelism, gathering K/V between projection and attention)
and ``forward`` (the whole latent through ``dit_block_apply``, bf16 by
default, with ``remat``; the flow-matching trainer's).  K1 and K2
differentiate through their backward kernels, so ``forward`` trains on
the card.

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
from repro_torch.models.layers import pspec, pzeros, resolve_device
from repro_torch.sharding import constrain
from repro_torch.sharding.ctx import product

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


def _pos_freqs(half: int) -> torch.Tensor:
    """``pos_embedding``'s frequencies, always computed on the host, so
    the card and the CPU use bit-equal ones: two backends' ``exp``
    differ by one ulp on some entries, and the phase ``pos * freq``
    multiplies that by the position (up to 75,600 for a 720p video)."""
    return torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32) / half)


def _sincos(n_tokens: int, freqs):
    pos = torch.arange(n_tokens, dtype=torch.float32, device=freqs.device)
    args = pos[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def pos_embedding(n_tokens: int, dim: int, device=None):
    """1D sincos position embedding over flattened latent tokens, with
    the frequencies from the host (:func:`_pos_freqs`)."""
    return _sincos(n_tokens, _pos_freqs(dim // 2).to(device))


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
    """silu(c) @ w + b split into ``n`` contiguous (B, D) pieces (a
    product of batch rows, which the product rule leaves to cuBLAS)."""
    mods = product(F.silu(c), w.to(c.dtype)) + b.to(c.dtype)
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
        self.ada_w = pzeros((d, 6 * d), ("embed", "mlp"), device)
        self.ada_b = pzeros((6 * d,), (None,), device)


class DiT(nn.Module):
    """``dit.init``: weights drawn from ``generator`` at cfg's shapes."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        dc = cfg.dit
        d = cfg.d_model
        patch_in = dc.patch_size * dc.patch_size * dc.in_channels
        self.x_embed = pspec((patch_in, d), (None, "embed"), generator,
                             device)
        self.t_mlp1 = pspec((256, d), (None, "embed"), generator, device)
        self.t_mlp2 = pspec((d, d), ("embed", "embed"), generator, device)
        self.txt_proj = pspec((dc.cond_dim, d), (None, "embed"), generator,
                              device)
        self.blocks = nn.ModuleList(
            DiTBlock(cfg, generator=generator, device=device)
            for _ in range(cfg.num_layers))
        self.final_ada_w = pzeros((d, 2 * d), ("embed", "mlp"), device)
        self.final_ada_b = pzeros((2 * d,), (None,), device)
        self.final_out = pzeros((d, patch_in), ("embed", None), device)
        # on the device with the weights: copying them from pageable
        # memory at every forward would wait for the stream that every
        # rank thread shares
        self.register_buffer("pos_freqs", _pos_freqs(d // 2).to(device),
                             persistent=False)


def liven_adaln(model: DiT, d_model: int, *, seed: int = 123,
                scale: float = 0.05) -> None:
    """Small seeded draws, in place, for a DiT's zero-initialised adaLN
    modulation (``ada_w``, ``ada_b``, ``final_ada_*``) and output head
    (``final_out``).  At the JAX init they are zero (adaLN-Zero), so every
    attention and adaLN branch is gated off and gets a zero upstream
    gradient.  The draws come from a ``torch.Generator`` on the model's
    device, scaled by (128 / d_model)^1/2 so that the modulation keeps
    the size it has at the reduced width (d_model 128)."""
    device = model.final_out.device
    scale = scale * math.sqrt(128 / d_model)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = [p for blk in model.blocks for p in (blk.ada_w, blk.ada_b)]
    params += [model.final_ada_w, model.final_ada_b, model.final_out]
    with torch.no_grad():
        for p in params:
            p.copy_(scale * torch.randn(p.shape, generator=gen,
                                        device=device))


def init(cfg: ModelConfig, *, generator=None, device=None) -> DiT:
    """``dit.init``: a DiT at cfg's shapes on ``device`` (the card by
    default), weights from ``generator`` (seed 0 by default)."""
    device = resolve_device(device)
    if generator is None:
        generator = L.default_generator(device)
    return DiT(cfg, generator=generator, device=device)


def dit_block_apply(p: DiTBlock, x, c, txt, cfg: ModelConfig):
    """x: (B, N, D) latent tokens; c: (B, D) adaLN cond; txt: (B, Lt, D)."""
    sh_a, sc_a, g_a, sh_m, sc_m, g_m = _split_mods(c, p.ada_w, p.ada_b, 6)
    h = _mod_norm(x, sh_a, sc_a)
    attn, _ = L.attention_apply(p.attn, h, cfg, causal=False, use_rope=False)
    x = _gated_residual(x, g_a, attn)

    # cross-attention to text conditioning (not modulated, PixArt-style)
    h = _mod_norm(x)
    ca, _ = L.attention_apply(p.cross, h, cfg, causal=False, kv_x=txt,
                              use_rope=False)
    x = x + ca

    h = _mod_norm(x, sh_m, sc_m)
    return _gated_residual(x, g_m, L.swiglu_apply(p.mlp, h))


def forward(model: DiT, latents, t, txt_embeds, cfg: ModelConfig, *,
            dtype=torch.bfloat16, remat: str = "none"):
    """Denoiser forward: predicts velocity/noise for latent input.

    latents: (B, F, H, W, C); t: (B,) timesteps; txt_embeds:
    (B, Lt, cond_dim).  Returns (B, F, H, W, C) fp32.  The timestep path
    runs in fp32 against weights cast to ``dtype``, as JAX's promotion
    of an fp32 einsum with a bf16 operand does.  ``remat="full"``
    recomputes each block in the backward (JAX's ``jax.checkpoint`` of
    the scan body; other values, as in JAX, recompute nothing).
    """
    dc = cfg.dit
    shape = latents.shape
    x = patchify(latents, dc.patch_size).to(dtype) @ model.x_embed.to(dtype)
    x = x + _sincos(x.shape[1], model.pos_freqs).to(dtype)[None]

    t_emb = timestep_embedding(t, 256)
    c = t_emb @ model.t_mlp1.to(dtype).float()
    c = F.silu(c) @ model.t_mlp2.to(dtype).float()
    txt = txt_embeds.to(dtype) @ model.txt_proj.to(dtype)
    # keep the conditioning in compute dtype, as JAX's scan carry
    c = (c + txt.mean(dim=1)).to(dtype)

    block = L.remat(dit_block_apply, "full" if remat == "full" else "none")
    for blk in model.blocks:
        x = constrain(x, "act_batch", "act_seq", None)
        x = block(blk, x, c, txt, cfg)

    sh, sc = _split_mods(c, model.final_ada_w, model.final_ada_b, 2)
    x = _mod_norm(x, sh, sc) @ model.final_out.to(dtype)
    return unpatchify(x.float(), shape, dc.patch_size)


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


def latent_shape(cfg: ModelConfig, height: int, width: int,
                 frames: int = 0) -> tuple[int, int, int, int]:
    """(F, H_lat, W_lat, C) for a pixel-space request (8x VAE downsample)."""
    dc = cfg.dit
    f = frames if frames else dc.latent_frames
    # video VAE: 4x temporal downsample (Wan-style), 8x spatial
    f_lat = max(1, (f + 3) // 4) if f > 1 else 1
    return (f_lat, height // 8, width // 8, dc.in_channels)


def token_count(cfg: ModelConfig, height: int, width: int,
                frames: int = 0) -> int:
    f, h, w, c = latent_shape(cfg, height, width, frames)
    p = cfg.dit.patch_size
    return f * (h // p) * (w // p)


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
    (B, N_local, patch_dim).  Every product goes through
    ``sharding.ctx.product``: in fp32 on the card the token rows' (the
    patch embedding, q/k/v/o, cross q/o and the text's k/v, the MLP, the
    text projection and the output head) run the split-TF32 kernel, the
    timestep MLP's and the modulations' batch rows cuBLAS.
    """
    x = product(tok_shard.to(dtype), model.x_embed.to(dtype))
    pe = _sincos(n_total, model.pos_freqs).to(dtype)
    x = x + pe[pos_offset:pos_offset + x.shape[1]][None]

    t_emb = timestep_embedding(t, 256)
    c = product(t_emb, model.t_mlp1.to(dtype))
    c = product(F.silu(c), model.t_mlp2.to(dtype))
    txt = product(txt_embeds.to(dtype), model.txt_proj.to(dtype))
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
        ca, _ = L.attention_apply(blk.cross, h, cfg, causal=False, kv_x=txt,
                                  use_rope=False)
        x = x + ca

        h = _mod_norm(x, sh_m, sc_m)
        x = _gated_residual(x, g_m, L.swiglu_apply(blk.mlp, h))

    sh, sc = _split_mods(c, model.final_ada_w, model.final_ada_b, 2)
    x = _mod_norm(x, sh, sc)
    return product(x, model.final_out.to(dtype))
