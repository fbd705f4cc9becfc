"""Plain PyTorch DiT denoiser forward: the benchmark's frozen copy of the
diffusion transformer the port serves (adaLN-Zero blocks, self-attention
over latent tokens, cross-attention to the text embeddings, SwiGLU), in
float32, with no kernels, no cache and no batching.

Parameters are a dict of tensors named as :func:`param_specs` lists
them.  ``sizes`` is the ``model`` section of a configuration file.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.arith import Arith

#: bytes of one block of attention scores (rows are split to stay under it)
SCORE_BLOCK_BYTES = 1 << 30


def param_specs(sizes: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """name -> (shape, init) of the denoiser's parameters.  ``init`` is
    ``fan_in`` (normal, std fan_in^-1/2 over all leading axes) or
    ``zeros``; the adaLN modulation weights are drawn like any product's
    (adaLN-Zero's zeros would gate every block off)."""
    d, h, kv, hd = (sizes["d_model"], sizes["num_heads"],
                    sizes["num_kv_heads"], sizes["head_dim"])
    ff, cond = sizes["d_ff"], sizes["cond_dim"]
    pd = sizes["patch_size"] ** 2 * sizes["in_channels"]
    specs = {"x_embed": ((pd, d), "fan_in"), "t_mlp1": ((256, d), "fan_in"),
             "t_mlp2": ((d, d), "fan_in"), "txt_proj": ((cond, d), "fan_in")}
    for i in range(sizes["num_layers"]):
        p = f"blocks.{i}."
        for a in ("attn", "cross"):
            specs[p + a + ".wq"] = ((d, h, hd), "fan_in")
            specs[p + a + ".wk"] = ((d, kv, hd), "fan_in")
            specs[p + a + ".wv"] = ((d, kv, hd), "fan_in")
            specs[p + a + ".wo"] = ((h, hd, d), "fan_in")
        specs[p + "mlp.w_gate"] = ((d, ff), "fan_in")
        specs[p + "mlp.w_up"] = ((d, ff), "fan_in")
        specs[p + "mlp.w_down"] = ((ff, d), "fan_in")
        specs[p + "ada_w"] = ((d, 6 * d), "fan_in")
        specs[p + "ada_b"] = ((6 * d,), "zeros")
    specs["final_ada_w"] = ((d, 2 * d), "fan_in")
    specs["final_ada_b"] = ((2 * d,), "zeros")
    specs["final_out"] = ((d, pd), "fan_in")
    return specs


def layer_norm(x, eps: float = 1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def modulate(x, shift, scale):
    return layer_norm(x) * (1.0 + scale[:, None]) + shift[:, None]


def attention(q, k, v, ar: Arith):
    """softmax(q k^T / sqrt(d)) v over (B, S, H, d) tensors, the scores
    materialised in blocks of query rows."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    rows = max(1, SCORE_BLOCK_BYTES // (4 * h * sk))
    kt = k.permute(0, 2, 3, 1)                       # (B, H, d, Sk)
    vt = v.permute(0, 2, 1, 3)                       # (B, H, Sk, d)
    out = torch.empty_like(q)
    for i in range(0, sq, rows):
        qb = q[:, i:i + rows].permute(0, 2, 1, 3)    # (B, H, r, d)
        p = torch.softmax(ar.mm(qb, kt) * d ** -0.5, dim=-1)
        out[:, i:i + rows] = ar.mm(p, vt).permute(0, 2, 1, 3)
    return out


def project(x, w, ar: Arith):
    """(B, S, d) x (d, H, hd) -> (B, S, H, hd)."""
    return ar.mm(x, w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], *w.shape[1:])


def project_out(a, w, ar: Arith):
    """(B, S, H, hd) x (H, hd, d) -> (B, S, d)."""
    return ar.mm(a.flatten(-2), w.reshape(-1, w.shape[-1]))


def timestep_embedding(t, dim: int = 256, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def pos_embedding(n_tokens: int, dim: int, device):
    """1D sincos embedding of the flattened token positions; the
    frequencies are computed on the host."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32) / half)
    args = (torch.arange(n_tokens, dtype=torch.float32, device=device)[:, None]
            * freqs.to(device)[None])
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def forward(params: dict, tokens, t, txt_embeds, sizes: dict,
            ar: Arith = Arith()):
    """Velocity for patchified latent tokens.

    tokens: (B, N, patch_dim); t: (B,) timesteps in [0, 1000];
    txt_embeds: (B, Lt, cond_dim).  Returns (B, N, patch_dim)."""
    P = params
    x = ar.mm(tokens.float(), P["x_embed"])
    x = x + pos_embedding(x.shape[1], x.shape[2], x.device)[None]
    c = ar.mm(timestep_embedding(t), P["t_mlp1"])
    c = ar.mm(F.silu(c), P["t_mlp2"])
    txt = ar.mm(txt_embeds.float(), P["txt_proj"])
    c = c + txt.mean(dim=1)
    sc = F.silu(c)
    for i in range(sizes["num_layers"]):
        p = f"blocks.{i}."
        mods = ar.mm(sc, P[p + "ada_w"]) + P[p + "ada_b"]
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = mods.chunk(6, dim=-1)
        h = modulate(x, sh_a, sc_a)
        q = project(h, P[p + "attn.wq"], ar)
        k = project(h, P[p + "attn.wk"], ar)
        v = project(h, P[p + "attn.wv"], ar)
        a = attention(q, _kv_heads(k, q), _kv_heads(v, q), ar)
        x = x + g_a[:, None] * project_out(a, P[p + "attn.wo"], ar)
        h = layer_norm(x)
        q = project(h, P[p + "cross.wq"], ar)
        k = project(txt, P[p + "cross.wk"], ar)
        v = project(txt, P[p + "cross.wv"], ar)
        a = attention(q, _kv_heads(k, q), _kv_heads(v, q), ar)
        x = x + project_out(a, P[p + "cross.wo"], ar)
        h = modulate(x, sh_m, sc_m)
        m = ar.mm(F.silu(ar.mm(h, P[p + "mlp.w_gate"]))
                  * ar.mm(h, P[p + "mlp.w_up"]), P[p + "mlp.w_down"])
        x = x + g_m[:, None] * m
    mods = ar.mm(sc, P["final_ada_w"]) + P["final_ada_b"]
    sh, scale = mods.chunk(2, dim=-1)
    return ar.mm(modulate(x, sh, scale), P["final_out"])


def _kv_heads(k, q):
    """k's heads repeated over their query group (GQA)."""
    rep = q.shape[2] // k.shape[2]
    return k if rep == 1 else torch.repeat_interleave(k, rep, dim=2)


def patchify(latents, patch: int):
    """(B, F, H, W, C) -> (B, F*(H/p)*(W/p), p*p*C)."""
    b, f, h, w, c = latents.shape
    x = latents.reshape(b, f, h // patch, patch, w // patch, patch, c)
    return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(
        b, f * (h // patch) * (w // patch), patch * patch * c)


def unpatchify(tokens, shape, patch: int):
    """(B, N, p*p*C) -> (B, F, H, W, C) of ``shape``."""
    b, f, h, w, c = shape
    x = tokens.reshape(b, f, h // patch, w // patch, patch, patch, c)
    return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, f, h, w, c)
