"""Plain PyTorch text encoder: the benchmark's frozen copy of the small
bidirectional transformer that conditions the DiT (RMSNorm, rotary
self-attention, SwiGLU), in float32.  ``sizes`` is the ``text_encoder``
section of a configuration file."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.arith import Arith
from perfbench.reference.dit import attention, project, project_out


def param_specs(sizes: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """name -> (shape, init); ``unit`` is a unit normal (the token
    table), ``ones`` a norm's weight.  The untied output table is a
    parameter the encoder never reads; it is drawn all the same."""
    d, h, hd = sizes["d_model"], sizes["num_heads"], sizes["head_dim"]
    kv, ff, vocab = sizes["num_kv_heads"], sizes["d_ff"], sizes["vocab"]
    specs = {"embed.tok": ((vocab, d), "unit"),
             "embed.unembed": ((d, vocab), "fan_in")}
    for i in range(sizes["num_layers"]):
        p = f"blocks.{i}."
        specs[p + "ln_attn"] = ((d,), "ones")
        specs[p + "attn.wq"] = ((d, h, hd), "fan_in")
        specs[p + "attn.wk"] = ((d, kv, hd), "fan_in")
        specs[p + "attn.wv"] = ((d, kv, hd), "fan_in")
        specs[p + "attn.wo"] = ((h, hd, d), "fan_in")
        specs[p + "ln_mlp"] = ((d,), "ones")
        specs[p + "mlp.w_gate"] = ((d, ff), "fan_in")
        specs[p + "mlp.w_up"] = ((d, ff), "fan_in")
        specs[p + "mlp.w_down"] = ((ff, d), "fan_in")
    specs["ln_final"] = ((d,), "ones")
    return specs


def rmsnorm(w, x, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """Rotary embedding of (B, S, H, hd) at positions 0..S-1."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    ang = pos[..., None].float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def encode(params: dict, tokens, sizes: dict, ar: Arith = Arith()):
    """tokens: (B, Lt) int64 -> embeddings (B, Lt, d_model)."""
    P, eps, theta = params, sizes["norm_eps"], sizes["rope_theta"]
    x = P["embed.tok"][tokens]
    for i in range(sizes["num_layers"]):
        p = f"blocks.{i}."
        a = rmsnorm(P[p + "ln_attn"], x, eps)
        q = rope(project(a, P[p + "attn.wq"], ar), theta)
        k = rope(project(a, P[p + "attn.wk"], ar), theta)
        v = project(a, P[p + "attn.wv"], ar)
        rep = q.shape[2] // k.shape[2]
        if rep > 1:
            k = torch.repeat_interleave(k, rep, dim=2)
            v = torch.repeat_interleave(v, rep, dim=2)
        x = x + project_out(attention(q, k, v, ar), P[p + "attn.wo"], ar)
        m = rmsnorm(P[p + "ln_mlp"], x, eps)
        x = x + ar.mm(F.silu(ar.mm(m, P[p + "mlp.w_gate"]))
                      * ar.mm(m, P[p + "mlp.w_up"]), P[p + "mlp.w_down"])
    return rmsnorm(P["ln_final"], x, eps)
