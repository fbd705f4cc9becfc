"""Mamba2 (state-space duality) blocks — arXiv:2405.21060, in PyTorch.

Port of ``repro/models/ssm.py``.  Prefill and forward run the chunked SSD
through the K4 kernel wrapper :func:`repro_torch.kernels.ops.ssd` (its
sequential plain version for CPU tensors) in place of the JAX package's
jnp twin ``ssd_chunked``; single-token decode is plain torch, as in JAX.
Parameters keep the JAX tree's names and layouts (``blocks`` stacked
along a leading layer axis there, a ``ModuleList`` here), so
:func:`repro_torch.convert.load_jax_params` loads ``ssm.init``'s tree.
The cache keeps the JAX layout too: each leaf carries a leading layer
axis.  ``SSMConfig.head_block`` and ``ModelConfig.scan_unroll`` size the
JAX working set and its compile; the port ignores them.

Entry points build on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.layers import (pones, pspec, pzeros,
                                       resolve_device)
from repro_torch.sharding import constrain
from repro_torch.sharding.ctx import product

_INTRA_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def ssm_dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = s.num_heads or (d_inner // s.head_dim)
    conv_dim = d_inner + 2 * s.state_dim
    return d_inner, nheads, conv_dim


class SSDBlock(nn.Module):
    """``ssd_block_init``: one Mamba2 block's parameters."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        d_inner, nheads, conv_dim = ssm_dims(cfg)
        proj_out = 2 * d_inner + 2 * s.state_dim + nheads   # z, x, B, C, dt
        self.ln = L.rmsnorm_init(d, device)
        self.in_proj = pspec((d, proj_out), ("embed", "ssm_inner"),
                             generator, device)
        self.conv_w = pspec((s.conv_kernel, conv_dim), (None, "ssm_inner"),
                            generator, device, scale=s.conv_kernel ** -0.5)
        self.conv_b = pzeros((conv_dim,), ("ssm_inner",), device)
        self.A_log = pzeros((nheads,), (None,), device)     # A = -exp(A_log)
        self.dt_bias = pzeros((nheads,), (None,), device)
        self.D = pones((nheads,), (None,), device)
        self.norm = L.rmsnorm_init(d_inner, device)
        self.out_proj = pspec((d_inner, d), ("ssm_inner", "embed"),
                              generator, device)


def _split_proj(zxbcdt, cfg: ModelConfig):
    s = cfg.ssm
    d_inner, nheads, _ = ssm_dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner, s.state_dim, s.state_dim,
                                nheads], dim=-1)


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d, then SiLU. x: (B, S, C); w: (K, C).

    ``state``: (B, K-1, C) trailing context for decode; returns new state.
    """
    k = w.shape[0]
    if state is None:
        pad = torch.zeros_like(x[:, :k - 1])
        xp = torch.cat([pad, x], dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b
    # a copy, not a view: a view of the tail would keep all of xp alive in
    # the cache (71 MB a layer at mamba2-1.3b's full-width prefill)
    new_state = xp[:, -(k - 1):].clone() if k > 1 else None
    return F.silu(out), new_state


def ssd_decode_step(x, dt, A, B, C, state):
    """Single-token SSD update.  x: (b,1,h,p); state: (b,h,p,n)."""
    dA = torch.exp(dt[:, 0, :, None, None] * A[None, :, None, None])
    dBx = torch.einsum("bn,bhp->bhpn", B[:, 0], x[:, 0] * dt[:, 0, :, None])
    state = state * dA + dBx
    y = torch.einsum("bn,bhpn->bhp", C[:, 0], state)
    return y[:, None], state


def ssd_block_apply(p: SSDBlock, x_in, cfg: ModelConfig, cache=None):
    """One Mamba2 block (pre-norm, gated). Returns (out, new_cache)."""
    s = cfg.ssm
    d_inner, nheads, _ = ssm_dims(cfg)
    h = L.rmsnorm(p.ln, x_in, cfg.norm_eps)
    zxbcdt = product(h, p.in_proj.to(h.dtype))
    z, x, B, C, dt = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([x, B, C], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    conv_out, new_conv_state = _causal_conv(
        conv_in, p.conv_w.to(h.dtype), p.conv_b.to(h.dtype), conv_state)
    x, B, C = torch.split(conv_out, [d_inner, s.state_dim, s.state_dim],
                          dim=-1)
    b, l, _ = x.shape
    x = x.reshape(b, l, nheads, -1)
    dt = F.softplus(dt.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())

    if cache is not None and l == 1:                        # decode
        y, new_state = ssd_decode_step(x.float(), dt, A, B.float(),
                                       C.float(), cache["state"])
    else:                          # prefill; K4 masks a ragged last chunk
        cdt = _INTRA_DTYPES[s.intra_dtype]
        y, new_state = ops.ssd(
            x.to(cdt).contiguous(), dt.contiguous(), A,
            B.to(cdt).contiguous(), C.to(cdt).contiguous(), chunk=s.chunk)
        y = y.float()
    y = y + x.float() * p.D.float()[None, None, :, None]
    y = y.reshape(b, l, d_inner).to(x_in.dtype)
    y = L.rmsnorm(p.norm, y * F.silu(z), cfg.norm_eps)
    out = product(y, p.out_proj.to(x_in.dtype))
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv_state.to(cache["conv"].dtype),
                     "state": new_state,
                     "len": cache["len"] + l}
    return x_in + out, new_cache


def ssd_block_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                    device=None):
    s = cfg.ssm
    d_inner, nheads, conv_dim = ssm_dims(cfg)
    device = resolve_device(device)
    return {
        "conv": torch.zeros((batch, s.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, nheads, s.head_dim, s.state_dim),
                             dtype=torch.float32, device=device),
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# Full Mamba2 LM
# ---------------------------------------------------------------------------

class Mamba2(nn.Module):
    """``init``: embedding, the SSD blocks and the final norm.  Weights
    are drawn from ``generator`` (one on ``device``; seed 0 by default)."""

    def __init__(self, cfg: ModelConfig, *, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = L.default_generator(device)
        self.embed = L.Embedding(cfg, generator=generator, device=device)
        self.blocks = nn.ModuleList(
            SSDBlock(cfg, generator=generator, device=device)
            for _ in range(cfg.num_layers))
        self.ln_final = L.rmsnorm_init(cfg.d_model, device)


def init(cfg: ModelConfig, *, generator=None, device=None) -> Mamba2:
    """The family's model (``ssm.init``): seed-0 weights on the card
    unless ``device`` or ``generator`` says otherwise."""
    return Mamba2(cfg, generator=generator, device=device)


def sample_dt_a(dt_shape, nheads: int, generator):
    """Mamba2's published ranges (state-spaces/mamba, ``mamba2.py``): dt
    log-uniform in [1e-3, 1e-1] and A = -U[1, 16], fp32 on the
    generator's device."""
    dev = generator.device
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(dt_shape, generator=generator,
                                                device=dev))
    A = -(1.0 + 15.0 * torch.rand((nheads,), generator=generator,
                                  device=dev))
    return dt, A


def init_published_a_dt(model: nn.Module, seed: int = 0) -> None:
    """Redraw ``dt_bias`` (through the inverse softplus) and ``A_log`` of
    every :class:`SSDBlock` in ``model`` (a Mamba2, a hybrid, ...), in
    module order, in Mamba2's published ranges (:func:`sample_dt_a`).
    The JAX init (both zero) gives every head A = -1 and dt near 0.7, so
    the state carried across a 128-token chunk underflows to zero and a
    run proves nothing about the carry."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in (m for m in model.modules() if isinstance(m, SSDBlock)):
            dt, A = sample_dt_a((blk.A_log.shape[0],), blk.A_log.shape[0], gen)
            blk.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            blk.A_log.copy_(torch.log(-A))


def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
               dtype=torch.bfloat16, device=None):
    return {"blocks": L.stacked(ssd_block_cache(cfg, batch, dtype, device),
                                (cfg.num_layers,))}


def _scan(model: Mamba2, caches, x, cfg: ModelConfig):
    """Every layer with its cache (prefill, decode)."""
    new = []
    for i, blk in enumerate(model.blocks):
        c_l = {k: v[i] for k, v in caches["blocks"].items()}
        x = constrain(x, "act_batch", "act_seq", None)
        x, nc = ssd_block_apply(blk, x, cfg, cache=c_l)
        new.append(nc)
    return x, {k: torch.stack([c[k] for c in new]) for k in new[0]}


def _block(blk, x, cfg: ModelConfig):
    return ssd_block_apply(blk, x, cfg)[0]


def forward(model: Mamba2, tokens, cfg: ModelConfig, *, remat: str = "none",
            dtype=torch.bfloat16):
    """Teacher-forced logits (b, s, vocab) in fp32, and the zero aux loss.
    ``remat="full"`` recomputes each layer in the backward (JAX's
    ``jax.checkpoint`` of the scan body), K4's forward among it; the
    SSD differentiates through K4's backward kernel (``ops.ssd_bwd``)."""
    x = L.embed(model.embed, tokens, cfg, dtype)
    fn = L.remat(_block, "full" if remat == "full" else "none")
    for blk in model.blocks:
        x = constrain(x, "act_batch", "act_seq", None)
        x = fn(blk, x, cfg)
    x = L.rmsnorm(model.ln_final, x, cfg.norm_eps)
    return L.unembed(model.embed, x, cfg), torch.zeros((), device=x.device)


def prefill(model: Mamba2, tokens, cache, cfg: ModelConfig, *,
            dtype=torch.bfloat16):
    x = L.embed(model.embed, tokens, cfg, dtype)
    x, new_caches = _scan(model, cache, x, cfg)
    x = L.rmsnorm(model.ln_final, x, cfg.norm_eps)
    return L.unembed(model.embed, x[:, -1:], cfg), {"blocks": new_caches}


def decode_step(model: Mamba2, tokens, cache, pos, cfg: ModelConfig, *,
                dtype=torch.bfloat16):
    x = L.embed(model.embed, tokens, cfg, dtype)
    x, new_caches = _scan(model, cache, x, cfg)
    x = L.rmsnorm(model.ln_final, x, cfg.norm_eps)
    return L.unembed(model.embed, x, cfg), {"blocks": new_caches}
