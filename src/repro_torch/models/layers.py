"""Shared model building blocks of ``repro/models/layers.py`` in
PyTorch: attention (full, cached, SWA ring, cross), MLA, SwiGLU, the
grouped capacity-buffer MoE and the embeddings, for the DiT serving path
and every LM family.

Parameters are ``nn.Module`` attributes named after the JAX tree keys and
kept in the JAX einsum layouts (``wq`` is (d, H, hd), ``wo`` is
(H, hd, d)), so :func:`repro_torch.convert.load_jax_params` copies a JAX
tree in without reshaping.  Each carries the JAX ``pspec``'s logical
sharding axes (``pspec``, ``pzeros``, ``pones`` take them beside the
shape; :func:`repro_torch.sharding.specs.param_axes` reads them), less
the leading ``"layers"`` axes of the JAX stacks, which the port
unrolls.  Full (uncached, unwindowed) attention always
goes through the flash-attention kernel wrapper
(:func:`repro_torch.kernels.ops.attention`); windowed and cached
attention run :func:`sdpa`'s plain tensor ops, as the JAX package runs
its jnp ``sdpa`` there.

Attention caches are written in place: a cached call stores the new
keys and values into ``cache["k"]``/``cache["v"]`` (index copies at
device-side positions, no host sync) and returns a cache that holds the
same tensors with ``len`` advanced.  The JAX package returns updated
copies; in place, a decode step does not copy every layer's cache.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.sharding.ctx import (current_mesh, grad_gathered,
                                     index_read, index_write, lookup,
                                     merged, per_rank, product, settled,
                                     split_last, split_ready, take,
                                     write_rows)
from repro_torch.sharding.sp import flash_decode
from repro_torch.sharding.specs import with_axes


def resolve_device(device) -> torch.device:
    """``device`` or, by default, the card; without CUDA the caller must
    ask for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the model on the CPU (the kernels' plain "
                           "versions)")
    return device


def default_generator(device: torch.device):
    """The seed-0 generator that a family's ``init`` draws its weights
    from by default, on ``device``; None on ``meta``, which has no
    generator (its tensors hold no values: the dry run's abstract
    model)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(0)


def _matmul_policy(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable``: keep the outputs of
    products without batch dimensions, recompute everything else."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    return torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, mode: str):
    """``fn`` under the JAX package's rematerialization ``mode``:
    ``"none"`` as is; ``"full"`` recomputed in the backward
    (``jax.checkpoint``: ``torch.utils.checkpoint``, non-reentrant);
    ``"selective"`` saving only the plain matmul outputs
    (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``).
    All three give the same values."""
    if mode == "none":
        return fn
    if mode == "full":
        return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                                 use_reentrant=False)
    if mode == "selective":
        ctx = functools.partial(
            torch.utils.checkpoint.create_selective_checkpoint_contexts,
            _matmul_policy)
        return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                                 use_reentrant=False, context_fn=ctx)
    raise ValueError(f"remat: unknown mode {mode!r}")


# ---------------------------------------------------------------------------
# Parameter creation (the JAX package's pspec / pzeros / pones)
# ---------------------------------------------------------------------------


def pspec(shape, axes, generator, device, scale=None) -> nn.Parameter:
    """Normal(0, scale) draw with logical sharding ``axes`` (one per
    dim); scale defaults to fan_in ** -0.5 with the JAX package's fan-in
    rule (all leading axes)."""
    if scale is None:
        fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
        scale = max(fan_in, 1) ** -0.5
    val = torch.randn(shape, generator=generator, device=device)
    return with_axes(nn.Parameter(scale * val, requires_grad=False), axes)


def pzeros(shape, axes, device) -> nn.Parameter:
    return with_axes(nn.Parameter(torch.zeros(shape, device=device),
                                  requires_grad=False), axes)


def pones(shape, axes, device) -> nn.Parameter:
    return with_axes(nn.Parameter(torch.ones(shape, device=device),
                                  requires_grad=False), axes)


def stacked(one: dict, lead: tuple) -> dict:
    """Each leaf of ``one`` repeated along new leading axes ``lead`` (a
    per-layer cache stacked in the JAX layout)."""
    return {k: v.expand(lead + v.shape).clone() for k, v in one.items()}


# ---------------------------------------------------------------------------
# Normalization and rotary embeddings
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, device) -> nn.Parameter:
    return pones((d,), ("embed",), device)


def rmsnorm(w, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    ang = positions[..., None].float() * freqs             # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def project(x, w):
    """(B, S, d) x (d, H, hd) -> contiguous (B, S, H, hd)."""
    w2 = merged(w.to(x.dtype).reshape(w.shape[0], -1), 1, w.shape[1])
    return split_last(product(x, w2), w.shape[1:])


def project_out(a, w):
    """(B, S, H, hd) x (H, hd, d) -> (B, S, d)."""
    return product(merged(a.flatten(-2), -1, a.shape[-2]),
                   merged(w.to(a.dtype).reshape(-1, w.shape[-1]), 0,
                           w.shape[0]))


class Attention(nn.Module):
    """Parameters of one attention layer (``attention_init``)."""

    def __init__(self, cfg: ModelConfig, d_model: int | None = None, *,
                 generator, device):
        super().__init__()
        d = d_model or cfg.d_model
        h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        self.wq = pspec((d, h, hd), ("embed", "heads", "head_dim"),
                        generator, device)
        self.wk = pspec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                        generator, device)
        self.wv = pspec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                        generator, device)
        self.wo = pspec((h, hd, d), ("heads", "head_dim", "embed"),
                        generator, device)


def repeat_kv(k, n_rep: int):
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd)."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd) \
        .reshape(b, s, kv * n_rep, hd)


def _mask_scores(scores, masked):
    """``scores`` with -1e30 where ``masked``: in place, but out of place
    for a ``DTensor``, whose in-place ops keep their placements (a
    partial sum must be reduced before it is masked)."""
    if isinstance(scores, DTensor):
        return scores.masked_fill(masked, -1e30)
    return scores.masked_fill_(masked, -1e30)


def sdpa(q, k, v, *, causal: bool, window: int = 0, q_offset=0,
         kv_len=None, bias=None):
    """Scaled dot-product attention over (B, S, H, hd) tensors, as plain
    tensor ops: scores in fp32, masked to -1e30 in fp32 score space,
    softmax in fp32, probabilities cast to q's dtype before PV (as JAX's
    ``sdpa`` does).

    ``window``   > 0 -> sliding-window mask (keys within `window` of query).
    ``q_offset``     -> absolute position of q[0] (an int or a 0-d tensor).
    ``kv_len``       -> optional (B,) valid key lengths (decode caches).
    """
    if isinstance(q, DTensor):
        return per_rank_attention(
            functools.partial(sdpa, causal=causal, window=window), q, k, v,
            q_offset=q_offset, kv_len=kv_len, bias=bias)
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    n_rep = h // k.shape[2]
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores * (hd ** -0.5)
    qpos = torch.arange(sq, device=q.device) + q_offset          # (sq,)
    kpos = torch.arange(sk, device=q.device)                     # (sk,)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.logical_and(mask, kpos[None, :] <= qpos[:, None])
    if window:
        mask = torch.logical_and(mask, kpos[None, :] > qpos[:, None] - window)
    scores = _mask_scores(scores, ~mask[None, None])
    if kv_len is not None:
        valid = kpos[None, :] < kv_len[:, None]                  # (B, sk)
        scores = _mask_scores(scores, ~valid[:, None, None])
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(q.dtype))


def per_rank_attention(fn, q, k, v, **rest):
    """``fn(q, k, v, **rest)`` (an attention written in plain tensor ops)
    on each rank's local tensors of ``DTensor`` operands, placed by K2's
    rule (``ops.attention_rule``: batch or heads sharded, the sequences
    whole); each ``rest`` tensor of the batch's length follows q's batch,
    any other is replicated.  DTensor itself would flatten (batch, heads)
    for the product and leave a strided shard, which torch 2.11 refuses.
    """
    qt, kt, _ = ops.attention_rule(q, k)
    batch = tuple(p if p.is_shard(0) else Replicate() for p in qt)
    whole = (Replicate(),) * len(qt)
    names = list(rest)
    ins = [qt, kt, kt] + [
        None if not isinstance(rest[n], DTensor) else
        batch if rest[n].ndim and rest[n].shape[0] == q.shape[0] else whole
        for n in names]

    def body(q, k, v, *vals):
        return fn(q, k, v, **dict(zip(names, vals)))
    return per_rank(body, (qt,), tuple(ins), q.device_mesh)(
        q, k, v, *(rest[n] for n in names))


def _full_attention(q, k, v, *, causal: bool):
    """Full (uncached, unwindowed) attention: always the flash-attention
    kernel (its plain version for CPU tensors).  The JAX package chooses
    by ``cfg.use_pallas``; the port has one path."""
    return ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal)


def _sp_decode_ok(cache) -> bool:
    """Flash decoding needs an activation-sharding mesh with a "model"
    axis.  JAX also asks the cache's sequence to divide over that axis;
    the port's cache under such a mesh is the rank's shard of
    ``cache["k"].shape[1]`` rows, so the sequence, that many rows on
    each of the axis's ranks, always divides."""
    mesh = current_mesh()
    return mesh is not None and "model" in mesh.mesh_dim_names


def _cache_write(cache, rows, k, v):
    """Store k/v (B, s, KV, hd) into the cache's rows ``rows``, in
    place."""
    write_rows(cache["k"], rows, k)
    write_rows(cache["v"], rows, v)


def attention_apply(p: Attention, x, cfg: ModelConfig, *, causal=True,
                    window=0, positions=None, cache=None, kv_x=None,
                    use_rope=True, sp_decode: bool = False):
    """Returns (out, new_cache).

    Training/prefill: ``cache=None`` -> attends within ``x``.
    Decode: ``cache={"k","v","len"}`` -> store x's kv into the cache (in
    place) and attend to it.  A cache of exactly ``window`` rows is the
    SWA ring buffer: a prefill installs its last ``window`` keys at slots
    ``pos % window``, a decode step writes one slot and attends to the
    ``min(len + 1, window)`` valid ones.
    ``sp_decode``: a one-token decode step without a window, under
    :func:`repro_torch.sharding.activation_sharding` with a ``"model"``
    axis, runs :func:`repro_torch.sharding.sp.flash_decode` over the
    rank's sequence shard of the cache; otherwise the plain cached
    decode, as in JAX.
    Cross-attention: ``kv_x`` provides the key/value sequence; a
    ``cache`` that holds ``"k"`` is the precomputed cross-kv and is used
    in place of ``kv_x``'s.  Returns ``{"k", "v"}`` for the caller to
    cache.
    """
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = project(x, p.wq)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    if kv_x is not None:                              # cross attention
        if cache is not None and "k" in cache:        # precomputed cross-kv
            k, v = cache["k"], cache["v"]
        else:
            k, v = project(kv_x, p.wk), project(kv_x, p.wv)
        out = _full_attention(q, k, v, causal=False)
        new_cache = {"k": k, "v": v}
    elif cache is None:                               # full self-attn
        k, v = project(x, p.wk), project(x, p.wv)
        if use_rope:
            k = apply_rope(k, positions, cfg.rope_theta)
        if window:                    # SWA keeps the masked plain path
            out = sdpa(q, k, v, causal=causal, window=window)
        else:
            out = _full_attention(q, k, v, causal=causal)
        new_cache = None
    else:                                             # cached decode/prefill
        k_new, v_new = project(x, p.wk), project(x, p.wv)
        if use_rope:
            k_new = apply_rope(k_new, positions, cfg.rope_theta)
        cache_len = cache["len"]                      # (B,) int32
        k_all, v_all = cache["k"], cache["v"]
        rows = torch.arange(s, device=x.device)
        if window and k_all.shape[1] == window:       # ring buffer (SWA)
            if s > 1:
                # windowed prefill: attend within the new sequence under the
                # window mask, then install the last min(s, W) keys into the
                # ring at slots (pos % W).  Assumes prefill starts at len=0.
                out = sdpa(q, k_new, v_new, causal=True, window=window)
                last = min(s, window)
                _cache_write(cache, rows[s - last:] % window,
                             k_new[:, s - last:], v_new[:, s - last:])
            else:
                _cache_write(cache, cache_len[0] % window + rows, k_new,
                             v_new)
                # ring decode: slots < min(len+1, W) valid; keys are stored
                # pre-rotated at absolute positions so scores stay correct.
                valid = torch.clamp(cache_len + s, max=window)
                out = sdpa(q, k_all, v_all, causal=False, kv_len=valid)
        elif sp_decode and s == 1 and not window and _sp_decode_ok(cache):
            # flash-decoding over the sequence-sharded cache: local partial
            # softmax per shard + max/sum all-reduce combine, the cache
            # never gathered
            out, k_all, v_all = flash_decode(
                q, k_new, v_new, k_all, v_all, cache_len,
                mesh=current_mesh())
        else:
            _cache_write(cache, cache_len[0] + rows, k_new, v_new)
            out = sdpa(q, k_all, v_all, causal=True, q_offset=cache_len[0],
                       kv_len=cache_len + s, window=window)
        new_cache = {"k": k_all, "v": v_all, "len": cache_len + s}
    return project_out(out, p.wo), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """``mla_init``: the joint K/V down-projection with the decoupled
    rope key (``w_dkv``), the latent's up-projections (``w_uk``,
    ``w_uv``), the output and the latent's norm; queries come through
    ``w_dq`` + ``q_norm`` + ``w_uq`` when ``q_lora_rank`` > 0, else
    through ``w_uq`` from d_model."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
        qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
        kw = dict(generator=generator, device=device)
        heads = (None, "heads", "head_dim")
        self.w_dkv = pspec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("embed", None), **kw)
        self.w_uk = pspec((m.kv_lora_rank, h, m.qk_nope_head_dim), heads,
                          **kw)
        self.w_uv = pspec((m.kv_lora_rank, h, m.v_head_dim), heads, **kw)
        self.wo = pspec((h, m.v_head_dim, d), ("heads", "head_dim", "embed"),
                        **kw)
        self.kv_norm = rmsnorm_init(m.kv_lora_rank, device)
        if m.q_lora_rank:
            self.w_dq = pspec((d, m.q_lora_rank), ("embed", None), **kw)
            self.q_norm = rmsnorm_init(m.q_lora_rank, device)
            self.w_uq = pspec((m.q_lora_rank, h, qk_hd), heads, **kw)
        else:
            self.w_uq = pspec((d, h, qk_hd), ("embed", "heads", "head_dim"),
                              **kw)


def mla_apply(p: MLA, x, cfg: ModelConfig, *, positions=None, cache=None,
              absorbed: bool = False):
    """MLA attention. The cache holds the *compressed* latent ``c`` (B,
    S, r) and the shared rope key ``kr`` (B, S, 1, rope_hd), written in
    place at rows ``len``..``len + s``.

    ``absorbed=True`` projects q through ``w_uk`` into latent space and
    scores it against concat(latent, rope key) as one product (no
    per-step K/V expansion); the naive branch expands K and V from the
    latent.  Scores are fp32 (products of x's dtype accumulated in fp32,
    as JAX's ``preferred_element_type``); probabilities are cast to x's
    dtype before the value product, as in the JAX package.
    """
    m = cfg.mla
    b, s, _ = x.shape
    h, dt = cfg.num_heads, x.dtype
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]

    # --- queries
    if hasattr(p, "w_dq"):
        q = project(rmsnorm(p.q_norm, product(x, p.w_dq.to(dt)),
                            cfg.norm_eps),
                    p.w_uq)
    else:
        q = project(x, p.w_uq)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    # --- compressed kv latent (+ shared rope key)
    c_lat, k_rope = product(x, p.w_dkv.to(dt)).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_lat = rmsnorm(p.kv_norm, c_lat, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)

    if cache is not None:
        cache_len = cache["len"]
        q_offset = cache_len[0]
        rows = q_offset + torch.arange(s, device=x.device)
        write_rows(cache["c"], rows, c_lat)
        write_rows(cache["kr"], rows, k_rope)
        c_lat, k_rope = cache["c"], cache["kr"]
        kv_len = cache_len + s
        new_cache = {"c": c_lat, "kr": k_rope, "len": kv_len}
    else:
        new_cache = kv_len = None
        q_offset = 0

    sk = c_lat.shape[1]
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    if absorbed:
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, p.w_uk.to(dt))
        q_cat = torch.cat([q_abs, q_rope], -1)
        kv_cat = torch.cat([c_lat, k_rope[:, :, 0, :]], -1)
        scores = torch.einsum("bshr,btr->bhst", q_cat.float(),
                              kv_cat.float()) * scale
        scores = _causal_len_mask(scores, s, sk, kv_len, q_offset)
        probs = torch.softmax(scores, dim=-1).to(dt)
        ctx_lat = torch.einsum("bhst,btr->bshr", probs, c_lat)
        out = torch.einsum("bshr,rhv->bshv", ctx_lat, p.w_uv.to(dt))
    else:
        # the latent's sequence whole before it is expanded (the attention
        # needs it whole; a no-op for plain tensors)
        c_lat, k_rope = settled(c_lat, gather=1), settled(k_rope, gather=1)
        k_nope = torch.einsum("btr,rhk->bthk", c_lat, p.w_uk.to(dt))
        v = torch.einsum("btr,rhv->bthv", c_lat, p.w_uv.to(dt))
        k = torch.cat([k_nope, k_rope.expand(b, sk, h, m.qk_rope_head_dim)],
                      -1)
        q_full = torch.cat([q_nope, q_rope], -1)
        attend = functools.partial(_mla_attend, scale=scale)
        if isinstance(q_full, DTensor):
            out = per_rank_attention(attend, q_full, k, v, kv_len=kv_len,
                                     q_offset=q_offset)
        else:
            out = attend(q_full, k, v, kv_len=kv_len, q_offset=q_offset)
    return project_out(out, p.wo), new_cache


def _mla_attend(q, k, v, *, kv_len, q_offset, scale):
    """MLA's naive attention: fp32 scores of q (B, S, H, k) against k (B,
    T, H, k), masked, softmax, probabilities in q's dtype against v."""
    scores = torch.einsum("bshk,bthk->bhst", q.float(), k.float()) * scale
    scores = _causal_len_mask(scores, q.shape[1], k.shape[1], kv_len,
                              q_offset)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthv->bshv", probs, v)


def _causal_len_mask(scores, sq, sk, kv_len, q_offset=0):
    """scores: (B, H, sq, sk). Causal mask (+ kv_len validity for caches),
    filled with -1e30 in fp32 score space."""
    dev = scores.device
    if kv_len is None:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=dev).tril(
            sk - sq)
        return scores.masked_fill(~mask[None, None], -1e30)
    valid = torch.arange(sk, device=dev)[None, :] < kv_len[:, None]  # (B, sk)
    if sq == 1:
        # decode: causal (kpos <= len) is implied by validity (kpos < len+1)
        return scores.masked_fill(~valid[:, None, None], -1e30)
    qpos = torch.arange(sq, device=dev) + q_offset                  # (sq,)
    causal = torch.arange(sk, device=dev)[None, :] <= qpos[:, None]
    mask = causal[None, None] & valid[:, None, None]
    return scores.masked_fill(~mask, -1e30)


# ---------------------------------------------------------------------------
# MLP / MoE
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    """``swiglu_init``: gate/up (d, dff), down (dff, d)."""

    def __init__(self, d: int, dff: int, *, generator, device):
        super().__init__()
        self.w_gate = pspec((d, dff), ("embed", "mlp"), generator, device)
        self.w_up = pspec((d, dff), ("embed", "mlp"), generator, device)
        self.w_down = pspec((dff, d), ("mlp", "embed"), generator, device)


def swiglu_apply(p: SwiGLU, x):
    g = product(x, p.w_gate.to(x.dtype))
    u = product(x, p.w_up.to(x.dtype))
    return product(F.silu(g) * u, p.w_down.to(x.dtype))


class MoE(nn.Module):
    """``moe_init``: the router (d, E), the expert-stacked SwiGLU weights
    (E, d, eff) / (E, eff, d) and, with shared experts, one SwiGLU of
    width ``eff * num_shared_experts``."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        m, d = cfg.moe, cfg.d_model
        eff = m.expert_d_ff or cfg.d_ff
        kw = dict(generator=generator, device=device)
        self.router = pspec((d, m.num_experts), ("embed", None), **kw)
        self.w_gate = pspec((m.num_experts, d, eff),
                            ("experts", "embed", "mlp"), **kw)
        self.w_up = pspec((m.num_experts, d, eff),
                          ("experts", "embed", "mlp"), **kw)
        self.w_down = pspec((m.num_experts, eff, d),
                            ("experts", "mlp", "embed"), **kw)
        if m.num_shared_experts:
            self.shared = SwiGLU(d, eff * m.num_shared_experts, **kw)


def one_hot(idx, n: int):
    """``F.one_hot(idx, n)`` (int64) for ids known to lie in [0, n), as a
    comparison: ``F.one_hot`` checks its ids on the device, which
    ``DTensor`` cannot do under inference mode."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def top_k(probs, k: int):
    """The ``k`` largest entries of the last axis and their indices, in
    ``jax.lax.top_k``'s order: descending, and the lower index first
    among equal values (``torch.topk`` promises no order among ties, and
    a bf16 router's logits tie often)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p: MoE, xt, cfg: ModelConfig, exact: bool = False):
    """Routing of grouped tokens ``xt`` (G, tg, d): router probabilities
    (fp32), the top-k gate weights (x's dtype, renormalised) and expert
    ids, each (token, k) pair's slot in its expert's queue, whether it
    fits the capacity, and the capacity.

    Capacity is every routed copy when ``exact`` or when a group routes at
    most 4096, else the capacity factor's share (Python's ``round``, as
    the JAX package).  Slots are ranks in token-major, k-minor order;
    pairs past the capacity go to the overflow slot ``cap``.
    """
    m = cfg.moe
    n_g, tg, _ = xt.shape
    probs = torch.softmax(product(xt, p.router.to(xt.dtype)).float(),
                          dim=-1)
    gate_w, gate_i = top_k(probs, m.top_k)                 # (g, tg, k)
    gate_w = (gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)).to(
        xt.dtype)
    if exact or tg * m.top_k <= 4096:
        cap = tg * m.top_k
    else:
        cap = int(max(4, round(tg * m.top_k / m.num_experts
                               * m.capacity_factor)))
    flat_e = gate_i.reshape(n_g, tg * m.top_k)             # (g, tg*k)
    onehot = one_hot(flat_e, m.num_experts)
    slot = (onehot.cumsum(1) - onehot).gather(2, flat_e[..., None])[..., 0]
    keep = slot < cap
    return probs, gate_w, gate_i, torch.where(keep, slot, cap), keep, cap


def moe_apply(p: MoE, x, cfg: ModelConfig, exact: bool = False):
    """Grouped capacity-buffer MoE: top-k route (:func:`moe_route`) ->
    per-group scatter into a (G, E, C + 1, d) buffer -> batched expert
    products -> weighted gather-combine, the overflow row masked out.
    ``exact=True`` (decode) sets capacity = group tokens x top_k, so no
    token drops.  Returns (out (B, S, d), the load-balance loss).
    """
    m = cfg.moe
    x = settled(x, gather=1)        # (b, s) flattens into the tokens
    b, s, d = x.shape
    t = b * s
    n_g = max(1, min(m.num_groups, t))
    if t % n_g:
        raise ValueError(f"moe_apply: {t} tokens do not split into "
                         f"{n_g} groups")
    tg, dt = t // n_g, x.dtype
    xt = x.reshape(n_g, tg, d)
    probs, gate_w, gate_i, slot, keep, cap = moe_route(p, xt, cfg, exact)
    flat_e = gate_i.reshape(n_g, tg * m.top_k)

    buf = x.new_zeros((n_g, m.num_experts, cap + 1, d))
    tok_idx = torch.arange(tg, device=x.device).repeat_interleave(m.top_k)
    g_idx = torch.arange(n_g, device=x.device)[:, None]
    buf = index_write(buf, (g_idx, flat_e, slot), take(xt, 1, tok_idx))
    h = F.silu(product(buf, p.w_gate.to(dt))) * product(buf,
                                                         p.w_up.to(dt))
    del buf                  # the largest buffer, before the down product
    y = product(h, p.w_down.to(dt))
    del h

    gathered = index_read(y, (g_idx, flat_e, slot)).masked_fill(
        ~keep[..., None], 0.0)
    out = split_ready(gathered * gate_w.reshape(n_g, -1)[..., None], 1, tg) \
        .reshape(n_g, tg, m.top_k, d).sum(dim=2)
    if hasattr(p, "shared"):
        out = out + swiglu_apply(p.shared, xt)
    aux = _load_balance_loss(probs.reshape(t, -1), gate_i.reshape(t, -1),
                             m.num_experts)
    # its backward flattens (b, s) again: the gradient's sequence whole
    return grad_gathered(split_ready(out, 1, b).reshape(b, s, d), 1), aux


def _load_balance_loss(probs, gate_i, num_experts: int):
    """Switch-style load-balancing auxiliary loss.  The expert counts are
    a sum of one-hot rows, the same integers as ``torch.bincount``'s,
    which ``DTensor`` cannot shard."""
    t = probs.shape[0]
    me = probs.mean(dim=0)                                 # mean router prob
    ce = one_hot(gate_i.reshape(-1), num_experts).sum(0).float() \
        / (t * gate_i.shape[-1])
    return num_experts * (me * ce).sum()


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """``embedding_init``: token table, plus an unembedding when the
    embeddings are not tied (kept so the JAX tree maps one to one)."""

    def __init__(self, cfg: ModelConfig, *, generator, device):
        super().__init__()
        self.tok = pspec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                         generator, device, scale=1.0)
        if not cfg.tie_embeddings:
            self.unembed = pspec((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"), generator, device)


def embed(p: Embedding, tokens, cfg: ModelConfig, dtype):
    out = lookup(p.tok.to(dtype), tokens)
    if cfg.tie_embeddings:
        out = out * (cfg.d_model ** 0.5)
    return out


def unembed(p: Embedding, x, cfg: ModelConfig):
    """fp32 logits: the weight is cast to x's dtype and the product is
    accumulated and returned in fp32, as JAX's ``preferred_element_type``
    does (a bf16 x bf16 product is exact in fp32)."""
    w = p.unembed if hasattr(p, "unembed") else p.tok.T
    return product(x.float(), w.to(x.dtype).float())
