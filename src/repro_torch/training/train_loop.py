"""train_step factory (``repro/training/train_loop.py`` in PyTorch): the
(module, opt_state, batch) -> (module, opt_state, metrics) step for any
family of the zoo, with remat, MoE dispatch grouping and gradient
compression.

As the serve-loop steps do, the step takes the model module where JAX
takes params.  It makes the parameters require grad for the step (and
leaves them as it found them), takes the gradients of JAX's loss with
``torch.autograd.grad`` (K2, K1 and K4, the ``ssm`` and ``hybrid``
families' SSD, differentiate through their backward kernels on the
card), and updates the module in place with AdamW.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.models.layers import resolve_device
from repro_torch.sharding.ctx import per_rank, placements_of
from repro_torch.training import optimizer as opt
from repro_torch.training.compression import compress_decompress


def cross_entropy(logits, labels):
    """logits (B,S,V) fp32; labels (B,S) int; -100 masked."""
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = _gold_logit(logits, safe)
    nll = (logz - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def _gold_logit(logits, idx):
    """``logits[b, s, idx[b, s]]``.  For ``DTensor`` logits each rank
    gathers from its own vocab shard (zero where the id lies in another)
    and the result is their partial sum, so that the gather's backward
    stays the size of a rank's shard (DTensor's own strategy makes the
    backward's zeros of the global shape)."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, idx[..., None])[..., 0]
    mesh, v = logits.device_mesh, logits.ndim - 1
    pl = tuple(Replicate() if p.is_partial() else p
               for p in placements_of(logits))
    vocab = [p.is_shard(v) for p in pl]
    start = compute_local_shape_and_global_offset(logits.shape, mesh,
                                                  pl)[1][v]
    idx_pl = tuple(Replicate() if hit else p for p, hit in zip(pl, vocab))
    out_pl = tuple(Partial() if hit else p for p, hit in zip(pl, vocab))

    def body(lg, i):
        local = i - start
        hit = (local >= 0) & (local < lg.shape[-1])
        got = torch.gather(lg, -1, local.clamp(0, lg.shape[-1] - 1)[..., None])
        return torch.where(hit, got[..., 0], 0.0)
    return per_rank(body, (out_pl,), (pl, idx_pl), mesh)(logits, idx)


def loss_fn(module, batch, cfg: ModelConfig, remat: str,
            dtype=torch.bfloat16):
    """(loss, aux): the flow-matching loss for the DiT, else cross
    entropy (+ 0.01 x the MoE's load-balance loss).  ``dtype`` is the
    forward's activation dtype: bf16, as JAX's ``loss_fn`` runs it."""
    model = get_model(cfg)
    if cfg.family == "dit":
        # flow-matching loss: predict velocity between noise and latents
        lat, t, txt, noise = (batch["latents"], batch["t"], batch["txt"],
                              batch["noise"])
        sigma = (t / 1000.0)[:, None, None, None, None]
        x_t = (1 - sigma) * lat + sigma * noise
        v_pred = model.forward(module, x_t, t, txt, cfg, remat=remat,
                               dtype=dtype)
        v_true = noise - lat
        return (torch.mean((v_pred - v_true) ** 2),
                torch.zeros((), device=lat.device))
    if cfg.family == "encdec":
        logits, aux = model.forward(module, batch["tokens"], batch["frames"],
                                    cfg, remat=remat, dtype=dtype)
    elif cfg.family == "vlm":
        logits, aux = model.forward(module, batch["tokens"],
                                    batch["patches"], cfg, remat=remat,
                                    dtype=dtype)
        # labels only cover the text positions; logits include the prefix
        logits = logits[:, batch["patches"].shape[1]:]
    else:
        logits, aux = model.forward(module, batch["tokens"], cfg,
                                    remat=remat, dtype=dtype)
    return cross_entropy(logits, batch["labels"]) + 0.01 * aux, aux


def grads_of(module, batch, cfg: ModelConfig, remat: str = "none",
             dtype=torch.bfloat16):
    """(loss, aux, grads by parameter name): the loss and its gradient
    with respect to every parameter (zeros where it does not depend on
    one, as ``jax.grad`` gives)."""
    params = dict(module.named_parameters())
    was = {n: p.requires_grad for n, p in params.items()}
    try:
        for p in params.values():
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, aux = loss_fn(module, batch, cfg, remat, dtype)
            got = torch.autograd.grad(loss, list(params.values()),
                                      allow_unused=True)
    finally:
        for n, p in params.items():
            p.requires_grad_(was[n])
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(params.items(), got)}
    return loss.detach(), aux.detach(), grads


def make_train_step(cfg: ModelConfig, *, remat: str = "full",
                    lr: float = 3e-4, moe_groups: int = 1,
                    compression: Optional[str] = None):
    """Returns train_step(module, opt_state, batch) -> (module, opt_state,
    metrics); ``opt_state`` from ``optimizer.adamw_init(dict(module.
    named_parameters()))``.

    ``moe_groups`` should equal the number of batch shards so the MoE
    capacity buffer stays sharded with the tokens.
    ``compression``: None | "int8" | "topk" — gradient compression applied
    before the (data-parallel) all-reduce.
    """
    if cfg.moe is not None and moe_groups > 1:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                num_groups=moe_groups))

    def train_step(module, opt_state, batch):
        loss, aux, grads = grads_of(module, batch, cfg, remat)
        if compression:
            grads = compress_decompress(grads, method=compression)
        new_opt, om = opt.adamw_update(grads, opt_state,
                                       dict(module.named_parameters()), lr=lr)
        metrics = {"loss": loss, "aux_loss": aux, **om}
        return module, new_opt, metrics

    return train_step


def synth_batch(cfg: ModelConfig, batch: int, seq: int, generator=None,
                as_specs: bool = False, device=None):
    """Synthetic training batch of JAX's shapes and dtypes on ``device``
    (the card by default), drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; seed 0 by default); with
    ``as_specs`` meta-device tensors of those shapes."""
    device = torch.device("meta") if as_specs else resolve_device(device)
    if generator is None and not as_specs:
        generator = torch.Generator(device=device).manual_seed(0)

    def normal(shape):
        if as_specs:
            return torch.empty(shape, device=device)
        return torch.randn(shape, generator=generator, device=device)

    if cfg.family == "dit":
        dc = cfg.dit
        f = dc.latent_frames
        f_lat = max(1, (f + 3) // 4) if f > 1 else 1
        lat_shape = (batch, f_lat, 64, 64, dc.in_channels)
        t = (torch.empty((batch,), device=device) if as_specs else
             1000.0 * torch.rand((batch,), generator=generator,
                                 device=device))
        return {"latents": normal(lat_shape), "noise": normal(lat_shape),
                "t": t, "txt": normal((batch, 64, dc.cond_dim))}
    if as_specs:
        toks = torch.empty((batch, seq), dtype=torch.int32, device=device)
    else:
        toks = torch.randint(0, cfg.vocab_size, (batch, seq),
                             generator=generator, device=device,
                             dtype=torch.int32)
    out = {"tokens": toks, "labels": toks}
    if cfg.family == "encdec":
        out["frames"] = normal((batch, cfg.frontend_seq, cfg.d_model))
    if cfg.family == "vlm":
        out["patches"] = normal((batch, cfg.frontend_seq, cfg.d_model))
    return out
