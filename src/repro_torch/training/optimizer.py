"""AdamW (``repro/training/optimizer.py`` in PyTorch).

The JAX package's formula, not ``torch.optim.AdamW``'s (whose defaults
and clipping differ): global-norm clip at 1.0, b1 = 0.9, b2 = 0.95,
eps = 1e-8, weight decay 0.1 on every leaf (decoupled, inside the
update), fp32 moments, bias corrections from the fp32 step count.

Where the JAX update returns new parameters, :func:`adamw_update`
writes them into the given tensors in place (a ``Module``'s parameters)
and updates the moments in place, so a step holds no second copy of the
weights; it returns the new state and the metrics.  The moments are
dictionaries keyed by parameter name; the state is a ``NamedTuple`` of
``step``, ``m``, ``v`` as in JAX, so ``CheckpointManager`` writes it as
``step``, ``m/...``, ``v/...`` leaves under the same indices.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: fp32 elements the update processes in one batch of ``_foreach`` ops;
#: bounds its temporaries (three a batch) to a few GB at full width
_CHUNK = 1 << 28


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32, on the host
    m: dict                     # name -> fp32 tensor like the parameter
    v: dict


def adamw_init(params: dict) -> AdamWState:
    """Zero moments for ``params`` (name -> tensor, e.g.
    ``dict(module.named_parameters())``), fp32, each like its parameter:
    on its device, and a ``DTensor`` of its placements for a
    ``DTensor`` parameter."""
    m = {n: torch.zeros_like(p, dtype=torch.float32,
                             memory_format=torch.contiguous_format)
         for n, p in params.items()}
    v = {n: torch.zeros_like(t) for n, t in m.items()}
    return AdamWState(torch.zeros((), dtype=torch.int32), m, v)


def _chunks(names, params):
    out, size = [], 0
    for n in names:
        out.append(n)
        size += params[n].numel()
        if size >= _CHUNK:
            yield out
            out, size = [], 0
    if out:
        yield out


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict, *,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 1.0):
    """One AdamW step: ``params`` (name -> tensor) are updated in place
    from ``grads`` (name -> tensor).  Returns (new state, metrics) with
    ``metrics["grad_norm"]`` the global gradient norm before clipping (a
    0-d fp32 tensor on the gradients' device)."""
    names = list(params)
    norms = torch._foreach_norm([grads[n].float() for n in names])
    gnorm = torch.stack(norms).square().sum().sqrt()
    scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    # the JAX package's bias corrections, in fp32
    f = np.float32(int(step))
    bc1 = float(np.float32(1.0) - np.float32(b1) ** f)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** f)
    for chunk in _chunks(names, params):
        p = [params[n] for n in chunk]
        m = [state.m[n] for n in chunk]
        v = [state.v[n] for n in chunk]
        g = torch._foreach_mul([grads[n].float() for n in chunk], scale)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        del g
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        delta = torch._foreach_div(m, bc1)
        torch._foreach_div_(delta, denom)
        del denom
        p32 = [t.float() for t in p]
        torch._foreach_add_(delta, p32, alpha=weight_decay)
        torch._foreach_add_(p32, delta, alpha=-lr)
        for t, new in zip(p, p32):
            if new is not t:             # a non-fp32 parameter
                t.copy_(new)
    return AdamWState(step, state.m, state.v), {"grad_norm": gnorm}
