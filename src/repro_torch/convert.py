"""Load a JAX parameter tree into the port's modules.

The tree is the value tree of the JAX package's init (``split_params(
...)[0]`` of ``dit.init``, ``text_encoder.init``, ``vae.init``,
``ssm.init``, ``transformer.init``, ``hybrid.init``, ``vlm.init`` or
``encdec.init``) with numpy leaves.  Keys map to parameter names one to
one (``attn.wq`` -> ``attn.wq``, ``dense_0.attn.w_dkv`` ->
``dense_0.attn.w_dkv``).  A leaf under a stacked key carries leading
layer axes and fills one parameter per index: under ``"blocks"``,
``"enc_blocks"`` and ``"dec_blocks"`` one axis (``blocks.{i}.<rest>``,
also the transformer's super-blocks, ``blocks.{i}.pos0.attn.wq``), under
the hybrid's ``"mamba_groups"`` two (``mamba_groups.{g}.{j}.<rest>``).
Other axes are the parameter's own: a MoE layer's expert-stacked
``moe.w_gate`` (E, d, eff) is one parameter.  Layouts are the same in
both packages, so no leaf is reshaped.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


#: top-level keys whose leaves carry leading layer axes, and how many
STACKED = {"blocks": 1, "enc_blocks": 1, "dec_blocks": 1, "mamba_groups": 2}


def _flatten(tree, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, np.asarray(val)


def load_jax_params(module: nn.Module, tree) -> None:
    """Copy every leaf of ``tree`` into ``module``; raises unless the two
    hold exactly the same parameters at the same shapes."""
    params = dict(module.named_parameters())
    filled = set()

    def assign(name, arr):
        if name not in params:
            raise KeyError(f"JAX leaf {name!r} has no parameter in "
                           f"{type(module).__name__}")
        p = params[name]
        if tuple(p.shape) != arr.shape:
            raise ValueError(f"{name}: JAX shape {arr.shape}, port shape "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))
        filled.add(name)

    for name, arr in _flatten(tree):
        top, _, rest = name.partition(".")
        axes = STACKED.get(top, 0)
        if axes:
            for idx in np.ndindex(arr.shape[:axes]):
                assign(".".join([top, *map(str, idx), rest]), arr[idx])
        else:
            assign(name, arr)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"no JAX leaf for {missing}")
