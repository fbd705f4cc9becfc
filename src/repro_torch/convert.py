"""Load a JAX parameter tree into the port's modules.

The tree is the value tree of the JAX package's init (``split_params(
...)[0]`` of ``dit.init`` / ``text_encoder.init`` / ``vae.init``) with
numpy leaves.  Keys map to parameter names one to one (``attn.wq`` ->
``attn.wq``); a leaf under ``"blocks"`` carries a leading layer axis and
fills ``blocks.{i}.<rest>`` for every layer ``i``.  Layouts are the same
in both packages, so no leaf is reshaped.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


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
        if name.startswith("blocks."):
            rest = name[len("blocks."):]
            for i in range(arr.shape[0]):
                assign(f"blocks.{i}.{rest}", arr[i])
        else:
            assign(name, arr)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"no JAX leaf for {missing}")
