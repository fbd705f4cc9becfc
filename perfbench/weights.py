"""Weights made from the seed, the same for the program and the reference.

Each group of parameters (one DiT block, the rest of the DiT, the text
encoder, the VAE) is one ``torch.randn`` call of a ``torch.Generator``
on the device, seeded from the run's seed and the group's name, split
into the group's parameters and scaled in place.  :func:`load` copies
the groups into the program's modules one at a time, so only one group
is ever held twice; :func:`make` keeps them, for the reference.
"""
from __future__ import annotations

import hashlib
import math
import re

import torch


def _group(module: str, name: str) -> str:
    m = re.match(r"blocks\.(\d+)\.", name)
    return f"{module}.blocks.{m[1]}" if module == "dit" and m else module


def groups(specs: dict[str, dict]) -> dict[str, list[tuple[str, str]]]:
    """group name -> [(module, parameter name)] in a fixed order."""
    out: dict[str, list[tuple[str, str]]] = {}
    for module, mspecs in specs.items():
        for name in mspecs:
            out.setdefault(_group(module, name), []).append((module, name))
    return out


def group_seed(seed: int, group: str) -> int:
    digest = hashlib.sha256(f"{seed}/{group}".encode()).hexdigest()
    return int(digest[:15], 16)


def draw(specs: dict[str, dict], seed: int, group: str,
         members: list[tuple[str, str]], device) -> dict[tuple, torch.Tensor]:
    """(module, name) -> tensor for one group, drawn in one call."""
    drawn = [(key, specs[key[0]][key[1]]) for key in members]
    total = sum(math.prod(shape) for _, (shape, init) in drawn
                if init in ("fan_in", "unit"))
    gen = torch.Generator(device=device).manual_seed(group_seed(seed, group))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for key, (shape, init) in drawn:
        if init == "zeros":
            out[key] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[key] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            off += n
            if init == "fan_in":
                fan_in = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
                t.mul_(fan_in ** -0.5)
            out[key] = t
    return out


@torch.no_grad()
def load(modules: dict[str, torch.nn.Module], specs: dict[str, dict],
         seed: int, device) -> int:
    """Copy the seed's weights into ``modules`` (module key -> the
    program's ``nn.Module``), whose parameters must be exactly those of
    ``specs``, by name and shape.  Returns the bytes copied."""
    params = {k: dict(m.named_parameters()) for k, m in modules.items()}
    for k, mspecs in specs.items():
        got = {n: tuple(p.shape) for n, p in params[k].items()}
        want = {n: tuple(s) for n, (s, _) in mspecs.items()}
        if got != want:
            diff = sorted(set(got.items()) ^ set(want.items()))[:6]
            raise ValueError(f"the program's {k} parameters differ from the "
                             f"benchmark's configuration: {diff}")
    copied = 0
    for group, members in groups(specs).items():
        for (k, name), t in draw(specs, seed, group, members,
                                 device).items():
            params[k][name].copy_(t)
            copied += t.numel() * t.element_size()
    return copied


def make(specs: dict[str, dict], seed: int, device) -> dict[str, dict]:
    """The seed's weights as dicts of tensors by module (for the
    reference)."""
    out: dict[str, dict] = {k: {} for k in specs}
    for group, members in groups(specs).items():
        for (k, name), t in draw(specs, seed, group, members,
                                 device).items():
            out[k][name] = t
    return out
