"""Logical-axis -> mesh-axis sharding rules (MaxText-style).

Port of ``repro/sharding/specs.py`` onto a
:class:`torch.distributed.device_mesh.DeviceMesh` and ``DTensor``
placements.  Parameters carry logical axis names (each constructor in
:mod:`repro_torch.models` records them beside the shapes through
:func:`with_axes`; :func:`param_axes` reads them).  Rules map logical names
to mesh axis names; a dimension is left unsharded when its size does
not divide the mesh axis size (automatic fallback, so one rule set
covers every arch: e.g. kv_heads=8 cannot shard over model=16 and
silently falls back while heads=96 shards fine).

:class:`P` is the port's stand-in for JAX's ``PartitionSpec``: a tuple
with one entry per tensor dim, each ``None``, a mesh axis name or a
tuple of them.  :func:`placements` turns it into ``DTensor``
placements; :class:`NamedSharding` pairs it with a mesh, as JAX's does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

AxisTarget = Union[None, str, tuple[str, ...]]


class P(tuple):
    """PartitionSpec: ``P("data", None)`` shards dim 0 over ``data``."""

    def __new__(cls, *parts: AxisTarget):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a :class:`P`, JAX's ``NamedSharding``: where each
    dimension of a tensor lies on ``mesh``."""
    mesh: DeviceMesh
    spec: P

    @property
    def placements(self) -> tuple:
        """The ``DTensor`` placements of :attr:`spec` on :attr:`mesh`."""
        return tuple(placements(self.spec, self.mesh))


# ---------------------------------------------------------------------------
# Rule sets
# ---------------------------------------------------------------------------

# Training: FSDP ("data") x TP ("model"); "pod" is pure DP for params
# (replicated + gradient all-reduce across pods).
TRAIN_RULES: dict[str, AxisTarget] = {
    "vocab": "model",
    "embed": "data",            # FSDP shard of the param's embed dim
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",         # expert parallelism
    "layers": None,
    "ssm_inner": "model",
    # activations
    "act_batch": ("pod", "data"),
    "act_seq": "model",         # Megatron-SP residual-stream sharding
    "act_vocab": "model",
    "act_heads": "model",
}

# Serving: params replicated across "data" (weights fit per TP group),
# batch over data, sequence/cache over model where beneficial.
SERVE_RULES: dict[str, AxisTarget] = {
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "layers": None,
    "ssm_inner": "model",
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_vocab": "model",
    "act_heads": "model",
    # kv caches: shard the sequence dim over model (paper's SP layout)
    "cache_seq": "model",
    "cache_kv": None,
}


def _sizes(mesh: DeviceMesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(mesh: DeviceMesh, target: AxisTarget) -> int:
    if target is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(target, str):
        return sizes.get(target, 0)
    size = 1
    for t in target:
        if t not in sizes:
            return 0
        size *= sizes[t]
    return size


def spec_for(shape: tuple[int, ...], logical: tuple[Optional[str], ...],
             rules: dict[str, AxisTarget], mesh: DeviceMesh) -> P:
    """Build a :class:`P` with divisibility fallback.

    Each mesh axis may appear at most once in a spec; later dims fall back
    to None if an axis is already used.
    """
    if len(shape) != len(logical):
        raise ValueError(f"shape {shape} and logical axes {logical} differ "
                         f"in length")
    parts: list[AxisTarget] = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        target = rules.get(name) if name else None
        if target is None:
            parts.append(None)
            continue
        tgt_axes = (target,) if isinstance(target, str) else tuple(target)
        if any(a in used for a in tgt_axes):
            parts.append(None)
            continue
        size = mesh_axis_size(mesh, target)
        if size == 0 or dim % size != 0:
            parts.append(None)
            continue
        used.update(tgt_axes)
        parts.append(target)
    return P(*parts)


def placements(spec: P, mesh: DeviceMesh) -> list:
    """``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    every mesh dim that tensor dim ``d`` targets (both dims of a tuple
    target such as ``("pod", "data")``), ``Replicate()`` elsewhere."""
    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        for axis in (part,) if isinstance(part, str) else part:
            out[names.index(axis)] = Shard(d)
    return out


def with_axes(param: nn.Parameter, axes) -> nn.Parameter:
    """Record ``param``'s logical axes (one per dim) on it."""
    axes = tuple(axes)
    if len(axes) != param.ndim:
        raise ValueError(f"logical axes {axes} for a {param.ndim}-d "
                         f"parameter")
    param.logical_axes = axes
    return param


def _axes(name: str, p: nn.Parameter) -> tuple:
    if not hasattr(p, "logical_axes"):
        raise ValueError(f"parameter {name!r} has no logical axes")
    return p.logical_axes


def param_axes(module: nn.Module) -> dict:
    """``{parameter name: logical axes}`` of ``module``; raises for a
    parameter created without them."""
    return {name: _axes(name, p) for name, p in module.named_parameters()}


def tree_param_specs(module: nn.Module, rules, mesh: DeviceMesh) -> dict:
    """``{parameter name: P}`` for every parameter of ``module`` (the
    port's counterpart of the spec tree JAX gives ``jit``)."""
    return {name: spec_for(tuple(p.shape), _axes(name, p), rules, mesh)
            for name, p in module.named_parameters()}


def param_shardings(module: nn.Module, rules, mesh: DeviceMesh) -> dict:
    """``{parameter name: DTensor placements}`` on ``mesh``."""
    return {name: placements(spec, mesh)
            for name, spec in tree_param_specs(module, rules, mesh).items()}
