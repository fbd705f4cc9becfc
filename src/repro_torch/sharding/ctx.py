"""Activation-sharding context.

Port of ``repro/sharding/ctx.py``.  Model code calls :func:`constrain`
on intermediate activations with logical axis names.  With no context,
or when the names do not match the tensor's rank, it returns ``x``
itself, so the same model code runs unsharded (as every CPU test runs
it).  Under :func:`activation_sharding`, a ``DTensor`` is redistributed
to :func:`~repro_torch.sharding.specs.spec_for`'s placements, the
port's ``with_sharding_constraint``.  The port's models run on plain
local tensors (each rank's own shard), so a plain tensor comes back
unchanged under a context too.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.sharding.specs import AxisTarget, placements, spec_for

_CTX: contextvars.ContextVar[Optional[tuple[DeviceMesh, dict]]] = \
    contextvars.ContextVar("sharding_ctx", default=None)


@contextlib.contextmanager
def activation_sharding(mesh: DeviceMesh, rules: dict[str, AxisTarget]):
    tok = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(tok)


def current_mesh() -> Optional[DeviceMesh]:
    ctx = _CTX.get()
    return ctx[0] if ctx else None


def constrain(x, *logical: Optional[str]):
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    if len(logical) != x.ndim:
        return x
    spec = spec_for(tuple(x.shape), tuple(logical), rules, mesh)
    return x.redistribute(mesh, placements(spec, mesh))
