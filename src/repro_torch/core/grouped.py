"""GFC realization #2: membership-as-data grouped collectives.

Port of ``repro/core/grouped.py``.  ONE world-level program is prepared
per op and input shape, and its subgroup structure is an *input tensor*
(per-rank group ids), so forming any subgroup never triggers a new
capture: group formation is metadata, here in its strongest form.

JAX compiles the program over a mesh of devices.  The port's ranks are
:class:`~repro_torch.core.gfc.GroupFreeComm`'s threads on one device,
so :func:`build_grouped_ops` takes the world size and that device where
JAX takes a mesh, and the world-stacked tensor ``x`` (W, ...) lives on
the one device.  On the card each op is one CUDA graph captured at the
world shape (:class:`~repro_torch.core.executable_cache.Program`), with
``group_ids`` a static input buffer: a new membership is new data,
never a new capture.  ``stats`` counts captures (on the CPU, eager
preparations) and calls per op.

Trade-off (DESIGN.md): data moves over the whole world (a masked sum or
gather over W rows), so bandwidth is wasted by a factor world/group
against a native subgroup collective; the executable cache is the path
for large payloads and this one for high-churn small groups.
"""
from __future__ import annotations

import threading
from typing import Callable

import torch

from repro_torch.core.executable_cache import Program, resolve_device


def _mask(x, group_ids):
    """(W, W, 1, ...) in x's dtype: [r, s] is 1 where rank s is in rank
    r's group."""
    g = group_ids[:, 0]
    w = g.shape[0]
    return (g[None, :] == g[:, None]).to(x.dtype).view(
        w, w, *(1,) * (x.ndim - 1))


def _grouped_all_reduce(x, group_ids):
    return (x[None] * _mask(x, group_ids)).sum(1, dtype=x.dtype)


def _grouped_all_gather(x, group_ids):
    return x[None] * _mask(x, group_ids)


def build_grouped_ops(world_size: int, *, device=None) -> dict:
    """World-prepared grouped collectives; ``group_ids`` is data, not
    code.

    Returns ``{"all_reduce", "all_gather", "stats"}``.  Each op takes the
    world-stacked ``x`` (W, ...) and ``group_ids`` (W, 1) of an integer
    dtype:

    * ``all_reduce``: ``out[r]`` is the sum of the rows whose id equals
      row r's, shape (W, ...);
    * ``all_gather``: ``out[r]`` is the world-stacked ``x`` with the
      other groups' rows zeroed, shape (W, W, ...) (the caller compacts
      by its descriptor order).
    """
    device = resolve_device(device)
    programs: dict[tuple, Program] = {}
    lock = threading.Lock()
    stats = {op: {"captures": 0, "calls": 0}
             for op in ("all_reduce", "all_gather")}

    def make(op: str, body: Callable) -> Callable:
        def run(x, group_ids):
            if x.shape[0] != world_size or \
                    tuple(group_ids.shape) != (world_size, 1):
                raise ValueError(
                    f"{op}: x {tuple(x.shape)} and group_ids "
                    f"{tuple(group_ids.shape)} do not stack a world of "
                    f"{world_size}")
            key = (op, tuple(x.shape), x.dtype, group_ids.dtype)
            with lock:
                if key not in programs:
                    programs[key] = Program(body, [
                        torch.zeros_like(x, device=device),
                        torch.zeros_like(group_ids, device=device)])
                    stats[op]["captures"] += 1
                stats[op]["calls"] += 1
                prog = programs[key]
            return prog(x, group_ids)
        return run

    return {"all_reduce": make("all_reduce", _grouped_all_reduce),
            "all_gather": make("all_gather", _grouped_all_gather),
            "stats": stats}
