"""GFC realization #1: a compile-once-per-group-SHAPE collective cache.

Port of ``repro/core/executable_cache.py``.  On a TPU the expensive
per-group state is the compiled XLA executable of the collective; the
paper's insight, "separate communication state from subgroup
membership", becomes: key the prepared collective on (op, group size,
shard shape, dtype), never on member identity, so binding a new rank set
of a size already seen is a descriptor-only metadata step
(:class:`~repro_torch.core.gfc.GroupDescriptor`), the paper's ~60 µs
registration.

The port's ranks are :class:`~repro_torch.core.gfc.GroupFreeComm`'s
threads on one device, so a group's shards live in one group-global
tensor of shape ``(size * shape[0], *shape[1:])`` and the "compiled
executable" is a CUDA graph, captured and instantiated once per key on
static input buffers.  A call copies its input into the static buffer,
replays the graph and returns a fresh tensor that a later call does not
overwrite (as JAX returns a fresh array).  On the CPU, which a caller
must ask for, the same runner is prepared without a graph and counted
the same way; on a CUDA device a key is captured or the call raises.

The ops mean exactly what JAX's ``shard_map`` bodies with
``in_specs=P("g")`` mean on the group-global tensor:

* ``all_gather`` (tiled, out ``P()``): the group-global tensor;
* ``all_reduce`` (``psum``, out ``P()``): the sum of the ``size``
  shards, shard-shaped;
* ``all_to_all`` (tiled, split and concat on axis 0, out ``P("g")``):
  the block transpose of ``(size, size, shape[0] / size, ...)``.

``python -m repro_torch.benchmarks.group_setup`` measures a capture
against a cache hit against descriptor registration.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

import torch

from repro_torch.core.gfc import GroupDescriptor


def _all_gather(x, size: int):
    return torch.cat(x.chunk(size, 0))


def _all_reduce(x, size: int):
    shards = x.view(size, x.shape[0] // size, *x.shape[1:])
    return shards.sum(0, dtype=x.dtype)          # ints stay in their width


def _all_to_all(x, size: int):
    per = x.shape[0] // (size * size)
    return x.view(size, size, per, *x.shape[1:]).transpose(0, 1) \
        .reshape(x.shape)


_OPS: dict[str, Callable] = {"all_gather": _all_gather,
                             "all_reduce": _all_reduce,
                             "all_to_all": _all_to_all}


def resolve_device(device) -> torch.device:
    """``device``, by default the card; without CUDA the caller must ask
    for the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "prepare collectives without a graph")
    return device


class Program:
    """A collective body prepared once on static input buffers.

    ``body(*inputs)`` returns the result from the buffers' contents.  On
    a CUDA device it is captured as a CUDA graph (after one warm-up run
    on a side stream); on the CPU it runs eagerly.  A call checks its
    arguments against the buffers, copies them in, runs, and returns a
    fresh tensor.  Calls are serialised: rank threads may share one
    program.  ``graph`` is the captured ``torch.cuda.CUDAGraph`` (None on
    the CPU)."""

    def __init__(self, body: Callable, inputs: list[torch.Tensor]):
        self._body, self._inputs = body, inputs
        self.graph = self._out = None
        self._lock = threading.Lock()
        device = inputs[0].device
        if device.type != "cuda":
            return
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body(*inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.cuda.graph(graph):
            self._out = body(*inputs)
        self.graph = graph

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        if len(args) != len(self._inputs):
            raise TypeError(f"expected {len(self._inputs)} tensors, got "
                            f"{len(args)}")
        for buf, a in zip(self._inputs, args):
            if a.shape != buf.shape or a.dtype != buf.dtype or \
                    a.device != buf.device:
                raise ValueError(
                    f"prepared for {tuple(buf.shape)} {buf.dtype} on "
                    f"{buf.device}, got {tuple(a.shape)} {a.dtype} on "
                    f"{a.device}")
        with self._lock:
            for buf, a in zip(self._inputs, args):
                buf.copy_(a)
            if self.graph is None:
                return self._body(*self._inputs).clone()
            self.graph.replay()
            return self._out.clone()


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class ExecutableCache:
    """Prepared-collective cache keyed by (op, size, shard_shape, dtype)
    on one device (the card unless ``device="cpu"``)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cache: dict[tuple, Program] = {}
        self.stats = {"compiles": 0, "hits": 0, "compile_seconds": 0.0,
                      "bind_seconds": 0.0}

    def _key(self, op: str, size: int, shape: tuple, dtype) -> tuple:
        return (op, size, tuple(shape), dtype_name(dtype))

    def get(self, op: str, size: int, shape: tuple, dtype) -> Program:
        """Prepared collective for ANY group of ``size`` ranks: it takes
        the group-global tensor ``(size * shape[0], *shape[1:])``."""
        key = self._key(op, size, shape, dtype)
        if key in self._cache:
            self.stats["hits"] += 1
            return self._cache[key]
        if op not in _OPS:
            raise ValueError(f"unknown collective {op!r}; known: "
                             f"{sorted(_OPS)}")
        if op == "all_to_all" and shape[0] % size:
            raise ValueError(f"all_to_all: a shard of {shape[0]} rows does "
                             f"not split over {size} ranks")
        t0 = time.perf_counter()
        gshape = (shape[0] * size,) + tuple(shape[1:])
        x = torch.zeros(gshape, dtype=dtype, device=self.device)
        fn = _OPS[op]
        prog = Program(lambda x: fn(x, size), [x])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._cache[key] = prog
        self.stats["compiles"] += 1
        self.stats["compile_seconds"] += time.perf_counter() - t0
        return prog

    def bind(self, op: str, desc: GroupDescriptor, shape: tuple,
             dtype) -> Callable:
        """Bind a logical group to the size-keyed collective.

        The descriptor supplies the logical->physical rank mapping; the
        prepared collective is reused across every rank set of this
        size.  This is the metadata-only step the paper measures at
        ~60 µs."""
        t0 = time.perf_counter()
        compiled = self.get(op, desc.size, shape, dtype)

        def run(global_array):
            return compiled(global_array)
        run.descriptor = desc
        self.stats["bind_seconds"] += time.perf_counter() - t0
        return run
