"""Multi-pod dry run: trace every (arch x shape x mesh) cell abstractly.

Port of ``repro/launch/dryrun.py``.  For each live cell this builds the
model, the AdamW state, the inputs and the caches as ``DTensor`` values
on the ``meta`` device (each rank's shard a tensor of shapes and dtypes
only: no memory), distributed by the production shardings, and runs the
cell's step once under :func:`repro_torch.sharding.activation_sharding`
and DTensor's ``implicit_replication``: the train step (forward,
backward and the AdamW update), the prefill step or the decode step.
DTensor shards each op by its placements and inserts the collectives
that the placements need, as XLA's partitioner does under ``jit(...,
in_shardings=...)``; the kernels take their shape-only branch
(:mod:`repro_torch.kernels.ops`).  Nothing is allocated on a device and
no kernel is launched.  The process group is a ``FakeStore`` group of
the mesh's size, and the figures are rank 0's:

* ``per_device_memory_bytes``: the peak of rank 0's live local bytes
  over the step.  The arguments (parameters, optimizer state, inputs,
  caches) are live throughout; every other tensor from its op until the
  last reference to its storage goes (autograd's saved tensors
  included), so a peak is what the caching allocator would have to hold,
  less its rounding and workspaces;
* ``output_bytes``: the local bytes of the step's outputs;
* ``flops``: rank 0's local operations (``torch.utils.flop_counter``'s
  formulas: products and attention), each counted once, plus the
  kernels' (:mod:`repro_torch.kernels.cost`).  Elementwise work is not
  counted, where XLA's ``cost_analysis`` counts it;
* ``hlo_bytes``: the local ops' operand and result bytes, op by op
  (views excluded), plus the kernels' own: an upper bound beside XLA's
  ``bytes accessed``, which counts a fused computation once;
* ``collective_bytes``: the result bytes of each collective, by JAX's
  kinds (``all-gather``, ``all-reduce``, ``reduce-scatter``,
  ``all-to-all``, ``collective-permute``), as JAX sums the result shapes
  of its HLO's collectives;
* ``compile_s``: the trace's seconds (the name is JAX's).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k --mesh 2,2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both

Results go to ``--out`` (default ``build/dryrun/dryrun.json``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import sys
import time
import traceback
import warnings
import weakref
from pathlib import Path
from typing import Any

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.placement_types import _StridedShard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, cell_is_applicable,
                                 get_config)
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import get_model
from repro_torch.serving.serve_loop import (input_specs, make_prefill_step,
                                            make_serve_step)
from repro_torch.sharding import (SERVE_RULES, TRAIN_RULES, NamedSharding, P,
                                  activation_sharding, tree_param_specs)
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# NVIDIA H100 SXM data-sheet figures, for "NVIDIA H100 80GB HBM3" at its
# 700 W power limit (roofline)
PEAK_FLOPS = 989e12          # bf16 dense, per card
HBM_BW = 3.35e12             # bytes/s per card (HBM3)
HBM_BYTES = 80e9             # bytes per card
NVLINK_BW = 450e9            # bytes/s per card, each way (NVLink 4)

#: ``_c10d_functional`` collectives (DTensor's) and ``c10d`` ones (the
#: sequence-parallel decode's) by JAX's HLO kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_NO_TRAFFIC = {"wait_tensor", "_wrap_tensor_autograd", "empty",
               "empty_like", "empty_strided", "detach", "lift_fresh"}


def _fake_active() -> bool:
    """True inside DTensor's sharding propagation, which runs each op on
    fake tensors of the global shapes to learn its outputs' metadata."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


@functools.lru_cache(maxsize=None)
def _composite(func) -> bool:
    """Whether ``func`` is defined by its decomposition (a
    CompositeImplicitAutograd kernel)."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)


def _tensors(tree) -> list:
    """The tensors of ``tree``: an op's arguments or outputs (a tensor, a
    flat list or tuple, one with lists in it, or any pytree)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    for x in (tree if isinstance(tree, (list, tuple)) else (tree,)):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)) and all(
                isinstance(y, torch.Tensor) for y in x):
            out.extend(x)
        elif x is not None and not isinstance(x, (int, float, bool, str)):
            out.extend(t for t in pytree.tree_leaves(x)
                       if isinstance(t, torch.Tensor))
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


class _Trace(TorchDispatchMode):
    """Rank 0's local ops: the ``DTensor``-level op is left to DTensor
    (``NotImplemented``), whose local ops and collectives then come back
    through this mode one by one.  Storages are known by ``id`` while
    they live (a finalizer forgets each one as it dies)."""

    def __init__(self, keep_ops: bool = False):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: dict[str, int] = {}
        self.live = self.peak = self.argument_bytes = 0
        self.ops: list[str] | None = [] if keep_ops else None
        self.kernel_calls: list = []
        self._known: dict[int, int] = {}
        self._plan: dict = {}
        self.quiet = 0     # > 0 inside DTensor's sharding propagation

    def argument(self, args) -> None:
        """Counts the local bytes of the meta tensors of ``args`` (a
        module's parameters, or a tree) as live for the whole step."""
        for t in map(_local, _arg_tensors(args)):
            s = t.untyped_storage()
            if t.is_meta and id(s) not in self._known:
                self._known[id(s)] = s.nbytes()
                self.live += s.nbytes()
                self.argument_bytes += s.nbytes()
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        self.live -= self._known.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if not (self.quiet or _fake_active()) and _composite(func):
            # under inference mode a composite op (matmul, einsum) comes
            # whole: its parts are what run, and what carry a FLOP formula
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not (self.quiet or _fake_active()):
            self._record(func, args, kwargs, out)
        return out

    def _plan_of(self, func):
        """(collective kind or None, FLOP formula or None, whether the op
        moves bytes) of ``func``."""
        plan = self._plan.get(func)
        if plan is None:
            name = func._schema.name.split("::")[-1]
            kind = (_COLLECTIVES.get(name) if func.namespace in
                    ("_c10d_functional", "c10d") else None)
            plan = self._plan[func] = (
                kind, flop_registry.get(func._overloadpacket),
                not func.is_view and name not in _NO_TRAFFIC)
        return plan

    def _record(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        if not all(t.is_meta for t in outs):
            return      # DTensor's host-side bookkeeping, not rank 0's work
        kind, flop, moves = self._plan_of(func)
        if kind is not None:
            size = sum(t.nbytes for t in outs)
            self.collectives[kind] = self.collectives.get(kind, 0) + size
        if flop is not None:
            self.flops += flop(*args, **kwargs, out_val=out)
        if moves:
            self.bytes += sum(t.nbytes for t in _tensors(args)) \
                + sum(t.nbytes for t in _tensors(list(kwargs.values()))) \
                + sum(t.nbytes for t in outs)
        for t in outs:
            s = t.untyped_storage()
            key = id(s)
            if key not in self._known:
                self._known[key] = s.nbytes()
                self.live += s.nbytes()
                weakref.finalize(s, self._free, key)
        if self.live > self.peak:
            self.peak = self.live
        if self.ops is not None:
            shapes = ", ".join(f"{str(t.dtype)[6:]}{list(t.shape)}"
                               for t in outs)
            self.ops.append(f"{func} -> {shapes}")


@contextlib.contextmanager
def _quiet_propagation(trace: _Trace):
    """DTensor finds an op's output placements by running it, on fake
    tensors or through its decomposition on meta ones, the first time it
    meets the op's placements and shapes: that work is not rank 0's and
    is kept out of ``trace``."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "propagate_op_sharding_non_cached"
    orig = ShardingPropagator.__dict__.get(name)
    if orig is None:            # another torch: nothing to wrap
        yield
        return

    @functools.wraps(orig)
    def quiet(self, *args, **kwargs):
        trace.quiet += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            trace.quiet -= 1
    setattr(ShardingPropagator, name, quiet)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


@contextlib.contextmanager
def _memo_strided_sizes():
    """DTensor finds a strided shard's local size (a flattened dimension
    sharded over two mesh axes, as a product's (batch x sequence) rows
    are) by splitting an index tensor of the dimension's length; the
    trace asks for the same few sizes thousands of times.  Memoized for
    the trace: the answer is a function of the arguments alone."""
    cls = _StridedShard
    orig = cls.__dict__.get("local_shard_size_and_offset")
    if orig is None:            # another torch: nothing to memoize
        yield
        return
    memo: dict = {}

    def sizes(self, size, num_chunks, rank, *args, **kwargs):
        if not all(isinstance(v, int) for v in (size, num_chunks, rank)):
            return orig(self, size, num_chunks, rank, *args, **kwargs)
        key = (self.dim, self.split_factor, size, num_chunks, rank, args,
               tuple(sorted(kwargs.items())))
        got = memo.get(key)
        if got is None:
            got = memo[key] = orig(self, size, num_chunks, rank, *args,
                                   **kwargs)
        n, offset = got
        return n, list(offset) if isinstance(offset, list) else offset
    cls.local_shard_size_and_offset = sizes
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def _arg_tensors(args) -> list:
    """The tensors of ``args``, a module standing for its parameters."""
    out = []
    for a in args:
        out += (list(a.parameters()) if isinstance(a, nn.Module)
                else _tensors(a))
    return out


def local_bytes(args) -> int:
    """Rank 0's device bytes of the tensors of ``args`` (a sequence of
    trees and modules): each ``meta`` storage once (a host tensor, such as
    the AdamW step counter, holds no device memory)."""
    seen, total = set(), 0
    for t in map(_local, _arg_tensors(args)):
        if not t.is_meta:
            continue
        s = t.untyped_storage()
        if id(s) not in seen:
            seen.add(id(s))
            total += s.nbytes()
    return total


def _abstract_params(cfg: ModelConfig) -> nn.Module:
    """The family's model at ``cfg``'s shapes on ``meta``."""
    return get_model(cfg).init(cfg, device="meta")


def _batch_axes(mesh: DeviceMesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _batch_spec(tree, mesh: DeviceMesh, rules, seq_axis=None):
    """Shard the leading batch dim of every tensor leaf; 2nd dim
    optionally."""
    ba = _batch_axes(mesh)

    def one(x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return NamedSharding(mesh, P())
        parts: list[Any] = [None] * x.ndim
        bsz = math.prod(_axis_size(mesh, a) for a in ba)
        if x.shape[0] % bsz == 0:
            parts[0] = ba
        if seq_axis is not None and x.ndim > 1 and \
                x.shape[1] % _axis_size(mesh, seq_axis) == 0 and \
                x.shape[1] > 1:
            parts[1] = seq_axis
        return NamedSharding(mesh, P(*parts))
    return pytree.tree_map(one, tree)


def cache_sharding_for(cfg: ModelConfig, cache_tree, mesh: DeviceMesh,
                       batch: int):
    """Explicit sharding for each cache leaf based on its shape
    signature."""
    ba = _batch_axes(mesh)
    bsz = math.prod(_axis_size(mesh, a) for a in ba)
    msz = _axis_size(mesh, "model")

    def one(x):
        parts: list[Any] = [None] * x.ndim
        for i, d in enumerate(x.shape):
            if d == batch and batch % bsz == 0 and ba not in parts:
                parts[i] = ba
                # the dim right after batch is sequence (kv len) when large
                j = i + 1
                if j < x.ndim and x.shape[j] % msz == 0 and \
                        x.shape[j] >= msz and x.shape[j] > 1:
                    parts[j] = "model"
                break
        return NamedSharding(mesh, P(*parts))
    return pytree.tree_map(one, cache_tree)


def distribute_abstract(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """A ``DTensor`` of ``t``'s global shape and dtype whose local shard
    is a fresh ``meta`` tensor of rank 0's shape (its own storage, so that
    its bytes are the shard's)."""
    pl = sharding.placements
    shape, _ = compute_local_shape_and_global_offset(t.shape, sharding.mesh,
                                                     pl)
    local = torch.empty(shape, dtype=t.dtype, device="meta")
    return DTensor.from_local(local, sharding.mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def _distribute_module(module: nn.Module, shardings: dict) -> None:
    """Replace each parameter of ``module`` by its abstract ``DTensor``
    (``shardings``: parameter name -> :class:`NamedSharding`)."""
    for prefix, mod in module.named_modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            full = f"{prefix}.{name}" if prefix else name
            mod._parameters[name] = nn.Parameter(
                distribute_abstract(p, shardings[full]), requires_grad=False)


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    error: str = ""
    compile_s: float = 0.0
    flops: float = 0.0
    hlo_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    per_device_memory_bytes: float = 0.0
    output_bytes: float = 0.0


_MESHES: dict = {}


def _make_mesh(multi_pod: bool, shape=None, device: str = "cuda"):
    """(mesh, name): the production mesh, (16, 16) or (2, 16, 16), or
    ``shape`` over the last of ("pod", "data", "model"), of ``device``'s
    type, on a ``FakeStore`` process group of the mesh's size at rank 0
    (set up here, and set up anew when the size changes)."""
    if shape is not None:
        shape = tuple(shape)
        name = "x".join(map(str, shape))
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        name = "2x16x16" if multi_pod else "16x16"
    key = (shape, device)
    if key in _MESHES:
        return _MESHES[key], name
    world = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
        _MESHES.clear()
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    if shape in ((16, 16), (2, 16, 16)):
        mesh = make_production_mesh(multi_pod=len(shape) == 3, device=device)
    else:
        axes = ("pod", "data", "model")[-len(shape):]
        mesh = init_device_mesh(torch.device(device).type, shape,
                                mesh_dim_names=axes)
    _MESHES[key] = mesh
    return mesh, name


def apply_variant(cfg: ModelConfig, variant: str) -> ModelConfig:
    """Perf-iteration config transforms (the JAX package's variants;
    ``serve_bf16``, ``mla_absorbed`` and ``sp_decode`` act in
    :func:`_trace_cell`)."""
    if variant == "ssd_bf16" and cfg.ssm is not None:
        return cfg.with_(ssm=dataclasses.replace(cfg.ssm,
                                                 intra_dtype="bfloat16"))
    if variant == "ssd_bf16_hb16" and cfg.ssm is not None:
        return cfg.with_(ssm=dataclasses.replace(
            cfg.ssm, intra_dtype="bfloat16", head_block=16))
    if variant.startswith("ssd_chunk") and cfg.ssm is not None:
        return cfg.with_(ssm=dataclasses.replace(cfg.ssm,
                                                 chunk=int(variant[9:])))
    return cfg


def _trace_cell(cfg: ModelConfig, cell: ShapeCell, mesh: DeviceMesh,
                remat: str, variant: str, keep_ops: bool = False):
    """(trace, output bytes): the cell's step traced once on rank 0's
    abstract shards (the port's ``jit(...).lower()``)."""
    cfg = apply_variant(cfg, variant)
    # the serve steps run under inference mode, where DTensor takes views
    # only of the DTensors made there
    with torch.inference_mode(cell.kind != "train"):
        step, args, rules = cell_arguments(cfg, cell, mesh, remat, variant)
        trace = _Trace(keep_ops)
        trace.argument(args)
        ops.shape_only.clear()
        with activation_sharding(mesh, rules), implicit_replication(), \
                trace, _quiet_propagation(trace), _memo_strided_sizes(), \
                warnings.catch_warnings():
            # a (1,) position vector meets DTensors in every decode step
            warnings.filterwarnings("ignore", message="Found a non-scalar")
            out = step(*args)
    for _, flops, nbytes in ops.shape_only:
        trace.flops += flops
        trace.bytes += nbytes
    trace.kernel_calls = list(ops.shape_only)
    ops.shape_only.clear()
    return trace, local_bytes(out)


def cell_arguments(cfg: ModelConfig, cell: ShapeCell, mesh: DeviceMesh,
                   remat: str = "full", variant: str = ""):
    """(step, arguments, activation rules) of a cell: the step of its
    kind and its arguments as abstract ``DTensor`` values under the
    production shardings (JAX's ``in_shardings``), the module first.
    A serving cell's must be made under inference mode, as
    :func:`_trace_cell` makes them."""
    module = _abstract_params(cfg)
    if "serve_bf16" in variant and cell.kind != "train":
        # serving weights stored in bf16: half the weight-read traffic
        module.to(torch.bfloat16)
    rules = dict(TRAIN_RULES if cell.kind == "train" else SERVE_RULES)
    _distribute_module(module, {
        name: NamedSharding(mesh, spec)
        for name, spec in tree_param_specs(module, rules, mesh).items()})
    ishape = input_specs(cfg, cell)

    def placed(key):
        tree = ishape[key]
        shardings = (cache_sharding_for(cfg, tree, mesh, cell.global_batch)
                     if key == "cache" else _batch_spec(tree, mesh, rules))
        return pytree.tree_map(distribute_abstract, tree, shardings)
    if cell.kind == "train":
        bsz = math.prod(_axis_size(mesh, a) for a in _batch_axes(mesh))
        step = make_train_step(cfg, remat=remat, moe_groups=bsz)
        opt = adamw_init(dict(module.named_parameters()))
        return step, (module, opt, placed("batch")), rules
    if cell.kind == "prefill":
        extra = [placed(k) for k in ("frames", "patches") if k in ishape]
        return (make_prefill_step(cfg),
                (module, placed("tokens"), *extra, placed("cache")), rules)
    step = make_serve_step(cfg, mla_absorbed="mla_absorbed" in variant,
                           sp_decode="sp_decode" in variant)
    return step, (module, placed("tokens"), placed("cache"),
                  placed("pos")), rules


def depth_variants(cfg: ModelConfig):
    """(cfg@1unit, cfg@2units, n_units) for linear depth extrapolation.

    The units are the JAX package's (whose XLA cost analysis counts a
    loop body once): total = g(1) + (units - 1) * (g(2) - g(1)).  An
    eager trace counts every layer, so the extrapolation of a trace
    equals the full-depth trace's count.
    """
    if cfg.family == "hybrid":
        k = cfg.shared_attn_every
        groups = cfg.num_layers // k
        tail = cfg.num_layers - groups * k
        return (cfg.with_(num_layers=k + tail, scan_unroll=True),
                cfg.with_(num_layers=2 * k + tail, scan_unroll=True),
                groups)
    if cfg.family == "encdec":
        # enc and dec layer counts are equal in the full config
        return (cfg.with_(num_layers=1, num_encoder_layers=1,
                          scan_unroll=True),
                cfg.with_(num_layers=2, num_encoder_layers=2,
                          scan_unroll=True),
                cfg.num_layers)
    if cfg.local_global != (0, 0):
        p = sum(cfg.local_global)
        return (cfg.with_(num_layers=p, scan_unroll=True),
                cfg.with_(num_layers=2 * p, scan_unroll=True),
                cfg.num_layers // p)
    nd = cfg.moe.num_dense_layers if cfg.moe is not None else 0
    return (cfg.with_(num_layers=nd + 1, scan_unroll=True),
            cfg.with_(num_layers=nd + 2, scan_unroll=True),
            cfg.num_layers - nd)


def _costs_of(trace) -> tuple[float, float, dict]:
    return float(trace.flops), float(trace.bytes), dict(trace.collectives)


def extract_costs(cfg: ModelConfig, cell: ShapeCell, mesh: DeviceMesh,
                  remat: str, variant: str) -> tuple[float, float, dict]:
    """Depth-extrapolated per-device (flops, bytes, collective_bytes)."""
    c1, c2, units = depth_variants(cfg)
    f1, b1, coll1 = _costs_of(_trace_cell(c1, cell, mesh, remat,
                                          variant)[0])
    f2, b2, coll2 = _costs_of(_trace_cell(c2, cell, mesh, remat,
                                          variant)[0])
    flops = f1 + (units - 1) * (f2 - f1)
    nbytes = b1 + (units - 1) * (b2 - b1)
    coll = {}
    for op in set(coll1) | set(coll2):
        v1, v2 = coll1.get(op, 0), coll2.get(op, 0)
        coll[op] = max(0, int(v1 + (units - 1) * (v2 - v1)))
    return flops, nbytes, coll


def run_cell(arch: str, shape: str, multi_pod: bool,
             remat: str = "full", save_hlo: bool = False,
             variant: str = "", extrapolate: bool = True, *,
             mesh_shape=None, device: str = "cuda",
             cfg: ModelConfig | None = None,
             cell: ShapeCell | None = None) -> CellResult:
    """One cell: ``arch`` x ``shape`` (or the given ``cfg`` and ``cell``)
    on the production mesh or ``mesh_shape``.  A failure is recorded in
    ``error``, not raised, so that a sweep goes on."""
    cfg = cfg or get_config(arch)
    cell = cell or SHAPES[shape]
    mesh, mesh_name = _make_mesh(multi_pod, mesh_shape, device)
    res = CellResult(arch, shape, mesh_name, ok=False)
    t0 = time.time()
    try:
        # deliverable: the FULL config must trace
        trace, res.output_bytes = _trace_cell(cfg, cell, mesh, remat,
                                              variant, keep_ops=save_hlo)
        res.compile_s = time.time() - t0
        res.per_device_memory_bytes = float(trace.peak)
        if save_hlo:
            RESULTS_DIR.mkdir(parents=True, exist_ok=True)
            tag = f"{arch}_{shape}_{mesh_name}"
            (RESULTS_DIR / f"ops_{tag}.txt").write_text("\n".join(
                trace.ops + [f"kernel {k} flops={f} bytes={b}"
                             for k, f, b in trace.kernel_calls]) + "\n")
        if extrapolate:
            res.flops, res.hlo_bytes, res.collective_bytes = extract_costs(
                cfg, cell, mesh, remat, variant)
        else:
            res.flops, res.hlo_bytes, res.collective_bytes = _costs_of(trace)
        res.ok = True
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        res.error = f"{type(e).__name__}: {e}"[:2000]
        res.compile_s = time.time() - t0
        traceback.print_exc()
    return res


def live_cells():
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = cell_is_applicable(cfg, shape)
            if ok:
                yield arch, shape
            else:
                print(f"SKIP {arch} x {shape}: {why}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true",
                    help="every live cell (of --arch alone, if given)")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="off")
    ap.add_argument("--mesh", default=None,
                    help="mesh shape over the last of (pod, data, model), "
                    "e.g. 2,2 or 2,2,2 (default: the production mesh)")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (the trace allocates "
                    "nothing on it)")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--variant", default="",
                    help="perf variant tag, e.g. mla_absorbed")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write each cell's traced local ops")
    ap.add_argument("--no-extract", action="store_true",
                    help="the full trace's costs, no depth extrapolation")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    mesh_shape = (tuple(int(x) for x in args.mesh.split(","))
                  if args.mesh else None)
    pods = {"off": [False], "on": [True], "both": [False, True]}[
        args.multi_pod]
    if mesh_shape is not None:
        pods = [False]
    cells = ([c for c in live_cells() if args.arch in (None, c[0])]
             if args.all else [(args.arch, args.shape)])
    results = []
    for arch, shape in cells:
        for mp in pods:
            r = run_cell(arch, shape, mp, remat=args.remat,
                         save_hlo=args.save_hlo, variant=args.variant,
                         extrapolate=(not mp) and not args.no_extract,
                         mesh_shape=mesh_shape, device=args.device)
            print(f"=== {arch} x {shape} x {r.mesh} ===", flush=True)
            print(json.dumps(dataclasses.asdict(r)), flush=True)
            results.append(dataclasses.asdict(r))
    if dist.is_initialized():
        dist.destroy_process_group()
        _MESHES.clear()

    out = Path(args.out) if args.out else RESULTS_DIR / "dryrun.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    existing = []
    if out.exists():
        existing = json.loads(out.read_text())
        keys = {(r["arch"], r["shape"], r["mesh"]) for r in results}
        existing = [r for r in existing
                    if (r["arch"], r["shape"], r["mesh"]) not in keys]
    out.write_text(json.dumps(existing + results, indent=1))
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells traced OK -> {out}")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
