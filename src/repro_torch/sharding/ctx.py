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

:func:`product` and :func:`index_write` are the model code's ``x @ w``
and ``dst[key] = value``: on plain tensors exactly those (an fp32 product
on the card through ``ops.linear``'s kernel where ``ops.product_route``
sends it); on
``DTensor`` operands (the dry run's) they run each rank's local tensors
under XLA's partitioning of a product and of a scatter, where DTensor's
own would choose op by op (torch 2.11 also refuses to flatten a sharded
sequence, and has no sharding for ``index_put``).
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.placement_types import _StridedShard

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


def placements_of(t: DTensor) -> tuple:
    """``t``'s placements with each shard's dim made non-negative (torch
    2.11 can leave a ``Shard(-1)``, which it then refuses to take)."""
    out = []
    for p in t.placements:
        if p.is_shard() and p.dim < 0:
            dim = p.dim % t.ndim
            p = (_StridedShard(dim, split_factor=p.split_factor)
                 if isinstance(p, _StridedShard) else Shard(dim))
        out.append(p)
    return tuple(out)


def per_rank(fn, outs, ins, mesh: DeviceMesh):
    """``fn`` on each rank's local tensors of its ``DTensor`` arguments,
    each redistributed to its entry of ``ins`` (placements; None for a
    plain tensor or a number); each output a ``DTensor`` of its entry of
    ``outs`` (None for an absent output)."""
    return local_map(fn, out_placements=outs, in_placements=ins,
                     device_mesh=mesh, redistribute_inputs=True)


def product_rule(x: DTensor, w: DTensor) -> tuple:
    """(x's, w's, the output's) placements for ``x (..., d) @ w (d, f)``,
    mesh dim by mesh dim, as XLA partitions a product: a row dim of x
    (batch, sequence) stays sharded and w is gathered there (FSDP's
    weight all-gather), unless w's columns are sharded on that mesh dim,
    where x is gathered instead (Megatron's all-gather before a
    column-parallel product); a sharded contraction leaves a partial sum;
    a pending partial sum is reduced first."""
    last = x.ndim - 1
    xs, ws, outs = [], [], []
    for xp, wp in zip(placements_of(x), placements_of(w)):
        xp = Replicate() if xp.is_partial() else xp
        wp = Replicate() if wp.is_partial() else wp
        if xp.is_shard() and xp.dim != last and not wp.is_shard(1):
            got = (xp, Replicate(), xp)
        elif xp.is_shard(last) or wp.is_shard(0):
            got = (Shard(last), Shard(0), Partial())
        elif wp.is_shard(1):
            got = (Replicate(), wp, Shard(last))
        else:
            got = (Replicate(),) * 3
        for out, g in zip((xs, ws, outs), got):
            out.append(g)
    return tuple(xs), tuple(ws), tuple(outs)


def expert_product_rule(x: DTensor, w: DTensor) -> tuple:
    """As :func:`product_rule` for a product per expert, ``x (..., E, n,
    d) @ w (E, d, f)``: a leading (group) dim of x stays sharded and w is
    gathered there; else the experts, the contraction or w's columns
    sharded as w is (expert parallelism, a partial sum, column
    parallelism)."""
    last, experts = x.ndim - 1, x.ndim - 3
    xs, ws, outs = [], [], []
    for xp, wp in zip(placements_of(x), placements_of(w)):
        xp = Replicate() if xp.is_partial() else xp
        wp = Replicate() if wp.is_partial() else wp
        if xp.is_shard() and xp.dim < experts:
            got = (xp, Replicate(), xp)
        elif wp.is_shard(0):
            got = (Shard(experts), wp, Shard(experts))
        elif wp.is_shard(1):
            got = (Shard(last), wp, Partial())
        elif wp.is_shard(2):
            got = (Replicate(), wp, Shard(last))
        else:
            got = (Replicate(),) * 3
        for out, g in zip((xs, ws, outs), got):
            out.append(g)
    return tuple(xs), tuple(ws), tuple(outs)


def product(x, w):
    """``x @ w`` for a 2-d ``w``, or per expert for a 3-d one (``x (...,
    E, n, d)``); for ``DTensor`` operands by :func:`product_rule` or
    :func:`expert_product_rule`, on each rank's local tensors.  An fp32
    token-row product on the card runs the split-TF32 kernel
    (``ops.linear``), as ``ops.product_route`` decides from the operands;
    any other product is cuBLAS's, the fp32 ones on the card counted by
    the rule's reason."""
    route = ops.product_route(x, w)
    if route == "gemm":
        return ops.linear(x, w)
    ops.count_library(route)
    if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x @ w
    rule = product_rule if w.ndim == 2 else expert_product_rule
    xs, ws, outs = rule(x, w)
    return per_rank(torch.matmul, (outs,), (xs, ws), x.device_mesh)(x, w)


def lookup(table, idx):
    """``table[idx]``, rows of a (V, d) table.  For ``DTensor`` operands
    each rank looks up its own rows: where the vocab is sharded, ids of
    another shard give zeros and the result is their partial sum (as
    DTensor's own embedding does); where ids are sharded, the table is
    gathered there (FSDP); torch 2.11 can place neither an ``index`` of
    ids sharded over two mesh dims nor its backward."""
    if not (isinstance(table, DTensor) and isinstance(idx, DTensor)):
        return table[idx]
    mesh, last = table.device_mesh, idx.ndim
    ts, xs, outs = [], [], []
    for tp, xp in zip(placements_of(table), placements_of(idx)):
        tp = Replicate() if tp.is_partial() else tp
        if xp.is_shard():
            got = (Replicate(), xp, xp)
        elif tp.is_shard(0):
            got = (tp, Replicate(), Partial())
        elif tp.is_shard(1):
            got = (tp, Replicate(), Shard(last))
        else:
            got = (Replicate(),) * 3
        for out, g in zip((ts, xs, outs), got):
            out.append(g)
    ts = tuple(ts)
    start = compute_local_shape_and_global_offset(table.shape, mesh, ts)[1][0]

    def body(t, i):
        if not any(p.is_shard(0) for p in ts):
            return t[i]
        local = i - start
        hit = (local >= 0) & (local < t.shape[0])
        rows = t[local.clamp(0, t.shape[0] - 1)]
        return torch.where(hit[..., None], rows, torch.zeros((), dtype=t.dtype,
                                                             device=t.device))
    return per_rank(body, (tuple(outs),), (ts, tuple(xs)), mesh)(table, idx)


def _indexed(t: DTensor, n: int) -> tuple:
    """``t``'s placements for indexing its ``n`` leading dims: those dims
    and any partial sum made whole, the trailing dims as they are."""
    return tuple(p if p.is_shard() and p.dim >= n else Replicate()
                 for p in placements_of(t))


def _trailing(pl: tuple, shift: int) -> tuple:
    """Placements ``pl`` of a tensor's trailing dims moved ``shift`` dims
    (onto the result of indexing, or the value written)."""
    return tuple(Shard(p.dim + shift) if p.is_shard() else Replicate()
                 for p in pl)


def index_read(src, key: tuple):
    """``src[key]`` for index tensors ``key`` on src's leading dims.  For
    a ``DTensor`` src each rank reads its own shard of the trailing dims,
    the indexed dims and the indices replicated (torch 2.11 cannot place
    an index whose ids are sharded over two mesh dims)."""
    if not isinstance(src, DTensor):
        return src[key]
    n, mesh = len(key), src.device_mesh
    pl = _indexed(src, n)
    shift = len(torch.broadcast_shapes(*(k.shape for k in key))) - n
    whole = (Replicate(),) * mesh.ndim
    return per_rank(lambda s, *idx: s[idx], (_trailing(pl, shift),),
                    (pl, *(whole if isinstance(k, DTensor) else None
                           for k in key)), mesh)(src, *key)


def take(x, dim: int, idx):
    """``x`` indexed by ``idx`` on ``dim`` (``x[:, idx]`` for dim 1).  For
    a ``DTensor`` each rank takes from its own shard, ``dim`` whole
    (torch 2.11 cannot place the backward of an index that skips a
    dim)."""
    if not isinstance(x, DTensor):
        return x[(slice(None),) * dim + (idx,)]
    pl = tuple(Replicate() if p.is_partial() or p.is_shard(dim) else p
               for p in placements_of(x))
    return per_rank(lambda t, i: t.index_select(dim, i), (pl,),
                    (pl, (Replicate(),) * len(pl)
                     if isinstance(idx, DTensor) else None),
                    x.device_mesh)(x, idx)


def index_write(dst, key: tuple, value):
    """``dst[key] = value`` for index tensors ``key`` on dst's leading
    dims; returns dst.  For a ``DTensor`` dst a new one: each rank writes
    its own shard of the trailing dims (which the indices do not touch),
    the indexed dims and the indices replicated."""
    if not isinstance(dst, DTensor):
        dst[key] = value
        return dst
    n, mesh = len(key), dst.device_mesh
    pl = _indexed(dst, n)
    vals = _trailing(pl, value.ndim - dst.ndim)
    whole = (Replicate(),) * mesh.ndim

    def body(d, v, *idx):
        return d.index_put(idx, v)
    return per_rank(body, (pl,), (pl, vals, *(
        whole if isinstance(k, DTensor) else None for k in key)), mesh)(
        dst, value, *key)


# ---------------------------------------------------------------------------
# model code's reshapes and cache writes on DTensors
# ---------------------------------------------------------------------------

def _whole(t, dim: int, first: int):
    """``DTensor`` ``t`` gathered on ``dim`` where ``dim`` is sharded over
    more ranks than ``first``, the leading factor it is split into,
    divides (8 KV heads over 16): DTensor cannot split an uneven shard."""
    dim %= t.ndim
    mesh, n, pl = t.device_mesh, 1, placements_of(t)
    for i, p in enumerate(pl):
        n *= mesh.size(i) if p.is_shard(dim) else 1
    if first % n == 0:
        return t
    return t.redistribute(placements=[
        Replicate() if p.is_shard(dim) else p for p in pl])


def merged(t, dim: int, first: int):
    """``t``, whose ``dim`` merges ``first`` x the rest; for a ``DTensor``
    under autograd, the gradient is made splittable (:func:`_whole`)
    before it reaches the merge's backward."""
    if isinstance(t, DTensor) and t.requires_grad:
        t.register_hook(functools.partial(_whole, dim=dim, first=first))
    return t


def split_last(x, sizes):
    """``x`` (..., prod(sizes)) viewed as (..., *sizes), a ``DTensor``
    first made splittable (:func:`_whole`)."""
    if isinstance(x, DTensor):
        x = _whole(x, -1, sizes[0])
    return x.view(*x.shape[:-1], *sizes)


def settled(x, gather: int | None = None):
    """``x`` with any partial sum it carries reduced (a ``DTensor``
    that a product over a sharded dimension left ``Partial``: DTensor
    cannot reshape one), and dim ``gather`` gathered where sharded (a
    dim to be flattened into the one before it); ``x`` itself
    otherwise."""
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if p.is_partial() or (
        gather is not None and p.is_shard(gather)) else p
        for p in placements_of(x)]
    return x if tuple(pl) == x.placements else x.redistribute(placements=pl)


def write_rows(dst, rows, src) -> None:
    """``dst[:, rows] = src`` in place: ``src`` (B, s, ...) into the rows
    ``rows`` (a device index tensor, so no host sync) of ``dst`` (B, S,
    ...).  A ``DTensor`` ``dst`` whose rows may be sharded is written by
    each rank in its own shard, each of its rows taken from ``src`` where
    ``rows`` lands in it (XLA's masked update of a sharded
    dynamic-update-slice); ``src`` comes to every rank whole along its
    rows."""
    if not isinstance(dst, DTensor):
        dst.index_copy_(1, rows, src.to(dst.dtype))
        return
    mesh, pl, n = dst.device_mesh, placements_of(dst), dst.shape[1]
    start = compute_local_shape_and_global_offset(dst.shape, mesh, pl)[1][1]

    def body(d, r, s):
        ar = torch.arange(r.numel(), device=d.device)
        take = torch.full((n,), -1, dtype=torch.long, device=d.device) \
            .scatter_(0, r.long(), ar)[start:start + d.shape[1]]
        new = s.to(d.dtype).index_select(1, take.clamp(min=0))
        own = (take >= 0).view(1, -1, *[1] * (d.ndim - 2))
        d.copy_(torch.where(own, new, d))
    whole = tuple(Replicate() if p.is_shard(1) else p for p in pl)
    per_rank(body, None, (pl, (Replicate(),) * mesh.ndim, whole), mesh)(
        dst, rows, src)


def grad_gathered(t, dim: int):
    """``t``; for a ``DTensor`` under autograd, its gradient is gathered
    on ``dim`` before it reaches the backward of the split that made
    ``t``, which flattens ``dim`` into the one before it (torch 2.11
    cannot flatten a sharded non-leading dim)."""
    if isinstance(t, DTensor) and t.requires_grad:
        t.register_hook(functools.partial(settled, gather=dim))
    return t


def split_ready(t, dim: int, first: int):
    """``t`` ready to have ``dim`` split with ``first`` leading: a
    ``DTensor`` with any partial sum reduced and ``dim`` made splittable
    (:func:`_whole`); ``t`` itself otherwise."""
    if isinstance(t, DTensor):
        t = _whole(settled(t), dim, first)
    return t


# last: ops imports this module's per_rank and placements_of, defined above
from repro_torch.kernels import ops  # noqa: E402
