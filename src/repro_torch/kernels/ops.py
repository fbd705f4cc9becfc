"""Public wrappers for the Hopper kernels in ``csrc/``.

Each wrapper launches its CUDA kernel for tensors on the card and runs
the kernel's plain PyTorch version (:mod:`repro_torch.kernels.ref`) for
tensors on the CPU; there is no other switch.  A CUDA call that cannot
launch (no ``nvcc``, a shape the kernel does not take, a refused launch)
raises rather than computing some other way.  Unlike the TPU wrappers,
nothing is padded: the kernels mask ragged sequence edges themselves.

Each launch adds one to :data:`launches` under the wrapper's name, so a
run can show that its path went through the kernels.

Products.  :func:`linear` is the fp32 product ``x @ w`` on the tensor
cores in split-TF32 (``csrc/gemm.cu``).  The models reach it through
``sharding.ctx.product``, which asks :func:`product_route` where each
product runs: the kernel for the fp32 token-row products on the card,
cuBLAS for the rest, each fp32 one on the card counted by its reason in
:data:`library_products`.

Gradients.  ``attention``, ``fused_adaln`` and ``ssd`` are
differentiable: when grad mode is on and an operand requires grad they
run through a ``torch.autograd.Function`` whose backward is K2's, K1's or
K4's backward kernel (:func:`attention_bwd`, :func:`fused_adaln_bwd`,
:func:`ssd_bwd`) on the card and its closed-form plain version in
``ref.py`` on the CPU; only then does K2's forward write the log-sum-exp
and K4's forward keep the scratch (cum, S_in, C B^T) their backward
kernels read.  Otherwise (a serving call under ``inference_mode``, frozen
weights) they launch what they always did.  ``splice_attention`` has no
backward kernel and raises ``NotImplementedError`` rather than return an
output without a gradient path.  The JAX package's Pallas kernels have
no backward at all: it trains through its jnp path, which the port does
not keep.

The DiT path calls these wrappers thousands of times a request, on rank
threads that share one GIL, and K1's kernel runs for a few microseconds,
so the host's cost per call is kept low: the C entry points are looked
up once and kept in :data:`_fns`; the stream is the raw current-stream
handle (no ``torch.cuda.Stream`` object is built); and all the checks of
one call run in one pass over its operands (shape, dtype, device index
and contiguity, each raising ``ValueError`` as before).

The dry run (:mod:`repro_torch.launch.dryrun`).  Two more kinds of
operand reach the wrappers there, and neither launches anything:

* all on ``meta`` (each rank's shard in a trace that allocates no
  memory): the shape-only branch runs the card path's shape and dtype
  checks, returns empty ``meta`` outputs, allocates the card path's
  scratch on ``meta`` too (K4's forward scratch, its backward's work
  buffer, K2's backward's row sums), so that a trace's memory counts
  it (not K2's and K3's split-key pieces, whose number follows the
  card's SM count: a few rows of floats a piece), and appends the
  kernel's operations and bytes (:mod:`repro_torch.kernels.cost`) to
  :data:`shape_only`.  A CPU or
  CUDA operand never takes it: a mix with ``meta`` is refused as any
  other mix is;
* ``DTensor``: the wrapper runs on each rank's local tensors through
  ``local_map`` (``redistribute_inputs=True``) with the kernel's
  placement rule, so that DTensor moves the operands as the kernel
  needs: K2 and K3 take q, k and v sharded on batch or heads (KV heads
  for k and v, where they divide), the sequence replicated; K1 rows
  sharded (batch or sequence), the features replicated; K4 batch or
  heads sharded, the sequence replicated.  Each backward follows its
  forward's rule; a gradient summed over a sharded dimension comes back
  ``Partial``.  Only the first operand (q or x) is looked at.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import build, cost, ref
from repro_torch.sharding.ctx import per_rank, placements_of

#: head dims the attention kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
#: widest row the adaLN kernel holds in registers (one warp, 128 a lane)
MAX_ADALN_DIM = 4096
#: (head_dim p, state n, chunk) the SSD kernel is instantiated for
SSD_SHAPES = ((64, 128, 128), (16, 16, 16), (16, 16, 32), (32, 16, 64),
              (64, 32, 128), (64, 64, 128))
#: the stage kernels one SSD call launches, in order (one template for
#: both dtypes: split-TF32 in fp32, bf16 products in bf16; stage 2 fp32)
SSD_STAGES = ("ssd_chunk_state_mma", "ssd_state_pass", "ssd_cb_mma",
              "ssd_chunk_scan_mma")
#: the stage kernels one SSD backward call launches, in order (one
#: template for both dtypes: split-TF32 in fp32, bf16 products in bf16)
SSD_BWD_STAGES = ("ssd_bwd_dstate_mma", "ssd_bwd_state_pass",
                  "ssd_bwd_chunk_mma", "ssd_bwd_sum")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}

#: the tile rows the GEMM kernel (``csrc/gemm.cu``) is instantiated for,
#: the first preferred on a tie; a tile is that many rows of x by
#: GEMM_TILE_COLS output columns
GEMM_TILE_ROWS = (128, 96)
GEMM_TILE_COLS = 128
#: why :func:`product_route` left an fp32 product on the card to cuBLAS
LIBRARY_REASONS = ("rows", "grad", "dtensor", "align", "experts")

_count_lock = threading.Lock()
#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"fused_adaln": 0, "attention": 0, "splice_attention": 0,
            "ssd": 0, "attention_bwd": 0, "fused_adaln_bwd": 0,
            "ssd_bwd": 0, "linear": 0}
#: launches of K2's and K3's kernels by dtype and route, one a wrapper
#: call (also counted under the wrapper's name in :data:`launches`): the
#: tensor-core tile kernel alone, or split keys (the tile kernel over its
#: key pieces, then the combine kernel); and of K4's forward and backward
#: by dtype (fp32 and bf16 run different instances of their stage
#: kernels)
kernel_launches = {"attention fp32": 0, "attention fp32 split": 0,
                   "attention bf16": 0, "attention bf16 split": 0,
                   "ssd fp32": 0, "ssd bf16": 0, "ssd_bwd fp32": 0,
                   "ssd_bwd bf16": 0, "gemm fp32": 0}
#: fp32 products on the card that :func:`product_route` left to cuBLAS
#: since the last reset, by reason (:data:`LIBRARY_REASONS`)
library_products = dict.fromkeys(LIBRARY_REASONS, 0)
#: the library's C entry points by name, bound on first use
_fns: dict = {}
#: (wrapper, operations, bytes) of every call the shape-only branch took
#: since it was last cleared; the dry run reads and clears it
shape_only: list = []


def reset_launches() -> None:
    with _count_lock:
        for counts in (launches, kernel_launches, library_products):
            for name in counts:
                counts[name] = 0


@dataclasses.dataclass
class SplicedKV:
    """A §11 hit-path KV stream: the stale snapshot plus this step's
    fresh local shard at ``offset`` — handed to :func:`splice_attention`
    so the spliced tensor is never materialized (DESIGN.md §12)."""
    k_stale: Any                  # (B, N_total, KV, d)
    v_stale: Any
    k_fresh: Any                  # (B, N_local, KV, d)
    v_fresh: Any
    offset: int


def _on_card(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; anything else (a
    mix, another device type) is refused."""
    if all(t.is_cuda for t in tensors):
        return True
    if all(t.device.type == "cpu" for t in tensors):
        return False
    raise ValueError("kernel operands must all lie on the CPU or all on "
                     f"CUDA, got {[str(t.device) for t in tensors]}")


def _all_meta(name: str, *tensors) -> None:
    """The shape-only branch's entry check: every operand on ``meta``
    (a mix is refused, as :func:`_on_card` refuses one)."""
    if not all(t.is_meta for t in tensors):
        raise ValueError(f"{name}: kernel operands must all lie on the CPU, "
                         f"all on CUDA or all on meta, got "
                         f"{[str(t.device) for t in tensors]}")


def _traced(name: str, counts: tuple[int, int]) -> None:
    shape_only.append((name, *counts))


def _per_rank(fn, outs, ins, *args):
    """``fn(*args)`` on each rank's local tensors of the ``DTensor``
    operands, redistributed to ``ins`` (one entry an argument, None for
    an absent operand or a number); each output a ``DTensor`` of its
    entry of ``outs`` (one entry an output, None for an absent one)."""
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    return per_rank(fn, outs, ins, mesh)(*args)


def attention_rule(q, k) -> tuple:
    """(q's, k's and v's, the log-sum-exp's) placements: on each mesh
    dim, batch sharded where q's is, heads where q's are and the KV heads
    divide the same way, else replicated (the sequence is gathered)."""
    mesh, qt, kt, lt = q.device_mesh, [], [], []
    for i, pl in enumerate(placements_of(q)):
        if pl.is_shard(0):
            dims = (0, 0, 0)
        elif pl.is_shard(2) and k.shape[2] % mesh.size(i) == 0:
            dims = (2, 2, 1)
        else:
            dims = (None,) * 3
        for out, d in zip((qt, kt, lt), dims):
            out.append(Replicate() if d is None else Shard(d))
    return tuple(qt), tuple(kt), tuple(lt)


def _adaln_rule(x) -> tuple:
    """(x's, the (B, D) rows', the rows' gradients') placements: rows
    sharded where x's batch (dim 0) or sequence (dim 1) is, the features
    replicated.  A row gradient is a sum over the sequence: ``Partial``
    where the sequence is sharded."""
    xt, rt, gt = [], [], []
    for pl in placements_of(x):
        if pl.is_shard(0):
            got = (Shard(0), Shard(0), Shard(0))
        elif pl.is_shard(1):
            got = (Shard(1), Replicate(), Partial())
        else:
            got = (Replicate(),) * 3
        for out, g in zip((xt, rt, gt), got):
            out.append(g)
    return tuple(xt), tuple(rt), tuple(gt)


def _ssd_rule(x) -> tuple:
    """(x's and dt's, A's, B's and C's, the final state's, A's
    gradient's, B's and C's gradients') placements: batch or heads
    sharded where x's are, the sequence and the head dim replicated.  A
    gradient summed over a sharded dimension (dA over batch, dB and dC
    over heads) is ``Partial``."""
    cols = ([], [], [], [], [], [])
    for pl in placements_of(x):
        r = Replicate()
        if pl.is_shard(0):
            got = (Shard(0), r, Shard(0), Shard(0), Partial(), Shard(0))
        elif pl.is_shard(2):
            got = (Shard(2), Shard(0), r, Shard(1), Shard(0), Partial())
        else:
            got = (r,) * 6
        for out, g in zip(cols, got):
            out.append(g)
    return tuple(tuple(c) for c in cols)


def _check(name: str, like, *specs) -> int:
    """One pass over ``(what, tensor, shape)``: each tensor has its shape,
    ``like``'s dtype and device, and is contiguous.  Returns the kernel's
    dtype code."""
    dtype, dev = like.dtype, like.get_device()
    for what, t, shape in specs:
        if t.shape != shape:
            raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.dtype != dtype or t.get_device() != dev:
            raise ValueError(f"{name}: {what} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {like.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    code = _DTYPES.get(dtype)
    if code is None:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32 or bfloat16)")
    return code


def _fn(name: str):
    """The C entry point ``name``; the first call builds the library."""
    if build._lib is None:   # not loaded yet (or unloaded): bind anew
        _fns.clear()
    fn = _fns.get(name)
    if fn is None:
        fn = _fns[name] = getattr(build.load(), name)
    return fn


def _launch(name: str, fn, *args, route: str | None = None) -> None:
    err = fn(*args)
    if err != 0:
        msg = _fn("gfdit_error_string")(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")
    with _count_lock:        # rank threads launch concurrently
        launches[name] += 1
        if route is not None:
            kernel_launches[route] += 1


def _stream(device: int) -> int:
    return torch._C._cuda_getCurrentRawStream(device)


def _wants_grad(*tensors) -> bool:
    """True when autograd will differentiate through this call (grad
    mode on, checked first: the serving path runs in inference mode)."""
    if not torch.is_grad_enabled():
        return False
    for t in tensors:
        if t is not None and t.requires_grad:
            return True
    return False


def _refuse_grad(name: str, why: str, *tensors) -> None:
    if _wants_grad(*tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel: {why}.  Call it under "
            f"torch.no_grad() or inference_mode, or with operands that do "
            f"not require grad")


def _aligned(name: str, **ptrs) -> None:
    for what, ptr in ptrs.items():
        if ptr % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned (the "
                             f"kernel copies 16-byte chunks)")


def attention(q, k, v, *, causal: bool = False):
    """Flash attention.  q: (B, Sq, H, d); k/v: (B, Sk, KV, d) with
    H % KV == 0; causal needs Sq == Sk.  Every operand 16-byte aligned.
    Returns (B, Sq, H, d).  Differentiable (see the module's note).

    On the card both dtypes run one tensor-core kernel (``mma.sync``,
    fp32 softmax and accumulators): bf16 on bf16 operands, P rounded to
    bf16 before P V as FlashAttention-2 rounds it; fp32 in split-TF32,
    three TF32 products for each fp32 one with P kept in fp32, within
    1e-5 of the plain version.  A grid of query tiles too small to fill
    the card's SMs also splits the keys into pieces whose fp32 partial
    outputs a second kernel merges by log-sum-exp
    (:func:`attention_splits` says how many; the wrapper allocates their
    scratch).  Each call counts under its route in
    :data:`kernel_launches`.  Nothing falls back: a CUDA operand launches
    the kernel or raises."""
    if isinstance(q, DTensor):
        qt, kt, _ = attention_rule(q, k)
        return _per_rank(functools.partial(attention, causal=causal),
                         (qt,), (qt, kt, kt), q, k, v)
    if _wants_grad(q, k, v):
        return _Attention.apply(q, k, v, causal)
    return _attention_fwd(q, k, v, causal, False)[0]


def attention_lse(q, k, v, *, causal: bool = False):
    """K2's forward as the autograd path runs it: (out, lse), lse the
    (B, H, Sq) fp32 log-sum-exp of each row's scaled scores."""
    if isinstance(q, DTensor):
        qt, kt, lt = attention_rule(q, k)
        return _per_rank(functools.partial(attention_lse, causal=causal),
                         (qt, lt), (qt, kt, kt), q, k, v)
    return _attention_fwd(q, k, v, causal, True)


def _attention_shape(name, q, k, v, causal, *more) -> int:
    """K2's checks: q (B, Sq, H, d), k and v (B, Sk, KV, d) and each of
    ``more`` (what, tensor) of q's shape; returns the dtype code."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    dtype = _check(name, q, ("q", q, (b, sq, h, d)), ("k", k, (b, sk, kv, d)),
                   ("v", v, (b, sk, kv, d)),
                   *((what, t, (b, sq, h, d)) for what, t in more))
    if d not in HEAD_DIMS or h % kv or (causal and sq != sk):
        raise ValueError(f"{name}: unsupported head_dim={d}, H={h}, KV={kv}, "
                         f"causal={causal} with Sq={sq}, Sk={sk}")
    return dtype


@functools.lru_cache(maxsize=None)
def _splits(b: int, sq: int, sk: int, h: int, d: int, dtype: int,
            device: int) -> int:
    n = ctypes.c_int()
    err = _fn("gfdit_attention_splits")(b, sq, sk, h, d, dtype, device,
                                        ctypes.byref(n))
    if err != 0:
        msg = _fn("gfdit_error_string")(err).decode()
        raise RuntimeError(f"attention_splits: {msg} ({err})")
    return n.value


def attention_splits(b: int, sq: int, sk: int, h: int, d: int,
                     dtype=torch.bfloat16, device: int = 0) -> int:
    """The key pieces K2's (and K3's) ``dtype`` kernel splits a call of
    ``b`` x ``sq`` queries over ``h`` heads and ``sk`` key positions into
    on the card ``device``: 1 (no split) unless the query tiles cannot
    fill its SMs once.  The rule is the library's
    (``gfdit_attention_splits``: the SM count, the tile grid and the key
    tiles)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"attention: unsupported head_dim={d}")
    return _splits(b, sq, sk, h, d, _DTYPES[dtype], device)


def _split_scratch(q, b, sq, sk, h, d, dtype, dev, splits=None):
    """(scratch tensor or None, its floats, the key pieces, the route) of
    a card call in ``splits`` pieces (None: :func:`attention_splits`'
    count): the split pieces' fp32 partial outputs and (row max, row sum)
    pairs, n b sq h (d + 2) floats, for a split call."""
    route = "attention fp32" if dtype == _DTYPES[torch.float32] \
        else "attention bf16"
    n = _splits(b, sq, sk, h, d, dtype, dev) if splits is None else splits
    if n == 1:
        return None, 0, n, route
    floats = n * b * sq * h * (d + 2)
    return (torch.empty(floats, dtype=torch.float32, device=q.device),
            floats, n, route + " split")


def _attention_fwd(q, k, v, causal: bool, want_lse: bool, splits=None):
    """K2's forward, (out, lse or None); on the card in ``splits`` key
    pieces (None: the library's count; a timing script passes others)."""
    if not (q.is_cuda or q.is_meta or _on_card(q, k, v)):
        out = ref.attention_ref(q, k, v, causal=causal)
        return out, (ref.attention_lse_ref(q, k, causal=causal)
                     if want_lse else None)
    name = "attention"
    if q.is_meta:
        _all_meta(name, q, k, v)
    dtype = _attention_shape(name, q, k, v, causal)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    if q.is_meta:
        _traced(name, cost.attention(b, sq, sk, h, kv, d, causal,
                                     q.element_size(), want_lse))
        return out, lse
    fn = _fn("gfdit_attention")
    pq, pk, pv = q.data_ptr(), k.data_ptr(), v.data_ptr()
    _aligned(name, q=pq, k=pk, v=pv)
    dev = q.get_device()
    scratch, floats, n, route = _split_scratch(q, b, sq, sk, h, d, dtype,
                                               dev, splits)
    _launch(name, fn, pq, pk, pv, out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if scratch is None else scratch.data_ptr(), floats, n, b,
            sq, sk, h, kv, d, int(causal), 1.0 / math.sqrt(d), dtype, dev,
            _stream(dev), route=route)
    return out, lse


def attention_bwd(q, k, v, o, lse, do, *, causal: bool = False):
    """K2's backward: (dq, dk, dv) of :func:`attention` at output ``o``
    with log-sum-exp ``lse`` (from :func:`attention_lse`) for the output
    gradient ``do``.  On the card one call runs three kernels of
    ``csrc/attention_bwd.cu`` (D = rowsum(dO * O), then dK/dV, then dQ,
    both on the tensor cores: bf16 products, or fp32 ones as three TF32
    products each) and counts one launch; q, k, v and ``do`` must be
    16-byte aligned (the kernels stage them by 16-byte copies).  The CPU
    version is ``ref.attention_bwd_ref``."""
    if isinstance(q, DTensor):
        qt, kt, lt = attention_rule(q, k)
        return _per_rank(functools.partial(attention_bwd, causal=causal),
                         (qt, kt, kt), (qt, kt, kt, qt, lt, qt),
                         q, k, v, o, lse, do)
    if not (q.is_cuda or q.is_meta or _on_card(q, k, v, o, lse, do)):
        return ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    name = "attention_bwd"
    if q.is_meta:
        _all_meta(name, q, k, v, o, lse, do)
    dtype = _attention_shape(name, q, k, v, causal, ("o", o), ("do", do))
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    _check(name, lse, ("lse", lse, (b, h, sq)))
    if lse.dtype != torch.float32 or lse.get_device() != q.get_device():
        raise ValueError(f"{name}: lse must be float32 on {q.device}, got "
                         f"{lse.dtype} on {lse.device}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if q.is_meta:
        _traced(name, cost.attention_bwd(b, sq, sk, h, kv, d, causal,
                                         q.element_size()))
        return dq, dk, dv
    fn = _fn("gfdit_attention_bwd")
    _aligned(name, q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
             do=do.data_ptr())
    dev = q.get_device()
    _launch(name, fn, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), b, sq, sk, h, kv, d, int(causal),
            1.0 / math.sqrt(d), dtype, dev, _stream(dev))
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """K2 with its backward kernel; the forward saves q, k, v, the output
    and the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _attention_fwd(q, k, v, causal, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*attention_bwd(q, k, v, out, lse, do.contiguous(),
                               causal=ctx.causal), None)


def splice_attention(q, k_stale, v_stale, k_fresh, v_fresh, *, offset: int):
    """§11 hit-path attention over splice(stale, fresh @ offset).

    The kernel reads keys [0, offset) and [offset+L, Sk) from the stale
    snapshot and [offset, offset+L) from the fresh shard; the spliced
    tensor never exists.  It is K2's kernel of the operands' dtype, split
    keys included, walked over the three segments.  The CPU version
    materializes the splice.  No backward: raises when autograd would
    differentiate through it."""
    if isinstance(q, DTensor):
        qt, kt, _ = attention_rule(q, k_stale)
        return _per_rank(functools.partial(splice_attention, offset=offset),
                         (qt,), (qt, kt, kt, kt, kt), q, k_stale, v_stale,
                         k_fresh, v_fresh)
    _refuse_grad("splice_attention", "the §11 hit path only serves, and "
                 "no training path reaches it", q, k_stale, v_stale, k_fresh,
                 v_fresh)
    return _splice_fwd(q, k_stale, v_stale, k_fresh, v_fresh, offset)


def _splice_fwd(q, k_stale, v_stale, k_fresh, v_fresh, offset, splits=None):
    """K3's forward; on the card in ``splits`` key pieces, as
    :func:`_attention_fwd`."""
    if not (q.is_cuda or q.is_meta or
            _on_card(q, k_stale, v_stale, k_fresh, v_fresh)):
        return ref.splice_attention_ref(q, k_stale, v_stale, k_fresh,
                                        v_fresh, offset=offset)
    name = "splice_attention"
    if q.is_meta:
        _all_meta(name, q, k_stale, v_stale, k_fresh, v_fresh)
    b, sq, h, d = q.shape
    sk, kv = k_stale.shape[1], k_stale.shape[2]
    n = k_fresh.shape[1]
    dtype = _check(name, q, ("q", q, (b, sq, h, d)),
                   ("k_stale", k_stale, (b, sk, kv, d)),
                   ("v_stale", v_stale, (b, sk, kv, d)),
                   ("k_fresh", k_fresh, (b, n, kv, d)),
                   ("v_fresh", v_fresh, (b, n, kv, d)))
    offset = int(offset)
    if d not in HEAD_DIMS or h % kv or n == 0 or not 0 <= offset <= sk - n:
        raise ValueError(f"{name}: unsupported head_dim={d}, H={h}, KV={kv}, "
                         f"offset={offset}, L={n}, Sk={sk}")
    out = torch.empty_like(q)
    if q.is_meta:
        _traced(name, cost.splice_attention(b, sq, sk, h, kv, d,
                                            q.element_size()))
        return out
    fn = _fn("gfdit_splice_attention")
    ptrs = dict(q=q.data_ptr(), k_stale=k_stale.data_ptr(),
                v_stale=v_stale.data_ptr(), k_fresh=k_fresh.data_ptr(),
                v_fresh=v_fresh.data_ptr())
    _aligned(name, **ptrs)
    dev = q.get_device()
    scratch, floats, pieces, route = _split_scratch(q, b, sq, sk, h, d,
                                                    dtype, dev, splits)
    _launch(name, fn, *ptrs.values(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), floats, pieces,
            b, sq, sk, n, h, kv, d, offset, 1.0 / math.sqrt(d), dtype, dev,
            _stream(dev), route=route)
    return out


def fused_adaln(x, shift=None, scale=None, gate=None, residual=None, *,
                ln: bool = True):
    """Fused (LN +) modulate (+ gated residual), one pass over x.

    Variants:
      shift/scale only          -> LN(x)*(1+scale)+shift
      nothing                   -> LN(x)
      gate/residual, ln=False   -> residual + gate*x
      everything                -> residual + gate*(LN(x)*(1+scale)+shift)
    x/residual: (B, N, D); shift/scale/gate: (B, D), all of x's dtype.
    Differentiable (see the module's note).
    """
    if (shift is None) != (scale is None):
        raise ValueError("fused_adaln: shift and scale go together")
    if (gate is None) != (residual is None):
        raise ValueError("fused_adaln: gate and residual go together")
    if not (ln or shift is not None or gate is not None):
        raise ValueError("fused_adaln: identity fusion requested")
    if isinstance(x, DTensor):
        xt, rt, _ = _adaln_rule(x)
        args = (x, shift, scale, gate, residual)
        return _per_rank(functools.partial(fused_adaln, ln=ln),
                         (xt,), _like(args, (xt, rt, rt, rt, xt)), *args)
    if _wants_grad(x, shift, scale, gate, residual):
        return _AdaLN.apply(x, shift, scale, gate, residual, ln)
    return _adaln_fwd(x, shift, scale, gate, residual, ln)


def _like(args, placements) -> tuple:
    """``placements`` with None where the argument is absent."""
    return tuple(None if a is None else pl
                 for a, pl in zip(args, placements))


def _adaln_fwd(x, shift, scale, gate, residual, ln: bool):
    if not (x.is_cuda or x.is_meta) and not _on_card(
            *(t for t in (x, shift, scale, gate, residual) if t is not None)):
        return ref.adaln_ref(x, shift, scale, gate, residual, ln=ln)
    name = "fused_adaln"
    if x.is_meta:
        _all_meta(name, *(t for t in (x, shift, scale, gate, residual)
                          if t is not None))
    b, n, d = x.shape
    specs = [("x", x, (b, n, d))]
    if shift is not None:
        specs += [("shift", shift, (b, d)), ("scale", scale, (b, d))]
    if gate is not None:
        specs += [("gate", gate, (b, d)), ("residual", residual, (b, n, d))]
    dtype = _check(name, x, *specs)
    if not 0 < d <= MAX_ADALN_DIM or b * n == 0:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)}")
    out = torch.empty_like(x)
    if x.is_meta:
        _traced(name, cost.adaln(b, n, d, ln=ln, mod=shift is not None,
                                 gated=gate is not None,
                                 es=x.element_size()))
        return out
    fn = _fn("gfdit_adaln")
    dev = x.get_device()
    _launch(name, fn, x.data_ptr(),
            None if shift is None else shift.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if gate is None else gate.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), b * n, n, d, int(ln), dtype, dev, _stream(dev))
    return out


def fused_adaln_bwd(x, shift=None, scale=None, gate=None, dy=None, *,
                    ln: bool = True):
    """K1's backward: (dx, dshift, dscale, dgate, dresidual) of
    :func:`fused_adaln` for the output gradient ``dy`` (None where the
    operand is absent; the residual's presence follows the gate's, and
    its gradient is ``dy`` itself, as in the plain version: nothing is
    copied).  On the card a row kernel reads each row of x and dy once,
    writes dx and, per block of rows, one partial row of each column sum
    (dshift, dscale, dgate as present) into scratch sized by the kernel's
    own rule (``gfdit_adaln_bwd_scratch``); a second launch sums the
    partials in a fixed order (deterministic, no atomics).  One call
    counts one launch.  The CPU version is ``ref.adaln_bwd_ref``.  The
    shape-only branch allocates no partials: their size is the card's
    occupancy, a few rows of d floats a block."""
    if isinstance(x, DTensor):
        xt, rt, gt = _adaln_rule(x)
        args = (x, shift, scale, gate, dy)
        outs = _like((x, shift, scale, gate, gate), (xt, gt, gt, gt, xt))
        return _per_rank(functools.partial(fused_adaln_bwd, ln=ln),
                         outs, _like(args, (xt, rt, rt, rt, xt)), *args)
    given = [t for t in (x, shift, scale, gate, dy) if t is not None]
    if not (x.is_cuda or x.is_meta or _on_card(*given)):
        return ref.adaln_bwd_ref(x, shift, scale, gate, dy, ln=ln)
    name = "fused_adaln_bwd"
    if x.is_meta:
        _all_meta(name, *given)
    b, n, d = x.shape
    specs = [("x", x, (b, n, d)), ("dy", dy, (b, n, d))]
    if shift is not None:
        specs += [("shift", shift, (b, d)), ("scale", scale, (b, d))]
    if gate is not None:
        specs += [("gate", gate, (b, d))]
    dtype = _check(name, x, *specs)
    if not 0 < d <= MAX_ADALN_DIM or b * n == 0:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)}")
    dx = torch.empty_like(x)
    dshift = dscale = dgate = partial = None
    floats = 0
    if shift is not None:
        dshift, dscale = torch.empty_like(shift), torch.empty_like(scale)
    if gate is not None:
        dgate = torch.empty_like(gate)
    dres = None if gate is None else dy
    if x.is_meta:
        _traced(name, cost.adaln_bwd(b, n, d, ln=ln, mod=shift is not None,
                                     gated=gate is not None,
                                     es=x.element_size()))
        return dx, dshift, dscale, dgate, dres
    dev = x.get_device()
    if shift is not None or gate is not None:
        floats = _fn("gfdit_adaln_bwd_scratch")(
            b, n, d, int(shift is not None), int(gate is not None), dev)
        partial = torch.empty(floats, dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()
    _launch(name, _fn("gfdit_adaln_bwd"), x.data_ptr(), ptr(shift),
            ptr(scale), ptr(gate), dy.data_ptr(), dx.data_ptr(), ptr(dshift),
            ptr(dscale), ptr(dgate), ptr(partial), floats, b, n, d, int(ln),
            dtype, dev, _stream(dev))
    return dx, dshift, dscale, dgate, dres


def adaln_bwd_plan(b: int, n: int, d: int, *, ln: bool = True,
                   mod: bool = True, gated: bool = False,
                   dtype=torch.float32, aligned: bool = True,
                   device: int = 0) -> dict:
    """The launch K1's backward row kernel makes at (b, n, d) for the
    variant, on the vector path (``aligned``: 16-byte aligned operands and
    d a multiple of the 16-byte vector) or the scalar one: warps a row,
    vectors a lane, threads and rows a block, blocks a batch row, resident
    blocks an SM (the occupancy calculator) and shared bytes a block."""
    out = (ctypes.c_int * 7)()
    vec = aligned and d % (128 // torch.finfo(dtype).bits) == 0
    err = _fn("gfdit_adaln_bwd_plan")(b, n, d, int(ln), int(mod), int(gated),
                                      _DTYPES[dtype], int(vec), device, out)
    if err != 0:
        msg = _fn("gfdit_error_string")(err).decode()
        raise RuntimeError(f"adaln_bwd_plan: {msg} ({err})")
    return dict(zip(("warps_a_row", "vectors_a_lane", "threads",
                     "rows_a_block", "blocks_a_batch_row", "blocks_per_sm",
                     "smem_bytes"), out))


class _AdaLN(torch.autograd.Function):
    """K1 with its backward kernel; the forward saves x and the (B, D)
    modulation rows (the residual's gradient is the output's)."""

    @staticmethod
    def forward(ctx, x, shift, scale, gate, residual, ln):
        ctx.save_for_backward(x, shift, scale, gate)
        ctx.ln = ln
        return _adaln_fwd(x, shift, scale, gate, residual, ln)

    @staticmethod
    def backward(ctx, dy):
        x, shift, scale, gate = ctx.saved_tensors
        dx, dshift, dscale, dgate, dres = fused_adaln_bwd(
            x, shift, scale, gate, dy.contiguous(), ln=ctx.ln)
        return dx, dshift, dscale, dgate, dres, None


def ssd(x, dt, A, B, C, *, chunk: int = 128):
    """Mamba2 SSD chunked scan.  x: (b, l, h, p); dt: (b, l, h) and
    A: (h,) fp32; B/C: (b, l, n) of x's dtype (fp32 or bf16); x, B and C
    16-byte aligned.

    Returns (y (b, l, h, p) in x's dtype, final_state (b, h, p, n) fp32).
    The kernels mask a ragged last chunk, so ``l`` need not be a multiple
    of ``chunk``; the CPU version is the sequential recurrence.  On the
    card one call runs the four stage kernels of ``csrc/ssd.cu``
    (:data:`SSD_STAGES`: the chunk states, C B^T and the chunk scan on the
    tensor cores, fp32 as three TF32 products for each fp32 one, bf16 with
    the scores and decays, the carried state and the decay-weighted B rows
    rounded to bf16 where they enter a product) and counts one launch,
    also under its dtype in :data:`kernel_launches`; their scratch is
    allocated here (``ref.ssd_chunked_ref`` computes the same stages).
    Differentiable (see the module's note): the backward is
    :func:`ssd_bwd`, which reads the forward's scratch."""
    if isinstance(x, DTensor):
        xt, at, bt, st, _, _ = _ssd_rule(x)
        return _per_rank(functools.partial(ssd, chunk=chunk),
                         (xt, st), (xt, xt, at, bt, bt), x, dt, A, B, C)
    if _wants_grad(x, dt, A, B, C):
        return _SSD.apply(x, dt, A, B, C, chunk)
    return _ssd_fwd(x, dt, A, B, C, chunk)[:2]


def ssd_for_grad(x, dt, A, B, C, *, chunk: int = 128):
    """K4's forward as the autograd path runs it: (y, final_state,
    scratch), the scratch the fp32 tensor that :func:`ssd_bwd` reads on
    the card (cum, the chunk states overwritten with S_in, C B^T in the
    (j, i) layout), None on the CPU.  Local tensors only: a scratch is one
    rank's."""
    return _ssd_fwd(x, dt, A, B, C, chunk)


def _ssd_scratch_sizes(b, l, h, p, n, chunk):
    """Floats of the forward's scratch parts: cum (b, nc, h, chunk), chunk
    states (b, nc, h, n, p), C B^T (b, nc, chunk, chunk); every size a
    multiple of 16 floats, so each part is 16-byte aligned."""
    bnc = b * -(-l // chunk)
    return bnc * h * chunk, bnc * h * n * p, bnc * chunk * chunk


def ssd_bwd_scratch(b: int, l: int, h: int, p: int, n: int,
                    chunk: int) -> int:
    """Floats of K4's backward's own scratch at (b, l, h, p, n, chunk),
    the rule of ``csrc/ssd_bwd.cu`` (``ssd_bwd_parts``, which the library
    answers as ``gfdit_ssd_bwd_scratch``): per (batch, chunk, head) the
    state gradient G (n x p), one partial dot a stage-2 block (n / R2 of
    them, R2 = min(n, 4 x 256 threads / p) state rows a block), the
    per-head dB and dC rows (chunk x n each) and one dA partial."""
    if (p, n, chunk) not in SSD_SHAPES:
        raise ValueError(f"ssd_bwd: unsupported (p, n, chunk)="
                         f"{(p, n, chunk)}; the kernel takes {SSD_SHAPES}")
    bnch = b * -(-l // chunk) * h
    r2 = min(n, 4 * 256 // p)
    return bnch * (n * p + n // r2 + 2 * chunk * n + 1)


def _parts(t, sizes) -> list:
    """The data pointers of consecutive parts of ``sizes`` floats of ``t``."""
    parts, at = [], t.data_ptr()
    for size in sizes:
        parts.append(at)
        at += 4 * size
    return parts


def _ssd_shape(name, x, dt, A, B, C, chunk):
    b, l, h, p = x.shape
    n = B.shape[-1]
    dtype = _check(name, x, ("x", x, (b, l, h, p)), ("B", B, (b, l, n)),
                   ("C", C, (b, l, n)))
    _check(name, A, ("dt", dt, (b, l, h)), ("A", A, (h,)))
    if A.dtype != torch.float32:
        raise ValueError(f"{name}: dt and A must be float32, got {A.dtype}")
    if (p, n, chunk) not in SSD_SHAPES or b * l * h == 0:
        raise ValueError(f"{name}: unsupported (p, n, chunk)={(p, n, chunk)} "
                         f"with b={b}, l={l}, h={h}; the kernel takes "
                         f"{SSD_SHAPES}")
    return b, l, h, p, n, dtype


def _ssd_fwd(x, dt, A, B, C, chunk: int):
    if not (x.is_cuda or x.is_meta or _on_card(x, dt, A, B, C)):
        return (*ref.ssd_ref(x, dt, A, B, C, chunk=chunk), None)
    name = "ssd"
    if x.is_meta:
        _all_meta(name, x, dt, A, B, C)
    b, l, h, p, n, dtype = _ssd_shape(name, x, dt, A, B, C, chunk)
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    sizes = _ssd_scratch_sizes(b, l, h, p, n, chunk)
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    if x.is_meta:
        _traced(name, cost.ssd(b, l, h, p, n, chunk, x.element_size()))
        return y, state, scratch
    ptrs = dict(x=x.data_ptr(), B=B.data_ptr(), C=C.data_ptr())
    _aligned(name, **ptrs)
    fn = _fn("gfdit_ssd")
    dev = x.get_device()
    _launch(name, fn, ptrs["x"], dt.data_ptr(), A.data_ptr(), ptrs["B"],
            ptrs["C"], y.data_ptr(), state.data_ptr(),
            *_parts(scratch, sizes), b, l, h, p, n, chunk, dtype, dev,
            _stream(dev), route=f"ssd {_DTYPE_NAMES[x.dtype]}")
    return y, state, scratch


def ssd_bwd(x, dt, A, B, C, dy, dstate=None, *, chunk: int = 128,
            scratch=None):
    """K4's backward: (dx, ddt, dA, dB, dC) of :func:`ssd` for the output
    gradient ``dy`` (x's shape and dtype) and the final state's
    ``dstate`` ((b, h, p, n) fp32; None: the state is not used, and its
    terms are skipped), each in its operand's shape and dtype.  On the
    card ``scratch`` is the forward's, from :func:`ssd_for_grad` on the
    same operands (for ``DTensor`` operands, the rank's own); one call
    runs the four stage kernels of
    ``csrc/ssd_bwd.cu`` (:data:`SSD_BWD_STAGES`: the per-chunk state
    gradients, their reverse pass across chunks, a chunk kernel per
    (batch, chunk, head) and the sums over heads; the first and third run
    their products on the tensor cores, fp32 in split-TF32, bf16 as bf16
    products with Z, P, the masked decays, xb, G and S_in rounded to bf16
    where they enter one) and counts one launch, also under its dtype in
    :data:`kernel_launches`; their scratch is allocated here by
    the kernel's own rule (``gfdit_ssd_bwd_scratch``;
    :func:`ssd_bwd_scratch` is its Python twin).  x, B, C and dy
    16-byte aligned.  Deterministic: no atomics.  The CPU version is
    ``ref.ssd_bwd_ref`` (``scratch`` is not read)."""
    if isinstance(x, DTensor):
        xt, at, bt, st, gat, gbt = _ssd_rule(x)
        args = (x, dt, A, B, C, dy, dstate)
        return _per_rank(
            functools.partial(ssd_bwd, chunk=chunk, scratch=scratch),
            (xt, xt, gat, gbt, gbt),
            _like(args, (xt, xt, at, bt, bt, xt, st)), *args)
    given = [t for t in (x, dt, A, B, C, dy, dstate) if t is not None]
    if not (x.is_cuda or x.is_meta or _on_card(*given)):
        return ref.ssd_bwd_ref(x, dt, A, B, C, dy, dstate, chunk=chunk)
    name = "ssd_bwd"
    if x.is_meta:
        _all_meta(name, *given)
    b, l, h, p, n, dtype = _ssd_shape(name, x, dt, A, B, C, chunk)
    _check(name, x, ("dy", dy, (b, l, h, p)))
    if dstate is not None:
        _check(name, A, ("dstate", dstate, (b, h, p, n)))
    sizes = _ssd_scratch_sizes(b, l, h, p, n, chunk)
    if scratch is None or scratch.dtype != torch.float32 or \
            scratch.numel() != sum(sizes) or \
            scratch.get_device() != x.get_device():
        raise ValueError(f"{name}: scratch must be the forward's (from "
                         f"ssd_for_grad on these operands): float32 of "
                         f"{sum(sizes)} elements on {x.device}")
    dx, ddt, dA, dB, dC = (torch.empty_like(t) for t in (x, dt, A, B, C))
    # the work buffer: the library's size on the card, its formula here
    floats = ssd_bwd_scratch(b, l, h, p, n, chunk) if x.is_meta else \
        _fn("gfdit_ssd_bwd_scratch")(b, l, h, p, n, chunk)
    work = torch.empty(floats, dtype=torch.float32, device=x.device)
    if x.is_meta:
        _traced(name, cost.ssd_bwd(b, l, h, p, n, chunk, x.element_size(),
                                   dstate is not None))
        return dx, ddt, dA, dB, dC
    _aligned(name, x=x.data_ptr(), B=B.data_ptr(), C=C.data_ptr(),
             dy=dy.data_ptr())
    cum, s_in, cbt = _parts(scratch, sizes)
    dev = x.get_device()
    _launch(name, _fn("gfdit_ssd_bwd"), x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(), cum, s_in, cbt,
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), work.data_ptr(), floats, b, l, h, p, n, chunk,
            dtype, dev, _stream(dev),
            route=f"ssd_bwd {_DTYPE_NAMES[x.dtype]}")
    return dx, ddt, dA, dB, dC


class _SSD(torch.autograd.Function):
    """K4 with its backward kernel; the forward saves the operands and
    its scratch (None on the CPU).  A final state that nothing uses (the
    training path drops it) gives ``dstate = None``: no zeros are made."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, state, scratch = _ssd_fwd(x, dt, A, B, C, chunk)
        ctx.save_for_backward(x, dt, A, B, C, scratch)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, scratch = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        else:
            # the kernel reads dy in 16-byte chunks; an incoming gradient
            # may be a contiguous view at any offset
            dy = dy.contiguous()
            if dy.data_ptr() % 16:
                dy = dy.clone()
        if dstate is not None:
            dstate = dstate.contiguous()
        return (*ssd_bwd(x, dt, A, B, C, dy, dstate, chunk=ctx.chunk,
                         scratch=scratch), None)


def gemm_tiles(m: int, n: int, rows: int) -> int:
    """Output tiles of an ``m`` x ``n`` product in tiles of ``rows`` rows
    by :data:`GEMM_TILE_COLS` columns."""
    return -(-m // rows) * -(-n // GEMM_TILE_COLS)


def gemm_route(dtype, device: str, *, x_shape: tuple, w_shape: tuple,
               sms: int, dtensor: bool = False, grad: bool = False,
               contiguous: bool = True, aligned: bool = True) -> str:
    """The product rule, a pure function of what the operands of ``x @
    w`` show: their common ``dtype`` (None if they differ) and ``device``
    type, their shapes, the card's ``sms``, whether either is a
    ``DTensor``, whether autograd will differentiate the product, whether
    both are contiguous and 16-byte aligned.  ``"gemm"`` for
    :func:`linear`'s kernel (fp32 on the card, a 2-d weight, no gradient,
    K and N multiples of 4, contiguous and aligned, at least 64 rows and
    64 output columns whose tiles fill at least half the SMs); one of
    :data:`LIBRARY_REASONS` for an fp32 product on the card left to
    cuBLAS (``"dtensor"``: a sharded operand; ``"experts"``: a 3-d
    weight; ``"grad"``: a gradient wanted; ``"align"``: rows or addresses
    off 16 bytes, which the kernel's loads cannot take; ``"rows"``: too
    few rows or output columns to fill half the card even in the smallest
    tiles, where cuBLAS's small tiles and split K are the faster: the 77
    text tokens' products, a 64-column output head, batch rows);
    ``"other"`` for the rest (the CPU, ``meta``, another dtype, shapes
    ``x @ w`` refuses), which the rule does not count.  The SMs are the
    last question: at ``sms=0`` the rule answers as on any card, except
    that a product it sends to the kernel may still be ``"rows"``."""
    if device != "cuda" or dtype != torch.float32:
        return "other"
    if dtensor:
        return "dtensor"
    if len(w_shape) != 2:
        return "experts"
    if grad:
        return "grad"
    k, n = w_shape
    if not x_shape or x_shape[-1] != k:
        return "other"
    if k % 4 or n % 4 or not (contiguous and aligned):
        return "align"
    m = math.prod(x_shape) // k if k else 0
    if n < 64 or m < 64 or \
            2 * gemm_tiles(m, n, min(GEMM_TILE_ROWS)) < sms:
        return "rows"
    return "gemm"


def product_route(x, w) -> str:
    """:func:`gemm_route` of the operands of ``x @ w``; the card's SM
    count is read only for a product that could take the kernel."""
    dtype = x.dtype if x.dtype == w.dtype else None
    if not (x.is_cuda and dtype == torch.float32):   # the CPU tests' path
        return "other"
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return gemm_route(dtype, "cuda", x_shape=(), w_shape=(), sms=0,
                          dtensor=True)
    facts = dict(
        x_shape=x.shape, w_shape=w.shape,
        grad=torch.is_grad_enabled() and (x.requires_grad
                                          or w.requires_grad),
        contiguous=x.is_contiguous() and w.is_contiguous(),
        aligned=not (x.data_ptr() % 16 or w.data_ptr() % 16))
    route = gemm_route(dtype, "cuda", sms=0, **facts)
    if route != "gemm":
        return route
    return gemm_route(dtype, "cuda", sms=_sm_count(x.get_device()), **facts)


def count_library(route: str) -> None:
    """Counts a product :func:`product_route` left to cuBLAS under its
    reason (:data:`library_products`); other routes count nothing."""
    if route in library_products:
        with _count_lock:
            library_products[route] += 1


@functools.lru_cache(maxsize=None)
def gemm_tile_rows(m: int, n: int, sms: int) -> int:
    """The tile rows (:data:`GEMM_TILE_ROWS`) of :func:`linear`'s kernel
    for an ``m`` x ``n`` output on a card of ``sms`` SMs: the one whose
    waves of tiles cost least, a wave costing its tile rows plus 32 (the
    per-tile work that does not shrink with the rows); the first on a
    tie.  A fixed function of the shape: nothing is tuned at run time."""
    def waves_cost(rows):
        return -(-gemm_tiles(m, n, rows) // sms) * (rows + 32)
    return min(GEMM_TILE_ROWS, key=waves_cost)


@functools.lru_cache(maxsize=None)
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def linear(x, w):
    """``x (..., K) @ w (K, N)`` -> (..., N), fp32.  On the card one
    launch of ``csrc/gemm.cu``'s split-TF32 kernel (three TF32 products
    for each fp32 one on the tensor cores, fresh accumulators summed on
    the CUDA cores every 32 k; within 1e-5 rel-L2 of the fp32 product)
    in tiles of :func:`gemm_tile_rows` rows, counted under ``"gemm
    fp32"`` in :data:`kernel_launches`; both operands fp32, contiguous
    and 16-byte aligned, K and N multiples of 4, else it raises (nothing
    is copied).  No backward: raises when autograd would differentiate
    through it (:func:`product_route` sends such products to cuBLAS).
    The CPU version is ``ref.linear_ref``."""
    if not (x.is_cuda or _on_card(x, w)):
        return ref.linear_ref(x, w)
    name = "linear"
    _refuse_grad(name, "the rule routes products that want a gradient "
                 "to cuBLAS", x, w)
    if w.dim() != 2 or x.dim() == 0 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)} @ w {tuple(w.shape)}: "
                         f"expected x (..., K) and w (K, N)")
    k, n = w.shape
    _check(name, x, ("x", x, x.shape), ("w", w, w.shape))
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: the kernel takes float32, got {x.dtype}")
    if k % 4 or n % 4:
        raise ValueError(f"{name}: K={k} and N={n} must be multiples of 4 "
                         f"(the kernel moves rows in 16-byte pieces)")
    pointers = dict(x=x.data_ptr(), w=w.data_ptr())
    _aligned(name, **pointers)
    m = x.numel() // k
    y = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    dev = x.get_device()
    _launch(name, _fn("gfdit_gemm"), pointers["x"], pointers["w"],
            y.data_ptr(), m, n, k, gemm_tile_rows(m, n, _sm_count(dev)), dev,
            _stream(dev), route="gemm fp32")
    return y


def _occupancy(name: str, fn, *args, extra=()) -> tuple[int, int]:
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    err = fn(*args, ctypes.byref(blocks), ctypes.byref(smem), *extra)
    if err != 0:
        msg = _fn("gfdit_error_string")(err).decode()
        raise RuntimeError(f"{name}: {msg} ({err})")
    return blocks.value, smem.value


def attention_occupancy(head_dim: int, dtype=torch.float32,
                        device: int = 0) -> tuple[int, int]:
    """(resident blocks per SM, dynamic shared-memory bytes) of the
    ``dtype`` attention tile kernel at ``head_dim`` (both dtypes on the
    tensor cores), from the CUDA occupancy calculator."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"attention: unsupported head_dim={head_dim}")
    return _occupancy("attention_occupancy",
                      _fn("gfdit_attention_occupancy"), head_dim,
                      _DTYPES[dtype], device)


def attention_bwd_occupancy(head_dim: int, dtype=torch.float32,
                            device: int = 0) -> dict:
    """``{"dkdv": ..., "dq": ...}``: (resident blocks per SM, dynamic
    shared-memory bytes) of K2's two ``dtype`` backward kernels at
    ``head_dim``, from the CUDA occupancy calculator."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"attention_bwd: unsupported head_dim={head_dim}")
    fn = _fn("gfdit_attention_bwd_occupancy")
    return {kernel: _occupancy("attention_bwd_occupancy", fn, head_dim,
                               _DTYPES[dtype], which, device)
            for which, kernel in enumerate(("dkdv", "dq"))}


def ssd_occupancy(b: int, l: int, h: int, p: int, n: int, chunk: int,
                  dtype=torch.float32, device: int = 0) -> dict:
    """Per stage kernel of one :func:`ssd` call at ``(b, l, h, p, n,
    chunk)`` in ``dtype`` (:data:`SSD_STAGES`, the instances of that
    dtype): ``{name: (resident blocks per SM, shared-memory bytes a block,
    grid, threads a block)}``, from the CUDA occupancy calculator."""
    if (p, n, chunk) not in SSD_SHAPES:
        raise ValueError(f"ssd: unsupported (p, n, chunk)={(p, n, chunk)}")
    fn = _fn("gfdit_ssd_occupancy")
    out = {}
    for stage, name in enumerate(SSD_STAGES):
        grid, threads = ctypes.c_int(), ctypes.c_int()
        blocks, smem = _occupancy("ssd_occupancy", fn, stage, b, l, h, p,
                                  n, chunk, _DTYPES[dtype], device,
                                  extra=(ctypes.byref(grid),
                                         ctypes.byref(threads)))
        out[name] = (blocks, smem, grid.value, threads.value)
    return out


def ssd_bwd_occupancy(b: int, l: int, h: int, p: int, n: int, chunk: int,
                      dtype=torch.float32, device: int = 0) -> dict:
    """As :func:`ssd_occupancy`, for the stage kernels of one
    :func:`ssd_bwd` call (:data:`SSD_BWD_STAGES`; the first and third are
    the tensor-core kernels): ``{name: (blocks per SM, shared bytes,
    grid, threads)}``."""
    if (p, n, chunk) not in SSD_SHAPES:
        raise ValueError(f"ssd_bwd: unsupported (p, n, chunk)="
                         f"{(p, n, chunk)}")
    fn = _fn("gfdit_ssd_bwd_occupancy")
    out = {}
    for stage, name in enumerate(SSD_BWD_STAGES):
        grid, threads = ctypes.c_int(), ctypes.c_int()
        blocks, smem = _occupancy("ssd_bwd_occupancy", fn, stage, b, l, h,
                                  p, n, chunk, _DTYPES[dtype], device,
                                  extra=(ctypes.byref(grid),
                                         ctypes.byref(threads)))
        out[name] = (blocks, smem, grid.value, threads.value)
    return out


def gemm_occupancy(rows: int, device: int = 0) -> tuple[int, int]:
    """(resident blocks per SM, dynamic shared-memory bytes) of
    :func:`linear`'s kernel with tiles of ``rows`` rows, from the CUDA
    occupancy calculator."""
    if rows not in GEMM_TILE_ROWS:
        raise ValueError(f"linear: no kernel with {rows}-row tiles "
                         f"({GEMM_TILE_ROWS})")
    return _occupancy("gemm_occupancy", _fn("gfdit_gemm_occupancy"), rows,
                      device)
