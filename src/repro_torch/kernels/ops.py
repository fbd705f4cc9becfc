"""Public wrappers for the Hopper kernels in ``csrc/``.

Each wrapper launches its CUDA kernel for tensors on the card and runs
the kernel's plain PyTorch version (:mod:`repro_torch.kernels.ref`) for
tensors on the CPU; there is no other switch.  A CUDA call that cannot
launch (no ``nvcc``, a shape the kernel does not take, a refused launch)
raises rather than computing some other way.  Unlike the TPU wrappers,
nothing is padded: the kernels mask ragged sequence edges themselves.

Each launch adds one to :data:`launches` under the wrapper's name, so a
run can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from typing import Any

import torch

from repro_torch.kernels import build, ref

#: head dims the attention kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: widest row the adaLN kernel holds in registers (256 threads x 16)
MAX_ADALN_DIM = 4096
#: (head_dim p, state n, chunk) the SSD kernel is instantiated for
SSD_SHAPES = ((64, 128, 128), (16, 16, 16), (16, 16, 32), (32, 16, 64),
              (64, 32, 128))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_count_lock = threading.Lock()
#: kernel launches per wrapper since the last :func:`reset_launches`
launches = {"fused_adaln": 0, "attention": 0, "splice_attention": 0,
            "ssd": 0}


def reset_launches() -> None:
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _count(name: str) -> None:
    with _count_lock:        # rank threads launch concurrently
        launches[name] += 1


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


def _check(name: str, what: str, t, shape, like) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"{name}: {what} is {t.dtype} on {t.device}, "
                         f"expected {like.dtype} on {like.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _dtype_code(name: str, t) -> int:
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {t.dtype} not supported "
                         f"(float32 or bfloat16)")
    return _DTYPES[t.dtype]


def _launch(name: str, fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        msg = build.load().gfdit_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")
    _count(name)


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def attention(q, k, v, *, causal: bool = False):
    """Flash attention.  q: (B, Sq, H, d); k/v: (B, Sk, KV, d) with
    H % KV == 0; causal needs Sq == Sk.  Returns (B, Sq, H, d)."""
    if not _on_card(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal)
    name = "attention"
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    _check(name, "q", q, (b, sq, h, d), q)
    _check(name, "k", k, (b, sk, kv, d), q)
    _check(name, "v", v, (b, sk, kv, d), q)
    if d not in HEAD_DIMS or h % kv or (causal and sq != sk):
        raise ValueError(f"{name}: unsupported head_dim={d}, H={h}, KV={kv}, "
                         f"causal={causal} with Sq={sq}, Sk={sk}")
    dtype = _dtype_code(name, q)
    out = torch.empty_like(q)
    lib = build.load()
    _launch(name, lib.gfdit_attention, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), b, sq, sk, h, kv, d, int(causal),
            1.0 / math.sqrt(d), dtype, q.device.index, _stream(q))
    return out


def splice_attention(q, k_stale, v_stale, k_fresh, v_fresh, *, offset: int):
    """§11 hit-path attention over splice(stale, fresh @ offset).

    The kernel reads keys [0, offset) and [offset+L, Sk) from the stale
    snapshot and [offset, offset+L) from the fresh shard; the spliced
    tensor never exists.  The CPU version materializes it."""
    if not _on_card(q, k_stale, v_stale, k_fresh, v_fresh):
        return ref.splice_attention_ref(q, k_stale, v_stale, k_fresh,
                                        v_fresh, offset=offset)
    name = "splice_attention"
    b, sq, h, d = q.shape
    sk, kv = k_stale.shape[1], k_stale.shape[2]
    n = k_fresh.shape[1]
    _check(name, "q", q, (b, sq, h, d), q)
    _check(name, "k_stale", k_stale, (b, sk, kv, d), q)
    _check(name, "v_stale", v_stale, (b, sk, kv, d), q)
    _check(name, "k_fresh", k_fresh, (b, n, kv, d), q)
    _check(name, "v_fresh", v_fresh, (b, n, kv, d), q)
    offset = int(offset)
    if d not in HEAD_DIMS or h % kv or n == 0 or not 0 <= offset <= sk - n:
        raise ValueError(f"{name}: unsupported head_dim={d}, H={h}, KV={kv}, "
                         f"offset={offset}, L={n}, Sk={sk}")
    dtype = _dtype_code(name, q)
    out = torch.empty_like(q)
    lib = build.load()
    _launch(name, lib.gfdit_splice_attention, q.data_ptr(),
            k_stale.data_ptr(), v_stale.data_ptr(), k_fresh.data_ptr(),
            v_fresh.data_ptr(), out.data_ptr(), b, sq, sk, n, h, kv, d,
            offset, 1.0 / math.sqrt(d), dtype, q.device.index, _stream(q))
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
    """
    if (shift is None) != (scale is None):
        raise ValueError("fused_adaln: shift and scale go together")
    if (gate is None) != (residual is None):
        raise ValueError("fused_adaln: gate and residual go together")
    if not (ln or shift is not None or gate is not None):
        raise ValueError("fused_adaln: identity fusion requested")
    operands = [t for t in (x, shift, scale, gate, residual) if t is not None]
    if not _on_card(*operands):
        return ref.adaln_ref(x, shift, scale, gate, residual, ln=ln)
    name = "fused_adaln"
    b, n, d = x.shape
    _check(name, "x", x, (b, n, d), x)
    for what, t, shape in (("shift", shift, (b, d)), ("scale", scale, (b, d)),
                           ("gate", gate, (b, d)),
                           ("residual", residual, (b, n, d))):
        if t is not None:
            _check(name, what, t, shape, x)
    if not 0 < d <= MAX_ADALN_DIM or b * n == 0:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)}")
    dtype = _dtype_code(name, x)
    out = torch.empty_like(x)
    lib = build.load()

    def ptr(t):
        return None if t is None else t.data_ptr()
    _launch(name, lib.gfdit_adaln, x.data_ptr(), ptr(shift), ptr(scale),
            ptr(gate), ptr(residual), out.data_ptr(), b * n, n, d, int(ln),
            dtype, x.device.index, _stream(x))
    return out


def ssd(x, dt, A, B, C, *, chunk: int = 128):
    """Mamba2 SSD chunked scan.  x: (b, l, h, p); dt: (b, l, h) and
    A: (h,) fp32; B/C: (b, l, n) of x's dtype (fp32 or bf16).

    Returns (y (b, l, h, p) in x's dtype, final_state (b, h, p, n) fp32).
    The kernel masks a ragged last chunk, so ``l`` need not be a multiple
    of ``chunk``; the CPU version is the sequential recurrence."""
    if not _on_card(x, dt, A, B, C):
        return ref.ssd_ref(x, dt, A, B, C, chunk=chunk)
    name = "ssd"
    b, l, h, p = x.shape
    n = B.shape[-1]
    _check(name, "x", x, (b, l, h, p), x)
    _check(name, "B", B, (b, l, n), x)
    _check(name, "C", C, (b, l, n), x)
    _check(name, "dt", dt, (b, l, h), A)
    _check(name, "A", A, (h,), A)
    if A.dtype != torch.float32:
        raise ValueError(f"{name}: dt and A must be float32, got {A.dtype}")
    if (p, n, chunk) not in SSD_SHAPES or b * l * h == 0:
        raise ValueError(f"{name}: unsupported (p, n, chunk)={(p, n, chunk)} "
                         f"with b={b}, l={l}, h={h}; the kernel takes "
                         f"{SSD_SHAPES}")
    dtype = _dtype_code(name, x)
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    lib = build.load()
    _launch(name, lib.gfdit_ssd, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(), b, l,
            h, p, n, chunk, dtype, x.device.index, _stream(x))
    return y, state


def ssd_occupancy(p: int, n: int, chunk: int, dtype=torch.float32,
                  device: int = 0) -> tuple[int, int]:
    """(resident blocks per SM, dynamic shared-memory bytes) of the SSD
    kernel at ``(p, n, chunk)``, from the CUDA occupancy calculator."""
    if (p, n, chunk) not in SSD_SHAPES:
        raise ValueError(f"ssd: unsupported (p, n, chunk)={(p, n, chunk)}")
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    lib = build.load()
    err = lib.gfdit_ssd_occupancy(p, n, chunk, _DTYPES[dtype], device,
                                  ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        msg = lib.gfdit_error_string(err).decode()
        raise RuntimeError(f"ssd_occupancy: {msg} ({err})")
    return blocks.value, smem.value
