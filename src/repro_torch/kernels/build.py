"""Build the CUDA kernels in ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` (all
started together), the objects are linked into one shared library with a
plain C interface, and the library is loaded with :mod:`ctypes`.  The
library's name carries a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once.  The build goes into
``build/kernels/`` at the root of the checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
#: what the last build did: seconds spent (0.0 when the library was
#: already built) and ptxas's report of registers, shared memory, spills
build_info: dict = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # x, shift, scale, gate, residual, out, rows, n, d, ln, dtype, device,
    # stream
    "gfdit_adaln": [_P] * 6 + [_I] * 6 + [_P],
    # x, shift, scale, gate, dy, dx, dshift, dscale, dgate, partial,
    # partial floats, B, n, d, ln, dtype, device, stream
    "gfdit_adaln_bwd": [_P] * 10 + [ctypes.c_longlong] + [_I] * 6 + [_P],
    # B, n, d, mod, gated, device -> floats of partials' scratch
    "gfdit_adaln_bwd_scratch": [_I] * 6,
    # B, n, d, ln, mod, gated, dtype, vec, device -> the plan (7 ints)
    "gfdit_adaln_bwd_plan": [_I] * 9 + [_IP],
    # q, k, v, out, lse, scratch, scratch floats, splits, B, Sq, Sk, H, KV,
    # D, causal, sm_scale, dtype, device, stream
    "gfdit_attention": [_P] * 6 + [ctypes.c_longlong] + [_I] * 8
    + [_F, _I, _I, _P],
    # B, Sq, Sk, H, D, dtype, device -> the kernel's key pieces
    "gfdit_attention_splits": [_I] * 7 + [_IP],
    # q, k, v, o, dout, lse, dq, dk, dv, delta, B, Sq, Sk, H, KV, D, causal,
    # sm_scale, dtype, device, stream
    "gfdit_attention_bwd": [_P] * 10 + [_I] * 7 + [_F, _I, _I, _P],
    # q, k_stale, v_stale, k_fresh, v_fresh, out, scratch, scratch floats,
    # splits, B, Sq, Sk, L, H, KV, D, offset, sm_scale, dtype, device, stream
    "gfdit_splice_attention": [_P] * 7 + [ctypes.c_longlong] + [_I] * 9
    + [_F, _I, _I, _P],
    # x, dt, A, B, C, y, state, scratch cum, states, cbt, batch, L, H, P,
    # N, chunk, dtype, device, stream
    "gfdit_ssd": [_P] * 10 + [_I] * 8 + [_P],
    # stage, batch, L, H, P, N, chunk, dtype, device -> blocks per SM,
    # shared memory bytes, grid, threads a block
    "gfdit_ssd_occupancy": [_I] * 9 + [_IP] * 4,
    # x, dt, A, B, C, dy, dstate, cum, s_in, cbt, dx, ddt, dA, dB, dC,
    # work, work floats, batch, L, H, P, N, chunk, dtype, device, stream
    "gfdit_ssd_bwd": [_P] * 16 + [ctypes.c_longlong] + [_I] * 8 + [_P],
    # batch, L, H, P, N, chunk -> floats of the backward's own scratch
    "gfdit_ssd_bwd_scratch": [_I] * 6,
    # as gfdit_ssd_occupancy, for the backward's four stage kernels
    "gfdit_ssd_bwd_occupancy": [_I] * 9 + [_IP] * 4,
    # D, dtype, device -> blocks per SM, shared memory bytes
    "gfdit_attention_occupancy": [_I] * 3 + [_IP, _IP],
    # D, dtype, which (0 dK/dV, 1 dQ), device -> blocks per SM, shared
    # memory bytes
    "gfdit_attention_bwd_occupancy": [_I] * 4 + [_IP, _IP],
    # x, w, y, M, N, K, tile rows, device, stream
    "gfdit_gemm": [_P] * 3 + [_I] * 5 + [_P],
    # tile rows, device -> blocks per SM, shared memory bytes
    "gfdit_gemm_occupancy": [_I] * 2 + [_IP, _IP],
}

_RESTYPES = {"gfdit_adaln_bwd_scratch": ctypes.c_longlong,
             "gfdit_ssd_bwd_scratch": ctypes.c_longlong}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin/ on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha1(" ".join(ARCH + FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {target.name} failed:\n{link.stdout}")
        os.replace(tmp_lib, target)      # atomic: no half-written library
    build_info["seconds"] = time.perf_counter() - t0
    build_info["ptxas"] = "\n".join(logs)
    target.with_suffix(".log").write_text(build_info["ptxas"])


def library_path() -> Path:
    """Where the library built from the current ``csrc/`` lives."""
    return BUILD_DIR / f"libgfdit-{_digest()}.so"


def load() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if target.exists():
                build_info["seconds"] = 0.0
            else:
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            lib.gfdit_error_string.argtypes = [ctypes.c_int]
            lib.gfdit_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
