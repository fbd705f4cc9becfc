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
_SIGNATURES = {
    # x, shift, scale, gate, residual, out, rows, n, d, ln, dtype, device,
    # stream
    "gfdit_adaln": [_P] * 6 + [_I] * 6 + [_P],
    # q, k, v, out, B, Sq, Sk, H, KV, D, causal, sm_scale, dtype, device,
    # stream
    "gfdit_attention": [_P] * 4 + [_I] * 7 + [_F, _I, _I, _P],
    # q, k_stale, v_stale, k_fresh, v_fresh, out, B, Sq, Sk, L, H, KV, D,
    # offset, sm_scale, dtype, device, stream
    "gfdit_splice_attention": [_P] * 6 + [_I] * 8 + [_F, _I, _I, _P],
}


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


def load() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            target = BUILD_DIR / f"libgfdit-{_digest()}.so"
            if target.exists():
                build_info["seconds"] = 0.0
            else:
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.gfdit_error_string.argtypes = [ctypes.c_int]
            lib.gfdit_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
