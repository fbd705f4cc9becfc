"""The port's boundaries: it stands alone from the JAX package, runs on
the card unless asked for the CPU, and never computes a CUDA tensor
some other way when its kernels are missing."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.core.policies import make_policy  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
# an import of jax, or of the JAX package itself (not repro_torch)
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\s|,|\.|$)"
    r"|from\s+repro(\.|\s+import\b))", re.M)
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes')\n"
        "             or m == 'repro' or m.startswith(('jax.', 'repro.')))\n"
        "print(len(names), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20            # every module of the slice
    assert out[1].strip() == "[]"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, hits


@pytest.mark.parametrize("line,forbidden", [
    ("import jax", True), ("from jax import numpy", True),
    ("import repro.core", True), ("from repro.kernels import ops", True),
    ("from repro import core", True), ("import repro", True),
    ("import repro_torch.core", False),
    ("from repro_torch.kernels import ops", False),
    ("import jaxlib_like_name_but_not", False),
])
def test_forbidden_import_pattern(line, forbidden):
    assert bool(FORBIDDEN.search(line)) == forbidden


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_engine.ServingEngine(DIT_IMAGE.reduced(),
                                   make_policy("edf", 2), 2)


@pytest.mark.parametrize("kwargs", [dict(telemetry=object()),
                                    dict(snapshot_dir="snapshots")])
def test_engine_refuses_later_slices(kwargs):
    with pytest.raises(NotImplementedError, match="later slice"):
        torch_engine.ServingEngine(DIT_IMAGE.reduced(),
                                   make_policy("edf", 2), 2, device="cpu",
                                   **kwargs)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("wrapper", ["attention", "splice_attention",
                                     "fused_adaln"])
def test_cuda_tensor_without_kernels_raises(monkeypatch, tmp_path, wrapper):
    """With no kernel library and no nvcc, a CUDA tensor raises instead
    of being computed by the plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", no_nvcc)

    def t(*shape):
        return torch.zeros(shape).as_subclass(_CudaLooking)
    calls = {
        "attention": lambda: ops.attention(t(1, 8, 2, 32), t(1, 8, 2, 32),
                                           t(1, 8, 2, 32)),
        "splice_attention": lambda: ops.splice_attention(
            t(1, 4, 2, 32), t(1, 8, 2, 32), t(1, 8, 2, 32), t(1, 4, 2, 32),
            t(1, 4, 2, 32), offset=4),
        "fused_adaln": lambda: ops.fused_adaln(t(1, 8, 64)),
    }
    before = dict(ops.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        calls[wrapper]()
    assert ops.launches == before


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
