"""The port's boundaries: it stands alone from the JAX package, runs on
the card unless asked for the CPU, and never computes a CUDA tensor
some other way when its kernels are missing."""
import gc
import importlib
import importlib.util
import os
import re
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.core import migration  # noqa: E402
from repro_torch.core.policies import make_policy  # noqa: E402
from repro_torch.core.telemetry import Telemetry  # noqa: E402
from repro_torch.core.trajectory import Request  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
# an import of jax or ml_dtypes (a JAX dependency), or of the JAX package
# itself (not repro_torch)
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+ml_dtypes\b"
    r"|from\s+ml_dtypes\b|import\s+repro(\s|,|\.|$)"
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
    ("import ml_dtypes", True), ("        import ml_dtypes", True),
    ("from ml_dtypes import bfloat16", True),
    ("import ml_dtypes_like_name_but_not", False),
])
def test_forbidden_import_pattern(line, forbidden):
    assert bool(FORBIDDEN.search(line)) == forbidden


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_engine.ServingEngine(DIT_IMAGE.reduced(),
                                   make_policy("edf", 2), 2)


@pytest.mark.parametrize("demo", ["elastic", "packing", "cache",
                                  "topology", "hybrid", "failure"])
def test_demos_default_to_cuda_and_raise_without_it(monkeypatch, demo):
    """Every demo's engines run on the card unless the CPU is asked for;
    without CUDA the first engine raises, before any wall leg runs."""
    mod = importlib.import_module(f"repro_torch.serving.{demo}_demo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.run_demo(DIT_IMAGE.reduced())


def test_mamba2_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("mamba2-1.3b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ssm.Mamba2(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ssm.init_cache(cfg, 1)
    assert ssm.init_cache(cfg, 1, device="cpu")["blocks"]["state"].is_cpu


def test_migration_refuses_a_bfloat16_field():
    """No silent float32: a bfloat16 field waits for the slice that
    moves one."""
    with pytest.raises(NotImplementedError, match="later slice"):
        migration.np_dtype("bfloat16")
    assert migration.np_dtype("float32") == np.float32


def _tiny_request(rid="r0", steps=2):
    return Request(id=rid, model="dit-image", height=64, width=64,
                   frames=1, steps=steps, arrival=0.0)


def test_engine_serves_with_telemetry_and_records_decisions():
    tel = Telemetry()
    eng = torch_engine.ServingEngine(DIT_IMAGE.reduced(),
                                     make_policy("edf", 2), 2,
                                     device="cpu", telemetry=tel)
    try:
        assert eng.comm.telemetry is tel and eng.cp.telemetry is tel
        m = eng.serve([_tiny_request()], timeout=60)
    finally:
        eng.shutdown()
    assert m["completed"] == 1
    actions = {d["action"] for d in tel.decisions}
    assert "dispatch" in actions, actions
    assert set(tel.rank_states) == {0, 1}
    assert tel.summary()["makespan_s"] > 0


def test_engine_writes_denoise_snapshots_to_disk(tmp_path):
    eng = torch_engine.ServingEngine(DIT_IMAGE.reduced(),
                                     make_policy("edf", 2), 2,
                                     device="cpu", snapshot_interval=1,
                                     snapshot_dir=tmp_path)
    try:
        m = eng.serve([_tiny_request("snap", steps=3)], timeout=60)
    finally:
        eng.shutdown()
    assert m["completed"] == 1
    steps = sorted(p.name for p in (tmp_path / "snap").glob("step_*"))
    assert steps == ["step_1", "step_2"]          # keep-last-2
    assert (tmp_path / "snap" / "LATEST").read_text() == "2"
    assert (tmp_path / "snap" / "step_2" / "latent.npy").exists()


def test_dropped_engine_frees_its_pipeline_without_gc():
    """No reference cycle keeps the model (and on the card its device
    memory) alive once the engine is shut down and dropped; the finished
    pixels stay readable after shutdown."""
    gc.disable()
    try:
        eng = torch_engine.ServingEngine(DIT_IMAGE.reduced(),
                                         make_policy("edf", 2), 2,
                                         device="cpu")
        pipeline = weakref.ref(eng.pipeline)
        dit = weakref.ref(eng.pipeline.dit)
        req = _tiny_request()
        eng.serve([req], timeout=60)
        eng.shutdown()
        assert eng.result_pixels(req).shape == (1, 64, 64, 3)
        del eng
        assert pipeline() is None and dit() is None
    finally:
        gc.enable()


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("wrapper", ["attention", "splice_attention",
                                     "fused_adaln", "ssd"])
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
        "ssd": lambda: ops.ssd(t(1, 32, 2, 16), t(1, 32, 2), t(2),
                               t(1, 32, 16), t(1, 32, 16), chunk=16),
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


def test_chip_smoke_reads_registers_and_spills_from_ptxas():
    """chip_smoke.py's build phase names every kernel that spills."""
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN5gfdit1aE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN5gfdit1aE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 156 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN5gfdit1bE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN5gfdit1bE",
        "    16 bytes stack frame, 20 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 128 registers, used 0 barriers",
    ])
    assert smoke.ptxas_report(log) == {
        "_ZN5gfdit1aE": {"registers": 156, "spill_bytes": 0, "stack": 0},
        "_ZN5gfdit1bE": {"registers": 128, "spill_bytes": 24, "stack": 16}}
