"""Nothing the benchmark's run imports is the JAX package or JAX, and the
plain reference imports nothing of the program (checked in fresh
processes, by whole top-level module names)."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def _modules(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True,
        env={"PYTHONPATH": f"{REPO}:{REPO / 'src'}", "PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_imports_no_jax():
    mods = _modules(
        "import perfbench.run, perfbench.harness, perfbench.readers\n"
        "import repro_torch.serving.engine, repro_torch.core.policies\n"
        "import repro_torch.core.cost_model, repro_torch.kernels.build\n"
        "import repro_torch.configs.registry\n"
        "import torch.profiler\n"
        "from repro_torch.configs.registry import get_config\n"
        "get_config('dit-image')\n"
        "import importlib.util, pathlib\n"
        "for p in sorted(pathlib.Path('perfbench/metrics').glob('*.py')):\n"
        "    s = importlib.util.spec_from_file_location('m' + str(abs(hash(p))), p)\n"
        "    s.loader.exec_module(importlib.util.module_from_spec(s))\n")
    assert "repro_torch" in mods and "perfbench" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_reference_imports_nothing_of_the_program():
    mods = _modules("import perfbench.reference.pipeline, "
                    "perfbench.reference.arith")
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_harness_refuses_a_run_holding_jax(monkeypatch):
    from perfbench import harness
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_modules() == ["repro"]
