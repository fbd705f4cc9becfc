"""The port's twins of ``examples/quickstart.py`` and
``examples/elastic_policy_lab.py`` (``repro_torch.serving.quickstart``,
``repro_torch.serving.elastic_policy_lab``): each runs beside the JAX
example and prints the same metrics, line for line (the simulator is
deterministic and neither needs a device)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]


def _run(*argv) -> list:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, *argv], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.splitlines()


@pytest.mark.parametrize("name", ["quickstart", "elastic_policy_lab"])
def test_example_twin_prints_the_jax_metrics(name):
    want = _run(str(REPO / "examples" / f"{name}.py"))
    got = _run("-m", f"repro_torch.serving.{name}")
    assert len(want) >= 6
    assert got == want
