"""What the twins of ``benchmarks/`` share: where their results go, the
card's name, and their command line.

    python -m repro_torch.benchmarks.<name> [--device cpu] [--out DIR]

Each twin keeps its JAX script's names, module constants, ``run()`` and
``rows()``, and prints the same ``name,us_per_call,derived`` rows.  Its
results go to ``--out`` (default ``build/bench/`` of the checkout), never
to ``benchmarks/results/``, which holds the JAX package's.  A twin with a
device leg runs it on the card unless ``--device cpu`` is given; the
simulator-only twins run on the host and take no device.
"""
from __future__ import annotations

import argparse
import inspect
import subprocess
from pathlib import Path

import torch

from repro_torch.configs.dit_models import DIT_IMAGE

#: default output directory: ``build/bench/`` of the checkout
RESULTS = Path(__file__).resolve().parents[3] / "build" / "bench"


def out_dir(path, default) -> Path:
    """``path`` (else ``default``) as a directory that exists."""
    out = Path(default if path is None else path)
    out.mkdir(parents=True, exist_ok=True)
    return out


def device_of(device) -> torch.device:
    """``device``, by default the card; without CUDA the caller must ask
    for the CPU (a device leg never drops to it)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this suite's device leg runs on CUDA and none "
                           "is available; pass --device cpu (device='cpu') "
                           "to run the plain PyTorch path")
    return device


def serving_config(device: torch.device):
    """The DiT a device leg serves: ``DIT_IMAGE`` at full width and depth
    on the card, ``DIT_IMAGE.reduced()`` (the JAX scripts' size) on the
    CPU."""
    return DIT_IMAGE if device.type == "cuda" else DIT_IMAGE.reduced()


def card() -> str:
    """The card's name and power limit (``nvidia-smi``)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def print_rows(rows) -> None:
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")


def parser(module) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=module.__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run the device legs without a card "
                         "(default: cuda; the simulator-only suites take "
                         "no device)")
    ap.add_argument("--out", default=None,
                    help=f"directory for the results (default {RESULTS})")
    return ap


def run_suite(module, device, out) -> dict:
    """``module.run`` with those of ``device`` and the output directory
    ``out`` that it takes (the simulator-only suites take no device,
    ``group_setup`` writes no file)."""
    params = inspect.signature(module.run).parameters
    kwargs = {"device": device, "out_dir": out}
    return module.run(**{k: v for k, v in kwargs.items() if k in params})


def main(module, argv=None) -> int:
    """A twin's command line: run it, print its rows."""
    args = parser(module).parse_args(argv)
    print_rows(module.rows(run_suite(module, args.device, args.out)))
    return 0
