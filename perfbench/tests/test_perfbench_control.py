"""The control (the reference in TF32 put in the program's place) comes
out as not correct under each committed configuration's limits, at a
size a test run holds; the card test checks the device trace's clock."""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from perfbench import check
from perfbench.tools import control

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("workload,config", [
    ("tiny-interactive", "wan2.1-t2v-1.3b"), ("tiny-closed", "wan2.2-ti2v-5b")])
def test_control_fails_the_limits(tiny_root, workload, config):
    limits = json.loads((REPO / f"perfbench/configs/{config}.json")
                        .read_text())["limits"]
    line = control.readings(tiny_root, workload, 2 ** 31 + 3, "cpu", 2.0)
    mode = line["mode"]
    assert line["fails"]
    assert not check.verdict(line["control"], limits[mode])
    # every number the control gives fails on its own
    assert all(line["control"][k] > lim for k, lim in limits[mode].items())


@pytest.mark.cuda
def test_device_trace_on_the_card(cuda):
    import torch

    from perfbench import devtrace
    a = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    with devtrace.DeviceTrace() as tr:
        t0 = time.monotonic()
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()
        t1 = time.monotonic()
    gemm = [k for k in tr.kernels if devtrace.category(k[0]) == "gemm"]
    assert len(gemm) == 20
    # the kernels lie between the host's marks, to the launch latency
    assert t0 - 1e-3 <= gemm[0][1] and gemm[-1][2] <= t1 + 1e-3
