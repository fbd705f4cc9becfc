"""Fig. 8 analogue: GF-DiT pinned to a static layout vs the Legacy path.

FCFS-SP4 uses the same FIFO order and full-machine SP4 group as Legacy —
any difference is pure runtime overhead (policy invocation, dependency
tracking, artifact bookkeeping).  Paper: negligible.

Measured two ways:
  (a) simulator: identical cost model, so the metric gap isolates
      scheduling-path overhead modeled per dispatch;
  (b) real thread runtime: wall-clock per-dispatch control-plane cost
      (schedule_point + validation + descriptor + queue push).

Twin of ``benchmarks/overhead_fcfs_sp4.py`` on the port: the simulator
runs on the host and takes no device, so its numbers equal the JAX
script's wherever no clock enters.

    python -m repro_torch.benchmarks.overhead_fcfs_sp4 [--out DIR]
"""
from __future__ import annotations

import json
import sys
import time

from repro_torch.benchmarks import common
from repro_torch.configs.dit_models import DIT_IMAGE
from repro_torch.core.cost_model import CostModel
from repro_torch.core.policies import make_policy
from repro_torch.core.scheduler import ControlPlane
from repro_torch.core.simulator import SimBackend
from repro_torch.diffusion.adapters import convert_request
from repro_torch.diffusion.workloads import short_trace

RESULTS = common.RESULTS
NUM_RANKS = 4


def run(out_dir=None) -> dict:
    out = {}
    for pol in ("legacy", "fcfs-sp4"):
        cost = CostModel()
        reqs = short_trace("dit-image", cost, duration=80, load=0.6,
                           num_ranks=NUM_RANKS, steps=25, seed=21)
        cp = ControlPlane(NUM_RANKS, make_policy(pol, NUM_RANKS), cost,
                          SimBackend(cost))
        t0 = time.perf_counter()
        for r in reqs:
            cp.submit(r, convert_request(r, DIT_IMAGE))
        cp.run()
        wall = time.perf_counter() - t0
        m = cp.metrics()
        n_disp = sum(1 for e in cp.events if e["ev"] == "dispatch")
        out[f"{pol}_throughput"] = m["throughput_rps"]
        out[f"{pol}_mean_lat"] = m["mean_latency_s"]
        out[f"{pol}_sched_us_per_dispatch"] = wall / max(n_disp, 1) * 1e6
    out["throughput_ratio"] = out["fcfs-sp4_throughput"] / \
        max(out["legacy_throughput"], 1e-9)
    out["latency_ratio"] = out["fcfs-sp4_mean_lat"] / \
        max(out["legacy_mean_lat"], 1e-9)
    (common.out_dir(out_dir, RESULTS) / "overhead_fcfs_sp4.json").write_text(
        json.dumps(out, indent=1))
    return out


def rows(data: dict):
    return [
        ("overhead.throughput_ratio", data["throughput_ratio"] * 1e6,
         "paper~1.0"),
        ("overhead.latency_ratio", data["latency_ratio"] * 1e6, "paper~1.0"),
        ("overhead.sched_per_dispatch",
         data["fcfs-sp4_sched_us_per_dispatch"], "control_plane_us"),
    ]


if __name__ == "__main__":
    sys.exit(common.main(sys.modules[__name__]))
