"""Fig. 10 analogue: EDF vs SRTF-SP1 SLO attainment as arrival rate rises.

Paper claim: EDF wins at low/moderate load (deadline-aware parallelism
rescues tight requests); under sustained overload SRTF-SP1 crosses over by
preserving single-rank concurrency.

Twin of ``benchmarks/arrival_scaling.py`` on the port: the simulator
runs on the host and takes no device, so its numbers equal the JAX
script's wherever no clock enters.

    python -m repro_torch.benchmarks.arrival_scaling [--out DIR]
"""
from __future__ import annotations

import json
import sys

from repro_torch.benchmarks import common
from repro_torch.configs.dit_models import DIT_IMAGE
from repro_torch.core.cost_model import CostModel
from repro_torch.core.policies import make_policy
from repro_torch.core.scheduler import ControlPlane
from repro_torch.core.simulator import SimBackend
from repro_torch.diffusion.adapters import convert_request
from repro_torch.diffusion.workloads import short_trace

RESULTS = common.RESULTS
LOADS = [0.4, 0.7, 1.0, 1.3, 1.7]
NUM_RANKS = 4
STEPS = 20


def run(out_dir=None) -> dict:
    out = {}
    for load in LOADS:
        for pol in ("edf", "srtf-sp1"):
            cost = CostModel()
            reqs = short_trace("dit-image", cost, duration=600, load=load,
                               num_ranks=NUM_RANKS, steps=STEPS, seed=13)
            cp = ControlPlane(NUM_RANKS, make_policy(pol, NUM_RANKS), cost,
                              SimBackend(cost, jitter=0.05))
            for r in reqs:
                cp.submit(r, convert_request(r, DIT_IMAGE))
            cp.run()
            out[f"load{load}|{pol}"] = cp.metrics()
    (common.out_dir(out_dir, RESULTS) / "arrival_scaling.json").write_text(
        json.dumps(out, indent=1))
    return out


def rows(data: dict):
    out = []
    for load in LOADS:
        for pol in ("edf", "srtf-sp1"):
            m = data[f"load{load}|{pol}"]
            out.append((f"arrival.load{load}.{pol}",
                        m["slo_attainment"] * 1e6,
                        f"mean_lat={m['mean_latency_s']:.1f}s"))
    return out


if __name__ == "__main__":
    sys.exit(common.main(sys.modules[__name__]))
