"""Quickstart: elastic DiT serving in ~30 lines (``examples/quickstart.py``
on the port's control plane).

Submits a mixed image workload to the GF-DiT control plane under the EDF
policy (simulator backend) and prints serving metrics.  No device: the
simulator prices each task with the cost model.

    python -m repro_torch.serving.quickstart
"""
from repro_torch.configs.dit_models import DIT_IMAGE
from repro_torch.core.cost_model import CostModel
from repro_torch.core.policies import make_policy
from repro_torch.core.scheduler import ControlPlane
from repro_torch.core.simulator import SimBackend
from repro_torch.diffusion.adapters import convert_request
from repro_torch.diffusion.workloads import short_trace


def main():
    num_ranks = 4
    cost = CostModel()
    requests = short_trace("dit-image", cost, duration=60, load=0.8,
                           num_ranks=num_ranks, steps=25)
    control = ControlPlane(num_ranks, make_policy("edf", num_ranks), cost,
                           SimBackend(cost))
    for req in requests:
        control.submit(req, convert_request(req, DIT_IMAGE))
    control.run()

    m = control.metrics()
    print(f"requests     : {len(requests)}")
    print(f"completed    : {m['completed']}")
    print(f"throughput   : {m['throughput_rps']:.3f} req/s")
    print(f"mean latency : {m['mean_latency_s']:.2f} s")
    print(f"p95 latency  : {m['p95_latency_s']:.2f} s")
    print(f"SLO attainment: {m['slo_attainment']:.1%}")


if __name__ == "__main__":
    main()
