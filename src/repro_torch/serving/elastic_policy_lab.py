"""Policy programmability demo (paper §3.2; ``examples/elastic_policy_lab.py``
on the port's control plane): write a custom scheduling
policy in ~20 lines, evaluate it in the simulator against the built-ins,
and — because simulator and runtime share the policy interface AND the
event loop — it could be deployed on the real engine unchanged.

Policies return control-plane *actions* (DESIGN.md §3): ``Dispatch`` a
ready task, ``Reallocate`` a running request's rank set (effective at
its next denoise boundary, with automatic migration), ``Preempt`` a
running task (requeued, inputs intact), or ``Cancel`` a request.  No
device: the simulator prices each task with the cost model.

    python -m repro_torch.serving.elastic_policy_lab
"""
from repro_torch.configs.dit_models import DIT_VIDEO
from repro_torch.core.cost_model import CostModel
from repro_torch.core.policies import make_policy
from repro_torch.core.scheduler import (ControlPlane, Decision, Policy,
                                  Reallocate)
from repro_torch.core.simulator import SimBackend
from repro_torch.core.trajectory import ExecutionLayout
from repro_torch.diffusion.adapters import convert_request
from repro_torch.diffusion.workloads import foreground_burst_trace


class SizeAwarePolicy(Policy):
    """Custom policy: small requests get 1 rank; larger requests get the
    largest free group, but only while the queue is shallow."""
    name = "size-aware"

    def schedule(self, view):
        out, free = [], list(view.free_ranks)
        queue_deep = len(view.ready) > view.num_ranks
        for task, req, graph in sorted(view.ready,
                                       key=lambda t: t[1].arrival):
            if not free:
                break
            want = 1 if (req.size_class == "S" or queue_deep) else \
                min(len(free), 2 if req.size_class == "M" else 4)
            out.append(Decision(task.id, ExecutionLayout(tuple(free[:want]))))
            free = free[want:]
        return out


class BoundaryGrowPolicy(Policy):
    """Action-vocabulary demo: dispatch FCFS at one rank, then grow any
    running request onto the idle ranks at its next denoise boundary —
    a ~15-line elastic policy."""
    name = "boundary-grow"

    def schedule(self, view):
        out, free = [], list(view.free_ranks)
        for lay in view.pinned.values():        # honor earlier grants
            free = [r for r in free if r not in lay.ranks]
        for task, req, graph in sorted(view.ready,
                                       key=lambda t: t[1].arrival):
            if not free:
                return out
            out.append(Decision(task.id, ExecutionLayout((free.pop(0),))))
        for tid, (task, lay) in sorted(view.running.items()):
            if task.kind != "denoise" or task.request_id in view.pinned:
                continue
            grant = min(len(free), 3)
            if grant:
                out.append(Reallocate(
                    task.request_id,
                    ExecutionLayout(lay.ranks + tuple(free[:grant]))))
                free = free[grant:]
        return out


def evaluate(policy, trace):
    cost = CostModel()
    cp = ControlPlane(4, policy, cost, SimBackend(cost))
    for r in trace():
        cp.submit(r, convert_request(r, DIT_VIDEO))
    cp.run()
    m = cp.metrics()
    m["reallocs"] = sum(1 for e in cp.events if e["ev"] == "reallocate")
    return m


def main():
    def trace():
        return foreground_burst_trace("dit-video", CostModel(),
                                      duration=90, load=0.8, num_ranks=4,
                                      steps=20, seed=17)
    print(f"{'policy':14s} {'thr':>7s} {'mean':>8s} {'p95':>8s} "
          f"{'SLO':>6s} {'reallocs':>8s}")
    for pol in [make_policy("legacy", 4), make_policy("srtf-sp1", 4),
                make_policy("edf", 4), make_policy("elastic", 4),
                SizeAwarePolicy(), BoundaryGrowPolicy()]:
        m = evaluate(pol, trace)
        print(f"{pol.name:14s} {m['throughput_rps']:7.3f} "
              f"{m['mean_latency_s']:7.1f}s {m['p95_latency_s']:7.1f}s "
              f"{m['slo_attainment']:6.1%} {m['reallocs']:8d}")


if __name__ == "__main__":
    main()
