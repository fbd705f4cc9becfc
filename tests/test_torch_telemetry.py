"""The port's telemetry plane, sinks, SLO monitors, simulator and §6.1
workloads against the JAX package's, on the virtual clock.

The same workload trace (``short_trace`` and ``mixed_burst_trace`` at a
short duration, one fixed ``CostModel`` table) goes through
``ControlPlane`` + ``SimBackend`` + ``Telemetry`` (a ``JsonlSink``, a
``RollupSink`` and both SLO monitors attached) of each package.  Nothing
here computes on a device, so everything must be EQUAL, not close: the
``trace_signature``, ``clock_independent()``, the Perfetto JSON, the
JSONL lines, the rollup windows and the alerts.  Both packages draw
artifact and task ids from a process-wide counter, reset before each
run so that the ids in the streams agree.
"""
import itertools
import json
import types

import pytest

torch = pytest.importorskip("torch")

from repro.configs import dit_models as jdit  # noqa: E402
from repro.core import cost_model as jcost  # noqa: E402
from repro.core import policies as jpolicies  # noqa: E402
from repro.core import scheduler as jsched  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.core import slo_monitor as jslo  # noqa: E402
from repro.core import telemetry as jtel  # noqa: E402
from repro.core import telemetry_sinks as jsinks  # noqa: E402
from repro.core import trajectory as jtraj  # noqa: E402
from repro.diffusion import adapters as jadapters  # noqa: E402
from repro.diffusion import workloads as jworkloads  # noqa: E402
from repro_torch.configs import dit_models as tdit  # noqa: E402
from repro_torch.core import cost_model as tcost  # noqa: E402
from repro_torch.core import policies as tpolicies  # noqa: E402
from repro_torch.core import scheduler as tsched  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.core import slo_monitor as tslo  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core import telemetry_sinks as tsinks  # noqa: E402
from repro_torch.core import trajectory as ttraj  # noqa: E402
from repro_torch.diffusion import adapters as tadapters  # noqa: E402
from repro_torch.diffusion import workloads as tworkloads  # noqa: E402

JAX = types.SimpleNamespace(
    name="jax", dit=jdit, cost=jcost, policies=jpolicies, sched=jsched,
    sim=jsim, slo=jslo, tel=jtel, sinks=jsinks, traj=jtraj,
    adapters=jadapters, workloads=jworkloads)
PORT = types.SimpleNamespace(
    name="port", dit=tdit, cost=tcost, policies=tpolicies, sched=tsched,
    sim=tsim, slo=tslo, tel=ttel, sinks=tsinks, traj=ttraj,
    adapters=tadapters, workloads=tworkloads)

# measured-looking cells; every other cell interpolates from these or
# falls back to the analytical model (the same code in both packages)
TABLE = {
    "dit-image|encode|1024|1": 0.05,
    "dit-image|denoise|1024|1": 0.42,
    "dit-image|denoise|1024|2": 0.23,
    "dit-image|denoise|1024|4": 0.13,
    "dit-image|denoise|4096|4": 0.61,
    "dit-image|decode|1024|1": 0.08,
}

TRACES = {
    "short": lambda pkg, cost: pkg.workloads.short_trace(
        "dit-image", cost, duration=20.0, load=0.9, steps=4, seed=7),
    "mixed_burst": lambda pkg, cost: pkg.workloads.mixed_burst_trace(
        cost, duration=30.0, load=1.0, steps=4, seed=13),
}


def _run(pkg, trace: str, tmp_path, topology: bool) -> dict:
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pkg.traj, "_ids", itertools.count())
        return _run_from_zero(pkg, trace, tmp_path, topology)


def _run_from_zero(pkg, trace, tmp_path, topology) -> dict:
    cost = pkg.cost.CostModel(table=dict(TABLE))
    reqs = TRACES[trace](pkg, cost)
    path = tmp_path / f"{pkg.name}-{trace}.jsonl"
    rollup = pkg.sinks.RollupSink(window_s=2.0)
    tel = pkg.tel.Telemetry(sinks=[
        pkg.sinks.JsonlSink(path, flush_every=16), rollup,
        pkg.slo.SloBurnRateMonitor(window_s=10.0, budget=0.05,
                                   threshold=1.0, min_events=2),
        pkg.slo.GoodputMonitor(window_s=5.0, floor=0.05, min_events=1)])
    ranks = (pkg.traj.ClusterTopology(num_hosts=2, ranks_per_host=2)
             if topology else 4)
    cp = pkg.sched.ControlPlane(ranks, pkg.policies.ElasticPolicy(), cost,
                                pkg.sim.SimBackend(cost), telemetry=tel)
    cfg_of = {"dit-image": pkg.dit.DIT_IMAGE, "dit-video": pkg.dit.DIT_VIDEO}
    for r in reqs:
        cp.submit(r, pkg.adapters.convert_request(r, cfg_of[r.model]))
    cp.run()
    tel.close_sinks()
    return {
        "requests": [(r.id, r.model, r.size_class, r.arrival, r.deadline)
                     for r in reqs],
        "metrics": cp.metrics(),
        "signature": pkg.sched.trace_signature(cp.events),
        "clock_independent": tel.clock_independent(),
        "perfetto": json.dumps(tel.perfetto(), sort_keys=True),
        "jsonl": path.read_text().splitlines(),
        "windows": rollup.timeseries(),
        "rollup_summary": rollup.summary(4),
        "alerts": list(tel.alerts),
        "summary": tel.summary(),
    }


@pytest.fixture(scope="module", params=[
    ("short", False), ("mixed_burst", False), ("mixed_burst", True)],
    ids=["short", "mixed_burst", "mixed_burst-2x2"])
def runs(request, tmp_path_factory):
    trace, topology = request.param
    tmp = tmp_path_factory.mktemp(f"tel-{trace}")
    return {pkg.name: _run(pkg, trace, tmp, topology)
            for pkg in (JAX, PORT)}


@pytest.mark.parametrize("key", [
    "requests", "metrics", "signature", "clock_independent", "perfetto",
    "jsonl", "windows", "rollup_summary", "alerts", "summary"])
def test_port_equals_jax(runs, key):
    assert runs["port"][key] == runs["jax"][key]


def test_runs_are_not_vacuous(runs):
    port = runs["port"]
    assert port["metrics"]["completed"] > 3
    assert len(port["jsonl"]) > 100
    assert len(port["windows"]) > 3
    assert port["clock_independent"]["decisions"]
    kinds = {json.loads(ln).get("kind") for ln in port["jsonl"]}
    assert {"rank_state", "request", "decision"} <= kinds, kinds


def test_mixed_burst_raises_alerts(tmp_path):
    """The bursts of tight S deadlines miss SLOs: the burn-rate monitor
    alerts, in both packages alike."""
    got = [_run(pkg, "mixed_burst", tmp_path, False)["alerts"]
           for pkg in (JAX, PORT)]
    assert got[0] and got[0] == got[1]
