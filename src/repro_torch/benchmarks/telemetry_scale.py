"""Telemetry streaming at fleet scale (DESIGN.md §16): the stress gate.

Serves the seeded ~2e4-request open-loop stream
(:func:`repro_torch.diffusion.workloads.open_loop_trace`) through the
virtual-clock simulator twice:

* **run 1 — full retention, sinks detached**: a bare §15
  :class:`~repro_torch.core.telemetry.Telemetry` buffers every event
  in-memory (the pre-§16 behavior whose cost this PR bounds);
* **run 2 — sampled + streamed, sinks attached**: raw retention is
  governed by ``SamplingPolicy(rate=0.01)``, the retained stream
  exports incrementally through a :class:`JsonlSink` into
  ``telemetry_stream.jsonl`` of the output directory, the FULL stream folds
  into a :class:`RollupSink`, a :class:`CountingSink` measures what
  full export would have cost, and live SLO burn-rate / goodput
  monitors emit alerts into the same stream.

Gates (a failure raises, which ``repro_torch.benchmarks.run`` turns into
a non-zero exit):

1. **memory** — run 2 retains >=10x fewer raw events than run 1;
2. **rollup accuracy** — rollup-derived rank utilization and SLO
   violation rate match run 1's full-retention values within 2%;
3. **observation-only** — ``trace_signature`` of the two control-plane
   traces is byte-identical: attaching sinks + sampling + monitors
   changed NOTHING the scheduler did.

Results land in ``telemetry_scale.json`` (+ the streamed ``.jsonl``) of
the output directory.

Twin of ``benchmarks/telemetry_scale.py`` on the port: the simulator
runs on the host and takes no device, so every number but the walls
equals the JAX script's.

    python -m repro_torch.benchmarks.telemetry_scale [--out DIR]
"""
from __future__ import annotations

import json
import sys
import time

from repro_torch.benchmarks import common

RESULTS = common.RESULTS

#: open-loop stream shape (see open_loop_trace): 2 hosts x 8 ranks,
#: degree-8-forcing deadlines — every denoise step fans out ~16 rank
#: transitions, the event volume this suite exists to bound
N_REQUESTS = 20000
NUM_HOSTS, RANKS_PER_HOST = 2, 8
#: offered load vs degree-8 service capacity.  Deliberately below the
#: EDF escalation knee: past ~0.7 a transient backlog makes EDF grow
#: late requests to the largest feasible degree, which LOWERS capacity
#: (degree 16 serves fewer req/s than 2x degree 8) — the queue then
#: diverges and an open-loop run goes quadratic in wall time.  0.55
#: keeps the stream busy (approximately half utilization, a steady
#: trickle of SLO misses for the burn monitor) while staying stable
#: out to 2e4 requests.
LOAD = 0.55
SAMPLE_RATE = 0.01
MEM_REDUCTION_GATE = 10.0
ACCURACY_GATE = 0.02


def _retained_events(tel) -> int:
    """Raw events held in the instrument's in-memory streams."""
    return (sum(len(s) for s in tel.lifecycle.values())
            + sum(len(s) for s in tel.rank_states.values())
            + sum(len(s) for s in tel.overlay.values())
            + len(tel.decisions) + len(tel.cost_stream)
            + len(tel.alerts))


def _serve(telemetry):
    """One sim serving run of the open-loop stream; fresh cost model and
    trace per run so both runs make byte-identical decisions."""
    from repro_torch.configs.dit_models import DIT_IMAGE
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.policies import EDFPolicy
    from repro_torch.core.scheduler import ControlPlane
    from repro_torch.core.simulator import SimBackend
    from repro_torch.core.trajectory import ClusterTopology
    from repro_torch.diffusion.adapters import convert_request
    from repro_torch.diffusion.workloads import open_loop_trace

    cost = CostModel()
    topo = ClusterTopology(num_hosts=NUM_HOSTS,
                           ranks_per_host=RANKS_PER_HOST)
    trace = open_loop_trace(cost, n_requests=N_REQUESTS, load=LOAD,
                            num_ranks=topo.num_ranks)
    cfg = DIT_IMAGE.reduced()
    # degree cap: EDF grows LATE requests to the largest feasible
    # degree, and degree 16 serves fewer req/s than two degree-8 slots
    # — on an open-loop stream one deep-enough burst tips the plane
    # into a metastable regime where everything is late, everything
    # runs wide, and the queue diverges (wall time goes quadratic).
    # Capping candidates at 8 keeps escalation capacity-positive, so
    # the stream stays stable out to 2e4 requests.
    policy = EDFPolicy(candidate_degrees=(2, 4, 8))
    cp = ControlPlane(topo, policy, cost,
                      SimBackend(cost), telemetry=telemetry)
    t0 = time.perf_counter()
    for r in trace:
        cp.submit(r, convert_request(r, cfg))
    cp.run()
    telemetry.close_sinks()
    return cp, time.perf_counter() - t0


def run(out_dir=None) -> dict:
    from repro_torch.core.scheduler import trace_signature
    from repro_torch.core.slo_monitor import GoodputMonitor, SloBurnRateMonitor
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.core.telemetry_sinks import (CountingSink, JsonlSink,
                                            RollupSink, SamplingPolicy)
    results = common.out_dir(out_dir, RESULTS)

    # run 1: full retention, no sinks (the detached side of gate 3)
    tel_full = Telemetry()
    cp_full, wall_full = _serve(tel_full)
    full_events = _retained_events(tel_full)
    s_full = tel_full.summary()

    # run 2: sampled retention + the whole §16 streaming stack
    jsonl_path = results / "telemetry_stream.jsonl"
    jsonl = JsonlSink(jsonl_path)
    rollup = RollupSink(window_s=20.0)
    counting = CountingSink()
    burn = SloBurnRateMonitor(window_s=60.0, budget=0.05, threshold=2.0)
    goodput = GoodputMonitor(window_s=60.0, floor=1e-4)
    tel_sampled = Telemetry(
        sinks=[jsonl, rollup, counting, burn, goodput],
        sampling=SamplingPolicy(rate=SAMPLE_RATE, seed=0))
    cp_sampled, wall_sampled = _serve(tel_sampled)
    sampled_events = _retained_events(tel_sampled)
    s_rollup = rollup.summary(num_ranks=NUM_HOSTS * RANKS_PER_HOST)

    # gates ------------------------------------------------------------
    problems = []
    reduction = full_events / max(sampled_events, 1)
    if reduction < MEM_REDUCTION_GATE:
        problems.append(
            f"memory: retained {sampled_events} of {full_events} events "
            f"({reduction:.1f}x < {MEM_REDUCTION_GATE}x) at "
            f"p={SAMPLE_RATE}")

    def _rel(a: float, b: float) -> float:
        return abs(a - b) / max(abs(a), abs(b), 1e-9)

    util_err = _rel(s_rollup["rank_utilization"],
                    s_full["rank_utilization"])
    if util_err > ACCURACY_GATE:
        problems.append(
            f"rollup utilization {s_rollup['rank_utilization']:.4f} vs "
            f"full {s_full['rank_utilization']:.4f} "
            f"({util_err:.1%} > {ACCURACY_GATE:.0%})")
    viol_err = _rel(s_rollup["violation_rate"], s_full["violation_rate"])
    if viol_err > ACCURACY_GATE:
        problems.append(
            f"rollup violation rate {s_rollup['violation_rate']:.4f} vs "
            f"full {s_full['violation_rate']:.4f} "
            f"({viol_err:.1%} > {ACCURACY_GATE:.0%})")

    sig_full = trace_signature(cp_full.events)
    sig_sampled = trace_signature(cp_sampled.events)
    trace_match = sig_full == sig_sampled
    if not trace_match:
        problems.append("control-plane trace changed with sinks attached "
                        "(telemetry must stay observation-only)")
    if tel_sampled.counters.get("sink_detached"):
        problems.append("a sink was detached mid-run (sink error)")
    if not jsonl_path.exists() or jsonl.lines_written == 0:
        problems.append("JsonlSink exported nothing")

    out = {
        "n_requests": N_REQUESTS,
        "num_ranks": NUM_HOSTS * RANKS_PER_HOST,
        "sample_rate": SAMPLE_RATE,
        "full": {
            "retained_events": full_events,
            "rank_utilization": s_full["rank_utilization"],
            "violation_rate": s_full["violation_rate"],
            "completed": s_full["completed"],
            "failed": s_full["failed"],
            "makespan_s": s_full["makespan_s"],
            "serve_wall_s": wall_full,
        },
        "sampled": {
            "retained_events": sampled_events,
            "rank_utilization": tel_sampled.summary()["rank_utilization"],
            "completed": tel_sampled.summary()["completed"],
            "jsonl_lines": jsonl.lines_written,
            "jsonl_bytes": (jsonl_path.stat().st_size
                            if jsonl_path.exists() else 0),
            "full_stream_events": counting.events,
            "full_stream_by_kind": dict(counting.by_kind),
            "est_full_export_bytes": counting.estimated_bytes(),
            "burn_alerts": burn.alerts_fired,
            "goodput_alerts": goodput.alerts_fired,
            "alerts_total": len(tel_sampled.alerts),
            "serve_wall_s": wall_sampled,
        },
        "rollup": {
            "windows": s_rollup["windows"],
            "rank_utilization": s_rollup["rank_utilization"],
            "violation_rate": s_rollup["violation_rate"],
            "goodput_per_rank": s_rollup["goodput_per_rank"],
            "completed": s_rollup["completed"],
            "failed": s_rollup["failed"],
            "step_p50_s": s_rollup["step_p50_s"],
            "cost_err_p50": s_rollup["cost_err_p50"],
        },
        "gates": {
            "reduction_x": reduction,
            "util_rel_err": util_err,
            "violation_rel_err": viol_err,
            "trace_match": trace_match,
        },
    }
    (results / "telemetry_scale.json").write_text(
        json.dumps(out, indent=1, default=str))
    if problems:
        raise RuntimeError("; ".join(problems))
    return out


def rows(data: dict) -> list[tuple[str, float, str]]:
    g = data["gates"]
    derived = (f"reduction={g['reduction_x']:.1f}x;"
               f"util_err={g['util_rel_err']:.2%};"
               f"viol_err={g['violation_rel_err']:.2%};"
               f"trace_match={g['trace_match']};"
               f"alerts={data['sampled']['alerts_total']}")
    return [("telemetry_scale.open_loop",
             data["full"]["makespan_s"] * 1e6, derived)]


if __name__ == "__main__":
    sys.exit(common.main(sys.modules[__name__]))
