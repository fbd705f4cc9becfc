"""Telemetry suite (DESIGN.md §15): the cross-backend identity gate.

Serves the hybrid-parallelism and failure-domain demos with telemetry
instruments attached on BOTH execution backends and gates on the new
invariant alongside ``trace_signature``: every clock-independent
telemetry stream — per-rank state sequences, policy decision records
(with their staged explanations), and per-request lifecycle structure —
must agree byte-for-byte between the virtual-clock simulator and the
wall-clock thread runtime.  Clock-dependent streams (loop counters,
overlay spans, GFC latency samples) are exercised but excluded from the
comparison by construction.

The wall legs' Perfetto/Chrome traces are exported into the output
directory (``hybrid_trace.json``, ``failure_trace.json``), loadable in
``ui.perfetto.dev``.  A gate failure raises, which
``repro_torch.benchmarks.run`` turns into a non-zero exit.

The elastic demo's telemetry identity is gated in tier-1 pytest
(tests/test_torch_scenario_elastic.py), so this suite covers the two
demos tier-1 does not serve end-to-end.

Twin of ``benchmarks/telemetry_suite.py`` on the port: the wall legs
serve on the card at ``DIT_IMAGE``'s full width and depth, or with
``--device cpu`` at ``DIT_IMAGE.reduced()``, the JAX script's size:

    python -m repro_torch.benchmarks.telemetry_suite [--device cpu]
        [--out DIR]
"""
from __future__ import annotations

import json
import sys

from repro_torch.benchmarks import common

RESULTS = common.RESULTS


def _leg(name: str, demo_result: dict, results) -> tuple[dict, list[str]]:
    problems = []
    if not demo_result["trace_match"]:
        problems.append(f"{name}: sim/wall trace signatures differ")
    if not demo_result["telemetry_match"]:
        problems.append(f"{name}: clock-independent telemetry differs")
    tel = demo_result["wall"]["telemetry_obj"]
    tel.perfetto(str(results / f"{name}_trace.json"))
    s = tel.summary()
    return {
        "trace_match": demo_result["trace_match"],
        "telemetry_match": demo_result["telemetry_match"],
        "decisions": len(tel.decisions),
        "explained": sum(1 for d in tel.decisions
                         if d.get("explanation") is not None),
        "makespan_s": s["makespan_s"],
        "rank_utilization": s["rank_utilization"],
        "goodput_per_rank": s["goodput_per_rank"],
        "completed": s["completed"],
        "counters": dict(tel.counters),
    }, problems


def _streamed_leg(results) -> tuple[dict, list[str]]:
    """Streaming sinks (DESIGN.md §16) on a small sim workload at FULL
    retention: serving with a JsonlSink + RollupSink attached must leave
    the control-plane trace byte-identical to a sink-free run, export a
    non-empty ``.jsonl``, and the rollup's busy accounting must agree
    with the in-memory instrument exactly."""
    from repro_torch.configs.dit_models import DIT_IMAGE
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.policies import make_policy
    from repro_torch.core.scheduler import ControlPlane, trace_signature
    from repro_torch.core.simulator import SimBackend
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.core.telemetry_sinks import JsonlSink, RollupSink
    from repro_torch.core.trajectory import ClusterTopology, Request
    from repro_torch.diffusion.adapters import convert_request

    cfg = DIT_IMAGE.reduced()
    topo = ClusterTopology(num_hosts=2, ranks_per_host=2)

    def serve(tel):
        cost = CostModel()
        cp = ControlPlane(topo, make_policy("elastic", topo.num_ranks),
                          cost, SimBackend(cost), telemetry=tel)
        for i in range(8):
            r = Request(id=f"s{i}", model="dit-image", height=128,
                        width=128, frames=1, steps=4, arrival=i * 0.2,
                        deadline=i * 0.2 + 30.0)
            cp.submit(r, convert_request(r, cfg))
        cp.run()
        tel.close_sinks()
        return cp

    cp_bare = serve(Telemetry())
    path = results / "telemetry_suite_stream.jsonl"
    jsonl, rollup = JsonlSink(path), RollupSink(window_s=0.25)
    tel = Telemetry(sinks=[jsonl, rollup])
    cp_sink = serve(tel)

    problems = []
    if trace_signature(cp_bare.events) != trace_signature(cp_sink.events):
        problems.append("streamed: sinks changed the control-plane trace")
    if jsonl.lines_written == 0 or not path.exists():
        problems.append("streamed: JsonlSink exported nothing")
    busy_tel = tel.busy_seconds()
    busy_roll = rollup.busy_seconds()
    drift = max(abs(busy_tel.get(r, 0.0) - busy_roll.get(r, 0.0))
                for r in set(busy_tel) | set(busy_roll))
    if drift > 1e-9:
        problems.append(f"streamed: rollup busy drift {drift}")
    return {
        "trace_match": not problems,
        "jsonl_lines": jsonl.lines_written,
        "jsonl_bytes": path.stat().st_size if path.exists() else 0,
        "rollup_windows": len(rollup.windows),
        "busy_drift_s": drift,
    }, problems


def run(device=None, out_dir=None) -> dict:
    from repro_torch.serving import failure_demo, hybrid_demo
    results = common.out_dir(out_dir, RESULTS)
    device = common.device_of(device)
    cfg = common.serving_config(device)
    out, problems = {}, []
    leg, probs = _leg("hybrid", hybrid_demo.run_demo(cfg, device=device),
                      results)
    out["hybrid"] = leg
    problems += probs
    leg, probs = _leg("failure", failure_demo.run_demo(cfg, device=device),
                      results)
    out["failure"] = leg
    problems += probs
    leg, probs = _streamed_leg(results)
    out["streamed"] = leg
    problems += probs
    (results / "telemetry_suite.json").write_text(
        json.dumps(out, indent=1, default=str))
    if problems:
        raise RuntimeError("; ".join(problems))
    return out


def rows(data: dict) -> list[tuple[str, float, str]]:
    out = []
    for name in ("hybrid", "failure"):
        d = data[name]
        derived = (f"telemetry_match={d['telemetry_match']};"
                   f"util={d['rank_utilization']:.3f};"
                   f"goodput_per_rank={d['goodput_per_rank']:.4f};"
                   f"decisions={d['decisions']}")
        out.append((f"telemetry.{name}_demo", d["makespan_s"] * 1e6,
                    derived))
    s = data["streamed"]
    out.append(("telemetry.streamed", float(s["jsonl_lines"]),
                f"trace_match={s['trace_match']};"
                f"jsonl_bytes={s['jsonl_bytes']};"
                f"windows={s['rollup_windows']}"))
    return out


if __name__ == "__main__":
    sys.exit(common.main(sys.modules[__name__]))
