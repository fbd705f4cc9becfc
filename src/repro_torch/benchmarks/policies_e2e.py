"""Fig. 6 analogue: end-to-end serving across policies x workloads x models.

Legacy (fixed-pipeline, static full-machine SP) vs GF-DiT policies
(FCFS-SP1, SRTF-SP1, SRTF-SPmax, EDF) on the short and foreground-burst
traces for both the image and video models.  Metrics: throughput, mean
latency, P95 latency, SLO attainment (failures count as violations) —
plus, from the telemetry plane (DESIGN.md §15), per-policy
``rank_utilization`` (mean busy fraction over the makespan) and
``goodput_per_rank`` (completions per rank-second), recorded for every
workload slice into ``results/policies_e2e.json``.

Also runs the many-small-images burst workload (DESIGN.md §9 step
packing): ``packing`` and ``elastic-pack`` co-batch same-shape denoise
steps across requests and must beat non-packing ``elastic`` on
throughput while holding SLO violations (``--only small-burst`` runs
just this slice; CI tracks it per PR).

And the multi-host topology workload (DESIGN.md §10): on a simulated
2-host x 4-rank cluster, the topology-aware ``elastic`` policy must beat
the topology-blind ``elastic-blind`` variant on throughput AND SLO
violation rate (``--only multi-host``; CI gates it per PR).

And the feature-cache workload (DESIGN.md §11): cached elastic
(``cache_interval=4`` plane + cache-affine policy) must beat non-cached
elastic on throughput on an M-image SLO stream whose min SP degree is 2
(per-rank activation memory rules out SP1 for M-class requests — the
regime where KV-gather collectives are unavoidable), while a wall-clock
probe holds the stale-reuse pixel error inside the §11 budget and
asserts ``cache_interval=1`` bit-exactness (``--only cache``; CI gates
it per PR).

And the hybrid-shape workload (DESIGN.md §14): a guided M-image SLO
stream (classifier-free guidance doubles the denoise work) plus a
best-effort video background on the simulated 2-host x 4-rank cluster;
deadlines are set against the split ``cfg2 x sp2`` service rate, so the
shape-searching ``elastic-hybrid`` policy must beat scalar ``elastic``
on throughput AND SLO violation rate while actually dispatching cfg2
shapes (``--only hybrid``; CI gates it per PR).

And the failure-domain chaos workload (DESIGN.md §13): the same seeded
whole-host kill script replayed against a recovering plane (failout +
snapshot rollback + re-place on survivors) and a blind baseline that
fails every touched request; recovery must beat blind on throughput AND
SLO violation rate (``--only chaos``; CI gates it per PR).

Simulation-driven (paper §5.5: the simulator is an execution backend for
the same policy interface; fidelity measured in sim_fidelity.py).

Twin of ``benchmarks/policies_e2e.py`` on the port.  Every slice but the
cache slice's pixel probe is the simulator on the host, so its numbers
equal the JAX script's; the probe (``cache_demo.pixel_error_report``)
serves on the card through K1, K2 and K3 unless ``--device cpu``:

    python -m repro_torch.benchmarks.policies_e2e [--only SLICE]
        [--device cpu] [--out DIR]
"""
from __future__ import annotations

import json
import sys

from repro_torch.benchmarks import common
from repro_torch.configs.dit_models import DIT_IMAGE, DIT_VIDEO
from repro_torch.core.cost_model import CostModel
from repro_torch.core.policies import make_policy
from repro_torch.core.scheduler import ControlPlane
from repro_torch.core.simulator import SimBackend
from repro_torch.core.trajectory import ClusterTopology
from repro_torch.diffusion.adapters import convert_request
from repro_torch.diffusion.workloads import foreground_burst_trace, short_trace

RESULTS = common.RESULTS

POLICIES = ["legacy", "fcfs-sp1", "srtf-sp1", "srtf-spmax", "edf",
            "elastic"]
NUM_RANKS = 4
STEPS = 25
# multi-host topology workload (DESIGN.md §10)
MH_TOPO = ClusterTopology(num_hosts=2, ranks_per_host=4)


def _tel():
    from repro_torch.core.telemetry import Telemetry
    return Telemetry()


def _tel_metrics(cp, m: dict) -> dict:
    """Merge the telemetry plane's per-policy efficiency numbers
    (DESIGN.md §15) into one workload-slice metrics dict: mean rank
    utilization over the makespan and goodput per rank-second."""
    s = cp.telemetry.summary()
    m["rank_utilization"] = s["rank_utilization"]
    m["goodput_per_rank"] = s["goodput_per_rank"]
    return m


def _trace(model: str, workload: str):
    cost = CostModel()
    if workload == "short":
        return short_trace(model, cost, duration=120, load=0.85,
                           num_ranks=NUM_RANKS, steps=STEPS, seed=7)
    # heavier burst pressure (paper calibrates per-platform "comparable
    # serving pressure"; its A100 foreground-burst drives Legacy to 37%
    # completion)
    return foreground_burst_trace(model, cost, duration=240, load=1.05,
                                  num_ranks=NUM_RANKS, steps=STEPS,
                                  seed=11)


def _metrics_with_timeout(cp, timeout) -> dict:
    """Paper §6.1: requests exceeding the loose client timeout are failures
    and SLO violations; latency stats cover completed requests only.
    ``timeout`` may be a scalar or a per-model dict (mixed workloads)."""
    lat, done, slo_miss = [], 0, 0
    total = len(cp.requests)
    span = 0.0
    for req in cp.requests.values():
        limit = timeout[req.model] if isinstance(timeout, dict) \
            else timeout
        t = (req.done_time - req.arrival) if req.done_time is not None \
            else None
        if t is None or t > limit:
            slo_miss += 1
            continue
        done += 1
        lat.append(t)
        span = max(span, req.done_time)
        if req.deadline is not None and req.done_time > req.deadline:
            slo_miss += 1
    lat_s = sorted(lat)
    return {
        "completed": done, "failed": total - done,
        "throughput_rps": done / span if span else 0.0,
        "mean_latency_s": sum(lat) / len(lat) if lat else float("nan"),
        "p95_latency_s": (lat_s[int(0.95 * (len(lat_s) - 1))]
                          if lat_s else float("nan")),
        "slo_attainment": 1.0 - slo_miss / total if total else 1.0,
        "makespan_s": span,
    }


def _run_mixed(out: dict):
    """Bursty MIXED image/video workload (elastic showcase): best-effort
    video background + SLO image stream + tight S-image bursts.  The
    elastic policy preempts/reallocates; EDF and friends cannot."""
    from repro_torch.diffusion.workloads import (mixed_burst_trace,
                                           standalone_service_time)
    cfg_of = {"dit-image": DIT_IMAGE, "dit-video": DIT_VIDEO}
    for pol in POLICIES:
        cost = CostModel()
        cp = ControlPlane(NUM_RANKS, make_policy(pol, NUM_RANKS), cost,
                          SimBackend(cost, jitter=0.05), telemetry=_tel())
        trace = mixed_burst_trace(CostModel(), duration=240, load=1.0,
                                  num_ranks=NUM_RANKS, steps=STEPS,
                                  seed=13)
        for r in trace:
            cp.submit(r, convert_request(r, cfg_of[r.model]))
        cp.run()
        base = CostModel()
        timeouts = {
            "dit-image": 12 * standalone_service_time(
                "dit-image", "M", base, STEPS),
            "dit-video": 12 * standalone_service_time(
                "dit-video", "S", base, max(STEPS // 3, 4)),
        }
        out[f"mixed|burst|{pol}"] = _tel_metrics(
            cp, _metrics_with_timeout(cp, timeouts))


def _run_small_burst(out: dict):
    """Many-small-images burst (step packing, DESIGN.md §9): one shared
    pack signature at 2x single-task capacity.  Acceptance: packing (or
    pack-aware elastic) improves throughput >= 1.5x over non-packing
    elastic with no increase in SLO violation rate."""
    from repro_torch.diffusion.workloads import (small_image_burst_trace,
                                           standalone_service_time)
    for pol in ("elastic", "elastic-pack", "packing", "edf"):
        cost = CostModel()
        cp = ControlPlane(NUM_RANKS, make_policy(pol, NUM_RANKS), cost,
                          SimBackend(cost, jitter=0.05), telemetry=_tel())
        trace = small_image_burst_trace(CostModel(), duration=45,
                                        load=2.0, num_ranks=NUM_RANKS,
                                        steps=12, seed=17)
        for r in trace:
            cp.submit(r, convert_request(r, DIT_IMAGE))
        cp.run()
        timeout = 12 * standalone_service_time("dit-image", "S",
                                               CostModel(), 12)
        m = _tel_metrics(cp, _metrics_with_timeout(cp, timeout))
        packs = [e for e in cp.events if e["ev"] == "packed_dispatch"]
        m["packs"] = len(packs)
        m["max_pack_batch"] = max((e["batch"] for e in packs), default=0)
        out[f"small|burst|{pol}"] = m


CACHE_INTERVAL = 4          # staleness window of the cached leg
CACHE_MIN_DEGREE = [2, 4]   # M-class requests do not fit on one rank


def _run_cache(out: dict, device=None):
    """Feature-cache workload (DESIGN.md §11): an M-image SLO stream at
    1.6x uncached degree-4 capacity, candidate degrees {2, 4} for BOTH
    legs (symmetric: SP1 is ruled out by per-rank activation memory, not
    by the policy under test).  The cached plane skips the KV all-gather
    on interval-1 of every interval steps and the cache-affine policy
    keeps requests seated on their snapshots.  Acceptance: cached
    elastic >= 1.2x throughput of non-cached elastic, stale-reuse pixel
    error inside the budget, interval=1 bit-exact."""
    from repro_torch.core.policies import ElasticPolicy
    from repro_torch.diffusion.workloads import (cache_trace,
                                           standalone_service_time)
    for pol, interval, affinity in (("elastic", None, False),
                                    ("elastic-cache", CACHE_INTERVAL,
                                     True)):
        cost = CostModel()
        cp = ControlPlane(
            NUM_RANKS,
            ElasticPolicy(candidate_degrees=list(CACHE_MIN_DEGREE),
                          cache_affinity=affinity),
            cost, SimBackend(cost, jitter=0.05),
            cache_interval=interval, telemetry=_tel())
        trace = cache_trace(CostModel(), duration=240, load=1.6,
                            num_ranks=NUM_RANKS, steps=STEPS, seed=29)
        for r in trace:
            cp.submit(r, convert_request(r, DIT_IMAGE))
        cp.run()
        timeout = 12 * standalone_service_time("dit-image", "M",
                                               CostModel(), STEPS)
        m = _tel_metrics(cp, _metrics_with_timeout(cp, timeout))
        m["cache_hits"] = sum(
            1 for e in cp.events if e["ev"] == "dispatch"
            and str(e.get("cache", "")).startswith("hit"))
        m["cache_refreshes"] = sum(
            1 for e in cp.events if e["ev"] == "dispatch"
            and e.get("cache") == "refresh")
        out[f"cache|burst|{pol}"] = m
    # wall-clock accuracy probe (the simulator has no pixels): the §11
    # error budget and the interval-1 bit-exactness are REAL runtime
    # claims, so they are measured on the thread backend
    from repro_torch.serving.cache_demo import pixel_error_report
    out["cache|error"] = pixel_error_report(DIT_IMAGE.reduced(),
                                            interval=CACHE_INTERVAL,
                                            device=device)


def _run_multi_host(out: dict):
    """2-host x 4-rank simulated cluster (DESIGN.md §10): the
    topology-aware elastic policy places SP groups host-locally, re-pins
    spanning stragglers, and prices candidate degrees at their span; the
    blind variant takes free ranks by bare index and routinely straddles
    the inter-host link.  Acceptance: aware beats blind on throughput
    AND SLO violation rate."""
    from repro_torch.diffusion.workloads import (multi_host_trace,
                                           standalone_service_time)
    for pol in ("elastic", "elastic-blind", "edf"):
        cost = CostModel()
        cp = ControlPlane(MH_TOPO, make_policy(pol, MH_TOPO.num_ranks),
                          cost, SimBackend(cost, jitter=0.05),
                          telemetry=_tel())
        trace = multi_host_trace(CostModel(), duration=240, load=1.0,
                                 num_ranks=MH_TOPO.num_ranks,
                                 steps=STEPS, seed=23)
        for r in trace:
            cp.submit(r, convert_request(r, DIT_IMAGE))
        cp.run()
        timeout = 12 * standalone_service_time("dit-image", "M",
                                               CostModel(), STEPS)
        m = _tel_metrics(cp, _metrics_with_timeout(cp, timeout))
        spans: dict[int, int] = {}
        for e in cp.events:
            if e["ev"] == "dispatch" and e["kind"] == "denoise":
                s = MH_TOPO.span_of(e["ranks"])
                spans[s] = spans.get(s, 0) + 1
        m["denoise_dispatches_by_span"] = {str(k): v
                                           for k, v in sorted(spans.items())}
        out[f"multi|host|{pol}"] = m


def _run_hybrid(out: dict):
    """Hybrid-shape workload (DESIGN.md §14): guided M-image SLO stream
    + best-effort unguided video background on the 2-host x 4-rank
    cluster.  Both legs run the same elastic machinery; only the shape
    search differs.  Acceptance: elastic-hybrid beats scalar elastic on
    throughput AND SLO violation rate, and actually serves cfg2
    shapes."""
    from repro_torch.diffusion.workloads import (hybrid_trace,
                                           standalone_service_time)
    cfg_of = {"dit-image": DIT_IMAGE, "dit-video": DIT_VIDEO}
    for pol in ("elastic", "elastic-hybrid"):
        cost = CostModel()
        cp = ControlPlane(MH_TOPO, make_policy(pol, MH_TOPO.num_ranks),
                          cost, SimBackend(cost, jitter=0.05),
                          telemetry=_tel())
        trace = hybrid_trace(CostModel(), duration=240, load=0.9,
                             num_ranks=MH_TOPO.num_ranks, steps=STEPS,
                             seed=37)
        for r in trace:
            cp.submit(r, convert_request(r, cfg_of[r.model]))
        cp.run()
        base = CostModel()
        timeouts = {
            "dit-image": 12 * standalone_service_time(
                "dit-image", "M", base, STEPS),
            "dit-video": 12 * standalone_service_time(
                "dit-video", "S", base, STEPS),
        }
        m = _tel_metrics(cp, _metrics_with_timeout(cp, timeouts))
        shapes: dict[str, int] = {}
        for e in cp.events:
            if e["ev"] == "dispatch" and e["kind"] == "denoise":
                c = e.get("cfg", 1)
                sp = len(e["ranks"]) // c
                key = f"cfg{c}x sp{sp}" if c > 1 else f"sp{sp}"
                shapes[key] = shapes.get(key, 0) + 1
        m["denoise_dispatches_by_shape"] = dict(sorted(shapes.items()))
        out[f"hybrid|mixed|{pol}"] = m


CHAOS_SNAP_INTERVAL = 5     # denoise snapshot cadence of the recovery leg


def _run_chaos(out: dict):
    """Failure-domain workload (DESIGN.md §13): the SAME seeded
    whole-host kill script replayed against two planes that differ ONLY
    in ``failure_recovery`` — both run the topology-aware elastic policy
    on the 2-host x 4-rank cluster.  The recovery plane fails out the
    touched work, rolls back to periodic denoise snapshots, and re-places
    on the survivors; the blind plane writes every touched request off.
    Acceptance: recovery beats blind on throughput AND SLO violation
    rate while the script actually lands (>= 1 host_down) and the
    recovery machinery actually runs (>= 1 rollback)."""
    from repro_torch.core.failures import FailureInjector
    from repro_torch.diffusion.workloads import (chaos_trace,
                                           standalone_service_time)

    def _trace():
        return chaos_trace(CostModel(), duration=240, load=0.9,
                           num_ranks=MH_TOPO.num_ranks, steps=STEPS,
                           seed=31)
    # kill window: the busy middle of the arrival stream, so losses land
    # on in-flight work rather than an idle or drained cluster
    arrivals = sorted(r.arrival for r in _trace())
    lo = arrivals[int(0.25 * (len(arrivals) - 1))]
    hi = arrivals[int(0.75 * (len(arrivals) - 1))]
    for leg, recovery, snap in (("elastic-recovery", True,
                                 CHAOS_SNAP_INTERVAL),
                                ("elastic-blind", False, None)):
        cost = CostModel()
        inj = FailureInjector.random(MH_TOPO, duration=hi, kills=3,
                                     mttr=45.0, seed=41, t_start=lo,
                                     keep_alive=1)
        cp = ControlPlane(MH_TOPO,
                          make_policy("elastic", MH_TOPO.num_ranks),
                          cost, SimBackend(cost, jitter=0.05),
                          injector=inj, snapshot_interval=snap,
                          failure_recovery=recovery, telemetry=_tel())
        for r in _trace():
            cp.submit(r, convert_request(r, DIT_IMAGE))
        cp.run()
        timeout = 12 * standalone_service_time("dit-image", "M",
                                               CostModel(), STEPS)
        m = _tel_metrics(cp, _metrics_with_timeout(cp, timeout))
        for ev in ("host_down", "host_up", "failout", "rollback",
                   "request_failed"):
            m[ev + "s"] = sum(1 for e in cp.events if e["ev"] == ev)
        out[f"chaos|trace|{leg}"] = m


def run(only: str | None = None, device=None, out_dir=None) -> dict:
    out = {}
    results = common.out_dir(out_dir, RESULTS)
    if only in ("small-burst", "multi-host", "cache", "chaos", "hybrid"):
        if only == "cache":
            _run_cache(out, device)
        else:
            {"small-burst": _run_small_burst,
             "multi-host": _run_multi_host,
             "chaos": _run_chaos,
             "hybrid": _run_hybrid}[only](out)
        existing = {}
        path = results / "policies_e2e.json"
        if path.exists():
            existing = json.loads(path.read_text())
        existing.update(out)
        path.write_text(json.dumps(existing, indent=1))
        return out
    _run_small_burst(out)
    _run_multi_host(out)
    _run_cache(out, device)
    _run_chaos(out)
    _run_hybrid(out)
    _run_mixed(out)
    for model_cfg in (DIT_IMAGE, DIT_VIDEO):
        model = model_cfg.name
        for workload in ("short", "burst"):
            for pol in POLICIES:
                cost = CostModel()
                cp = ControlPlane(NUM_RANKS, make_policy(pol, NUM_RANKS),
                                  cost, SimBackend(cost, jitter=0.05),
                                  telemetry=_tel())
                trace = _trace(model, workload)
                for r in trace:
                    cp.submit(r, convert_request(r, model_cfg))
                cp.run()
                # loose client timeout ~ paper ratio (25-50x S-class
                # standalone service time)
                from repro_torch.diffusion.workloads import \
                    standalone_service_time
                timeout = 12 * standalone_service_time(
                    model, "M", CostModel(), STEPS)
                out[f"{model}|{workload}|{pol}"] = _tel_metrics(
                    cp, _metrics_with_timeout(cp, timeout))
    (results / "policies_e2e.json").write_text(json.dumps(out, indent=1))
    return out


def rows(data: dict):
    out = []
    # headline improvement numbers vs Legacy (paper: 6.01x thr, -95% mean
    # latency, -90% SLO violations)
    best = {"thr": 0.0, "lat": 0.0, "slo": 0.0}
    for model in ("dit-image", "dit-video"):
        for workload in ("short", "burst"):
            leg = data[f"{model}|{workload}|legacy"]
            for pol in POLICIES:
                m = data[f"{model}|{workload}|{pol}"]
                out.append((f"policies.{model}.{workload}.{pol}.mean_lat",
                            m["mean_latency_s"] * 1e6,
                            f"slo={m['slo_attainment']:.3f}"
                            f";thr={m['throughput_rps']:.4f}"
                            f";p95={m['p95_latency_s']:.1f}"))
                if pol != "legacy" and leg["throughput_rps"] > 0:
                    best["thr"] = max(best["thr"], m["throughput_rps"]
                                      / leg["throughput_rps"])
                    if leg["mean_latency_s"] > 0:
                        best["lat"] = max(
                            best["lat"], 1 - m["mean_latency_s"]
                            / leg["mean_latency_s"])
                    leg_viol = 1 - leg["slo_attainment"]
                    if leg_viol > 0:
                        best["slo"] = max(
                            best["slo"],
                            1 - (1 - m["slo_attainment"]) / leg_viol)
    # mixed image/video burst: elastic vs edf (acceptance: lower mean
    # latency AND lower SLO-violation rate)
    for pol in POLICIES:
        m = data[f"mixed|burst|{pol}"]
        out.append((f"policies.mixed.burst.{pol}.mean_lat",
                    m["mean_latency_s"] * 1e6,
                    f"slo={m['slo_attainment']:.3f}"
                    f";thr={m['throughput_rps']:.4f}"
                    f";p95={m['p95_latency_s']:.1f}"))
    edf, ela = data["mixed|burst|edf"], data["mixed|burst|elastic"]
    out.append(("policies.mixed.elastic_vs_edf.mean_lat_reduction",
                (1 - ela["mean_latency_s"] / edf["mean_latency_s"]) * 1e6
                if edf["mean_latency_s"] else 0.0,
                f"elastic={ela['mean_latency_s']:.2f}s"
                f";edf={edf['mean_latency_s']:.2f}s"))
    out.append(("policies.mixed.elastic_vs_edf.slo_viol_reduction",
                (1 - (1 - ela["slo_attainment"])
                 / max(1 - edf["slo_attainment"], 1e-9)) * 1e6,
                f"elastic_viol={1 - ela['slo_attainment']:.3f}"
                f";edf_viol={1 - edf['slo_attainment']:.3f}"))
    out.append(("policies.best_throughput_gain_x", best["thr"] * 1e6,
                "paper_6.01x"))
    out.append(("policies.best_mean_latency_reduction", best["lat"] * 1e6,
                "paper_95pct"))
    out.append(("policies.best_slo_violation_reduction", best["slo"] * 1e6,
                "paper_90pct"))
    out.extend(small_burst_rows(data))
    out.extend(multi_host_rows(data))
    out.extend(cache_rows(data))
    out.extend(chaos_rows(data))
    out.extend(hybrid_rows(data))
    return out


def hybrid_rows(data: dict):
    """Hybrid-shape headline numbers (accepts partial --only runs)."""
    out = []
    if "hybrid|mixed|elastic" not in data:
        return out
    for pol in ("elastic", "elastic-hybrid"):
        m = data.get(f"hybrid|mixed|{pol}")
        if m is None:
            continue
        shapes = m.get("denoise_dispatches_by_shape", {})
        split = sum(v for k, v in shapes.items() if k.startswith("cfg"))
        out.append((f"policies.hybrid.mixed.{pol}.mean_lat",
                    m["mean_latency_s"] * 1e6,
                    f"slo={m['slo_attainment']:.3f}"
                    f";thr={m['throughput_rps']:.4f}"
                    f";split_dispatches={split}"))
    hyb = data["hybrid|mixed|elastic-hybrid"]
    sca = data.get("hybrid|mixed|elastic")
    if sca and sca["throughput_rps"]:
        out.append(("policies.hybrid.hybrid_vs_scalar.throughput_x",
                    hyb["throughput_rps"] / sca["throughput_rps"] * 1e6,
                    f"hybrid={hyb['throughput_rps']:.4f}"
                    f";scalar={sca['throughput_rps']:.4f};accept>1x"))
        out.append(("policies.hybrid.hybrid_vs_scalar.slo_viol_delta",
                    ((1 - hyb["slo_attainment"])
                     - (1 - sca["slo_attainment"])) * 1e6,
                    f"hybrid_viol={1 - hyb['slo_attainment']:.3f}"
                    f";scalar_viol={1 - sca['slo_attainment']:.3f}"
                    f";accept<0"))
    return out


def check_hybrid(data: dict) -> list[str]:
    """Hybrid-shape acceptance gate (CI fails on regression): on the
    guided mixed workload the shape-searching elastic-hybrid policy must
    beat scalar elastic on throughput AND SLO violation rate, and must
    actually dispatch cfg2 shapes (a hybrid policy that never splits is
    measuring nothing)."""
    problems = []
    hyb = data["hybrid|mixed|elastic-hybrid"]
    sca = data["hybrid|mixed|elastic"]
    if hyb["throughput_rps"] <= sca["throughput_rps"]:
        problems.append(
            f"hybrid throughput {hyb['throughput_rps']:.4f} <= scalar "
            f"{sca['throughput_rps']:.4f} (accept: strictly higher)")
    if (1 - hyb["slo_attainment"]) >= (1 - sca["slo_attainment"]):
        problems.append(
            f"hybrid SLO violations {1 - hyb['slo_attainment']:.3f} >= "
            f"scalar {1 - sca['slo_attainment']:.3f} "
            f"(accept: strictly lower)")
    shapes = hyb.get("denoise_dispatches_by_shape", {})
    if not any(k.startswith("cfg") for k in shapes):
        problems.append("hybrid leg dispatched no cfg2 shape — the "
                        "shape search never engaged")
    if any(k.startswith("cfg")
           for k in sca.get("denoise_dispatches_by_shape", {})):
        problems.append("scalar leg dispatched a cfg shape — the "
                        "baseline is not scalar")
    return problems


def chaos_rows(data: dict):
    """Failure-domain headline numbers (accepts partial --only runs)."""
    out = []
    if "chaos|trace|elastic-recovery" not in data:
        return out
    for leg in ("elastic-recovery", "elastic-blind"):
        m = data.get(f"chaos|trace|{leg}")
        if m is None:
            continue
        out.append((f"policies.chaos.trace.{leg}.mean_lat",
                    m["mean_latency_s"] * 1e6,
                    f"slo={m['slo_attainment']:.3f}"
                    f";thr={m['throughput_rps']:.4f}"
                    f";host_downs={m.get('host_downs', 0)}"
                    f";rollbacks={m.get('rollbacks', 0)}"
                    f";failed={m.get('request_faileds', 0)}"))
    rec = data["chaos|trace|elastic-recovery"]
    bli = data.get("chaos|trace|elastic-blind")
    if bli and bli["throughput_rps"]:
        out.append(("policies.chaos.recovery_vs_blind.throughput_x",
                    rec["throughput_rps"] / bli["throughput_rps"] * 1e6,
                    f"recovery={rec['throughput_rps']:.4f}"
                    f";blind={bli['throughput_rps']:.4f};accept>1x"))
        out.append(("policies.chaos.recovery_vs_blind.slo_viol_delta",
                    ((1 - rec["slo_attainment"])
                     - (1 - bli["slo_attainment"])) * 1e6,
                    f"recovery_viol={1 - rec['slo_attainment']:.3f}"
                    f";blind_viol={1 - bli['slo_attainment']:.3f}"
                    f";accept<0"))
    return out


def check_chaos(data: dict) -> list[str]:
    """Failure-domain acceptance gate (CI fails on regression): under the
    identical seeded kill script, the recovering plane must beat the
    blind baseline on throughput AND SLO violation rate, the script must
    actually land hosts (>= 1 host_down on both legs), and the recovery
    machinery must actually engage (>= 1 rollback or failout)."""
    problems = []
    rec = data["chaos|trace|elastic-recovery"]
    bli = data["chaos|trace|elastic-blind"]
    if rec["throughput_rps"] <= bli["throughput_rps"]:
        problems.append(
            f"recovery throughput {rec['throughput_rps']:.4f} <= blind "
            f"{bli['throughput_rps']:.4f} (accept: strictly higher)")
    if (1 - rec["slo_attainment"]) >= (1 - bli["slo_attainment"]):
        problems.append(
            f"recovery SLO violations {1 - rec['slo_attainment']:.3f} >= "
            f"blind {1 - bli['slo_attainment']:.3f} "
            f"(accept: strictly lower)")
    for leg in ("elastic-recovery", "elastic-blind"):
        if data[f"chaos|trace|{leg}"].get("host_downs", 0) < 1:
            problems.append(f"{leg}: kill script landed no host_down — "
                            f"the chaos gate measured nothing")
    if rec.get("rollbacks", 0) + rec.get("failouts", 0) < 1:
        problems.append("recovery leg saw no rollback/failout — the "
                        "recovery machinery never engaged")
    return problems


def cache_rows(data: dict):
    """Feature-cache headline numbers (accepts partial --only runs)."""
    out = []
    if "cache|burst|elastic" not in data:
        return out
    for pol in ("elastic", "elastic-cache"):
        m = data.get(f"cache|burst|{pol}")
        if m is None:
            continue
        out.append((f"policies.cache.burst.{pol}.mean_lat",
                    m["mean_latency_s"] * 1e6,
                    f"slo={m['slo_attainment']:.3f}"
                    f";thr={m['throughput_rps']:.4f}"
                    f";hits={m.get('cache_hits', 0)}"
                    f";refreshes={m.get('cache_refreshes', 0)}"))
    ela = data["cache|burst|elastic"]
    cac = data.get("cache|burst|elastic-cache")
    if cac and ela["throughput_rps"]:
        out.append(("policies.cache.cached_vs_elastic.throughput_x",
                    cac["throughput_rps"] / ela["throughput_rps"] * 1e6,
                    f"cached={cac['throughput_rps']:.4f}"
                    f";elastic={ela['throughput_rps']:.4f}"
                    f";accept>=1.2x"))
    err = data.get("cache|error")
    if err:
        out.append(("policies.cache.rel_l2_err", err["rel_l2_err"] * 1e6,
                    f"budget<=5e-2"
                    f";interval1_exact={err['interval1_exact']}"
                    f";hits={err['hits']};refreshes={err['refreshes']}"))
    return out


def check_cache(data: dict) -> list[str]:
    """Feature-cache acceptance gate (CI fails on regression): cached
    elastic must hold >= 1.2x throughput over non-cached elastic at a
    bounded pixel-error budget, and cache_interval=1 must stay bit-exact
    with the non-cached runtime (DESIGN.md §11)."""
    problems = []
    ela = data["cache|burst|elastic"]
    cac = data["cache|burst|elastic-cache"]
    ratio = cac["throughput_rps"] / max(ela["throughput_rps"], 1e-9)
    if ratio < 1.2:
        problems.append(f"cached elastic throughput {ratio:.2f}x "
                        f"non-cached (accept >= 1.2x)")
    err = data["cache|error"]
    if err["rel_l2_err"] > 5e-2:
        problems.append(f"stale-reuse pixel error {err['rel_l2_err']:.4f}"
                        f" > 5e-2 budget")
    if not err["interval1_exact"]:
        problems.append("cache_interval=1 output is NOT bit-exact with "
                        "the non-cached runtime")
    return problems


def multi_host_rows(data: dict):
    """Topology-workload headline numbers (accepts partial --only runs)."""
    out = []
    if "multi|host|elastic" not in data:
        return out
    for pol in ("elastic", "elastic-blind", "edf"):
        m = data.get(f"multi|host|{pol}")
        if m is None:
            continue
        spans = m.get("denoise_dispatches_by_span", {})
        out.append((f"policies.multi.host.{pol}.mean_lat",
                    m["mean_latency_s"] * 1e6,
                    f"slo={m['slo_attainment']:.3f}"
                    f";thr={m['throughput_rps']:.4f}"
                    f";span2={spans.get('2', 0)}"))
    aware = data["multi|host|elastic"]
    blind = data.get("multi|host|elastic-blind")
    if blind and blind["throughput_rps"]:
        out.append(("policies.multi.aware_vs_blind.throughput_x",
                    aware["throughput_rps"] / blind["throughput_rps"] * 1e6,
                    f"aware={aware['throughput_rps']:.4f}"
                    f";blind={blind['throughput_rps']:.4f};accept>1x"))
        out.append(("policies.multi.aware_vs_blind.slo_viol_delta",
                    ((1 - aware["slo_attainment"])
                     - (1 - blind["slo_attainment"])) * 1e6,
                    f"aware_viol={1 - aware['slo_attainment']:.3f}"
                    f";blind_viol={1 - blind['slo_attainment']:.3f}"
                    f";accept<0"))
    return out


def check_multi_host(data: dict) -> list[str]:
    """Topology acceptance gate (CI fails on regression): on the 2-host
    x 4-rank cluster the topology-aware elastic policy must improve
    throughput AND lower the SLO violation rate vs the blind variant."""
    problems = []
    aware = data["multi|host|elastic"]
    blind = data["multi|host|elastic-blind"]
    if aware["throughput_rps"] <= blind["throughput_rps"]:
        problems.append(
            f"aware throughput {aware['throughput_rps']:.4f} <= blind "
            f"{blind['throughput_rps']:.4f} (accept: strictly higher)")
    if (1 - aware["slo_attainment"]) >= (1 - blind["slo_attainment"]):
        problems.append(
            f"aware SLO violations {1 - aware['slo_attainment']:.3f} >= "
            f"blind {1 - blind['slo_attainment']:.3f} "
            f"(accept: strictly lower)")
    return problems


def small_burst_rows(data: dict):
    """Step-packing headline numbers (accepts partial --only runs)."""
    out = []
    if "small|burst|elastic" not in data:
        return out
    for pol in ("elastic", "elastic-pack", "packing", "edf"):
        m = data.get(f"small|burst|{pol}")
        if m is None:
            continue
        out.append((f"policies.small.burst.{pol}.mean_lat",
                    m["mean_latency_s"] * 1e6,
                    f"slo={m['slo_attainment']:.3f}"
                    f";thr={m['throughput_rps']:.4f}"
                    f";packs={m.get('packs', 0)}"
                    f";maxb={m.get('max_pack_batch', 0)}"))
    ela = data["small|burst|elastic"]
    for pol in ("packing", "elastic-pack"):
        m = data.get(f"small|burst|{pol}")
        if m is None or not ela["throughput_rps"]:
            continue
        out.append((f"policies.small.{pol}_vs_elastic.throughput_x",
                    m["throughput_rps"] / ela["throughput_rps"] * 1e6,
                    f"{pol}={m['throughput_rps']:.3f}"
                    f";elastic={ela['throughput_rps']:.3f}"
                    f";accept>=1.5x"))
        out.append((f"policies.small.{pol}_vs_elastic.slo_viol_delta",
                    ((1 - m["slo_attainment"])
                     - (1 - ela["slo_attainment"])) * 1e6,
                    f"{pol}_viol={1 - m['slo_attainment']:.3f}"
                    f";elastic_viol={1 - ela['slo_attainment']:.3f}"
                    f";accept<=0"))
    return out


def check_small_burst(data: dict) -> list[str]:
    """Step-packing acceptance gate (CI fails on regression): packing and
    pack-aware elastic must hold >= 1.5x throughput over non-packing
    elastic with no increase in SLO violation rate."""
    problems = []
    ela = data["small|burst|elastic"]
    for pol in ("packing", "elastic-pack"):
        m = data[f"small|burst|{pol}"]
        ratio = m["throughput_rps"] / max(ela["throughput_rps"], 1e-9)
        if ratio < 1.5:
            problems.append(f"{pol} throughput {ratio:.2f}x elastic "
                            f"(accept >= 1.5x)")
        if (1 - m["slo_attainment"]) > (1 - ela["slo_attainment"]) + 1e-9:
            problems.append(
                f"{pol} SLO violations {1 - m['slo_attainment']:.3f} > "
                f"elastic {1 - ela['slo_attainment']:.3f}")
    return problems


SLICES = ["small-burst", "multi-host", "cache", "chaos", "hybrid"]


def main(argv=None) -> int:
    ap = common.parser(sys.modules[__name__])
    ap.add_argument("--only", choices=SLICES, default=None,
                    help="run just one workload slice (CI legs)")
    args = ap.parse_args(argv)
    d = run(only=args.only, device=args.device, out_dir=args.out)
    table, check = {
        None: (rows, None),
        "small-burst": (small_burst_rows, check_small_burst),
        "multi-host": (multi_host_rows, check_multi_host),
        "cache": (cache_rows, check_cache),
        "chaos": (chaos_rows, check_chaos),
        "hybrid": (hybrid_rows, check_hybrid)}[args.only]
    common.print_rows(table(d))
    problems = check(d) if check else []
    for p in problems:
        print(f"ACCEPTANCE FAILURE: {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
