"""Fig. 11 analogue: simulator vs REAL thread-runtime SLO attainment.

The same trace + the same policy objects run (a) under the cost-model
simulator and (b) on the thread backend with real JAX compute; the
simulator's cost model is first calibrated from profiled task costs on
this container (exactly the paper's methodology: "the simulator replays
the exact request trace and policy logic using measured stage costs").
Paper: <= 4.7 pp divergence.

Additionally runs the ElasticPolicy preempt/reallocate scenario
(repro_torch.serving.elastic_demo), the step-packing scenario
(repro_torch.serving.packing_demo, DESIGN.md §9), the multi-host topology
scenario (repro_torch.serving.topology_demo, DESIGN.md §10 — hierarchical
GFC + cross-host reallocation), AND the feature-cache scenario
(repro_torch.serving.cache_demo, DESIGN.md §11 — stale-KV reuse with a
mid-trace same-degree Reallocate migrating the warm cache), AND the
hybrid-shape scenario (repro_torch.serving.hybrid_demo, DESIGN.md §14 — a
guided request through batched sp4, a same-rank reshape, and cfg2 x sp2
split branches with a per-step merge exchange), AND the failure-domain
scenario (repro_torch.serving.failure_demo, DESIGN.md §13 — a scripted
whole-host loss with failout, snapshot rollback, and degraded
re-placement) on both backends and checks the canonical control-plane
decision traces — which canonicalize PackedDispatch membership, the
plane's cache hit/refresh/migrate calls, the cfg shape dimension, and
the recovery event sequence — are IDENTICAL.

Twin of ``benchmarks/sim_fidelity.py`` on the port.  On the card (the
default) the real-runtime leg serves ``DIT_IMAGE`` at full width and
depth (28 layers, d_model 1536, 24 x 64 heads) through K1-K3: classes S
and M are 512 px (1024 tokens) and 1024 px (4096 tokens); its stage
costs are measured on the card, each the mean of warm calls between
``torch.cuda.synchronize`` calls; the six demos serve at full width too.
``--device cpu`` runs ``DIT_IMAGE.reduced()`` at the JAX script's 128 and
256 px.  The cost table calibrated by the real runs is written with
``CostModel.save`` as ``cost_table_h100.json`` (``cost_table_cpu.json``
on the CPU) beside ``sim_fidelity.json`` in the output directory.
``run(demos=False)`` leaves out the six demo legs (``chip_smoke.py``
runs them in its scenarios phase).

    python -m repro_torch.benchmarks.sim_fidelity [--device cpu]
        [--out DIR] [--no-demos]
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time

import torch

from repro_torch.benchmarks import common
from repro_torch.configs.dit_models import DIT_IMAGE
from repro_torch.core.cost_model import CostModel
from repro_torch.core.policies import make_policy
from repro_torch.core.scheduler import ControlPlane
from repro_torch.core.simulator import SimBackend
from repro_torch.diffusion.adapters import convert_request
from repro_torch.diffusion.pipeline import TorchDiTPipeline
from repro_torch.diffusion.workloads import make_request
from repro_torch.serving.engine import ServingEngine

RESULTS = common.RESULTS
# the real-runtime leg runs ONE worker: rank threads share one device and
# its default stream (one host's cores on the CPU), so concurrent workers
# would serialize, dilating wall-clock versus the simulator's parallel-rank
# model (multi-rank semantics are validated by the scenario tests).
# Ordering policies still differ.
NUM_RANKS = 1
POLICIES = ["fcfs-sp1", "srtf-sp1", "edf"]
#: class -> resolution (px) of the real-runtime leg: DIT_IMAGE's S and M
#: at full width, the JAX script's sizes for DIT_IMAGE.reduced()
CLASS_RES = {"full": {"S": 512, "M": 1024}, "reduced": {"S": 128, "M": 256}}
STAGES = ("encode", "denoise", "decode")
#: where the calibrated cost table goes in the output directory
COST_TABLE = {"cuda": "cost_table_h100.json", "cpu": "cost_table_cpu.json"}
#: keys of run()'s result that are not a leg
META = ("device", "card", "stage_costs", "cost_table")


def _timeit(fn, device, reps: int = 3) -> float:
    """Mean seconds of ``reps`` warm calls of ``fn`` (one call first),
    the device synchronized around them."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


@torch.inference_mode()
def _profile_costs(cfg, device, res_of: dict) -> tuple[CostModel, dict]:
    """Measure REAL stage costs on ``device`` (the paper's methodology:
    "using measured stage costs") -> (calibrated cost model, seconds by
    class and stage)."""
    from repro_torch.models import dit as dit_mod, text_encoder, vae
    cost = CostModel()
    pipe = TorchDiTPipeline(cfg, seed=0, device=device)
    measured = {}
    for cls, res in res_of.items():
        n_tok = (res // 8 // cfg.dit.patch_size) ** 2
        pd = cfg.dit.patch_size ** 2 * cfg.dit.in_channels
        x = torch.zeros((1, n_tok, pd), device=device)
        txt = torch.zeros((1, 77, cfg.dit.cond_dim), device=device)
        t = torch.tensor([500.0], device=device)
        dt = _timeit(lambda: dit_mod.forward_sp_tokens(
            pipe.dit, x, t, txt, cfg, pos_offset=0, n_total=n_tok,
            kv_gather=lambda k, v, layer: (k, v)), device)
        toks = torch.zeros((1, 77), dtype=torch.int64, device=device)
        enc = _timeit(lambda: text_encoder.encode(
            pipe.text_encoder, toks, pipe.txt_cfg, dtype=torch.float32),
            device)
        hl = res // 8
        lat = torch.zeros((1, 1, hl, hl, cfg.dit.in_channels),
                          device=device)
        dec = _timeit(lambda: vae.decode(pipe.vae, lat, cfg), device,
                      reps=2)
        for deg in (1, 2, 4):
            # SP shards tokens but the ranks share one device; measured
            # SP1 cost is the right per-task estimate here
            cost.table[cost._key("dit-image", "denoise", n_tok, deg)] = dt
            cost.table[cost._key("dit-image", "decode", n_tok, deg)] = dec
        cost.table[cost._key("dit-image", "encode", n_tok, 1)] = enc
        measured[cls] = {"tokens": n_tok, "encode": enc, "denoise": dt,
                         "decode": dec}
    return cost, measured


def _mini_trace(cost: CostModel, res_of: dict, n: int = 12):
    reqs, t = [], 0.0
    for i in range(n):
        cls = "S" if i % 3 else "M"
        res = res_of[cls]
        n_tok = (res // 16) ** 2
        service = (cost.estimate("dit-image", "encode", n_tok, 1)
                   + 4 * cost.estimate("dit-image", "denoise", n_tok, 1)
                   + cost.estimate("dit-image", "decode", n_tok, 1))
        r = make_request("dit-image", cls, arrival=t, cost=cost, steps=4)
        r.height = r.width = res
        # moderate single-queue load; class-dependent tightness so some
        # requests are at risk and policy ordering matters
        r.deadline = t + (2.5 if cls == "S" else 4.0) * service + 0.3
        reqs.append(r)
        t += service * 0.75
    return reqs


def _elastic_fidelity(cfg, device) -> dict:
    """Strongest fidelity check: the ElasticPolicy scenario (preempt +
    mid-trajectory reallocation) must produce IDENTICAL control-plane
    decision traces on the simulator and the thread runtime."""
    from repro_torch.serving.elastic_demo import run_demo
    d = run_demo(cfg, device=device)
    return {
        "trace_match": d["trace_match"],
        "margins": d["margins"],
        "real_slo": d["wall"]["metrics"]["slo_attainment"],
        "sim_slo": d["sim"]["metrics"]["slo_attainment"],
        "real_completed": d["wall"]["metrics"]["completed"],
        "sim_completed": d["sim"]["metrics"]["completed"],
        "n_events": {"real": len(d["wall"]["events"]),
                     "sim": len(d["sim"]["events"])},
    }


def _packing_fidelity(cfg, device) -> dict:
    """Step-packing fidelity (DESIGN.md §9): the PackingPolicy scenario
    must form the SAME packs (membership included) on the simulator and
    the thread runtime."""
    from repro_torch.serving.packing_demo import run_demo
    d = run_demo(cfg, device=device)
    return {
        "trace_match": d["trace_match"],
        "real_packs": [e["batch"] for e in d["packs"]["wall"]],
        "sim_packs": [e["batch"] for e in d["packs"]["sim"]],
        "real_completed": d["wall"]["metrics"]["completed"],
        "sim_completed": d["sim"]["metrics"]["completed"],
    }


def _topology_fidelity(cfg, device) -> dict:
    """Topology fidelity (DESIGN.md §10): the 2-host scenario must trace
    identically on the simulator and the thread runtime, and
    hierarchical collectives must not change the output pixels."""
    from repro_torch.serving.topology_demo import run_demo
    d = run_demo(cfg, device=device)
    return {
        "trace_match": d["trace_match"],
        "pixels_match": d["pixels_match"],
        "hierarchical_collectives": d["wall"]["hierarchical_collectives"],
        "sim_migrated_bytes": d["sim"]["migrated_bytes"],
        "real_completed": d["wall"]["metrics"]["completed"],
        "sim_completed": d["sim"]["metrics"]["completed"],
    }


def _cache_fidelity(cfg, device) -> dict:
    """Feature-cache fidelity (DESIGN.md §11): the cache scenario must
    trace identically — hit/refresh/migrate decisions included — on the
    simulator and the thread runtime, with interval-1 bit-exactness and
    the stale-reuse error inside the budget."""
    from repro_torch.serving.cache_demo import run_demo
    d = run_demo(cfg, device=device)
    return {
        "trace_match": d["trace_match"],
        "modes": d["modes"],
        "interval1_exact": d["interval1_exact"],
        "rel_l2_err": d["rel_l2_err"],
        "migration_bitexact": d["migration_bitexact"],
        "sim_migrated_bytes": d["sim_migrated_bytes"],
        "real_completed": d["wall"]["metrics"]["completed"],
        "sim_completed": d["sim"]["metrics"]["completed"],
    }


def _hybrid_fidelity(cfg, device) -> dict:
    """Hybrid-shape fidelity (DESIGN.md §14): the scripted batched-sp4
    -> reshape -> cfg2 x sp2 chain must trace identically — cfg
    dimension included — on the simulator and the thread runtime, the
    split pixels must be bit-identical to the shard-size-matched
    batched-CFG control, and shape-search-off must be byte-identical to
    scalar elastic."""
    from repro_torch.serving.hybrid_demo import run_demo
    d = run_demo(cfg, device=device)
    return {
        "trace_match": d["trace_match"],
        "pixels_match": d["pixels_match"],
        "scalar_identical": d["scalar_identical"],
        "timeline": d["wall"]["timeline"],
        "sim_migrated_bytes": d["sim"]["migrated_bytes"],
        "real_completed": d["wall"]["metrics"]["completed"],
        "sim_completed": d["sim"]["metrics"]["completed"],
    }


def _failure_fidelity(cfg, device) -> dict:
    """Failure-domain fidelity (DESIGN.md §13): the scripted whole-host
    loss scenario — failout, snapshot rollback, re-place on survivors —
    must trace identically on the simulator and the thread runtime, and
    the recovered pixels must match an undisturbed control run."""
    from repro_torch.serving.failure_demo import run_demo
    d = run_demo(cfg, device=device)
    return {
        "trace_match": d["trace_match"],
        "recovery": d["recovery"],
        "resumed_step": d["resumed_step"],
        "snapshot_step": d["snapshot_step"],
        "pixels_match": d["pixels_match"],
        "real_completed": d["completed"],
        "sim_completed": d["sim"]["metrics"]["completed"],
    }


def run(device=None, out_dir=None, demos: bool = True) -> dict:
    device = common.device_of(device)
    cfg = common.serving_config(device)
    res_of = CLASS_RES["full" if cfg == DIT_IMAGE else "reduced"]
    out = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "card": common.card() if device.type == "cuda" else None}
    if demos:
        out.update({
            "elastic_trace": _elastic_fidelity(cfg, device),
            "packing_trace": _packing_fidelity(cfg, device),
            "topology_trace": _topology_fidelity(cfg, device),
            "cache_trace": _cache_fidelity(cfg, device),
            "hybrid_trace": _hybrid_fidelity(cfg, device),
            "failure_trace": _failure_fidelity(cfg, device)})
    base = CostModel()
    for pol_name in POLICIES:
        cost, measured = _profile_costs(cfg, device, res_of)
        if "stage_costs" not in out:
            # the first profile, beside the analytical model's price
            out["stage_costs"] = {cls: {
                "tokens": m["tokens"],
                **{k: {"measured_s": m[k], "analytic_s": base.analytical(
                    "dit-image", k, m["tokens"], 1)} for k in STAGES}}
                for cls, m in measured.items()}
        trace0 = _mini_trace(cost, res_of)
        # --- real thread runtime (calibrates `cost` online from measured
        # task durations, §5.1)
        eng = ServingEngine(cfg, make_policy(pol_name, NUM_RANKS),
                            NUM_RANKS, cost=cost, device=device)
        real = eng.serve([dataclasses.replace(r) for r in trace0],
                         timeout=180)
        eng.shutdown()
        # --- simulator replays the EXACT trace + policy logic using the
        # stage costs measured during the real run (paper Fig. 11 method)
        calibrated = eng.cp.cost
        cp = ControlPlane(NUM_RANKS, make_policy(pol_name, NUM_RANKS),
                          calibrated, SimBackend(calibrated))
        for r in trace0:
            cp.submit(dataclasses.replace(r, task_ids=[]),
                      convert_request(r, cfg))
        cp.run()
        sim = cp.metrics()
        out[pol_name] = {
            "real_slo": real["slo_attainment"],
            "sim_slo": sim["slo_attainment"],
            "gap_pp": abs(real["slo_attainment"]
                          - sim["slo_attainment"]) * 100,
            "real_mean_lat": real["mean_latency_s"],
            "sim_mean_lat": sim["mean_latency_s"],
            "requests": len(trace0),
            "real_completed": real["completed"],
            "sim_completed": sim["completed"],
            # the stage costs the simulator replayed with
            "calibrated_s": {
                f"{cls}.{k}": calibrated.estimate(
                    "dit-image", k, (res // 16) ** 2, 1)
                for cls, res in res_of.items() for k in STAGES},
        }
    results = common.out_dir(out_dir, RESULTS)
    table = results / COST_TABLE[device.type]
    calibrated.save(table)
    out["cost_table"] = str(table)
    (results / "sim_fidelity.json").write_text(json.dumps(out, indent=1))
    return out


def rows(data: dict):
    out = []
    for pol, m in data.items():
        if pol in META:
            continue
        if pol == "elastic_trace":
            out.append(("sim_fidelity.elastic.trace_match",
                        1e6 if m["trace_match"] else 0.0,
                        f"identical_decision_traces={m['trace_match']}"
                        f";real_done={m['real_completed']}"
                        f";sim_done={m['sim_completed']}"))
            continue
        if pol == "packing_trace":
            out.append(("sim_fidelity.packing.trace_match",
                        1e6 if m["trace_match"] else 0.0,
                        f"identical_packs={m['trace_match']}"
                        f";real_packs={m['real_packs']}"
                        f";sim_packs={m['sim_packs']}"))
            continue
        if pol == "topology_trace":
            out.append(("sim_fidelity.topology.trace_match",
                        1e6 if (m["trace_match"]
                                and m["pixels_match"]) else 0.0,
                        f"identical_traces={m['trace_match']}"
                        f";pixels_bitexact={m['pixels_match']}"
                        f";hier={m['hierarchical_collectives']}"))
            continue
        if pol == "hybrid_trace":
            ok = m["trace_match"] and m["pixels_match"] \
                and m["scalar_identical"]
            out.append(("sim_fidelity.hybrid.trace_match",
                        1e6 if ok else 0.0,
                        f"identical_traces={m['trace_match']}"
                        f";split_pixels_bitexact={m['pixels_match']}"
                        f";search_off_scalar={m['scalar_identical']}"))
            continue
        if pol == "failure_trace":
            ok = m["trace_match"] and m["pixels_match"]
            out.append(("sim_fidelity.failure.trace_match",
                        1e6 if ok else 0.0,
                        f"identical_traces={m['trace_match']}"
                        f";pixels_bitexact={m['pixels_match']}"
                        f";resumed_step={m['resumed_step']}"
                        f";snapshot={m['snapshot_step']}"))
            continue
        if pol == "cache_trace":
            ok = m["trace_match"] and m["interval1_exact"] \
                and m["migration_bitexact"]
            out.append(("sim_fidelity.cache.trace_match",
                        1e6 if ok else 0.0,
                        f"identical_traces={m['trace_match']}"
                        f";interval1_bitexact={m['interval1_exact']}"
                        f";mig_bitexact={m['migration_bitexact']}"
                        f";rel_l2={m['rel_l2_err']:.2e}"))
            continue
        out.append((f"sim_fidelity.{pol}.gap", m["gap_pp"] * 1e4,
                    f"real={m['real_slo']:.3f};sim={m['sim_slo']:.3f};"
                    f"paper<=4.7pp"))
    return out


def main(argv=None) -> int:
    ap = common.parser(sys.modules[__name__])
    ap.add_argument("--no-demos", action="store_true",
                    help="leave out the six cross-backend demo legs")
    args = ap.parse_args(argv)
    common.print_rows(rows(run(args.device, args.out,
                               demos=not args.no_demos)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
