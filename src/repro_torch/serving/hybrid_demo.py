"""Cross-backend hybrid-parallelism demonstration (DESIGN.md §14).

A deterministic single-request scenario on a 2-host x 2-rank cluster
that drives every shape-aware layer on BOTH execution backends.  One
GUIDED request (classifier-free guidance: cond + uncond branches,
merged ``v = v_u + g*(v_c - v_u)`` every step) runs a scripted shape
chain:

* the first denoise steps run **batched-CFG at sp4** — one spanning
  group, both branches stacked on the batch axis through a B=2 KV
  gather (the thread backend's hierarchical two-stage gather, since the
  group straddles hosts);
* one mid-trajectory **Reallocate-RESHAPE** keeps the SAME four ranks
  but re-shapes them to **cfg2 x sp2**: the latent artifact re-slices
  through the ordinary §5 migration planner (every rank's shard doubles
  — same ranks, different field views), branch (0,1) serves cond on
  host 0, branch (2,3) serves uncond on host 1, and each step ends in
  ONE merge exchange across the host boundary;
* encode/decode run single-rank.

The control leg runs the same request with the SAME per-step shard
sizes but single-group batched-CFG throughout (sp4, then a Reallocate
onto batched sp2): shard-size-matched B=2 batched rows are bit-exact
against B=1 branch rows (the §9 batching property), the merge arithmetic
is the same fp32 expression, and the §5 planner moves bit-equal bytes —
so the split run's pixels must equal the control's.  On the card cuBLAS
picks its GEMM kernel by M and batch, so the port holds them to the
pixel budget (``pixels_match``: rel-L2 ``pixels_rel_l2`` <= 1e-4) and
reports bit equality as ``pixels_bitexact`` without gating on it.

All decisions are scripted from *structure* (task kind and step index),
never timing, so the virtual-clock simulator and the wall-clock thread
runtime produce identical :func:`~repro_torch.core.scheduler.trace_signature`
projections — with the ``cfg`` shape dimension recorded in both.  A
third check runs an UNGUIDED workload under ``ElasticPolicy()`` and
``ElasticPolicy(hybrid=True)`` and asserts byte-identical signatures:
shape search off the guided path changes nothing.

``repro/serving/hybrid_demo.py`` on the port: the wall legs run on the
card unless ``device="cpu"`` is passed.  Used by
tests/test_torch_scenario_hybrid.py and ``chip_smoke.py``.  Standalone:
``PYTHONPATH=src python -m repro_torch.serving.hybrid_demo [--device cpu]``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.cost_model import CostModel
from repro_torch.core.policies import ElasticPolicy
from repro_torch.core.scheduler import (ControlPlane, Dispatch, Policy,
                                        Reallocate, trace_signature)
from repro_torch.core.simulator import SimBackend
from repro_torch.core.trajectory import (ClusterTopology, ExecutionLayout,
                                         Request)
from repro_torch.diffusion.adapters import convert_request
from repro_torch.serving.cache_demo import compare_pixels
from repro_torch.serving.engine import ServingEngine

RES = 128                    # 64 latent tokens: small, fast
STEPS = 4
SHIFT_STEP = 2               # first post-reshape denoise step
GUIDANCE = 4.0
TOPO = ClusterTopology(num_hosts=2, ranks_per_host=2)

WIDE = ExecutionLayout((0, 1, 2, 3))              # sp4, batched CFG
SPLIT = ExecutionLayout((0, 1, 2, 3), cfg=2)      # cfg2 x sp2 reshape
NARROW = ExecutionLayout((0, 1))                  # batched sp2 control


class ShapeScriptPolicy(Policy):
    """Structural script: batched sp4 until ``SHIFT_STEP``, then ONE
    Reallocate to ``tail`` (the plane auto-dispatches the pinned steps);
    encode/decode single-rank.  No decision depends on time or cost, so
    both backends trace identically (DESIGN.md §8)."""
    name = "shape-script"

    def __init__(self, tail: ExecutionLayout):
        self.tail = tail

    def schedule(self, view):
        out = []
        for t, req, g in sorted(view.ready,
                                key=lambda x: (x[1].id, x[0].step_index)):
            if t.kind in ("encode", "decode"):
                if 0 in view.free_ranks:
                    out.append(Dispatch(t.id, ExecutionLayout((0,))))
            elif req.id in view.pinned:
                continue        # the plane auto-dispatches pinned steps
            elif t.step_index < SHIFT_STEP:
                if all(r in view.free_ranks for r in WIDE.ranks):
                    out.append(Dispatch(t.id, WIDE))
                    if t.step_index == SHIFT_STEP - 1:
                        # reshape the rest of the chain: same total
                        # degree, different (cfg x sp) split, effective
                        # at the next boundary with automatic re-slice
                        # migration (DESIGN.md §14)
                        out.append(Reallocate(req.id, self.tail))
            else:
                if all(r in view.free_ranks for r in self.tail.ranks):
                    out.append(Dispatch(t.id, self.tail))
        return out


def scenario_requests() -> list[Request]:
    return [Request(id="hyb", model="dit-image", height=RES, width=RES,
                    frames=1, steps=STEPS, arrival=0.0,
                    guidance=GUIDANCE)]


def shape_timeline(events: list[dict]) -> list[tuple]:
    """``(step, shape)`` per denoise dispatch — the printed timeline."""
    out = []
    for ev in events:
        if ev["ev"] == "dispatch" and ev["kind"] == "denoise":
            cfg = ev.get("cfg", 1)
            sp = len(ev["ranks"]) // cfg
            shape = f"cfg{cfg}x sp{sp}" if cfg > 1 else f"sp{sp}"
            out.append((ev["step"], shape))
    return out


def run_wall(cfg, reqs: list[Request], tail: ExecutionLayout,
             telemetry=None, device=None) -> dict:
    """Thread backend: real compute on ``device`` — branch groups, merge
    exchange, and the reshape migration all execute."""
    eng = ServingEngine(cfg, ShapeScriptPolicy(tail), TOPO,
                        cost=CostModel(), telemetry=telemetry,
                        device=device)
    metrics = eng.serve(reqs, timeout=240)
    out = {
        "metrics": metrics,
        "events": list(eng.cp.events),
        "signature": trace_signature(eng.cp.events),
        "timeline": shape_timeline(eng.cp.events),
        "pixels": {r.id: eng.result_pixels(r) for r in reqs},
        "telemetry": (telemetry.clock_independent()
                      if telemetry is not None else None),
        "telemetry_obj": telemetry,
    }
    eng.shutdown()
    return out


def run_sim(cfg, reqs: list[Request], tail: ExecutionLayout,
            telemetry=None) -> dict:
    """Simulator backend: same script, shape-keyed pricing (the cfg2
    steps price the split cell + merge term), virtual clock."""
    cost = CostModel()
    cp = ControlPlane(TOPO, ShapeScriptPolicy(tail), cost,
                      SimBackend(cost), telemetry=telemetry)
    for r in reqs:
        r = dataclasses.replace(r, task_ids=[])
        cp.submit(r, convert_request(r, cfg))
    cp.run()
    return {
        "metrics": cp.metrics(),
        "events": list(cp.events),
        "signature": trace_signature(cp.events),
        "timeline": shape_timeline(cp.events),
        "migrated_bytes": cp.backend.migrated_bytes,
        "telemetry": (telemetry.clock_independent()
                      if telemetry is not None else None),
        "telemetry_obj": telemetry,
    }


def scalar_search_off_identical(cfg=None, num_ranks: int = 4) -> bool:
    """Shape search disabled is byte-identical scalar behavior: an
    UNGUIDED workload under ``ElasticPolicy()`` and
    ``ElasticPolicy(hybrid=True)`` produces the same signature (hybrid
    search only ever touches guided requests)."""
    from repro_torch.diffusion.workloads import short_trace
    if cfg is None:
        from repro_torch.configs.dit_models import DIT_IMAGE
        cfg = DIT_IMAGE.reduced()
    sigs = []
    for hybrid in (False, True):
        cost = CostModel()
        reqs = short_trace("dit-image", cost, duration=30.0,
                           num_ranks=num_ranks, steps=4, seed=7)
        cp = ControlPlane(ClusterTopology.single_host(num_ranks),
                          ElasticPolicy(hybrid=hybrid), cost,
                          SimBackend(cost))
        for r in reqs:
            r = dataclasses.replace(r, task_ids=[])
            cp.submit(r, convert_request(r, cfg))
        cp.run()
        sigs.append(trace_signature(cp.events))
    return sigs[0] == sigs[1]


def run_demo(cfg=None, device=None) -> dict:
    """Run the reshape chain on both backends, the shard-size-matched
    batched control on the wall backend, and the search-off identity
    check; compare traces + pixels."""
    if cfg is None:
        from repro_torch.configs.dit_models import DIT_IMAGE
        cfg = DIT_IMAGE.reduced()
    from repro_torch.core.telemetry import Telemetry
    reqs = scenario_requests()
    sim = run_sim(cfg, reqs, SPLIT, telemetry=Telemetry())
    wall = run_wall(cfg, reqs, SPLIT, telemetry=Telemetry(), device=device)
    control = run_wall(cfg, reqs, NARROW, device=device)
    px = compare_pixels(wall["pixels"], control["pixels"])
    return {
        "wall": wall,
        "sim": sim,
        "control": control,
        "trace_match": wall["signature"] == sim["signature"],
        "telemetry_match": wall["telemetry"] == sim["telemetry"],
        "pixels_match": px["match"],
        "pixels_rel_l2": px["rel_l2"],
        "pixels_bitexact": px["bitexact"],
        "scalar_identical": scalar_search_off_identical(cfg),
    }


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--emit-trace", metavar="PATH", default=None,
                    help="write the wall leg's Perfetto/Chrome "
                         "trace.json here (chrome://tracing or "
                         "ui.perfetto.dev)")
    ap.add_argument("--device", default=None,
                    help="torch device of the wall legs (default: cuda)")
    args = ap.parse_args(argv)
    res = run_demo(device=args.device)
    print("shape timeline (wall):")
    for step, shape in res["wall"]["timeline"]:
        print(f"  step {step}: {shape}")
    print("shape timeline (control):")
    for step, shape in res["control"]["timeline"]:
        print(f"  step {step}: {shape}")
    print(f"sim/wall trace signatures identical: {res['trace_match']}")
    print("sim/wall clock-independent telemetry: "
          f"{res['telemetry_match']}")
    print(f"split pixels ~ batched-CFG control: {res['pixels_match']} "
          f"(rel-L2 {res['pixels_rel_l2']:.2e})")
    print("shape-search-off == scalar elastic:  "
          f"{res['scalar_identical']}")
    if args.emit_trace:
        res["wall"]["telemetry_obj"].perfetto(args.emit_trace)
        print(f"wall Perfetto trace written to {args.emit_trace}")
    if not (res["trace_match"] and res["pixels_match"]
            and res["scalar_identical"] and res["telemetry_match"]):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
