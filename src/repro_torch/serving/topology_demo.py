"""Cross-backend topology demonstration (DESIGN.md §10, paper §5.5).

A deterministic single-request scenario on a 2-host x 2-rank cluster
that drives every topology-aware layer on BOTH execution backends:

* the first denoise steps run on a layout spanning both hosts — the
  thread backend's GFC executes the hierarchical two-stage all-gather
  (intra-host gather -> leader exchange -> intra-host broadcast), the
  simulator prices the step with the span-keyed cost model;
* one mid-trajectory **Reallocate** pins the request onto a single host
  — the remaining ranks' latent shards migrate ACROSS hosts (the thread
  backend executes the plan, the simulator prices its inter-host slices
  honestly);
* the remaining denoise steps run host-local (flat GFC, span-1 cost),
  and encode/decode run single-rank.

All decisions are scripted from *structure* (task kind and step index),
never timing, so the virtual-clock simulator and the wall-clock thread
runtime produce identical :func:`~repro_torch.core.scheduler.trace_signature`
projections.  The wall leg additionally re-runs the same script on a
synthesized one-host topology (flat collectives everywhere) and checks
the output pixels agree — hierarchical execution must never change
results, only the path bytes take.  The port holds them to the pixel
budget (``pixels_match``: rel-L2 ``pixels_rel_l2`` <= 1e-4) and reports
bit equality as ``pixels_bitexact`` without gating on it.

``repro/serving/topology_demo.py`` on the port: the wall legs run on the
card unless ``device="cpu"`` is passed.  Used by
tests/test_torch_scenario_topology.py and ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.cost_model import CostModel
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
SHIFT_STEP = 2               # first host-local denoise step
TOPO = ClusterTopology(num_hosts=2, ranks_per_host=2)

SPAN_LAYOUT = ExecutionLayout((0, 1, 2, 3))     # straddles both hosts
LOCAL_LAYOUT = ExecutionLayout((0, 1))          # host 0 only


class TopologyScriptPolicy(Policy):
    """Structural script: spanning denoise until ``SHIFT_STEP``, then a
    single Reallocate onto host 0 (the plane auto-dispatches the pinned
    steps); encode/decode single-rank.  No decision depends on time or
    cost, so both backends trace identically."""
    name = "topology-script"

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
                if all(r in view.free_ranks for r in SPAN_LAYOUT.ranks):
                    out.append(Dispatch(t.id, SPAN_LAYOUT))
                    if t.step_index == SHIFT_STEP - 1:
                        # pin the rest of the chain onto one host: takes
                        # effect at the next boundary with automatic
                        # cross-host migration of the latent shards
                        out.append(Reallocate(req.id, LOCAL_LAYOUT))
            else:
                if all(r in view.free_ranks for r in LOCAL_LAYOUT.ranks):
                    out.append(Dispatch(t.id, LOCAL_LAYOUT))
        return out


def scenario_requests() -> list[Request]:
    return [Request(id="topo", model="dit-image", height=RES, width=RES,
                    frames=1, steps=STEPS, arrival=0.0)]


def run_wall(cfg, reqs: list[Request], topology, device=None) -> dict:
    """Thread backend: real compute on ``device`` with hierarchical GFC
    when the topology spans hosts."""
    eng = ServingEngine(cfg, TopologyScriptPolicy(), topology,
                        cost=CostModel(), device=device)
    metrics = eng.serve(reqs, timeout=240)
    out = {
        "metrics": metrics,
        "events": list(eng.cp.events),
        "signature": trace_signature(eng.cp.events),
        "pixels": {r.id: eng.result_pixels(r) for r in reqs},
        "hierarchical_collectives": eng.comm.stats["hierarchical"],
    }
    eng.shutdown()
    return out


def run_sim(cfg, reqs: list[Request]) -> dict:
    """Simulator backend: same script, span-keyed pricing, virtual
    clock."""
    cost = CostModel()
    cp = ControlPlane(TOPO, TopologyScriptPolicy(), cost,
                      SimBackend(cost))
    for r in reqs:
        r = dataclasses.replace(r, task_ids=[])
        cp.submit(r, convert_request(r, cfg))
    cp.run()
    return {
        "metrics": cp.metrics(),
        "events": list(cp.events),
        "signature": trace_signature(cp.events),
        "migrated_bytes": cp.backend.migrated_bytes,
    }


def run_demo(cfg=None, device=None) -> dict:
    """Run the scenario on both backends (and a flat one-host reference
    wall leg) and compare traces + pixels."""
    if cfg is None:
        from repro_torch.configs.dit_models import DIT_IMAGE
        cfg = DIT_IMAGE.reduced()
    reqs = scenario_requests()
    sim = run_sim(cfg, reqs)
    wall = run_wall(cfg, reqs, TOPO, device)
    flat = run_wall(cfg, reqs, ClusterTopology.single_host(TOPO.num_ranks),
                    device)
    px = compare_pixels(wall["pixels"], flat["pixels"])
    return {
        "wall": wall,
        "sim": sim,
        "flat": flat,
        "trace_match": (wall["signature"] == sim["signature"]
                        and flat["signature"] == sim["signature"]),
        "pixels_match": px["match"],
        "pixels_rel_l2": px["rel_l2"],
        "pixels_bitexact": px["bitexact"],
    }
