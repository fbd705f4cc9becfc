"""Cross-backend step-packing demonstration (DESIGN.md §9, paper §5.5).

A deterministic scenario that drives :class:`PackingPolicy` through pack
formation, batched execution, and completion fan-out on BOTH execution
backends:

* three identical small image requests arrive together,
* their encodes run concurrently on separate ranks,
* the *hold-for-peers* rule keeps early denoise steps out of the plane
  until every compatible peer reaches its first denoise boundary — on
  the wall clock the three encodes finish in nondeterministic order, but
  holding is trace-silent, so the first **PackedDispatch** always
  carries all three requests on both backends,
* every subsequent denoise step re-packs (the pack's single completion
  fans out simultaneously, so all members reach the next boundary at the
  same schedule point), and the decodes run unpacked at degree 1.

All triggers are *structural* (queue contents, trajectory boundaries,
pack membership), never wall-time thresholds, so the virtual-clock
simulator and the wall-clock thread runtime make identical decisions:
their :func:`~repro_torch.core.scheduler.trace_signature` projections —
which canonicalize pack membership — must match exactly.

``repro/serving/packing_demo.py`` on the port: the wall leg runs on the
card unless ``device="cpu"`` is passed.  Used by
tests/test_torch_scenario_packing.py and ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.cost_model import CostModel
from repro_torch.core.policies import PackingPolicy
from repro_torch.core.scheduler import ControlPlane, trace_signature
from repro_torch.core.simulator import SimBackend
from repro_torch.core.trajectory import Request
from repro_torch.diffusion.adapters import convert_request
from repro_torch.serving.engine import ServingEngine

RES = 128                    # 64 latent tokens: small, fast, packable
STEPS = 3
NUM_RANKS = 4
N_REQS = 3
PACK_DEGREE = 2              # packs share a 2-rank SP group


def _request(rid: str) -> Request:
    # best-effort (no deadline): the hold rule is then purely structural
    # and no leg can diverge on an ETA comparison (DESIGN.md §8)
    return Request(id=rid, model="dit-image", height=RES, width=RES,
                   frames=1, steps=STEPS, arrival=0.0)


def scenario_requests() -> list[Request]:
    return [_request(f"pk{i}") for i in range(N_REQS)]


def _policy() -> PackingPolicy:
    return PackingPolicy(degree=PACK_DEGREE, max_pack=N_REQS + 1)


def run_wall(cfg, reqs: list[Request], device=None) -> dict:
    """Thread backend: real batched compute on ``device``, wall clock."""
    eng = ServingEngine(cfg, _policy(), NUM_RANKS, cost=CostModel(),
                        device=device)
    metrics = eng.serve(reqs, timeout=240)
    out = {
        "metrics": metrics,
        "events": list(eng.cp.events),
        "signature": trace_signature(eng.cp.events),
        "pixels": {r.id: eng.result_pixels(r) for r in reqs},
        "latents": _final_latents(eng.cp, reqs),
    }
    eng.shutdown()
    return out


def _final_latents(cp, reqs) -> dict:
    """Per-request final denoise latent (leader-rank shard concatenation),
    for the bit-compatibility check against solo runs."""
    import numpy as np
    out = {}
    for r in reqs:
        g = cp.graphs[r.id]
        last = max((t for t in g.tasks.values() if t.kind == "denoise"),
                   key=lambda t: t.step_index)
        art = g.artifacts[last.outputs[0]]
        if art.data is None:
            out[r.id] = None
            continue
        ranks = art.layout.ranks if art.layout is not None \
            else sorted(art.data)
        out[r.id] = np.concatenate(
            [art.data[rk]["latent"] for rk in ranks], axis=0)
    return out


def run_sim(cfg, reqs: list[Request]) -> dict:
    """Simulator backend: same policy logic, virtual clock."""
    cost = CostModel()
    cp = ControlPlane(NUM_RANKS, _policy(), cost, SimBackend(cost))
    for r in reqs:
        r = dataclasses.replace(r, task_ids=[])
        cp.submit(r, convert_request(r, cfg))
    cp.run()
    return {
        "metrics": cp.metrics(),
        "events": list(cp.events),
        "signature": trace_signature(cp.events),
    }


def run_demo(cfg=None, device=None) -> dict:
    """Run the packing scenario on both backends and compare traces."""
    if cfg is None:
        from repro_torch.configs.dit_models import DIT_IMAGE
        cfg = DIT_IMAGE.reduced()
    reqs = scenario_requests()
    sim = run_sim(cfg, reqs)
    wall = run_wall(cfg, reqs, device)
    packs = {
        leg: [e for e in d["events"] if e["ev"] == "packed_dispatch"]
        for leg, d in (("wall", wall), ("sim", sim))
    }
    return {
        "wall": wall,
        "sim": sim,
        "packs": packs,
        "trace_match": wall["signature"] == sim["signature"],
    }
