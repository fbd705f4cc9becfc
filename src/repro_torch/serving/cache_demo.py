"""Cross-backend feature-cache demonstration (DESIGN.md §11).

A deterministic single-request scenario on 4 ranks that drives every
layer of the cross-step feature cache on BOTH execution backends:

* denoise step 0 runs on ranks (0, 1) and **refreshes** the cache (full
  KV all-gather, snapshot stored);
* step 1 **hits**: stale remote shards + fresh local K/V, no collective;
* a mid-trace same-degree **Reallocate** onto ranks (2, 3) takes effect
  at step 2 — the warm snapshot **migrates** through the ordinary
  layout-aware migration planner and step 2 is a ``hit+mig``;
* step 3 exhausts the staleness window (``CACHE_INTERVAL = 3``) and
  refreshes on the new ranks; steps 4-5 hit again.

All decisions are scripted from *structure* (task kind and step index),
and the cache hit/refresh/migrate calls are made by the control plane
itself, so the virtual-clock simulator and the wall-clock thread runtime
produce identical :func:`~repro_torch.core.scheduler.trace_signature`
projections — cache decisions included.

The wall leg additionally validates the cache's numerics:

* ``cache_interval=1`` (refresh every step) matches the non-cached
  runtime within the pixel budget (``PIXEL_BUDGET``, 1e-4 rel-L2: on
  the card cuBLAS picks its GEMM kernel by shape, so the port holds
  pixels to a tolerance, not to bit equality; whether they happen to be
  bit-equal is reported as ``interval1_bitexact``);
* the stale-reuse run's decoded pixels stay within the relative-L2
  error budget of the exact output (§11 accuracy contract);
* a no-Reallocate control run at the same interval produces pixels
  **bit-identical** to the reallocated run — the only way that holds is
  if migration moved the warm snapshot bit-identically (both runs make
  the same calls at the same shapes).

``repro/serving/cache_demo.py`` on the port, whose wall legs run on the
card unless ``device="cpu"`` is passed.  The JAX demo's ``use_pallas``
leg (kernels on vs off, same trace) has no counterpart: the port always
runs its kernels, so that leg would repeat the wall leg.  Used by
tests/test_torch_scenario_cache.py, ``chip_smoke.py`` and
``repro_torch.benchmarks`` (``sim_fidelity``'s cache leg and
``policies_e2e``'s cache probe, :func:`pixel_error_report`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel
from repro_torch.core.scheduler import (ControlPlane, Dispatch, Policy,
                                        Reallocate, trace_signature)
from repro_torch.core.simulator import SimBackend
from repro_torch.core.trajectory import ExecutionLayout, Request
from repro_torch.diffusion.adapters import convert_request
from repro_torch.models import dit
from repro_torch.serving.engine import ServingEngine

RES = 128                    # 64 latent tokens: small, fast
STEPS = 6
CACHE_INTERVAL = 3           # refresh every 3rd step
NUM_RANKS = 4
SHIFT_STEP = 2               # first denoise step on the new rank set
PIXEL_BUDGET = 1e-4          # rel-L2 on decoded pixels (DESIGN.md §12)

LAYOUT_A = ExecutionLayout((0, 1))
LAYOUT_B = ExecutionLayout((2, 3))


class CacheScriptPolicy(Policy):
    """Structural script: denoise on ``LAYOUT_A`` until ``SHIFT_STEP``,
    with a single same-degree Reallocate onto ``LAYOUT_B`` issued at the
    last A-step's dispatch (the plane auto-dispatches the pinned rest of
    the chain); encode/decode single-rank.  ``shift=False`` is the
    control variant that stays on ``LAYOUT_A`` for the whole chain."""
    name = "cache-script"

    def __init__(self, shift: bool = True):
        self.shift = shift

    def schedule(self, view):
        out = []
        for t, req, g in sorted(view.ready,
                                key=lambda x: (x[1].id, x[0].step_index)):
            if t.kind in ("encode", "decode"):
                if 0 in view.free_ranks:
                    out.append(Dispatch(t.id, ExecutionLayout((0,))))
            elif req.id in view.pinned:
                continue        # the plane auto-dispatches pinned steps
            elif all(r in view.free_ranks for r in LAYOUT_A.ranks):
                out.append(Dispatch(t.id, LAYOUT_A))
                if self.shift and t.step_index == SHIFT_STEP - 1:
                    # same-degree re-pin: takes effect at the next
                    # boundary and MIGRATES the warm cache (§11)
                    out.append(Reallocate(req.id, LAYOUT_B))
        return out


def scenario_requests() -> list[Request]:
    return [Request(id="cache", model="dit-image", height=RES, width=RES,
                    frames=1, steps=STEPS, arrival=0.0)]


def cache_modes(events: list[dict]) -> list[tuple]:
    """(step, mode) per denoise dispatch, in dispatch order."""
    return [(e["step"], e.get("cache")) for e in events
            if e["ev"] == "dispatch" and e["kind"] == "denoise"]


def _liven(pipeline, seed: int = 123, scale: float = 0.05):
    """Replace the adaLN-Zero zero-init gates (and the zero output head)
    with small fixed-seed values (:func:`repro_torch.models.dit.
    liven_adaln`).  An untrained DiT gates its attention output by
    exactly zero, so stale-KV reuse would be vacuously exact — livening
    the gates makes the error-budget claim a real measurement while
    keeping every leg of the demo deterministic (same seed, same
    perturbation, every engine)."""
    dit.liven_adaln(pipeline.dit, pipeline.cfg.d_model, seed=seed,
                    scale=scale)


def run_wall(cfg, reqs, *, cache_interval, shift: bool = True,
             device=None) -> dict:
    eng = ServingEngine(cfg, CacheScriptPolicy(shift=shift), NUM_RANKS,
                        cost=CostModel(), cache_interval=cache_interval,
                        device=device)
    _liven(eng.pipeline)
    metrics = eng.serve(reqs, timeout=240)
    out = {
        "metrics": metrics,
        "events": list(eng.cp.events),
        "signature": trace_signature(eng.cp.events),
        "modes": cache_modes(eng.cp.events),
        "pixels": {r.id: eng.result_pixels(r) for r in reqs},
    }
    eng.shutdown()
    return out


def run_sim(cfg, reqs, *, cache_interval) -> dict:
    cost = CostModel()
    cp = ControlPlane(NUM_RANKS, CacheScriptPolicy(), cost,
                      SimBackend(cost), cache_interval=cache_interval)
    for r in reqs:
        r = dataclasses.replace(r, task_ids=[])
        cp.submit(r, convert_request(r, cfg))
    cp.run()
    return {
        "metrics": cp.metrics(),
        "events": list(cp.events),
        "signature": trace_signature(cp.events),
        "modes": cache_modes(cp.events),
        "migrated_bytes": cp.backend.migrated_bytes,
    }


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    denom = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / max(denom, 1e-12)


def compare_pixels(got: dict, want: dict) -> dict:
    """Per-request pixels of two legs: the largest rel-L2 (inf where a
    leg has none), whether it is within ``PIXEL_BUDGET``, and whether
    every request's pixels happen to be bit-equal (reported, not
    gated)."""
    errs, equal = [], []
    for rid, w in want.items():
        g = got.get(rid)
        ok = g is not None and w is not None
        errs.append(rel_l2(g, w) if ok else float("inf"))
        equal.append(ok and np.array_equal(g, w))
    err = max(errs, default=float("inf"))
    return {"rel_l2": err, "match": bool(err <= PIXEL_BUDGET),
            "bitexact": bool(equal and all(equal))}


def run_demo(cfg=None, device=None) -> dict:
    """Run the scenario on both backends plus the numeric control legs
    and compare traces, cache decisions, and pixels."""
    if cfg is None:
        from repro_torch.configs.dit_models import DIT_IMAGE
        cfg = DIT_IMAGE.reduced()
    reqs = scenario_requests()
    sim = run_sim(cfg, reqs, cache_interval=CACHE_INTERVAL)
    wall = run_wall(cfg, reqs, cache_interval=CACHE_INTERVAL, device=device)
    # numeric controls (wall only; the simulator has no pixels)
    exact = run_wall(cfg, reqs, cache_interval=None, device=device)
    exact1 = run_wall(cfg, reqs, cache_interval=1, device=device)
    stay = run_wall(cfg, reqs, cache_interval=CACHE_INTERVAL, shift=False,
                    device=device)
    rid = reqs[0].id
    px, px_exact = wall["pixels"][rid], exact["pixels"][rid]
    interval1 = compare_pixels(exact1["pixels"], exact["pixels"])
    return {
        "wall": wall,
        "sim": sim,
        "trace_match": wall["signature"] == sim["signature"],
        "modes": wall["modes"],
        # cache_interval=1 == non-cached path, within the pixel budget
        "interval1_exact": interval1["match"],
        "interval1_rel_l2": interval1["rel_l2"],
        "interval1_bitexact": interval1["bitexact"],
        # stale reuse stays inside the §11 error budget
        "rel_l2_err": (rel_l2(px, px_exact)
                       if px is not None and px_exact is not None
                       else float("inf")),
        # the same-degree Reallocate moved the warm snapshot
        # bit-identically: the shifted and stay-put cached runs agree
        # bit for bit (same refresh schedule, same snapshot bytes)
        "migration_bitexact": bool(
            px is not None and stay["pixels"][rid] is not None
            and np.array_equal(px, stay["pixels"][rid])),
        "sim_migrated_bytes": sim["migrated_bytes"],
    }


def pixel_error_report(cfg=None, interval: int = CACHE_INTERVAL,
                       device=None) -> dict:
    """Small wall-clock error probe for benchmarks: serve the scripted
    scenario cached (``interval``) and uncached, report the relative-L2
    pixel error and whether ``cache_interval=1`` matches the non-cached
    runtime (``interval1_exact``: within ``PIXEL_BUDGET``, as
    :func:`run_demo` holds it; ``interval1_bitexact`` says whether the
    pixels are also bit-equal)."""
    if cfg is None:
        from repro_torch.configs.dit_models import DIT_IMAGE
        cfg = DIT_IMAGE.reduced()
    reqs = scenario_requests()
    exact = run_wall(cfg, reqs, cache_interval=None, device=device)
    exact1 = run_wall(cfg, reqs, cache_interval=1, device=device)
    cached = run_wall(cfg, reqs, cache_interval=interval, device=device)
    rid = reqs[0].id
    px_exact, px = exact["pixels"][rid], cached["pixels"][rid]
    interval1 = compare_pixels(exact1["pixels"], exact["pixels"])
    # a timed-out leg reports a failed measurement, not a traceback
    ok = px_exact is not None
    return {
        "cache_interval": interval,
        "rel_l2_err": (rel_l2(px, px_exact)
                       if ok and px is not None else float("inf")),
        "interval1_exact": interval1["match"],
        "interval1_rel_l2": interval1["rel_l2"],
        "interval1_bitexact": interval1["bitexact"],
        "hits": sum(1 for _, m in cached["modes"]
                    if m and m.startswith("hit")),
        "refreshes": sum(1 for _, m in cached["modes"]
                         if m == "refresh"),
    }
