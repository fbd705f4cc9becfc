"""Cross-backend failure-domain demonstration (DESIGN.md §13).

A deterministic single-request scenario on a 2-host x 2-rank cluster
that drives the whole host-loss recovery path on BOTH execution
backends:

* encode runs on rank 0, the denoise chain on host 0's ranks (0, 1),
  with periodic denoise-state snapshots every ``SNAP_INTERVAL`` steps
  (captured at steps 1, 3, 5 — ``training/checkpoint``-backed on the
  wall leg);
* a scripted :class:`HostDown` kills host 0 mid-denoise-step 3
  (half-step margins on both sides): the in-flight step **fails out**
  and drains to its boundary, the plane marks ranks (0, 1) dead, and
  the repair runs at the drain completion;
* repair dematerializes the lost artifacts (the sharded latents and the
  rank-0 text embeds), restores the step-1 snapshot latent onto the
  lowest alive rank, and rolls the trajectory back to denoise step 2 —
  NOT to step 0 (the reset cascade stops at the restored artifact; only
  encode re-runs, for its lost text embeds);
* the surviving steps re-place on host 1's ranks (2, 3) and the request
  completes degraded.

Every decision is scripted from *structure* (dead-rank-aware free
lists), and the failure script is a timed event source released by the
shared event loop, so the virtual-clock simulator and the wall-clock
thread runtime produce identical :func:`trace_signature` projections —
host_down / failout / rollback / snapshot events included.

The wall leg additionally validates recovery numerics: the recovered
pixels match an undisturbed control run.  That holds because the
snapshot round-trips the step-1 latent bytes exactly (two-phase-commit
checkpoint), re-encode is deterministic, and the degree-2 shard math is
rank-set independent.  The port holds them to the pixel budget
(``pixels_match``: rel-L2 ``pixels_rel_l2`` <= 1e-4; cuBLAS picks its
GEMM kernel by shape on the card) and reports bit equality as
``pixels_bitexact`` without gating on it.

``repro/serving/failure_demo.py`` on the port: every engine runs on the
card unless ``device="cpu"`` is passed, and the snapshots write through
``repro_torch.training.checkpoint`` in the JAX package's on-disk layout.
Used by tests/test_torch_scenario_failure.py and ``chip_smoke.py``.
"""
from __future__ import annotations

import dataclasses
import tempfile

from repro_torch.core.cost_model import CostModel
from repro_torch.core.failures import FailureInjector, HostDown
from repro_torch.core.scheduler import (ControlPlane, Dispatch, Policy,
                                        trace_signature)
from repro_torch.core.simulator import SimBackend
from repro_torch.core.trajectory import (ClusterTopology, ExecutionLayout,
                                         Request)
from repro_torch.diffusion.adapters import convert_request
from repro_torch.serving.cache_demo import compare_pixels
from repro_torch.serving.engine import ServingEngine

RES = 128                    # 64 latent tokens: small, fast
STEPS = 6
SNAP_INTERVAL = 2            # snapshots at denoise steps 1, 3, 5
FAIL_AFTER_STEPS = 3.5       # host 0 dies mid-denoise-step 3

TOPO = ClusterTopology(num_hosts=2, ranks_per_host=2)
LAYOUT_A = ExecutionLayout((0, 1))          # host 0
LAYOUT_B = ExecutionLayout((2, 3))          # host 1


class FailureScriptPolicy(Policy):
    """Structural script: denoise on ``LAYOUT_A`` while host 0 lives,
    on ``LAYOUT_B`` after the loss; encode/decode on the lowest free
    rank.  All choices read only the (dead-rank-aware) free list, so
    both backends make the identical sequence of decisions."""
    name = "failure-script"

    def schedule(self, view):
        out, taken = [], set()
        for t, req, g in sorted(view.ready,
                                key=lambda x: (x[1].id, x[0].step_index)):
            if t.kind in ("encode", "decode"):
                for r in sorted(view.free_ranks):
                    if r not in taken:
                        out.append(Dispatch(t.id, ExecutionLayout((r,))))
                        taken.add(r)
                        break
            else:
                for lay in (LAYOUT_A, LAYOUT_B):
                    if all(r in view.free_ranks and r not in taken
                           for r in lay.ranks):
                        out.append(Dispatch(t.id, lay))
                        taken.update(lay.ranks)
                        break
        return out


def _request(rid: str) -> Request:
    return Request(id=rid, model="dit-image", height=RES, width=RES,
                   frames=1, steps=STEPS, arrival=0.0)


def calibrate(cfg, device=None) -> CostModel:
    """Measure the cost of every cell the scenario dispatches (degree-2
    denoise, degree-1 encode/decode at 64 tokens) by serving the
    scripted scenario itself, failure-free: first pass warms up, second
    pass measures (elastic_demo methodology).

    The denoise cell is the median period between the measured pass's
    consecutive denoise dispatches, not the online EMA of the steps'
    durations: the EMA (weight 0.5) is mostly the last step or two, and
    the period is what the wall leg's clock advances by a step (the
    step plus the plane's completion-to-dispatch turn).  The kill lands
    3.5 steps in, so the cell's error counts 3.5 times against a margin
    of half a step."""
    cost = CostModel()
    for i, cal in enumerate((CostModel(), cost)):   # warm, measure
        eng = ServingEngine(cfg, FailureScriptPolicy(), TOPO, cost=cal,
                            device=device)
        eng.serve([_request(f"warm{i}")], timeout=240)
        starts = [e["t"] for e in eng.cp.events
                  if e["ev"] == "dispatch" and e["kind"] == "denoise"]
        eng.shutdown()
    cost.table.update(cost.calibration)
    cost.calibration.clear()        # the copied table is authoritative
    periods = sorted(b - a for a, b in zip(starts, starts[1:]))
    cost.table[CostModel._key("dit-image", "denoise", (RES // 16) ** 2,
                              len(LAYOUT_A.ranks))] = \
        periods[len(periods) // 2]
    return cost


def fail_time(cost: CostModel) -> float:
    """Mid-step-3 host kill, from the frozen calibration: encode plus
    3.5 denoise steps (margins: half a step on either side)."""
    tok = (RES // 16) ** 2
    enc = cost.estimate("dit-image", "encode", tok, 1)
    den2 = cost.estimate("dit-image", "denoise", tok, 2)
    return enc + FAIL_AFTER_STEPS * den2


def recovery_events(events: list[dict]) -> list[tuple]:
    """(ev, step) per recovery-relevant event, in trace order."""
    return [(e["ev"], e.get("step")) for e in events
            if e["ev"] in ("host_down", "failout", "rollback", "snapshot",
                           "request_failed")]


def run_wall(cfg, cost: CostModel, reqs, t_fail=None,
             telemetry=None, device=None) -> dict:
    """Thread backend: real compute on ``device``, checkpoint-backed
    snapshots on a temp directory, wall clock.  ``t_fail=None`` is the
    undisturbed control leg (same snapshot cadence, no failure)."""
    inj = (FailureInjector([HostDown(t_fail, 0)])
           if t_fail is not None else None)
    with tempfile.TemporaryDirectory(prefix="gfdit-snap-") as snap_dir:
        eng = ServingEngine(cfg, FailureScriptPolicy(), TOPO,
                            cost=CostModel(table=dict(cost.table)),
                            injector=inj, snapshot_interval=SNAP_INTERVAL,
                            snapshot_dir=snap_dir, telemetry=telemetry,
                            device=device)
        metrics = eng.serve(reqs, timeout=240)
        out = {
            "metrics": metrics,
            "events": list(eng.cp.events),
            "signature": trace_signature(eng.cp.events),
            "recovery": recovery_events(eng.cp.events),
            "timeouts": list(eng.backend.timeouts),
            "pixels": {r.id: eng.result_pixels(r) for r in reqs},
            "telemetry": (telemetry.clock_independent()
                          if telemetry is not None else None),
            "telemetry_obj": telemetry,
        }
        eng.shutdown()
    return out


def run_sim(cfg, cost: CostModel, reqs, t_fail, telemetry=None) -> dict:
    """Simulator backend: same script policy, same frozen costs, same
    failure script, virtual clock (metadata-only snapshots)."""
    sim_cost = CostModel(table=dict(cost.table))
    inj = FailureInjector([HostDown(t_fail, 0)])
    cp = ControlPlane(TOPO, FailureScriptPolicy(), sim_cost,
                      SimBackend(sim_cost), injector=inj,
                      snapshot_interval=SNAP_INTERVAL, telemetry=telemetry)
    for r in reqs:
        r = dataclasses.replace(r, task_ids=[])
        cp.submit(r, convert_request(r, cfg))
    cp.run()
    return {
        "metrics": cp.metrics(),
        "events": list(cp.events),
        "signature": trace_signature(cp.events),
        "recovery": recovery_events(cp.events),
        "telemetry": (telemetry.clock_independent()
                      if telemetry is not None else None),
        "telemetry_obj": telemetry,
    }


def run_demo(cfg=None, retries: int = 2, device=None) -> dict:
    """Full demo: calibrate, inject the scripted loss on both backends,
    compare traces and recovered pixels.

    The wall leg's timing margins are half a denoise step; on a shared
    host a contention spike can exceed them, so a signature mismatch
    re-serves the (cheap) wall leg — the claim under test is
    decision-trace identity given sane timing, not immunity to
    infrastructure noise.  Every attempt calibrates anew and replays
    its own sim leg on those costs: a host that slowed down (or sped
    up) after one frozen calibration would miss every attempt together.
    A run whose attempts are all used up returns ``trace_match:
    False``."""
    if cfg is None:
        from repro_torch.configs.dit_models import DIT_IMAGE
        cfg = DIT_IMAGE.reduced()
    from repro_torch.core.telemetry import Telemetry
    reqs = [_request("victim")]
    attempts = 0
    for attempts in range(1, retries + 2):
        frozen = CostModel(table=dict(calibrate(cfg, device).table))
        t_fail = fail_time(frozen)
        sim = run_sim(cfg, frozen, reqs, t_fail, telemetry=Telemetry())
        # fresh instrument per attempt: a noise-perturbed leg must not
        # leave stale streams behind for the comparison
        wall = run_wall(cfg, frozen, reqs, t_fail, telemetry=Telemetry(),
                        device=device)
        if wall["signature"] == sim["signature"] \
                and wall["telemetry"] == sim["telemetry"]:
            break
    control = run_wall(cfg, frozen, reqs, t_fail=None, device=device)
    px = compare_pixels(wall["pixels"], control["pixels"])
    rolled = [e for e in wall["events"] if e["ev"] == "rollback"]
    return {
        "wall": wall,
        "sim": sim,
        "attempts": attempts,
        "t_fail": t_fail,
        "trace_match": wall["signature"] == sim["signature"],
        "telemetry_match": wall["telemetry"] == sim["telemetry"],
        "recovery": wall["recovery"],
        # the request resumed from its snapshot, not from step 0
        "resumed_step": rolled[0]["step"] if rolled else None,
        "snapshot_step": rolled[0]["snapshot"] if rolled else None,
        "completed": wall["metrics"]["completed"],
        # degraded-mode output matches the undisturbed run
        "pixels_match": px["match"],
        "pixels_rel_l2": px["rel_l2"],
        "pixels_bitexact": px["bitexact"],
    }


if __name__ == "__main__":
    import json
    res = run_demo()
    print(json.dumps({k: v for k, v in res.items()
                      if k not in ("wall", "sim")}, indent=2, default=str))
