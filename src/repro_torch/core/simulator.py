"""Simulator backend (paper §5.5).

Replaces worker execution with cost-model completion events while
preserving task readiness, dependency updates, resource allocation, and
policy invocation — the same ControlPlane drives both this and the thread
backend, so "a policy selected offline can be deployed without rewriting
its decision logic".

Adds the two runtime effects the paper prices:
* layout-change migration latency (artifact bytes / link bandwidth + fixed
  software overhead) when consecutive tasks use different layouts;
* per-dispatch CPU overhead (the §6.4 runtime-overhead experiment).

Elastic actions (DESIGN.md §3) need no special support here: a preempted
or cancelled task's scheduled completion still fires at its boundary —
exactly when the thread backend's drain finishes — and the control plane
discards it (freeing the ranks) instead of committing outputs, so both
backends share identical reclaim timing.  Completions of superseded
dispatches are rejected by the plane via the `seq` guard.

Topology (DESIGN.md §10): the backend reads the plane's
:class:`~repro.core.trajectory.ClusterTopology` — spanning layouts are
priced via span-keyed cost estimates, and layout changes that cross
hosts are priced from the actual migration plan (inter-host slices over
the slow link) instead of the flat single-link formula.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.migration import layout_moved
from repro_torch.core.scheduler import Completion
from repro_torch.core.trajectory import (ClusterTopology, ExecutionLayout,
                                   RequestGraph, TrajectoryTask)

# migration pricing: staged copies over the interconnect + software setup
_LINK_BW = 50e9                  # bytes/s (ICI-class)
_MIGRATION_SETUP = 60e-6         # GFC logical-pair registration (paper: 60us)


def migration_seconds(nbytes: int, src: ExecutionLayout,
                      dst: ExecutionLayout) -> float:
    """Single-host migration pricing (the pre-topology model, kept
    byte-identical for one-host topologies)."""
    if not layout_moved(src, dst):
        return 0.0
    # each byte moves once; transfers parallel across rank pairs
    pairs = max(len(set(src.ranks) | set(dst.ranks)) - 1, 1)
    return _MIGRATION_SETUP + nbytes / (_LINK_BW * pairs)


class SimBackend:
    """Virtual-clock executor producing cost-model completions."""

    def __init__(self, cost, *, dispatch_overhead: float = 1e-4,
                 jitter: float = 0.0, seed: int = 0):
        self.cost = cost
        self.dispatch_overhead = dispatch_overhead
        self.jitter = jitter
        self._heap: list[tuple[float, int, Completion]] = []
        self._n = itertools.count()
        self._rng_state = seed or 1
        self.plane = None
        self.migrated_bytes = 0

    def attach(self, plane):
        self.plane = plane

    # ------------------------------------------------------------------
    def _rand(self) -> float:
        # xorshift — deterministic, no global RNG
        x = self._rng_state
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        self._rng_state = x
        return (x % 10_000) / 10_000.0

    # ------------------------------------------------------------------
    @property
    def topology(self) -> ClusterTopology:
        if self.plane is not None:
            return self.plane.topology
        return ClusterTopology.single_host(1 << 16)     # detached: flat

    def _migration(self, art, layout: ExecutionLayout) -> float:
        """Price one artifact's move into `layout`.  One-host topologies
        keep the flat single-link formula; multi-host topologies price
        the actual transfer plan, with cross-host slices over the slow
        inter-host link (DESIGN.md §10)."""
        topo = self.topology
        if topo.num_hosts <= 1 or not art.fields:
            return migration_seconds(art.nbytes, art.layout, layout)
        from repro_torch.core.migration import migration_cost, plan_migration
        entries = plan_migration(art.fields, art.layout, layout)
        return migration_cost(entries, topo)

    def _cache_effects(self, task: TrajectoryTask, graph: RequestGraph,
                       layout: ExecutionLayout) -> float:
        """Feature-cache side of one dispatch (DESIGN.md §11): a
        plane-stamped ``migrate`` moves the warm snapshot through the
        SAME migration pricing as any artifact (same-degree Reallocate);
        a refresh re-homes the snapshot to this layout for free (the
        gather writes it here).  Returns migration seconds to add."""
        stamp = task.meta.get("cache")
        if stamp is None:
            return 0.0
        art = graph.artifacts[stamp["art"]]
        mig = 0.0
        if stamp["migrate"] and art.layout is not None \
                and art.layout.ranks != layout.ranks:
            mig = self._migration(art, layout)
            self.migrated_bytes += art.nbytes
        art.layout = layout
        return mig

    def dispatch(self, task: TrajectoryTask, layout: ExecutionLayout,
                 graph: RequestGraph, now: float):
        model = graph.request.model
        tokens = task.meta.get("tokens", 4096)
        stamp = task.meta.get("cache")
        # guided denoise prices its shape cell (DESIGN.md §14): cfg=1
        # batched on one group, cfg>=2 split branches + merge exchange
        cfg = 0
        if task.kind == "denoise" and \
                getattr(graph.request, "guidance", None) is not None:
            cfg = max(getattr(layout, "cfg", 1), 1)
        dur = self.cost.estimate(model, task.kind, tokens, layout.degree,
                                 span=layout.span(self.topology),
                                 cached=bool(stamp
                                             and stamp["mode"] == "hit"),
                                 cfg=cfg)
        if self.jitter:
            dur *= 1.0 + self.jitter * (self._rand() - 0.5)
        # migration latency when the input artifact lives in another layout
        bytes0 = self.migrated_bytes
        mig = self._cache_effects(task, graph, layout)
        for aid in task.inputs:
            art = graph.artifacts[aid]
            if layout_moved(art.layout, layout):
                mig += self._migration(art, layout)
                self.migrated_bytes += art.nbytes
                art.layout = layout      # artifact now lives here
        # duration excludes migration, matching the thread backend (which
        # migrates before stamping t_dispatch): calibration must price the
        # STEP — migration is priced separately at every dispatch, and
        # folding it in would double-count it in future estimates
        tel = getattr(self.plane, "telemetry", None)
        if tel is not None and mig > 0:
            # priced-migration counter (the sim's counterpart of the wall
            # overlay's measured migrate spans — clock-dependent stream)
            tel.counter("sim_migrations")
            tel.span(layout.ranks[0], now + self.dispatch_overhead,
                     now + self.dispatch_overhead + mig, "migrate",
                     self.migrated_bytes - bytes0)
        finish = now + self.dispatch_overhead + mig + dur
        c = Completion(task.id, finish, dur,
                       seq=task.meta.get("_seq", 0))
        heapq.heappush(self._heap, (finish, next(self._n), c))
        # outputs adopt the task layout on completion (ControlPlane sets it)
        for aid in task.outputs:
            graph.artifacts[aid].layout = layout

    # ------------------------------------------------------------------
    def dispatch_pack(self, pack_id: str, members, layout: ExecutionLayout,
                      now: float):
        """One batched completion for a pack of compatible denoise tasks
        (DESIGN.md §9): duration comes from the BATCHED cost curve
        (collectives paid once, compute sub-linear until the roofline);
        migration is priced per member input that lives elsewhere."""
        task0, graph0 = members[0]
        model = graph0.request.model
        tokens = task0.meta.get("tokens", 4096)
        stamp0 = task0.meta.get("cache")
        dur = self.cost.estimate_packed(model, "denoise", tokens,
                                        layout.degree, len(members),
                                        span=layout.span(self.topology),
                                        cached=bool(stamp0 and
                                                    stamp0["mode"]
                                                    == "hit"))
        if self.jitter:
            dur *= 1.0 + self.jitter * (self._rand() - 0.5)
        mig = 0.0
        for task, graph in members:
            mig += self._cache_effects(task, graph, layout)
            for aid in task.inputs:
                art = graph.artifacts[aid]
                if layout_moved(art.layout, layout):
                    mig += self._migration(art, layout)
                    self.migrated_bytes += art.nbytes
                    art.layout = layout      # artifact now lives here
        finish = now + self.dispatch_overhead + mig + dur
        c = Completion(pack_id, finish, dur)     # duration: step only
        heapq.heappush(self._heap, (finish, next(self._n), c))
        for task, graph in members:
            for aid in task.outputs:
                graph.artifacts[aid].layout = layout

    # ------------------------------------------------------------------
    def peek(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def poll(self) -> list[Completion]:
        if not self._heap:
            return []
        t, _, c = heapq.heappop(self._heap)
        out = [c]
        # batch events at identical timestamps
        while self._heap and self._heap[0][0] == t:
            out.append(heapq.heappop(self._heap)[2])
        return out
