"""Cross-step feature cache (DESIGN.md §11; paper §7 future work).

DiT denoise steps are temporally redundant: the keys/values a rank
gathers from its peers at step *s-1* are a usable stand-in for a fresh
all-gather at step *s* (xDiT-style displaced/stale activation reuse).
This module owns the cache **contract** — storage layout, the
hit/refresh policy, and the invalidation rules — as a first-class,
schedulable, migratable resource:

* **storage** — one ``kv_cache`` artifact per request (created by the
  converter) holding, per rank, the per-layer gathered K/V from the
  last *refresh* step.  Every rank's copy is the bit-identical snapshot
  of that gather (``replicated`` fields), which is what makes the cache
  migratable through the ordinary layout-aware migration planner.
* **hit/refresh policy** — a denoise step at the cache's layout within
  ``interval`` steps of the last refresh is a **hit**: the executor
  splices its fresh local K/V shard into the cached remote shards and
  skips the GFC all-gather entirely.  At ``interval`` steps (or with no
  valid entry) the step is a **refresh**: the full gather runs and the
  snapshot is rewritten.  ``interval=1`` refreshes every step — the
  cached runtime path with bit-exact outputs.
* **invalidation** — residency clears on ``Preempt``/``Cancel``/worker
  failure and on any parallel-degree change; a same-degree rank-set
  change (``Reallocate``) *migrates* the warm cache instead, when the
  staleness window is still open.

The control plane stamps every denoise dispatch with the decision
(``task.meta["cache"]``), so the simulator, the thread backend, and the
cost model all act on the SAME plane-made call — cross-backend trace
identity holds with caching on (serving/cache_demo.py).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np

from repro_torch.core.trajectory import ExecutionLayout, RequestGraph, TrajectoryTask

#: artifact role owned by this subsystem (core/trajectory.py role set)
CACHE_ROLE = "kv_cache"


def cache_artifact(graph: RequestGraph):
    """The request's ``kv_cache`` artifact (None on pre-cache graphs)."""
    for a in graph.artifacts.values():
        if a.role == CACHE_ROLE:
            return a
    return None


def snapshot_kv(stores: list, layer: int) -> tuple[np.ndarray, np.ndarray]:
    """Stack the per-member stale K/V snapshots for ``layer`` into fresh
    (B, N_total, H, hd) arrays — the §11 hit path's batched view of the
    storage layout this module owns.  ``np.stack`` copies, so executors
    may splice rows in place (the jnp path) or hand the arrays to the
    fused splice kernel untouched (the Pallas path, DESIGN.md §12)."""
    K = np.stack([s[f"k{layer}"] for s in stores])
    V = np.stack([s[f"v{layer}"] for s in stores])
    return K, V


@dataclass(frozen=True)
class CacheEntry:
    """Plane-side residency record of one request's warm cache."""
    request_id: str
    artifact_id: str
    layout: ExecutionLayout         # layout the snapshot was gathered under
    refresh_step: int               # denoise step of the last full gather

    def staleness(self, step: int) -> int:
        return step - self.refresh_step


class FeatureCachePlane:
    """Control-plane residency tracker + per-dispatch decision stamper.

    ``interval=None`` disables the subsystem entirely (no stamps, no
    storage — byte-identical to the pre-cache runtime).  ``interval=1``
    keeps the cached execution path but refreshes every step (bit-exact
    outputs); ``interval>1`` reuses stale remote shards for up to
    ``interval-1`` steps between refreshes.
    """

    def __init__(self, interval: Optional[int] = None,
                 emit: Optional[Callable[[dict], None]] = None):
        assert interval is None or interval >= 1
        self._interval = interval
        self._emit = emit
        self.entries: dict[str, CacheEntry] = {}
        # telemetry counters (DESIGN.md §15); the owning ControlPlane
        # shares its instance.  Counters only — the stamp decisions
        # themselves ride the plane's dispatch decision records.
        self.telemetry = None

    # ------------------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._interval is not None

    @property
    def interval(self) -> int:
        """Effective staleness window (1 when disabled: no reuse)."""
        return self._interval if self.enabled else 1

    def residency_view(self) -> dict[str, CacheEntry]:
        """Read-only residency snapshot for :class:`SchedulerView`."""
        return dict(self.entries)

    # ------------------------------------------------------------------
    def invalidate(self, request_id: str, reason: str):
        """Drop residency (Preempt/Cancel/failure/degree change/done).
        The artifact's bytes may linger rank-side, but nothing reads
        them without a plane-stamped hit, and the next refresh
        overwrites them."""
        if self.entries.pop(request_id, None) is not None:
            if self.telemetry is not None:
                self.telemetry.counter(f"cache_invalidate.{reason}")
            if self._emit:
                self._emit({"ev": "cache_invalidate", "req": request_id,
                            "why": reason})

    def invalidate_ranks(self, ranks, reason: str):
        """Drop every residency whose warm rank-set intersects ``ranks``
        (DESIGN.md §13): a snapshot replicated across a partially-dead
        rank set is unreadable as a unit — a hit at the old layout would
        dispatch onto a dead rank, and the migration planner may pick a
        dead source."""
        dead = set(ranks)
        for rid in sorted(self.entries):
            if set(self.entries[rid].layout.ranks) & dead:
                self.invalidate(rid, reason)

    # ------------------------------------------------------------------
    def _plan(self, task: TrajectoryTask, layout: ExecutionLayout,
              graph: RequestGraph):
        """PURE decision for one member — reads residency, mutates
        nothing (safe for speculative "would this layout hit?" probes).

        Returns ``None`` when this dispatch can never participate
        (disabled, non-denoise, or a pre-cache graph), else
        ``(mode, migrate, artifact_id, stale_reason)`` where ``mode`` is
        ``"hit"`` / ``"refresh"`` / ``None`` (degree-1 bypass) and
        ``stale_reason``, when set, names why the existing residency
        entry must be invalidated if this plan is committed."""
        if not self.enabled or task.kind != "denoise":
            return None
        art = cache_artifact(graph)
        if art is None:
            return None
        ent = self.entries.get(task.request_id)
        if getattr(graph.request, "guidance", None) is not None or \
                getattr(layout, "cfg", 1) > 1:
            # guided steps bypass the cache (DESIGN.md §14): the batched
            # path gathers B=2 branch-specific KV, and split branches
            # gather DIFFERENT bytes per branch — neither fits the
            # one-replicated-snapshot storage contract.  Any residency a
            # request built before turning guided (or before a reshape
            # onto a cfg layout) invalidates with a cfg-change reason.
            return (None, False, art.id,
                    "cfg-change" if ent is not None else None)
        if layout.degree == 1:
            # no remote shards to reuse; a degree change kills residency
            return (None, False, art.id,
                    "degree-change" if ent is not None else None)
        stale_reason = None
        if ent is not None and ent.layout.degree != layout.degree:
            stale_reason, ent = "degree-change", None
        if ent is not None and getattr(ent.layout, "cfg", 1) != \
                getattr(layout, "cfg", 1):
            stale_reason, ent = "cfg-change", None
        migrate = False
        if ent is not None:
            stale = ent.staleness(task.step_index)
            if stale <= 0 or stale >= self.interval:
                mode = "refresh"        # window expired (or odd requeue)
            else:
                mode = "hit"
                # same degree, different rank set: the warm snapshot
                # moves through the ordinary migration planner
                migrate = ent.layout.ranks != layout.ranks
        else:
            mode = "refresh"
        return mode, migrate, art.id, stale_reason

    def _commit(self, task: TrajectoryTask, layout: ExecutionLayout,
                plan) -> Optional[dict]:
        if plan is None:
            task.meta.pop("cache", None)
            return None
        mode, migrate, aid, stale_reason = plan
        rid = task.request_id
        if stale_reason is not None:
            self.invalidate(rid, stale_reason)
        if mode is None:
            task.meta.pop("cache", None)
            return None
        if mode == "refresh":
            self.entries[rid] = CacheEntry(rid, aid, layout,
                                           task.step_index)
        elif migrate:
            self.entries[rid] = replace(self.entries[rid], layout=layout)
        stamp = {"mode": mode, "migrate": migrate, "art": aid}
        task.meta["cache"] = stamp
        if self.telemetry is not None:
            self.telemetry.counter(
                f"cache_{mode}" + ("_mig" if migrate else ""))
        return stamp

    # ------------------------------------------------------------------
    def stamp(self, task: TrajectoryTask, layout: ExecutionLayout,
              graph: RequestGraph) -> Optional[dict]:
        """Decide and record this dispatch's cache behavior; writes
        ``task.meta["cache"]`` (or clears a stale stamp) and updates
        residency.  Called by the control plane on EVERY solo dispatch
        before the backend sees the task."""
        return self._commit(task, layout, self._plan(task, layout, graph))

    def stamp_pack(self, members, layout: ExecutionLayout) -> Optional[str]:
        """Pack-level decision (DESIGN.md §9 x §11): the batched forward
        runs ONE set of collectives, so the pack hits only when EVERY
        member hits — any member needing a refresh forces a full gather,
        which then refreshes every member's snapshot for free.  Returns
        the shared mode (None when caching is off for this pack)."""
        plans = [self._plan(t, layout, g) for t, g in members]
        if any(p is None or p[0] is None for p in plans):
            for (t, _), p in zip(members, plans):
                self._commit(t, layout, p)     # clears stamps/residency
            return None
        if any(p[0] == "refresh" for p in plans):
            # the gather covers the whole batch: refresh everyone, and
            # drop now-pointless migrations (the snapshot is rewritten)
            plans = [("refresh", False, p[2], p[3]) for p in plans]
        for (t, _), p in zip(members, plans):
            self._commit(t, layout, p)
        return plans[0][0]
