"""Host-level failure injection + the plane's recovery contract
(DESIGN.md §13).

A production fleet loses whole hosts.  This module owns everything the
control plane needs to keep serving through that:

* :class:`HostDown` / :class:`HostUp` — scripted failure events, driven
  through the shared :class:`~repro.core.event_loop.EventLoop` on BOTH
  backends (the injector is a timed event source exactly like arrivals,
  so a failure script replays identically under the virtual and the wall
  clock — recovery decisions ride ``trace_signature``).
* :class:`FailureInjector` — a scripted or seeded-random event source.
  The random constructor pre-generates its whole kill script at build
  time from a deterministic LCG, so the script is a pure function of
  (topology, seed, knobs) and never of backend timing.
* :class:`SnapshotStore` — periodic denoise-state snapshots.  The plane
  captures the post-step latent every ``interval`` steps; on the thread
  backend the bytes write through :class:`~repro.training.checkpoint.
  CheckpointManager` (atomic two-phase commit), on the simulator only
  the step metadata is kept (the sim has no tensor data).  After a loss,
  a request resumes at its last snapshot step — not at step 0.
* the recovery procedure itself — :func:`host_down`, :func:`host_up`,
  :func:`repair_request` — applied in a fixed order so both backends
  observe the identical event sequence:

  1. mark the host's ranks dead (placement refuses them; they leave the
     free pool),
  2. drop Reallocate pins that touch the loss (their boundary would
     otherwise wait forever for dead ranks to free),
  3. invalidate §11 cache residencies whose warm rank-set intersects the
     loss,
  4. fail out in-flight tasks on dead ranks — pack members as a unit —
     via a ``failout`` drain (mirrors Preempt's boundary semantics: the
     in-flight device slice cannot be killed mid-step on either
     backend),
  5. dematerialize lost artifacts, restore the latest snapshot, and
     reset exactly the done tasks whose lost outputs are still needed
     (the rollback cascade stops at the restored artifact).

The blind baseline (``failure_recovery=False``) skips 4-5 and instead
fails every request touching the dead host — the behavior the chaos
benchmark gate measures recovery against.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.trajectory import Artifact, ExecutionLayout, RequestGraph

# ---------------------------------------------------------------------------
# failure events + injector
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HostDown:
    """Whole-host loss at time ``t``: every rank of ``host`` dies."""
    t: float
    host: int


@dataclass(frozen=True)
class HostUp:
    """Host ``host`` rejoins at time ``t`` (cold: no artifacts survive
    the outage — anything that lived there was already written off)."""
    t: float
    host: int


def _lcg(seed: int):
    """Deterministic, backend-independent RNG (same generator the
    workload traces use — a failure script must be a pure function of
    its seed)."""
    state = seed or 1

    def rand():
        nonlocal state
        state = (1103515245 * state + 12345) % (1 << 31)
        return state / (1 << 31)
    return rand


class FailureInjector:
    """Timed event source for host failures, drained by the event loop
    exactly like the arrival heap: ``next_time`` bounds the clock wait,
    ``pop_due`` releases events whose time has come."""

    def __init__(self, events=()):
        self.script: list = sorted(events, key=lambda e: e.t)
        self._i = 0

    # -- event-source protocol (mirrors the plane's arrival heap) ------
    def pending(self) -> bool:
        return self._i < len(self.script)

    def next_time(self) -> Optional[float]:
        return self.script[self._i].t if self.pending() else None

    def pop_due(self, now: float) -> list:
        out = []
        while self.pending() and self.script[self._i].t <= now:
            out.append(self.script[self._i])
            self._i += 1
        return out

    # ------------------------------------------------------------------
    @classmethod
    def random(cls, topology, *, duration: float, kills: int = 2,
               mttr: Optional[float] = None, seed: int = 1,
               t_start: float = 0.0,
               keep_alive: int = 1) -> "FailureInjector":
        """Seeded-random whole-host kill script.

        ``kills`` HostDown events land uniformly in ``[t_start,
        duration)``; each dead host rejoins ``mttr`` seconds later
        (``mttr=None``: it stays dead).  A kill that would leave fewer
        than ``keep_alive`` hosts alive is skipped — degraded-mode
        serving needs survivors to degrade onto.  The whole script is
        generated here, so two runs with the same arguments inject the
        identical failures regardless of backend or timing.
        """
        rand = _lcg(seed)
        times = sorted(t_start + rand() * max(duration - t_start, 0.0)
                       for _ in range(kills))
        events: list = []
        alive = set(range(topology.num_hosts))
        revivals: list[tuple[float, int]] = []      # (t_up, host)
        for t in times:
            for t_up, h in [r for r in revivals if r[0] <= t]:
                alive.add(h)
                revivals.remove((t_up, h))
            if len(alive) <= keep_alive:
                continue
            victims = sorted(alive)
            victim = victims[int(rand() * len(victims)) % len(victims)]
            alive.discard(victim)
            events.append(HostDown(t, victim))
            if mttr is not None:
                events.append(HostUp(t + mttr, victim))
                revivals.append((t + mttr, victim))
        return cls(events)


# ---------------------------------------------------------------------------
# denoise-state snapshots (training/checkpoint-backed replay)
# ---------------------------------------------------------------------------


class SnapshotStore:
    """Periodic denoise-state snapshots, one slot per request.

    The plane calls :meth:`capture` on every denoise completion whose
    step is :meth:`due`; the slot keeps the step, the output artifact
    id, and — on the thread backend — a defensive copy of the full
    latent (per-rank shards concatenated in layout order).  When a
    ``directory`` is configured the latent also writes through a
    per-request :class:`CheckpointManager` and :meth:`restore` reads the
    bytes back from disk, exercising the same two-phase-commit layout
    the training path trusts.
    """

    def __init__(self, interval: int, directory=None, keep: int = 2):
        assert interval >= 1
        self.interval = int(interval)
        self.directory = directory
        self.keep = keep
        # rid -> (step, artifact_id, payload | None); payload is None on
        # the simulator (metadata-only snapshots)
        self._mem: dict[str, tuple] = {}
        self._mgr: dict[str, object] = {}

    def due(self, step: int) -> bool:
        return step % self.interval == self.interval - 1

    # ------------------------------------------------------------------
    def _manager(self, rid: str):
        if rid not in self._mgr:
            # lazy import: the checkpoint module pulls in torch, which the
            # sim-only path must not pay for
            from pathlib import Path

            from repro_torch.training.checkpoint import CheckpointManager
            self._mgr[rid] = CheckpointManager(
                Path(self.directory) / rid, keep=self.keep)
        return self._mgr[rid]

    def capture(self, task, graph: RequestGraph,
                layout: ExecutionLayout) -> None:
        art = graph.artifacts[task.outputs[0]]
        payload = None
        if art.data is not None:
            import numpy as np
            try:
                parts = [art.data[r]["latent"] for r in layout.ranks]
                full = parts[0] if len(parts) == 1 \
                    else np.concatenate(parts, axis=0)
                payload = {"latent": np.array(full, copy=True),
                           "sigma": art.data[layout.ranks[0]].get("sigma")}
            except (KeyError, ValueError):
                payload = None          # non-latent output: metadata only
            if payload is not None and self.directory is not None:
                sigma = payload["sigma"]
                self._manager(task.request_id).save(
                    task.step_index, {"latent": payload["latent"]},
                    extra={"req": task.request_id,
                           "sigma": None if sigma is None
                           else float(sigma)})
        self._mem[task.request_id] = (task.step_index, art.id, payload)

    # ------------------------------------------------------------------
    def restore(self, plane, graph: RequestGraph,
                rid: str) -> Optional[int]:
        """Rematerialize the snapshot latent on the lowest alive rank
        (degree-1 layout: the next dispatch reshards it through the
        ordinary migration planner).  Returns the snapshot step, or None
        when there is nothing restorable."""
        rec = self._mem.get(rid)
        if rec is None:
            return None
        step, aid, payload = rec
        art = graph.artifacts[aid]
        if art.materialized:
            return None                 # nothing at/before the snapshot lost
        alive = sorted(set(range(plane.num_ranks)) - plane.dead_ranks)
        if not alive:
            return None
        leader = alive[0]
        latent, sigma = None, None
        if payload is not None:
            import numpy as np
            latent, sigma = payload["latent"], payload["sigma"]
            if self.directory is not None:
                tree, _ = self._manager(rid).restore(
                    {"latent": np.zeros_like(latent)}, step=step)
                latent = tree["latent"]
        art.layout = ExecutionLayout((leader,))
        art.materialized = True
        art.data = None
        if latent is not None:
            import numpy as np
            art.data = {leader: {"latent": np.array(latent, copy=True),
                                 "sigma": sigma}}
        return step

    def drop(self, rid: str) -> None:
        self._mem.pop(rid, None)
        self._mgr.pop(rid, None)


# ---------------------------------------------------------------------------
# artifact loss rules
# ---------------------------------------------------------------------------


def artifact_lost(art: Artifact, dead: set) -> bool:
    """Whether `art` is unrecoverable after `dead` ranks are lost.

    A sharded field loses a shard if ANY layout rank died; a
    replicated-only artifact survives while one layout rank lives (its
    layout is shrunk to the survivors by :func:`shrink_replicated`)."""
    if not art.materialized or art.layout is None:
        return False
    ranks = set(art.layout.ranks)
    if not (ranks & dead):
        return False
    kinds = {f.kind for f in art.fields.values()} - {"meta"}
    if not kinds or "sharded" in kinds:
        return True
    return ranks <= dead


def shrink_replicated(art: Artifact, dead: set) -> None:
    """A partially-dead replicated artifact keeps its surviving copies;
    the layout must shrink so later migrations never read a dead rank."""
    if not art.materialized or art.layout is None:
        return
    ranks = set(art.layout.ranks)
    if not (ranks & dead) or ranks <= dead:
        return
    kinds = {f.kind for f in art.fields.values()} - {"meta"}
    if not kinds or "sharded" in kinds:
        return
    survivors = tuple(r for r in art.layout.ranks if r not in dead)
    art.layout = ExecutionLayout(survivors, parallel=art.layout.parallel)
    if art.data is not None:
        for r in list(art.data):
            if r in dead:
                art.data.pop(r)


# ---------------------------------------------------------------------------
# the recovery procedure
# ---------------------------------------------------------------------------


def apply_failure(plane, ev) -> None:
    if isinstance(ev, HostDown):
        host_down(plane, ev.host)
    elif isinstance(ev, HostUp):
        host_up(plane, ev.host)


def host_down(plane, host: int) -> None:
    if host in plane.dead_hosts:
        return
    ranks = set(plane.topology.host_ranks(host))
    plane.dead_hosts.add(host)
    plane.dead_ranks |= ranks
    plane.free_ranks -= ranks
    plane.events.append({"t": plane.now, "ev": "host_down", "host": host,
                         "ranks": sorted(ranks)})
    if plane.telemetry is not None:
        plane.telemetry.ranks_dead(plane.now, ranks)
        plane.telemetry.counter("host_down")
    # 2. pins whose boundary would wait forever on dead ranks
    for rid in sorted(plane.pinned):
        if set(plane.pinned[rid].ranks) & ranks:
            plane.pinned.pop(rid)
    # 3. warm cache residencies intersecting the loss (DESIGN.md §11)
    plane.cache.invalidate_ranks(ranks, "host-down")
    # 4. fail out in-flight work on dead ranks (packs as a unit); the
    # device slice drains to its boundary — outputs are discarded there
    # and repair runs once the drain completes (the wall backend's
    # worker threads may still be reading the request's artifacts)
    touched: set[str] = set()
    for tid in sorted(plane.running):
        task, lay = plane.running[tid]
        if not (set(lay.ranks) & ranks):
            continue
        pack_id = plane._pack_of.get(tid)
        victims = (plane.packs[pack_id]["members"] if pack_id
                   else (tid,))
        for vid in victims:
            if vid not in plane.running:
                continue
            vtask, vlay = plane.running[vid]
            touched.add(vtask.request_id)
            prior = plane.preempting.get(vid)
            if prior == "drop" or prior == "failout":
                continue        # cancelled, or a sibling already marked us
            plane.pinned.pop(vtask.request_id, None)
            plane.cache.invalidate(vtask.request_id, "host-down")
            # an in-flight Preempt drain upgrades to failout: its inputs
            # sit on the dead layout and need repair after the drain
            plane.preempting[vid] = ("failout" if plane.failure_recovery
                                     else "drop")
            ev = {"t": plane.now, "ev": "failout", "task": vid,
                  "req": vtask.request_id, "kind": vtask.kind,
                  "step": vtask.step_index, "ranks": list(vlay.ranks)}
            if pack_id:
                ev["pack"] = pack_id
            plane.events.append(ev)
            if not plane.failure_recovery:
                plane._fail_request(vtask.request_id, "host-down")
    # 5. repair requests with no drain in flight right now; drained ones
    # repair at their failout completion (same sequence point on both
    # backends: the drain completion is a traced event)
    for rid in sorted(plane.released):
        req = plane.requests[rid]
        if req.failed or req.done_time is not None or rid in touched:
            continue
        repair_request(plane, rid)


def host_up(plane, host: int) -> None:
    if host not in plane.dead_hosts:
        return
    ranks = set(plane.topology.host_ranks(host))
    plane.dead_hosts.discard(host)
    plane.dead_ranks -= ranks
    # a revived rank re-enters the free pool unless a (stale, draining)
    # dispatch still holds it — those return at their drain completion
    held: set[int] = set()
    for _, lay in plane.running.values():
        held |= set(lay.ranks)
    plane.free_ranks |= ranks - held
    plane.events.append({"t": plane.now, "ev": "host_up", "host": host,
                         "ranks": sorted(ranks)})
    if plane.telemetry is not None:
        # held ranks (a stale dispatch still draining) go idle at their
        # drain completion, like any other completion-freed rank
        plane.telemetry.ranks_idle(plane.now, ranks - held)
        plane.telemetry.counter("host_up")


def repair_request(plane, rid: str) -> bool:
    """Write off lost artifacts and roll the request back to its last
    restorable point.  Returns True when anything was lost.

    Loss rule first (sharded: any dead rank; replicated: all dead),
    then snapshot restore, then the reset cascade: a done task resets to
    pending iff one of its outputs is unmaterialized AND still needed by
    a non-done task — so the cascade stops exactly at the restored
    snapshot artifact, and the request resumes at its last snapshot
    step, not step 0."""
    graph = plane.graphs[rid]
    lost = []
    for art in graph.artifacts.values():
        if artifact_lost(art, plane.dead_ranks):
            art.materialized = False
            art.layout = None
            art.data = None
            lost.append(art.id)
        else:
            shrink_replicated(art, plane.dead_ranks)
    if not lost or not _progress_blocked(graph):
        # either nothing died here, or only stale copies did (inputs of
        # already-done tasks left behind on an old layout): the request's
        # remaining work is untouched
        return False
    if not plane.failure_recovery:
        plane._fail_request(rid, "host-down")
        return True
    restored = None
    if plane.snapshots is not None:
        restored = plane.snapshots.restore(plane, graph, rid)
    # reset cascade to a consistent fixpoint
    changed = True
    while changed:
        changed = False
        needed: set[str] = set()
        for t in graph.tasks.values():
            if t.state != "done":
                needed.update(t.inputs)
        for t in graph.tasks.values():
            if t.state != "done":
                continue
            if any(aid in needed and not graph.artifacts[aid].materialized
                   for aid in t.outputs):
                t.state = "pending"
                t.layout = None
                t.complete_time = -1.0
                for aid in t.outputs:
                    a = graph.artifacts[aid]
                    if a.materialized:
                        a.materialized = False
                        a.layout = None
                        a.data = None
                changed = True
    resume = min((t.step_index for t in graph.tasks.values()
                  if t.kind == "denoise" and t.state != "done"),
                 default=-1)
    plane.events.append({"t": plane.now, "ev": "rollback", "req": rid,
                         "step": resume,
                         "snapshot": -1 if restored is None else restored,
                         "lost": sorted(lost)})
    if plane.telemetry is not None:
        # artifact ids are a process-global counter (not run-stable), so
        # the identity projection keeps the count and drops the list
        plane.telemetry.request_event(
            plane.now, rid, "rollback", step=resume,
            snapshot=-1 if restored is None else restored,
            n_lost=len(lost), lost=sorted(lost))
    return True


def _progress_blocked(graph: RequestGraph) -> bool:
    """A non-done task needs an unmaterialized artifact whose producer
    already ran: the dependency can never re-materialize on its own."""
    producer: dict[str, object] = {}
    for t in graph.tasks.values():
        for aid in t.outputs:
            producer[aid] = t
    for t in graph.tasks.values():
        if t.state == "done":
            continue
        for aid in t.inputs:
            if graph.artifacts[aid].materialized:
                continue
            prod = producer.get(aid)
            if prod is not None and prod.state == "done":
                return True
    return False
