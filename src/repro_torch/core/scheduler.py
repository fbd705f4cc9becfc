"""Event-driven control plane (paper §5.1, DESIGN.md §3/§6).

The control plane owns request admission, trajectory task graphs,
dependency state, artifact metadata, resource availability, and policy
invocation.  Execution backends (simulator | thread workers) share this
scheduler verbatim — the paper's key claim that the simulator is "an
alternative execution backend for the same trajectory abstraction".

Policies speak a four-verb *action vocabulary* (DESIGN.md §3) instead of
a single placement decision, making GPU parallelism a first-class
schedulable resource:

* :class:`Dispatch`   — place a ready task on free ranks (the classic
  decision; ``Decision`` remains as an alias);
* :class:`Reallocate` — change a *running* request's rank set.  Takes
  effect at the next trajectory boundary: the control plane pins the
  layout and dispatches the request's next denoise task itself, and the
  backend's layout-aware migration moves artifacts automatically;
* :class:`Preempt`    — evict a running task.  The in-flight slice is
  discarded at its device boundary (a kernel cannot be killed mid-step on
  either backend), the ranks free, and the task requeues with its input
  artifacts intact;
* :class:`Cancel`     — abort a request; running tasks drain and their
  outputs are discarded;
* :class:`PackedDispatch` — co-schedule a *pack* of batch-compatible
  denoise tasks (same model, same token shape, one shared layout) from
  different requests as ONE executor call (DESIGN.md §9).  The control
  plane validates compatibility, the backend runs the stacked batch, and
  the single pack completion fans out into per-task completions here.
  Preempting any member evicts the whole pack (the batched call is one
  device slice); every member requeues with inputs intact.

Dispatch completion is separated from device completion: `dispatch()`
returns after CPU-side preparation; the backend reports device completion
events asynchronously, at which point artifacts materialize, resources
free, and the policy is re-invoked (also after every preempt-requeue and
reallocation boundary — the EventLoop calls ``schedule_point`` after each
event batch).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Optional, Union

from repro_torch.core import failures as failure_domain
from repro_torch.core.cost_model import CostModel
from repro_torch.core.event_loop import EventLoop, VirtualClock
from repro_torch.core.migration import layout_moved
from repro_torch.core.trajectory import (ClusterTopology, ExecutionLayout,
                                   Request, RequestGraph, TrajectoryTask,
                                   as_topology)
from repro_torch.diffusion.feature_cache import CacheEntry, FeatureCachePlane


@dataclass
class Completion:
    task_id: str
    finish_time: float
    duration: float
    failed_ranks: tuple[int, ...] = ()
    seq: int = 0                    # dispatch sequence (stale-event guard)


# ---------------------------------------------------------------------------
# Action vocabulary (DESIGN.md §3)
# ---------------------------------------------------------------------------

@dataclass
class Dispatch:
    """Place a ready task on currently-free ranks."""
    task_id: str
    layout: ExecutionLayout


#: Legacy name for :class:`Dispatch` (pre-action-vocabulary API).
Decision = Dispatch


@dataclass
class Reallocate:
    """Pin a request to a new rank set from its next trajectory boundary
    onward; artifact migration to the new layout happens automatically."""
    request_id: str
    new_layout: ExecutionLayout


@dataclass
class Preempt:
    """Requeue a running task (inputs intact, in-flight slice discarded
    at its device boundary)."""
    task_id: str


@dataclass
class Cancel:
    """Abort a request: pending work is dropped, running work drains."""
    request_id: str


@dataclass
class PackedDispatch:
    """Co-schedule batch-compatible denoise tasks from different requests
    onto one rank set as a single batched executor call (DESIGN.md §9)."""
    task_ids: tuple[str, ...]
    layout: ExecutionLayout


Action = Union[Dispatch, Reallocate, Preempt, Cancel, PackedDispatch]


def pack_signature(task: TrajectoryTask, request: Request) -> tuple:
    """Batch-compatibility key (DESIGN.md §9): tasks may share one
    executor call only when stacking their latents is shape-safe — same
    model and the same exact token count (the per-rank shards of every
    member must match elementwise, so the "shape bucket" here is the
    exact count, a refinement of the cost model's power-of-two bucket).
    The parallel degree is shared by construction: a pack has ONE layout.
    Guided requests (DESIGN.md §14) carry their guidance scale in the
    signature, so they never co-batch with unguided work (the batched
    call would need per-member merge semantics the executor does not
    stack); unguided signatures are unchanged.
    """
    sig = (request.model, task.meta.get("tokens", 4096))
    if getattr(request, "guidance", None) is not None:
        sig += (request.guidance,)
    return sig


@dataclass
class SchedulerView:
    """What a policy is allowed to observe (paper §3.2)."""
    now: float
    ready: list[tuple[TrajectoryTask, Request, RequestGraph]]
    free_ranks: list[int]
    num_ranks: int
    cost: CostModel
    running: dict[str, tuple[TrajectoryTask, ExecutionLayout]]
    # elastic-action context
    requests: dict[str, Request] = field(default_factory=dict)
    graphs: dict[str, RequestGraph] = field(default_factory=dict)
    pinned: dict[str, ExecutionLayout] = field(default_factory=dict)
    preempting: frozenset = frozenset()
    # cluster topology (DESIGN.md §10); None only when a view is built
    # by hand in tests — the control plane always supplies one
    topology: Optional[ClusterTopology] = None
    # feature-cache residency (DESIGN.md §11): request id -> warm-cache
    # entry; interval 1 means caching is off (no stale reuse)
    cache_residency: dict[str, CacheEntry] = field(default_factory=dict)
    cache_interval: int = 1
    # failure domains (DESIGN.md §13): ranks on hosts currently down.
    # `free_ranks` already excludes them; policies sizing layouts against
    # the machine should use `num_alive`, not `num_ranks`.
    dead_ranks: frozenset = frozenset()
    # telemetry plane (DESIGN.md §15): policies stage decision
    # explanations here (`view.telemetry.stage(...)`); None when
    # telemetry is disabled — policies must guard on it
    telemetry: Optional[object] = None
    # live SLO monitor alerts (DESIGN.md §16): structured alert records
    # emitted by attached burn-rate/goodput monitors, newest last.
    # READ-ONLY this PR — policies may observe them (e.g. stage them in
    # an explanation) but acting on them belongs to the admission-
    # control arc (ROADMAP); no shipped policy branches on this field,
    # which keeps traces byte-identical with monitors attached.
    alerts: tuple = ()

    @property
    def num_alive(self) -> int:
        return self.num_ranks - len(self.dead_ranks)

    @property
    def free_by_host(self) -> dict[int, list[int]]:
        """Per-host free-rank view (sorted within each host)."""
        topo = self.topology or ClusterTopology.single_host(self.num_ranks)
        out: dict[int, list[int]] = {}
        for r in sorted(self.free_ranks):
            out.setdefault(topo.host_of(r), []).append(r)
        return out


class Policy:
    name = "base"

    def schedule(self, view: SchedulerView) -> list[Action]:
        raise NotImplementedError


class ControlPlane:
    #: structured task failures (GFC collective timeouts surfaced as
    #: ``failed_ranks`` completions) tolerated before the request fails
    max_task_failures = 3

    def __init__(self, topology=None, policy: Policy = None,
                 cost: CostModel = None, backend=None, *,
                 dispatch_overhead: float = 0.0, num_ranks=None,
                 cache_interval: Optional[int] = None,
                 injector=None, snapshot_interval: Optional[int] = None,
                 snapshot_dir=None, failure_recovery: bool = True,
                 telemetry=None):
        # `topology` accepts a ClusterTopology or a bare rank count
        # (back-compat shim: ControlPlane(num_ranks=N) — positional or
        # keyword — synthesizes a one-host topology with identical
        # behavior, DESIGN.md §10)
        if topology is None:
            topology = num_ranks
        assert topology is not None, "topology (or num_ranks=) required"
        self.topology = as_topology(topology)
        self.num_ranks = self.topology.num_ranks
        self.policy = policy
        self.cost = cost
        # the plane's topology governs pricing: a cost model reused
        # across planes must not keep a previous plane's topology
        cost.topology = self.topology
        self.backend = backend
        self.dispatch_overhead = dispatch_overhead
        self.graphs: dict[str, RequestGraph] = {}
        self.requests: dict[str, Request] = {}
        # active set for _view(): RELEASED requests not yet done/failed/
        # cancelled, in (arrival, submit) order (dict preserves
        # insertion; the arrivals heap breaks ties by submit sequence).
        # Scanning all graphs ever submitted per schedule point is
        # O(total requests) — quadratic over an open-loop run where the
        # whole trace is submitted upfront (benchmarks/telemetry_scale.py
        # streams ~2e4 requests through one plane).
        self._unfinished: dict[str, None] = {}
        self.running: dict[str, tuple[TrajectoryTask, ExecutionLayout]] = {}
        self.free_ranks: set[int] = set(range(self.num_ranks))
        self.now = 0.0
        self.events: list[dict] = []        # trace for benchmarks
        # elastic state
        self.pinned: dict[str, ExecutionLayout] = {}
        self.preempting: dict[str, str] = {}    # task_id -> requeue|drop
        # step packing (DESIGN.md §9)
        self.packs: dict[str, dict] = {}        # pack_id -> record
        self._pack_of: dict[str, str] = {}      # member task_id -> pack_id
        self._pack_seq = itertools.count()
        # pending (not yet released) arrivals
        self._arrivals: list[tuple[float, int, str]] = []
        self._sub_seq = itertools.count()
        self.released: set[str] = set()
        # cross-step feature cache residency (DESIGN.md §11); None
        # disables the subsystem (byte-identical pre-cache behavior)
        self.cache = FeatureCachePlane(cache_interval,
                                       emit=self._cache_event)
        # failure domains (DESIGN.md §13): an optional scripted/seeded
        # injector drives HostDown/HostUp through the event loop; the
        # plane tracks dead ranks, fails out in-flight work on them, and
        # (failure_recovery=True) repairs survivors via periodic
        # denoise-state snapshots.  failure_recovery=False is the blind
        # baseline: any request touching a dead host fails.
        self.injector = injector
        self.failure_recovery = failure_recovery
        self.dead_ranks: set[int] = set()
        self.dead_hosts: set[int] = set()
        self.snapshots = (failure_domain.SnapshotStore(
            snapshot_interval, snapshot_dir)
            if snapshot_interval else None)
        # telemetry plane (DESIGN.md §15): None disables every
        # instrument — the decision trace (`self.events`) is never
        # touched by telemetry, so signatures are byte-identical either
        # way.  The cache plane shares the same instance for counters.
        self.telemetry = telemetry
        self.cache.telemetry = telemetry
        if telemetry is not None:
            telemetry.attach(self.num_ranks, self.topology)
        backend.attach(self)

    def _cache_event(self, rec: dict):
        rec["t"] = self.now
        self.events.append(rec)

    # ------------------------------------------------------------------
    def submit(self, request: Request, graph: RequestGraph):
        self.requests[request.id] = request
        self.graphs[request.id] = graph
        if request.arrival <= self.now:
            self._release(request)
        else:
            heapq.heappush(self._arrivals,
                           (request.arrival, next(self._sub_seq),
                            request.id))

    def _release(self, request: Request):
        self.released.add(request.id)
        if not request.failed:      # cancelled-before-arrival stays out
            self._unfinished[request.id] = None
        self.events.append({"t": self.now, "ev": "arrival",
                            "req": request.id})
        if self.telemetry is not None:
            self.telemetry.request_event(self.now, request.id, "queued")

    def release_arrivals(self):
        """Admit every submitted request whose arrival has come due."""
        while self._arrivals and self._arrivals[0][0] <= self.now:
            _, _, rid = heapq.heappop(self._arrivals)
            self._release(self.requests[rid])

    def next_arrival(self) -> Optional[float]:
        return self._arrivals[0][0] if self._arrivals else None

    def release_failures(self):
        """Apply every injected failure event that has come due — the
        failure script is a timed event source exactly like arrivals, so
        both backends process it at the same loop positions."""
        if self.injector is None:
            return
        for ev in self.injector.pop_due(self.now):
            failure_domain.apply_failure(self, ev)

    def next_timed(self) -> Optional[float]:
        """Earliest pending timed event (arrival or injected failure):
        the clock must not sleep/jump past either."""
        na = self.next_arrival()
        nf = self.injector.next_time() if self.injector else None
        if na is None:
            return nf
        if nf is None:
            return na
        return min(na, nf)

    def quiescent(self) -> bool:
        """No event can ever fire again: nothing running on the backend,
        no future arrival (completions only come from running), and no
        pending failure event that could unblock unfinished work (e.g. a
        HostUp restoring capacity).  Leftover failure events with no
        unfinished request are irrelevant and do not hold the loop open."""
        if self.running or self._arrivals:
            return False
        if self.injector is not None and self.injector.pending() and any(
                req.done_time is None and not req.failed
                for rid, req in self.requests.items()
                if rid in self.released):
            return False
        return True

    # ------------------------------------------------------------------
    def _view(self) -> SchedulerView:
        ready = []
        # iterate the released-unfinished active set, not all graphs
        # ever submitted — same contents (done/failed/cancelled requests
        # never yield ready tasks; unreleased ones are filtered out) and
        # the same order for arrival-sorted submission
        for rid in self._unfinished:
            req = self.requests[rid]
            if req.failed:
                continue
            g = self.graphs[rid]
            for t in g.ready_tasks():
                ready.append((t, req, g))
        tel = self.telemetry
        return SchedulerView(now=self.now, ready=ready,
                             free_ranks=sorted(self.free_ranks),
                             num_ranks=self.num_ranks, cost=self.cost,
                             running=dict(self.running),
                             requests=self.requests, graphs=self.graphs,
                             pinned=dict(self.pinned),
                             preempting=frozenset(self.preempting),
                             topology=self.topology,
                             cache_residency=self.cache.residency_view(),
                             cache_interval=self.cache.interval,
                             dead_ranks=frozenset(self.dead_ranks),
                             telemetry=tel,
                             alerts=(tuple(tel.alerts)
                                     if tel is not None else ()))

    # ------------------------------------------------------------------
    # action application (validated; invalid actions are skipped)
    # ------------------------------------------------------------------

    def _ranks_ok(self, layout: ExecutionLayout) -> bool:
        return all(0 <= r < self.num_ranks and r not in self.dead_ranks
                   for r in layout.ranks)

    @staticmethod
    def _shape_ok(layout: ExecutionLayout, req: Request) -> bool:
        """A CFG-split shape (DESIGN.md §14) is valid only for a guided
        request and only at cfg=2 — the two guidance branches are cond
        and uncond; there is no third."""
        cfg = getattr(layout, "cfg", 1)
        if cfg == 1:
            return True
        return cfg == 2 and getattr(req, "guidance", None) is not None

    def _mark_running(self, task: TrajectoryTask, layout: ExecutionLayout,
                      extra_ev: Optional[dict] = None,
                      graph: Optional[RequestGraph] = None) -> int:
        """Shared dispatch bookkeeping (solo and packed): task state,
        dispatch-sequence bump, running registry, trace event.  Returns
        the dispatch sequence number of THIS dispatch."""
        task.state = "running"
        task.layout = layout
        task.dispatch_time = self.now
        task.meta["_seq"] = task.meta.get("_seq", 0) + 1
        self.running[task.id] = (task, layout)
        ev = {"t": self.now, "ev": "dispatch", "task": task.id,
              "req": task.request_id, "kind": task.kind,
              "step": task.step_index, "ranks": list(layout.ranks)}
        if getattr(layout, "cfg", 1) > 1:
            # shape dimension in the decision trace (DESIGN.md §14);
            # scalar layouts emit the historic event, byte-identical
            ev["cfg"] = layout.cfg
        stamp = task.meta.get("cache")
        if stamp is not None:
            # the plane-made cache decision is part of the decision
            # trace: both backends must make (and price) the same call
            ev["cache"] = stamp["mode"] + \
                ("+mig" if stamp["migrate"] else "")
        if extra_ev:
            ev.update(extra_ev)
        self.events.append(ev)
        tel = self.telemetry
        if tel is not None:
            # migrating marker (DESIGN.md §15): "this dispatch moves
            # input bytes" is a pure function of plane state BEFORE the
            # backend runs, so both backends mark the same transitions
            # (actual durations live in the wall overlay stream)
            mig = bool(stamp and stamp.get("migrate")) or (
                graph is not None and any(
                    layout_moved(graph.artifacts[aid].layout, layout)
                    for aid in task.inputs))
            tel.record_action("dispatch", ev, key=task.id, migrating=mig)
            tel.request_event(self.now, task.request_id, "step_start",
                              kind=task.kind, step=task.step_index,
                              ranks=tuple(layout.ranks),
                              cfg=getattr(layout, "cfg", 1),
                              cache=ev.get("cache"))
            for r in layout.ranks:
                if mig:
                    tel.rank_state(self.now, r, "migrating",
                                   req=task.request_id)
                tel.rank_state(self.now, r, "busy", req=task.request_id,
                               kind=task.kind, step=task.step_index,
                               pack=ev.get("pack"))
        return task.meta["_seq"]

    def _dispatch(self, task: TrajectoryTask, layout: ExecutionLayout,
                  graph: RequestGraph, *, via_pin: bool = False):
        # stamp the feature-cache decision (DESIGN.md §11) BEFORE the
        # backend sees the task: both backends act on the plane's call
        self.cache.stamp(task, layout, graph)
        self._mark_running(task, layout,
                           {"realloc": True} if via_pin else None,
                           graph=graph)
        self.free_ranks -= set(layout.ranks)
        self.backend.dispatch(task, layout, graph, self.now)

    def _apply_dispatch(self, d: Dispatch, view: SchedulerView) -> bool:
        if d.task_id in self.running:
            return False
        if not self._ranks_ok(d.layout) or \
                any(r not in self.free_ranks for r in d.layout.ranks):
            return False
        for t, req, g in view.ready:
            if t.id == d.task_id:
                if t.state != "pending":
                    return False
                if not self._shape_ok(d.layout, req):
                    return False
                # an explicit placement overrides and clears a pin
                self.pinned.pop(req.id, None)
                self._dispatch(t, d.layout, g)
                return True
        return False

    def _apply_packed(self, a: PackedDispatch, view: SchedulerView) -> bool:
        """Validate and co-dispatch a pack (DESIGN.md §9): members must be
        ready denoise tasks from DISTINCT requests sharing one
        :func:`pack_signature`; the shared layout must be free.  A pack of
        one degenerates to a plain dispatch."""
        ids = tuple(a.task_ids)
        if not ids or len(set(ids)) != len(ids):
            return False
        if any(tid in self.running for tid in ids):
            return False
        if not self._ranks_ok(a.layout) or \
                any(r not in self.free_ranks for r in a.layout.ranks):
            return False
        if getattr(a.layout, "cfg", 1) > 1:
            return False            # packs refuse CFG shapes (§14)
        by_id = {t.id: (t, req, g) for t, req, g in view.ready}
        members = []
        for tid in ids:
            if tid not in by_id:
                return False
            t, req, g = by_id[tid]
            if t.state != "pending" or t.kind != "denoise":
                return False
            if getattr(req, "guidance", None) is not None:
                return False        # guided steps never pack (§14)
            members.append((t, req, g))
        sigs = {pack_signature(t, req) for t, req, _ in members}
        if len(sigs) != 1:
            return False                # mixed models or token shapes
        rids = [req.id for _, req, _ in members]
        if len(set(rids)) != len(rids):
            return False                # denoise steps of one request chain
        if len(members) == 1:
            t, req, g = members[0]
            self.pinned.pop(req.id, None)
            self._dispatch(t, a.layout, g)
            return True
        model, tokens = next(iter(sigs))
        pack_id = f"pack-{next(self._pack_seq)}"
        membership = [(req.id, t.step_index) for t, req, _ in members]
        # pack-level cache decision (DESIGN.md §11): one set of
        # collectives -> the pack hits or refreshes as a unit
        pack_mode = self.cache.stamp_pack(
            [(t, g) for t, _, g in members], a.layout)
        seqs: dict[str, int] = {}
        for t, req, g in members:
            # an explicit placement overrides and clears a pin
            self.pinned.pop(req.id, None)
            seqs[t.id] = self._mark_running(
                t, a.layout, {"pack": pack_id,
                              "pack_members": list(membership)},
                graph=g)
            self._pack_of[t.id] = pack_id
        self.free_ranks -= set(a.layout.ranks)
        self.packs[pack_id] = {
            "members": tuple(t.id for t, _, _ in members),
            "layout": a.layout, "model": model, "tokens": tokens,
            "seqs": seqs, "span": a.layout.span(self.topology),
            "cached": pack_mode == "hit",
        }
        pack_ev = {"t": self.now, "ev": "packed_dispatch",
                   "pack": pack_id, "batch": len(members),
                   "reqs": [r for r, _ in membership],
                   "tokens": tokens,
                   "ranks": list(a.layout.ranks)}
        if pack_mode is not None:
            pack_ev["cache"] = pack_mode
        self.events.append(pack_ev)
        self.backend.dispatch_pack(
            pack_id, [(t, g) for t, _, g in members], a.layout, self.now)
        return True

    def _apply_reallocate(self, a: Reallocate) -> bool:
        req = self.requests.get(a.request_id)
        if req is None or req.failed or req.done_time is not None:
            return False
        if not self._ranks_ok(a.new_layout) or \
                not self._shape_ok(a.new_layout, req):
            return False
        self.pinned[a.request_id] = a.new_layout
        ev = {"t": self.now, "ev": "reallocate", "req": a.request_id,
              "ranks": list(a.new_layout.ranks)}
        if getattr(a.new_layout, "cfg", 1) > 1:
            ev["cfg"] = a.new_layout.cfg       # reshape (DESIGN.md §14)
        self.events.append(ev)
        if self.telemetry is not None:
            self.telemetry.record_action("reallocate", ev,
                                         key=a.request_id)
            self.telemetry.request_event(self.now, a.request_id,
                                         "reallocate",
                                         ranks=tuple(a.new_layout.ranks),
                                         cfg=getattr(a.new_layout,
                                                     "cfg", 1))
        return True

    def _apply_preempt(self, a: Preempt) -> bool:
        if a.task_id not in self.running or a.task_id in self.preempting:
            return False
        # preempting any pack member evicts the whole pack: the batched
        # call is one device slice, so every member's in-flight slice
        # drains together and every member requeues with inputs intact
        pack_id = self._pack_of.get(a.task_id)
        victims = (self.packs[pack_id]["members"] if pack_id
                   else (a.task_id,))
        for tid in victims:
            if tid in self.preempting or tid not in self.running:
                continue            # member already failed-out or evicted
            task, layout = self.running[tid]
            # eviction revokes the request's reallocation pin — otherwise
            # _autodispatch_pinned would re-dispatch the requeued task at
            # the pinned width before the policy runs, livelocking the
            # plane in a preempt/requeue cycle
            self.pinned.pop(task.request_id, None)
            # eviction clears feature-cache residency (DESIGN.md §11):
            # the requeued task will be re-placed, and a stale snapshot
            # must never be trusted across an eviction — for a pack,
            # EVERY member's cache invalidates (the batched slice was
            # one collective set)
            self.cache.invalidate(task.request_id, "preempt")
            self.preempting[tid] = "requeue"
            ev = {"t": self.now, "ev": "preempt",
                  "task": task.id, "req": task.request_id,
                  "kind": task.kind, "step": task.step_index,
                  "ranks": list(layout.ranks)}
            if pack_id:
                ev["pack"] = pack_id
            self.events.append(ev)
            if self.telemetry is not None:
                # a pack-wide eviction attaches the policy's staged
                # explanation to the member it actually named
                self.telemetry.record_action(
                    "preempt", ev,
                    key=tid if tid == a.task_id else None)
                self.telemetry.request_event(
                    self.now, task.request_id, "preempt",
                    kind=task.kind, step=task.step_index)
        return True

    def _apply_cancel(self, a: Cancel) -> bool:
        req = self.requests.get(a.request_id)
        if req is None or req.failed or req.done_time is not None:
            return False
        req.failed = True
        self._unfinished.pop(a.request_id, None)
        self.pinned.pop(a.request_id, None)
        self.cache.invalidate(a.request_id, "cancel")
        for tid, (task, _) in list(self.running.items()):
            if task.request_id == a.request_id:
                self.preempting[tid] = "drop"
        ev = {"t": self.now, "ev": "cancel", "req": a.request_id}
        self.events.append(ev)
        if self.telemetry is not None:
            self.telemetry.record_action("cancel", ev)
            self.telemetry.request_event(self.now, a.request_id, "cancel")
        return True

    def apply(self, action: Action, view: Optional[SchedulerView] = None
              ) -> bool:
        """Validate and apply one control-plane action."""
        if isinstance(action, Dispatch):
            return self._apply_dispatch(action, view or self._view())
        if isinstance(action, PackedDispatch):
            return self._apply_packed(action, view or self._view())
        if isinstance(action, Reallocate):
            return self._apply_reallocate(action)
        if isinstance(action, Preempt):
            return self._apply_preempt(action)
        if isinstance(action, Cancel):
            return self._apply_cancel(action)
        return False

    # ------------------------------------------------------------------
    def _autodispatch_pinned(self):
        """Honor reallocation pins at trajectory boundaries: when a pinned
        request's next denoise task is ready and the pinned ranks are
        free, the control plane dispatches it itself (migration to the
        new layout happens in the backend's dispatch path)."""
        for rid in sorted(self.pinned):
            layout = self.pinned[rid]
            req = self.requests.get(rid)
            if req is None or req.failed or rid not in self.released:
                continue
            g = self.graphs[rid]
            for t in g.ready_tasks():
                if t.kind != "denoise":
                    continue
                if all(r in self.free_ranks for r in layout.ranks):
                    self._dispatch(t, layout, g, via_pin=True)
                break       # denoise steps form a chain: at most one ready

    # ------------------------------------------------------------------
    def schedule_point(self):
        """Invoke the policy and apply its actions.  Called by the event
        loop after every arrival, completion, preempt-requeue, and
        reallocation boundary."""
        if self.telemetry is not None:
            # staged explanations live one schedule point: anything the
            # plane rejected must not leak onto a later application
            self.telemetry.begin_schedule()
        self._autodispatch_pinned()
        view = self._view()
        if not view.ready and not view.running:
            return
        for action in self.policy.schedule(view):
            self.apply(action, view)

    # ------------------------------------------------------------------
    def _discard_outputs(self, task: TrajectoryTask, graph: RequestGraph):
        for aid in task.outputs:
            art = graph.artifacts[aid]
            art.materialized = False
            art.layout = None
            art.data = None

    def on_completion(self, c: Completion):
        if c.task_id in self.packs:
            return self._on_pack_completion(c)
        self._complete_task(c)

    def _on_pack_completion(self, c: Completion):
        """One device completion for a pack fans out into per-member
        completions (DESIGN.md §9); the measured duration calibrates the
        BATCHED cost curve (one sample per call, not per member — the
        members shared the call, so attributing the full duration to each
        single-task key would poison the unbatched calibration)."""
        rec = self.packs.pop(c.task_id)
        self.now = max(self.now, c.finish_time)
        for tid in rec["members"]:
            self._pack_of.pop(tid, None)
            if tid not in self.running:
                continue
            # fan out with the seq recorded at PACK dispatch time, so a
            # member that was failed-out and redispatched solo keeps the
            # superseded-dispatch guard: this stale fan-out is dropped
            self._complete_task(Completion(
                tid, c.finish_time, c.duration,
                failed_ranks=c.failed_ranks,
                seq=rec["seqs"][tid]), observe=False)
        if self.telemetry is not None and c.duration > 0:
            # predicted-vs-observed for the BATCHED cell, priced before
            # the observation updates it (DESIGN.md §15)
            predicted = self.cost.estimate_packed(
                rec["model"], "denoise", rec["tokens"],
                rec["layout"].degree, len(rec["members"]),
                span=rec["span"], cached=rec.get("cached", False))
            self.telemetry.observe_cost(
                CostModel._pack_key(rec["model"], "denoise",
                                    rec["tokens"], rec["layout"].degree,
                                    len(rec["members"]), rec["span"],
                                    rec.get("cached", False)),
                predicted, c.duration, t=self.now)
        self.cost.observe_packed(rec["model"], "denoise", rec["tokens"],
                                 rec["layout"].degree, len(rec["members"]),
                                 c.duration, span=rec["span"],
                                 cached=rec.get("cached", False))

    def _complete_task(self, c: Completion, observe: bool = True):
        if c.task_id not in self.running:
            return                  # stale event from a failed dispatch
        task = self.running[c.task_id][0]
        if c.seq and c.seq != task.meta.get("_seq", 0):
            return                  # completion of a superseded dispatch
        mode = self.preempting.pop(c.task_id, None)
        task, layout = self.running.pop(c.task_id)
        self.now = max(self.now, c.finish_time)
        self.free_ranks |= set(layout.ranks) - self.dead_ranks
        tel = self.telemetry
        if tel is not None:
            tel.ranks_idle(self.now, set(layout.ranks) - self.dead_ranks)
            tel.request_event(
                self.now, task.request_id, "step_end", kind=task.kind,
                step=task.step_index,
                outcome=(mode if mode is not None else
                         "collective-failure" if c.failed_ranks
                         else "done"))
        graph = self.graphs[task.request_id]
        if mode is not None:
            # preempted, cancelled, or failed-out mid-flight: the device
            # slice reached its boundary but its outputs are discarded;
            # a preempted/failed-out task requeues with inputs intact.
            self._discard_outputs(task, graph)
            task.state = "pending"
            task.layout = None
            if mode in ("requeue", "failout"):
                self.events.append({"t": self.now, "ev": "requeued",
                                    "task": task.id,
                                    "req": task.request_id,
                                    "kind": task.kind,
                                    "step": task.step_index})
            if mode == "failout":
                # the drain is over: no worker still reads this request's
                # artifacts, so the host-loss repair can run (DESIGN.md
                # §13 — dematerialize lost artifacts, restore the latest
                # snapshot, reset exactly the tasks that need re-running)
                failure_domain.repair_request(self, task.request_id)
            return
        if c.failed_ranks:
            # structured collective failure (a GFC CollectiveTimeout the
            # executor surfaced as failed_ranks): the step did not
            # complete — discard its outputs and requeue with inputs
            # intact so the policy re-places it; repeated failures
            # without a matching host_down fail the request instead of
            # looping forever
            self._discard_outputs(task, graph)
            task.meta["_failures"] = task.meta.get("_failures", 0) + 1
            self.pinned.pop(task.request_id, None)
            self.cache.invalidate(task.request_id, "collective-timeout")
            self.events.append({"t": self.now, "ev": "task_failed",
                                "task": task.id, "req": task.request_id,
                                "kind": task.kind, "step": task.step_index,
                                "ranks": sorted(c.failed_ranks)})
            if task.meta["_failures"] >= self.max_task_failures:
                self._fail_request(task.request_id, "repeated-failure")
            else:
                task.state = "pending"
                task.layout = None
            return
        task.state = "done"
        task.complete_time = c.finish_time
        # a reallocation pin only governs the denoise chain; release it
        # (and its rank reservation) once that chain is complete
        if task.request_id in self.pinned and not any(
                t.kind == "denoise" and t.state != "done"
                for t in graph.tasks.values()):
            self.pinned.pop(task.request_id)
        for aid in task.outputs:
            art = graph.artifacts[aid]
            art.materialized = True
            if art.layout is None:
                art.layout = layout
        # periodic denoise-state snapshot (DESIGN.md §13): capture the
        # just-materialized latent so a later host loss replays from this
        # step, not from step 0.  The capture decision is a function of
        # (interval, step_index) only, so both backends stamp identical
        # snapshot events into the signature.
        if (self.snapshots is not None and task.kind == "denoise"
                and self.snapshots.due(task.step_index)):
            self.snapshots.capture(task, graph, layout)
            self.events.append({"t": self.now, "ev": "snapshot",
                                "req": task.request_id, "kind": "denoise",
                                "step": task.step_index})
        # online cost-model calibration (§5.1); pack members skip this —
        # the pack observes ONE batched sample instead.  Cache-hit steps
        # calibrate their own |c cell (DESIGN.md §11).
        if observe:
            stamp = task.meta.get("cache")
            # guided denoise calibrates its shape cell (DESIGN.md §14):
            # the 2x work must not poison the unguided calibration
            cfg = 0
            if task.kind == "denoise" and getattr(
                    self.requests[task.request_id], "guidance",
                    None) is not None:
                cfg = max(getattr(layout, "cfg", 1), 1)
            model = self.requests[task.request_id].model
            tokens = task.meta.get("tokens", 4096)
            span = layout.span(self.topology)
            cached = bool(stamp and stamp["mode"] == "hit")
            if tel is not None and c.duration > 0:
                # accuracy sample BEFORE the observation moves the cell
                predicted = self.cost.estimate(
                    model, task.kind, tokens, layout.degree, span=span,
                    cached=cached, cfg=cfg)
                tel.observe_cost(
                    CostModel._key(model, task.kind, tokens,
                                   layout.degree, span, cached, cfg),
                    predicted, c.duration, t=self.now,
                    req=task.request_id)
            self.cost.observe(model, task.kind, tokens, layout.degree,
                              c.duration, span=span, cached=cached,
                              cfg=cfg)
        req = self.requests[task.request_id]
        if graph.is_done() and req.done_time is None:
            req.done_time = c.finish_time
            self._unfinished.pop(req.id, None)
            self.pinned.pop(req.id, None)
            self.cache.invalidate(req.id, "done")
            if self.snapshots is not None:
                self.snapshots.drop(req.id)
            self.events.append({"t": self.now, "ev": "request_done",
                                "req": req.id})
            if tel is not None:
                # outcome under `metrics` (§15 staging convention): the
                # SLO verdict and latency are clock-dependent, so they
                # ride outside the identity projection
                tel.request_event(
                    self.now, req.id, "done",
                    metrics={"violation": bool(
                        req.deadline is not None
                        and req.done_time > req.deadline),
                        "latency": req.done_time - req.arrival})

    def _fail_request(self, rid: str, why: str):
        """Terminal request failure: release every plane-held resource and
        stamp the decision into the trace (DESIGN.md §13)."""
        req = self.requests.get(rid)
        if req is None or req.failed or req.done_time is not None:
            return
        req.failed = True
        self._unfinished.pop(rid, None)
        self.pinned.pop(rid, None)
        self.cache.invalidate(rid, "request-failed")
        if self.snapshots is not None:
            self.snapshots.drop(rid)
        self.events.append({"t": self.now, "ev": "request_failed",
                            "req": rid, "why": why})
        if self.telemetry is not None:
            self.telemetry.request_event(
                self.now, rid, "failed", why=why,
                metrics={"violation": True})   # unfinished == miss (§6.1)

    def fail_task(self, task_id: str, requeue: bool = True):
        """Worker failure: the trajectory task graph is the unit of
        recovery — re-enqueue the task; its input artifacts are intact."""
        task, layout = self.running.pop(task_id)
        self.preempting.pop(task_id, None)
        self.cache.invalidate(task.request_id, "failure")
        pack_id = self._pack_of.pop(task_id, None)
        # a pack member shares its rank set with its siblings: the ranks
        # free only when no sibling still runs on them (at the pack's
        # boundary, via the surviving members' completion fan-out)
        if pack_id is None or not any(
                tid in self.running
                for tid in self.packs[pack_id]["members"]):
            self.free_ranks |= set(layout.ranks) - self.dead_ranks
            if self.telemetry is not None:
                self.telemetry.ranks_idle(
                    self.now, set(layout.ranks) - self.dead_ranks)
        if requeue:
            task.state = "pending"
            task.layout = None
        else:
            self.requests[task.request_id].failed = True
            self._unfinished.pop(task.request_id, None)

    # ------------------------------------------------------------------
    def run(self, until: float = float("inf"), max_events: int = 10 ** 7):
        """Virtual-clock serving: the shared EventLoop advances time to
        the next completion or arrival, whichever is earlier."""
        EventLoop(self, VirtualClock(self)).run(until, max_events)
        return self

    # ------------------------------------------------------------------
    def metrics(self) -> dict:
        lat, done, failed = [], 0, 0
        total = len(self.requests)
        slo_miss = 0
        for req in self.requests.values():
            if req.done_time is not None:
                done += 1
                lat.append(req.done_time - req.arrival)
                if req.deadline is not None and req.done_time > req.deadline:
                    slo_miss += 1
            else:
                failed += 1
                slo_miss += 1       # unfinished counts as violation (§6.1)
        lat_sorted = sorted(lat)
        span = max((r.done_time for r in self.requests.values()
                    if r.done_time), default=0.0)
        return {
            "completed": done,
            "failed": failed,
            "throughput_rps": done / span if span else 0.0,
            "mean_latency_s": sum(lat) / len(lat) if lat else float("nan"),
            "p95_latency_s": (lat_sorted[int(0.95 * (len(lat_sorted) - 1))]
                              if lat_sorted else float("nan")),
            "slo_attainment": 1.0 - slo_miss / total if total else 1.0,
            "makespan_s": span,
        }


# ---------------------------------------------------------------------------
# trace comparison (benchmarks/sim_fidelity.py, DESIGN.md §6)
# ---------------------------------------------------------------------------

_SIGNATURE_EVENTS = ("dispatch", "preempt", "requeued", "reallocate",
                    "cancel", "host_down", "host_up", "failout",
                    "rollback", "snapshot", "request_failed")


def trace_signature(events: list[dict],
                    kinds: tuple = _SIGNATURE_EVENTS) -> list[tuple]:
    """Canonical, id- and time-free projection of a control-plane trace.

    Requests are keyed by arrival order and each carries its *ordered*
    decision records ``(event, task kind, step, ranks)``; wall-clock and
    virtual-clock runs of the same workload under the same policy should
    produce identical signatures even though timestamps (and the
    interleaving of events on disjoint rank sets) differ.

    Packed dispatches additionally record their full membership —
    canonicalized as ``(arrival index, step)`` pairs — so two traces only
    match when they formed the SAME packs (DESIGN.md §9).

    Cache-stamped dispatches (DESIGN.md §11) record the plane's
    hit/refresh/migrate decision, so two traces only match when they made
    the SAME feature-cache calls; uncached traces are unchanged.
    """
    order: dict[str, int] = {}
    for ev in events:
        if ev["ev"] == "arrival" and ev["req"] not in order:
            order[ev["req"]] = len(order)
    per_req: dict[int, list[tuple]] = {}
    for ev in events:
        if ev["ev"] not in kinds:
            continue
        idx = order.get(ev.get("req"), -1)
        rec = (ev["ev"], ev.get("kind"), ev.get("step"),
               tuple(ev.get("ranks", ())))
        if ev.get("cache") is not None:
            rec += (ev["cache"],)
        if ev.get("cfg"):
            # shape dimension (DESIGN.md §14): appended only when the
            # layout split branches, so scalar traces stay byte-identical
            rec += (("cfg", ev["cfg"]),)
        members = ev.get("pack_members")
        if members:
            rec += (tuple(sorted((order.get(rid, -1), step)
                                 for rid, step in members)),)
        per_req.setdefault(idx, []).append(rec)
    return [(idx, tuple(seq)) for idx, seq in sorted(per_req.items())]
