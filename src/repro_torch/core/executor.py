"""Thread execution backend (paper §5.1 execution plane).

Workers are threads (rank = thread); model executors run REAL JAX compute
on token shards with GFC collectives inside (sequence parallelism), so the
distributed semantics — dynamic groups, per-layer subgroup all-gathers,
layout migration — are executed faithfully.  Wall-clock speedup is not
observable on this 1-core container (documented in DESIGN.md §8); the
simulator supplies calibrated timing, and this backend supplies
correctness + overhead measurements.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Optional

from repro_torch.core.gfc import CollectiveTimeout, GroupFreeComm
from repro_torch.core.migration import (execute_migration, layout_moved,
                                  plan_migration)
from repro_torch.core.scheduler import Completion
from repro_torch.core.trajectory import (ExecutionLayout, RequestGraph,
                                   TrajectoryTask)


@dataclass
class _PackJob:
    """One rank's share of a batched pack dispatch (DESIGN.md §9)."""
    pack_id: str
    members: list                   # [(task, graph)] — shared, read-only
    layout: Any
    t_dispatch: float
    desc: Any


class ThreadBackend:
    """One worker thread per rank + a completion queue.

    ``adapter`` must provide
        execute(task, layout, rank, comm, graph) -> None
    which runs this rank's share of the task (GFC rendezvous inside) and,
    on the leader rank, installs output artifact data — and, for step
    packing, ``execute_packed(members, layout, rank, comm, desc)`` which
    runs the stacked batch as ONE model call.
    """

    def __init__(self, adapter, num_ranks: int,
                 comm: Optional[GroupFreeComm] = None):
        self.adapter = adapter
        self.num_ranks = num_ranks
        self.comm = comm or GroupFreeComm(num_ranks)
        self._queues: list[queue.Queue] = [queue.Queue()
                                           for _ in range(num_ranks)]
        self._completions: queue.Queue = queue.Queue()
        self._stop = False
        self.errors: list[str] = []
        # structured collective timeouts (a peer died mid-collective) are
        # NOT hard errors: they surface as failed_ranks on the completion
        # and the plane decides (requeue / fail the request) — DESIGN.md
        # §13.  Recorded here for observability only.
        self.timeouts: list[str] = []
        self._threads = [
            threading.Thread(target=self._worker, args=(r,), daemon=True)
            for r in range(num_ranks)]
        for t in self._threads:
            t.start()
        self._pending: dict[tuple[str, int], dict] = {}
        self._lock = threading.Lock()

    def attach(self, plane):
        self.plane = plane

    # ------------------------------------------------------------------
    def _worker(self, rank: int):
        while not self._stop:
            try:
                job = self._queues[rank].get(timeout=0.01)
            except queue.Empty:
                continue
            if isinstance(job, _PackJob):
                self._run_pack(rank, job)
                continue
            task, layout, graph, t_dispatch, desc, seq = job
            err, failed = None, ()
            try:
                self.adapter.execute(task, layout, rank, self.comm, graph,
                                     desc)
            except CollectiveTimeout as e:
                failed = tuple(e.missing_ranks) or (rank,)
                self.timeouts.append(
                    f"rank {rank} task {task.id}: missing {failed}: {e}")
            except Exception as e:   # noqa: BLE001
                err = f"{type(e).__name__}: {e}"
                self.errors.append(f"rank {rank} task {task.id}: {err}\n"
                                   + traceback.format_exc())
            self._finish(task.id, seq, layout, t_dispatch, err, failed)

    def _run_pack(self, rank: int, job: _PackJob):
        err, failed = None, ()
        try:
            self.adapter.execute_packed(job.members, job.layout, rank,
                                        self.comm, job.desc)
        except CollectiveTimeout as e:
            failed = tuple(e.missing_ranks) or (rank,)
            self.timeouts.append(
                f"rank {rank} pack {job.pack_id}: missing {failed}: {e}")
        except Exception as e:   # noqa: BLE001
            err = f"{type(e).__name__}: {e}"
            self.errors.append(f"rank {rank} pack {job.pack_id}: {err}\n"
                               + traceback.format_exc())
        # pack ids are fresh per dispatch, so the pending key needs no seq
        self._finish(job.pack_id, 0, job.layout, job.t_dispatch, err, failed)

    def _finish(self, key_id: str, seq: int, layout, t_dispatch: float,
                err: Optional[str], failed: tuple = ()):
        with self._lock:
            # keyed by (task, dispatch seq): a preempted task may be
            # redispatched while the superseded dispatch still drains
            st = self._pending.get((key_id, seq))
            if st is None:
                return              # late arrival after early emission
            st["done"] += 1
            if err:
                st["err"] = err
            if failed:
                st.setdefault("failed", set()).update(failed)
            now = time.monotonic() - self.t0
            emit = False
            if failed and not st.get("emitted"):
                # first structured collective failure: emit the failed
                # completion NOW — surviving peers of the group are still
                # blocked on their own timeouts and the plane must not
                # wait a full timeout per peer to start recovery
                st["emitted"] = True
                emit = True
            if st["done"] == layout.degree:
                del self._pending[(key_id, seq)]
                if not st.get("emitted"):
                    emit = True
            if emit:
                # a hard adapter error keeps the legacy contract —
                # failed_ranks=() and the error recorded in self.errors
                # (ServingEngine.serve raises); only collective timeouts
                # carry the structured missing-rank set
                self._completions.put(Completion(
                    key_id, now, now - t_dispatch,
                    failed_ranks=tuple(sorted(st.get("failed", ()))),
                    seq=seq))

    # ------------------------------------------------------------------
    def _prepare_task(self, task: TrajectoryTask, layout: ExecutionLayout,
                      graph: RequestGraph):
        """CPU-side dispatch preparation shared by the solo and packed
        paths: layout-aware migration of input artifacts (§5.3), output
        artifact rank slots (ranks fill their own), and the feature
        cache's plane-stamped effects (DESIGN.md §11) — migrate the warm
        snapshot on a same-degree layout change, or re-home/allocate the
        snapshot slots a refresh gather will fill."""
        tel = getattr(self.plane, "telemetry", None) \
            if hasattr(self, "plane") else None
        for aid in task.inputs:
            art = graph.artifacts[aid]
            if art.data is not None and \
                    layout_moved(art.layout, layout):
                t0 = time.monotonic()
                entries = plan_migration(art.fields, art.layout, layout)
                execute_migration(self.comm, art, layout, entries)
                if tel is not None:
                    tel.span(layout.ranks[0], t0, time.monotonic(),
                             "migrate", art.nbytes)
        stamp = task.meta.get("cache")
        if stamp is not None:
            cart = graph.artifacts[stamp["art"]]
            if stamp["migrate"] and cart.data is not None and \
                    cart.layout is not None and \
                    cart.layout.ranks != layout.ranks:
                t0 = time.monotonic()
                entries = plan_migration(cart.fields, cart.layout, layout)
                execute_migration(self.comm, cart, layout, entries)
                if tel is not None:
                    tel.span(layout.ranks[0], t0, time.monotonic(),
                             "migrate-cache", cart.nbytes)
            if cart.data is None:
                cart.data = {}
            for r in layout.ranks:
                cart.data.setdefault(r, {})
            if stamp["mode"] == "refresh":
                cart.layout = layout
        for aid in task.outputs:
            art = graph.artifacts[aid]
            if art.data is None:
                art.data = {r: {} for r in layout.ranks}

    def dispatch(self, task: TrajectoryTask, layout: ExecutionLayout,
                 graph: RequestGraph, now: float):
        if not hasattr(self, "t0"):
            self.t0 = time.monotonic()
        self._prepare_task(task, layout, graph)
        # the control plane creates ONE descriptor all ranks share (§4.3);
        # CFG shapes register their per-dimension groups together
        # (DESIGN.md §14) so branch and merge gids match across ranks
        if getattr(layout, "cfg", 1) > 1:
            desc = self.comm.register_shape(layout.ranks, layout.cfg)
        else:
            desc = self.comm.register_group(layout.ranks)
        seq = task.meta.get("_seq", 0)
        with self._lock:
            self._pending[(task.id, seq)] = {"done": 0}
        t_dispatch = time.monotonic() - self.t0
        for r in layout.ranks:
            self._queues[r].put((task, layout, graph, t_dispatch, desc,
                                 seq))

    # ------------------------------------------------------------------
    def dispatch_pack(self, pack_id: str, members, layout: ExecutionLayout,
                      now: float = 0.0):
        """Dispatch ONE job carrying N batch-compatible tasks to every
        rank of the shared layout; the adapter runs them as one stacked
        model call and the single completion (keyed by ``pack_id``) fans
        out in the control plane (DESIGN.md §9)."""
        if not hasattr(self, "t0"):
            self.t0 = time.monotonic()
        for task, graph in members:
            self._prepare_task(task, layout, graph)
        # ONE shared descriptor: the pack's collectives are a single set
        desc = self.comm.register_group(layout.ranks)
        with self._lock:
            self._pending[(pack_id, 0)] = {"done": 0}
        t_dispatch = time.monotonic() - self.t0
        job = _PackJob(pack_id, list(members), layout, t_dispatch, desc)
        for r in layout.ranks:
            self._queues[r].put(job)

    # ------------------------------------------------------------------
    def peek(self) -> Optional[float]:
        """Non-destructive look at the earliest queued completion: the
        former get/put-back implementation raced concurrent ``poll``
        calls and burned a 5 ms timeout on every idle iteration."""
        with self._completions.mutex:
            q = self._completions.queue
            return q[0].finish_time if q else None

    def poll(self) -> list[Completion]:
        out = []
        try:
            out.append(self._completions.get(timeout=0.005))
            while True:
                out.append(self._completions.get_nowait())
        except queue.Empty:
            pass
        return out

    def shutdown(self):
        self._stop = True
        for t in self._threads:
            t.join(timeout=1.0)
