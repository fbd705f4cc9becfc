"""Group-free collectives (paper §4).

Faithful implementation of the paper's protocol over a shared-memory
multi-rank runtime (threads = ranks, numpy buffers = symmetric memory):

* one WORLD-level setup at construction (symmetric buffer plane + per-edge
  signal slots) — paid once, like the paper's symmetric-buffer registration;
* a dynamic subgroup is a :class:`GroupDescriptor` — pure metadata (ordered
  ranks, group id, local index); registration is O(µs), no communicator;
* collective-instance agreement is Algorithm 1: per ordered rank edge,
  double-buffered signal slots selected by a local per-edge phase bit, with
  tokens (session, group, epoch) detecting stale/mismatched observations;
* correctness relies on *pairwise-consistent ordering* (§4.2), enforced by
  the centralized control plane + per-rank ordered submission.  The
  ``num_slots=1`` degenerate mode reproduces the Fig. 5(b) collision failure
  (used by property tests to show double buffering is necessary), and
  ``strict`` mode detects overwrite-before-consume violations.

Backend-aware execution (§4.5): payloads are staged into the symmetric
plane in chunks; the backend selector picks chunk sizes per message-size
range from a microbenchmark table.

Topology-aware execution (DESIGN.md §10): when the comm is constructed
with a :class:`~repro.core.trajectory.ClusterTopology` and a group spans
more than one host, ``all_gather`` runs the hierarchical two-stage
protocol — intra-host gather, inter-host leader exchange, intra-host
broadcast — so each payload byte crosses the slow inter-host link once
instead of ``(group-local peers)`` times.  The result is bit-exact
versus the flat single-stage path (property-tested in
tests/test_gfc_hierarchical.py): the final concatenation follows the
descriptor's rank order regardless of which stage moved each part.

Hardware adaptation note (DESIGN.md §2): on a real TPU deployment the
expensive per-group state is the compiled XLA executable, not a NCCL
communicator — see ``core/executable_cache.py`` for the compile-once-per-
group-shape realization and ``core/grouped.py`` for the zero-recompile
membership-as-data realization.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np


@dataclass(frozen=True)
class GroupDescriptor:
    """Logical group: ordered ranks + runtime group id (metadata only)."""
    gid: int
    ranks: tuple[int, ...]

    def local_index(self, rank: int) -> int:
        return self.ranks.index(rank)

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass(frozen=True)
class ShapeGroups:
    """Per-dimension groups of one parallelism shape (DESIGN.md §14).

    ``full`` spans every rank of the layout; ``branches[b]`` is CFG
    branch ``b``'s SP group (all intra-branch collectives run here);
    ``merge[i]`` joins branch-local index ``i`` of every branch — the
    one exchange per denoise step that combines cond/uncond velocities.
    Registered together (one call per dispatch) so all member ranks
    share gids."""
    full: GroupDescriptor
    branches: tuple[GroupDescriptor, ...]
    merge: tuple[GroupDescriptor, ...]


@dataclass
class _Slot:
    token: Optional[tuple] = None
    consumed: bool = True


class OrderingViolation(RuntimeError):
    """A signal token was overwritten before its peer consumed it."""


class CollectiveTimeout(TimeoutError):
    """A collective stalled waiting on specific peer rank(s).

    Subclasses :class:`TimeoutError` so legacy handlers keep working, but
    carries the missing rank set so the executor can surface a structured
    ``failed_ranks`` completion (DESIGN.md §13) instead of killing the
    worker thread."""

    def __init__(self, msg: str, *, missing_ranks: tuple[int, ...] = (),
                 edge: Optional[tuple[int, int]] = None):
        super().__init__(msg)
        self.missing_ranks = tuple(missing_ranks)
        self.edge = edge


@dataclass
class BackendChoice:
    name: str                       # "staged" | "direct"
    chunk_bytes: int


class BackendSelector:
    """Message-size -> (backend, chunk size), populated from microbenchmarks
    (paper §4.5).  Defaults mirror the paper's regimes: small payloads go
    direct (one copy), large payloads use chunked staging so local staging
    overlaps remote movement."""

    def __init__(self, table: Optional[list[tuple[int, BackendChoice]]] = None):
        self.table = table or [
            (1 << 16, BackendChoice("direct", 0)),          # <64 KiB
            (1 << 22, BackendChoice("staged", 1 << 18)),    # <4 MiB: 256 KiB
            (1 << 62, BackendChoice("staged", 1 << 20)),    # else: 1 MiB
        ]

    def choose(self, nbytes: int) -> BackendChoice:
        for limit, choice in self.table:
            if nbytes < limit:
                return choice
        return self.table[-1][1]


class GroupFreeComm:
    """World-level symmetric plane + GFC protocol (threads = ranks)."""

    def __init__(self, world_size: int, *, num_slots: int = 2,
                 strict: bool = True, session: int = 0,
                 selector: Optional[BackendSelector] = None,
                 topology=None, timeout: float = 30.0):
        self.world_size = world_size
        self.num_slots = num_slots
        self.strict = strict
        self.session = session
        # default wait bound for signal/stage observation; a peer that
        # never shows up within it raises CollectiveTimeout naming the
        # missing rank (DESIGN.md §13)
        self.timeout = timeout
        self.selector = selector or BackendSelector()
        # ClusterTopology (DESIGN.md §10) or None; spanning groups then
        # execute hierarchical two-stage collectives.  Plans are keyed
        # by the RANKS tuple, not the parent gid: the control plane
        # registers a fresh descriptor per dispatch, and a gid-keyed
        # cache would rebuild (and leak) sub-descriptors every step.
        self.topology = topology
        self._hier: dict[tuple[int, ...], dict] = {}
        self._cv = threading.Condition()
        # per ordered edge (src, dst): signal slots + local phase bit at src
        self._slots: dict[tuple[int, int], list[_Slot]] = {
            (s, d): [_Slot() for _ in range(num_slots)]
            for s in range(world_size) for d in range(world_size) if s != d}
        self._phase: dict[tuple[int, int], int] = {
            e: 0 for e in self._slots}
        # symmetric staging buffers: (gid, epoch, src_rank) -> payload
        self._stage: dict[tuple[int, int, int], Any] = {}
        # per-rank per-group local epoch counters
        self._epoch: dict[tuple[int, int], int] = {}
        self._gids = itertools.count()
        self.violations: list[str] = []
        # host-spanning collectives run two-stage (DESIGN.md §10)
        self.stats = {"hierarchical": 0}
        # telemetry plane (DESIGN.md §15): set by the serving engine (or
        # a benchmark) to collect per-registration latency samples and
        # the wall collective-overlay spans.  Instruments only APPEND to
        # telemetry lists — GIL-atomic, safe from worker threads (the
        # hierarchical planner registers sub-groups under `_cv`).
        self.telemetry = None

    # ------------------------------------------------------------------
    # group registration: METADATA ONLY (the paper's ~60 us operation)
    # ------------------------------------------------------------------
    def register_group(self, ranks: tuple[int, ...]) -> GroupDescriptor:
        tel = self.telemetry
        t0 = time.perf_counter() if tel is not None else 0.0
        desc = GroupDescriptor(gid=next(self._gids), ranks=tuple(ranks))
        if tel is not None:
            tel.gfc_register(time.perf_counter() - t0)
        return desc

    def register_shape(self, ranks: tuple[int, ...],
                       cfg: int = 1) -> ShapeGroups:
        """Register the per-dimension groups of a ``(cfg x sp)`` shape
        (DESIGN.md §14): still metadata-only — one descriptor per
        dimension slice, formed in a fixed order (full, branches by
        index, merge by branch-local index) so every member rank sees
        identical gids."""
        ranks = tuple(ranks)
        assert cfg >= 1 and len(ranks) % cfg == 0
        sp = len(ranks) // cfg
        full = self.register_group(ranks)
        branches = tuple(self.register_group(ranks[b * sp:(b + 1) * sp])
                         for b in range(cfg))
        merge = tuple(self.register_group(
            tuple(ranks[b * sp + i] for b in range(cfg)))
            for i in range(sp)) if cfg > 1 else ()
        return ShapeGroups(full=full, branches=branches, merge=merge)

    # ------------------------------------------------------------------
    # Algorithm 1: per-edge flip agreement
    # ------------------------------------------------------------------
    def _token(self, desc: GroupDescriptor, epoch: int) -> tuple:
        return (self.session, desc.gid, epoch)

    def _publish(self, edge: tuple[int, int], slot_idx: int, token: tuple):
        with self._cv:
            slot = self._slots[edge][slot_idx]
            if self.strict and not slot.consumed:
                msg = (f"edge {edge} slot {slot_idx}: token {slot.token} "
                       f"overwritten by {token} before consumption")
                self.violations.append(msg)
                raise OrderingViolation(msg)
            slot.token = token
            slot.consumed = False
            self._cv.notify_all()

    def _observe(self, edge: tuple[int, int], slot_idx: int, token: tuple,
                 timeout: Optional[float] = None):
        timeout = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        with self._cv:
            slot = self._slots[edge][slot_idx]
            while slot.token != token:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise CollectiveTimeout(
                        f"edge {edge} slot {slot_idx}: waiting {token}, "
                        f"holds {slot.token} (dead peer, deadlock, or "
                        f"ordering bug)",
                        missing_ranks=(edge[0],), edge=edge)
                self._cv.wait(remaining)
            slot.consumed = True
            self._cv.notify_all()

    def barrier(self, desc: GroupDescriptor, rank: int) -> int:
        """Pairwise flip agreement for one collective instance.

        Returns the instance epoch.  Must be called by every rank of the
        group, in pairwise-consistent order across groups.
        """
        key = (rank, desc.gid)
        epoch = self._epoch.get(key, 0)
        self._epoch[key] = epoch + 1
        tau = self._token(desc, epoch)
        slots_used: dict[int, int] = {}
        for p in desc.ranks:
            if p == rank:
                continue
            e = (rank, p)
            s = self._phase[e]
            slots_used[p] = s
            self._phase[e] = (s + 1) % self.num_slots   # flip
            self._publish(e, s, tau)
        for p in desc.ranks:
            if p == rank:
                continue
            self._observe((p, rank), slots_used[p], tau)
        return epoch

    # ------------------------------------------------------------------
    # staging + data movement
    # ------------------------------------------------------------------
    def _stage_put(self, desc, epoch: int, rank: int, payload):
        chunks = self._chunk(payload)
        with self._cv:
            self._stage[(desc.gid, epoch, rank)] = payload
            self._cv.notify_all()
        return chunks

    def _chunk(self, payload):
        """Chunked staging (overlap model; functional path copies whole)."""
        if not hasattr(payload, "nbytes"):
            return 1
        choice = self.selector.choose(payload.nbytes)
        if choice.name == "direct" or choice.chunk_bytes == 0:
            return 1
        return max(1, -(-payload.nbytes // choice.chunk_bytes))

    def _stage_get(self, desc, epoch: int, rank: int,
                   timeout: Optional[float] = None):
        key = (desc.gid, epoch, rank)
        timeout = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + timeout
        with self._cv:
            while key not in self._stage:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise CollectiveTimeout(
                        f"stage buffer {key} never published "
                        f"(rank {rank} dead or stalled)",
                        missing_ranks=(rank,))
                self._cv.wait(remaining)
            return self._stage[key]

    def _prune(self, desc, epoch: int):
        """Free buffers older than epoch-2 (double-buffer lifetime)."""
        with self._cv:
            stale = [k for k in self._stage
                     if k[0] == desc.gid and k[1] < epoch - 1]
            for k in stale:
                del self._stage[k]

    # ------------------------------------------------------------------
    # hierarchical execution for host-spanning groups (DESIGN.md §10)
    # ------------------------------------------------------------------
    def _spans_hosts(self, desc: GroupDescriptor) -> bool:
        return (self.topology is not None
                and self.topology.span_of(desc.ranks) > 1)

    def _hier_plan(self, desc: GroupDescriptor) -> dict:
        """Memoized two-stage plan for a spanning group: one intra-host
        sub-descriptor per host (group rank order preserved within the
        host) plus a leader descriptor over each host's first group
        rank.  Keyed by the ranks tuple so every dispatch of the same
        layout — each of which registers a fresh parent descriptor —
        reuses one set of sub-groups (bounded by distinct layouts, not
        by steps).  Built once under the lock so every member rank
        shares the same sub-group gids; registration stays
        metadata-only."""
        with self._cv:
            plan = self._hier.get(desc.ranks)
            if plan is None:
                by_host: dict[int, list[int]] = {}
                for r in desc.ranks:
                    by_host.setdefault(self.topology.host_of(r),
                                       []).append(r)
                hosts = sorted(by_host)
                plan = {
                    "hosts": hosts,
                    "by_host": by_host,
                    "local": {h: self.register_group(tuple(by_host[h]))
                              for h in hosts},
                    "leader": self.register_group(
                        tuple(by_host[h][0] for h in hosts)),
                }
                self._hier[desc.ranks] = plan
        return plan

    def _gather_parts(self, desc: GroupDescriptor, rank: int,
                      payload) -> list:
        """All-gather that returns the per-rank parts list (aligned with
        ``desc.ranks``) instead of a concatenation — the hierarchical
        path reassembles in the PARENT group's rank order for
        bit-exactness versus the flat path."""
        epoch = self._epoch.get((rank, desc.gid), 0)
        self._stage_put(desc, epoch, rank, payload)
        self.barrier(desc, rank)
        parts = [self._stage_get(desc, epoch, p) for p in desc.ranks]
        self._prune(desc, epoch)
        return parts

    def _hier_parts(self, desc: GroupDescriptor, rank: int,
                    payload) -> dict:
        """Two-stage (intra-host gather -> leader exchange -> intra-host
        broadcast) gather of arbitrary per-rank payloads; returns the
        rank -> payload mapping.  Every hierarchical collective
        (all_gather / all_to_all / all_reduce) is this parts-gather plus
        a LOCAL combine executed in ``desc.ranks`` order, which is what
        keeps each op bit-exact versus its flat path.  The memoized plan
        is keyed by the exact ranks tuple, so a group shrunken by dead
        ranks (DESIGN.md §13) builds its own plan — a host reduced to
        one survivor still gets a correct (singleton) local group, and a
        group that no longer spans hosts never reaches this path."""
        plan = self._hier_plan(desc)
        host = self.topology.host_of(rank)
        local = plan["local"][host]
        # stage 1: intra-host gather of this host's parts
        parts = self._gather_parts(local, rank, payload)
        # stage 3 epoch is read BEFORE the stage-2 barrier advances it
        epoch3 = self._epoch.get((rank, local.gid), 0)
        if rank == local.ranks[0]:
            # stage 2: leaders exchange whole host blocks (each block
            # crosses the inter-host fabric exactly once)
            blocks = self._gather_parts(plan["leader"], rank, parts)
            by_rank = {}
            for h, block in zip(plan["hosts"], blocks):
                for r, part in zip(plan["by_host"][h], block):
                    by_rank[r] = part
            # stage 3: intra-host broadcast of the assembled mapping
            # (staged directly — the mapping is not an ndarray payload)
            self._stage_put(local, epoch3, rank, by_rank)
        self.barrier(local, rank)
        out = self._stage_get(local, epoch3, local.ranks[0])
        self._prune(local, epoch3)
        with self._cv:
            self.stats["hierarchical"] += 1
        return out

    def _all_gather_hier(self, desc: GroupDescriptor, rank: int,
                         shard: np.ndarray, axis: int) -> np.ndarray:
        out = self._hier_parts(desc, rank, shard)
        return np.concatenate([out[r] for r in desc.ranks], axis=axis)

    # ------------------------------------------------------------------
    # collectives (issued by every member rank)
    # ------------------------------------------------------------------
    def _timed(self, op: str, desc: GroupDescriptor, rank: int,
               fn, *args):
        """Wall collective-overlay instrument (DESIGN.md §15): times one
        rank's passage through a collective in absolute monotonic time.
        Disabled path is one None check — no lambda, no timestamp."""
        tel = self.telemetry
        if tel is None:
            return fn(*args)
        t0 = time.monotonic()
        try:
            return fn(*args)
        finally:
            tel.span(rank, t0, time.monotonic(), op, desc.size)

    def all_gather(self, desc: GroupDescriptor, rank: int,
                   shard: np.ndarray, axis: int = 0) -> np.ndarray:
        return self._timed("all_gather", desc, rank, self._all_gather,
                           desc, rank, shard, axis)

    def _all_gather(self, desc: GroupDescriptor, rank: int,
                    shard: np.ndarray, axis: int = 0) -> np.ndarray:
        shard = np.asarray(shard)
        if self._spans_hosts(desc):
            return self._all_gather_hier(desc, rank, shard, axis)
        epoch = self._epoch.get((rank, desc.gid), 0)
        self._stage_put(desc, epoch, rank, shard)     # stage local input
        self.barrier(desc, rank)                      # Algorithm 1
        parts = [self._stage_get(desc, epoch, p) for p in desc.ranks]
        self._prune(desc, epoch)
        return np.concatenate(parts, axis=axis)

    def all_to_all(self, desc: GroupDescriptor, rank: int,
                   shards: list[np.ndarray]) -> list[np.ndarray]:
        return self._timed("all_to_all", desc, rank, self._all_to_all,
                           desc, rank, shards)

    def _all_to_all(self, desc: GroupDescriptor, rank: int,
                    shards: list[np.ndarray]) -> list[np.ndarray]:
        assert len(shards) == desc.size
        my_idx = desc.local_index(rank)
        if self._spans_hosts(desc):
            # hierarchical: each rank's destined-shards list rides the
            # two-stage parts-gather (host block crosses the fabric
            # once); the local pick-my-column is identical to flat
            out = self._hier_parts(desc, rank,
                                   [np.asarray(s) for s in shards])
            return [out[p][my_idx] for p in desc.ranks]
        epoch = self._epoch.get((rank, desc.gid), 0)
        self._stage_put(desc, epoch, rank,
                        [np.asarray(s) for s in shards])
        self.barrier(desc, rank)
        out = [self._stage_get(desc, epoch, p)[my_idx] for p in desc.ranks]
        self._prune(desc, epoch)
        return out

    def all_reduce(self, desc: GroupDescriptor, rank: int,
                   x: np.ndarray, op: str = "sum") -> np.ndarray:
        return self._timed("all_reduce", desc, rank, self._all_reduce,
                           desc, rank, x, op)

    def _all_reduce(self, desc: GroupDescriptor, rank: int,
                    x: np.ndarray, op: str = "sum") -> np.ndarray:
        if self._spans_hosts(desc):
            # hierarchical parts-gather, then the SAME local combine as
            # the flat path — np.stack in desc.ranks order — so the fp32
            # association order (and therefore every bit) is unchanged.
            # Leaders exchanging partial sums would be cheaper but not
            # bit-exact; trace-identity is this repo's verification tool.
            out = self._hier_parts(desc, rank, np.asarray(x))
            acc = np.stack([out[p] for p in desc.ranks])
            return {"sum": acc.sum(0), "max": acc.max(0),
                    "mean": acc.mean(0)}[op]
        epoch = self._epoch.get((rank, desc.gid), 0)
        self._stage_put(desc, epoch, rank, np.asarray(x))
        self.barrier(desc, rank)
        parts = [self._stage_get(desc, epoch, p) for p in desc.ranks]
        self._prune(desc, epoch)
        acc = np.stack(parts)
        return {"sum": acc.sum(0), "max": acc.max(0),
                "mean": acc.mean(0)}[op]

    def broadcast(self, desc: GroupDescriptor, rank: int,
                  x: Optional[np.ndarray], root_local: int = 0) -> np.ndarray:
        return self._timed("broadcast", desc, rank, self._broadcast,
                           desc, rank, x, root_local)

    def _broadcast(self, desc: GroupDescriptor, rank: int,
                   x: Optional[np.ndarray],
                   root_local: int = 0) -> np.ndarray:
        epoch = self._epoch.get((rank, desc.gid), 0)
        root_rank = desc.ranks[root_local]
        if rank == root_rank:
            self._stage_put(desc, epoch, rank, np.asarray(x))
        else:
            # non-roots still advance their epoch implicitly via barrier
            pass
        self.barrier(desc, rank)
        out = self._stage_get(desc, epoch, root_rank)
        self._prune(desc, epoch)
        return out

    def send(self, desc: GroupDescriptor, rank: int, x: np.ndarray):
        """P2P send over a logical pair group (migration path, §5.3)."""
        return self._timed("send", desc, rank, self._send, desc, rank, x)

    def _send(self, desc: GroupDescriptor, rank: int, x: np.ndarray):
        assert desc.size == 2 and rank in desc.ranks
        epoch = self._epoch.get((rank, desc.gid), 0)
        self._stage_put(desc, epoch, rank, np.asarray(x))
        self.barrier(desc, rank)
        self._prune(desc, epoch)

    def recv(self, desc: GroupDescriptor, rank: int) -> np.ndarray:
        return self._timed("recv", desc, rank, self._recv, desc, rank)

    def _recv(self, desc: GroupDescriptor, rank: int) -> np.ndarray:
        assert desc.size == 2 and rank in desc.ranks
        epoch = self._epoch.get((rank, desc.gid), 0)
        peer = desc.ranks[0] if desc.ranks[1] == rank else desc.ranks[1]
        self.barrier(desc, rank)
        out = self._stage_get(desc, epoch, peer)
        self._prune(desc, epoch)
        return out
