"""Reschedulable trajectory tasks + logical artifacts (paper §3.1).

A diffusion request becomes a placement-agnostic *trajectory task graph*:
nodes are independently schedulable tasks (encode / denoise-step / decode),
edges are artifact dependencies.  Completing a task produces a semantically
complete state, so the runtime may change placement/parallelism at every
boundary.

Artifacts record *dependency and semantic role*, not physical layout; the
same artifact may later be materialized replicated or sequence-sharded
depending on the layouts of its producer and consumer (§5.3 migration).
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass, field
from typing import Any, Optional

_ids = itertools.count()


def fresh_id(prefix: str) -> str:
    return f"{prefix}-{next(_ids)}"


# ---------------------------------------------------------------------------
# Artifacts
# ---------------------------------------------------------------------------

@dataclass
class FieldSpec:
    """One field of a logical artifact (codec-reported)."""
    kind: str                       # "sharded" | "replicated" | "meta"
    global_shape: tuple[int, ...] = ()
    dtype: str = "float32"
    shard_axis: int = 0             # axis sharded under SP layouts

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.global_shape:
            n *= d
        itemsize = {"float32": 4, "bfloat16": 2, "float16": 2,
                    "int32": 4}.get(self.dtype, 4)
        return n * itemsize


@dataclass
class Artifact:
    """Logical artifact: a dependency edge with a semantic role.

    Roles: ``text_embeds`` | ``latent`` | ``sched`` | ``output`` |
    ``kv_cache`` (DESIGN.md §11 — the per-request cross-step feature
    cache: a migratable side artifact that no task *depends* on, so it
    never gates readiness; the control plane's residency tracker decides
    when its bytes are live).
    """
    id: str
    request_id: str
    role: str
    fields: dict[str, FieldSpec] = field(default_factory=dict)
    # materialization (set when the producer completes)
    layout: Optional["ExecutionLayout"] = None
    data: Optional[dict] = None     # rank -> {field: np.ndarray shard}
    materialized: bool = False

    @property
    def nbytes(self) -> int:
        return sum(f.nbytes for f in self.fields.values()
                   if f.kind != "meta")


# ---------------------------------------------------------------------------
# Cluster topology (DESIGN.md §10)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ClusterTopology:
    """Hosts x local ranks, with link parameters.

    Global rank ``r`` lives on host ``r // ranks_per_host``.  Intra-host
    links model ICI/NVLink-class interconnect; inter-host links model
    NIC-class fabric — the dominant communication cost on any real
    multi-host deployment, which is why placement, cost estimation, GFC
    execution, and migration pricing are all keyed by the *span* (number
    of hosts a layout touches).  The defaults keep the single-host
    numbers identical to the pre-topology runtime (`_LINK_BW`,
    `_MIGRATION_SETUP` in core/simulator.py).
    """
    num_hosts: int = 1
    ranks_per_host: int = 1
    intra_bw: float = 50e9          # bytes/s within a host
    inter_bw: float = 12.5e9        # bytes/s across hosts
    intra_lat: float = 60e-6        # per-transfer setup within a host
    inter_lat: float = 250e-6      # per-transfer setup across hosts
    # heterogeneous fabrics: optional per-host-pair overrides of
    # ``inter_bw`` (e.g. rack-local pairs faster than cross-rack).
    # Accepts a {(h0, h1): bytes/s} mapping; stored canonicalized
    # (sorted pairs, sorted tuple) so the dataclass stays hashable.
    # Absent pairs fall back to ``inter_bw`` — byte-identical default.
    inter_bw_map: Optional[tuple] = None

    def __post_init__(self):
        assert self.num_hosts >= 1 and self.ranks_per_host >= 1
        if self.inter_bw_map is not None:
            merged: dict[tuple[int, int], float] = {}
            for (h0, h1), bw in dict(self.inter_bw_map).items():
                key = (min(h0, h1), max(h0, h1))
                prev = merged.setdefault(key, float(bw))
                assert prev == float(bw), \
                    f"conflicting inter_bw_map entries for hosts {key}"
            assert all(bw > 0 for bw in merged.values())
            object.__setattr__(self, "inter_bw_map",
                               tuple(sorted(merged.items())))

    @property
    def num_ranks(self) -> int:
        return self.num_hosts * self.ranks_per_host

    def inter_bw_of(self, h0: int, h1: int) -> float:
        """Bandwidth of the link between two hosts (override or
        default)."""
        if self.inter_bw_map:
            key = (min(h0, h1), max(h0, h1))
            for pair, bw in self.inter_bw_map:
                if pair == key:
                    return bw
        return self.inter_bw

    @property
    def inter_cost_factor(self) -> float:
        """How much more expensive an inter-host byte is (>= 1); with
        per-pair overrides this is the WORST link's factor (cost
        estimates for a spanning layout must not undersell the slowest
        edge it might cross)."""
        slowest = self.inter_bw
        if self.inter_bw_map:
            slowest = min(slowest, min(bw for _, bw in self.inter_bw_map))
        return max(self.intra_bw / slowest, 1.0)

    def host_of(self, rank: int) -> int:
        return rank // self.ranks_per_host

    def host_ranks(self, host: int) -> tuple[int, ...]:
        base = host * self.ranks_per_host
        return tuple(range(base, base + self.ranks_per_host))

    def hosts_of(self, ranks) -> tuple[int, ...]:
        return tuple(sorted({self.host_of(r) for r in ranks}))

    def span_of(self, ranks) -> int:
        return len({self.host_of(r) for r in ranks})

    @classmethod
    def single_host(cls, num_ranks: int) -> "ClusterTopology":
        return cls(num_hosts=1, ranks_per_host=num_ranks)


def as_topology(topo) -> ClusterTopology:
    """Back-compat shim: ``num_ranks=N`` call sites synthesize a one-host
    topology; existing behavior (placement, pricing, traces) is
    unchanged under it."""
    if isinstance(topo, ClusterTopology):
        return topo
    return ClusterTopology.single_host(int(topo))


# ---------------------------------------------------------------------------
# Execution layouts (paper §3.2)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExecutionLayout:
    """Ordered logical execution group + parallel *shape* (DESIGN.md §14).

    ``cfg`` splits the group into that many classifier-free-guidance
    branches of ``sp = degree // cfg`` ranks each; branch ``b`` owns the
    contiguous rank slice ``ranks[b*sp:(b+1)*sp]`` (contiguity keeps SP
    host-tight while a CFG pair may straddle hosts).  ``cfg=1`` is the
    scalar-SP layout every pre-shape trace used — byte-identical.
    """
    ranks: tuple[int, ...]          # ordered global ranks
    parallel: str = "sp"            # "sp" (sequence parallel) | "single"
    cfg: int = 1                    # CFG split-batch branches (shape dim)

    @property
    def degree(self) -> int:
        return len(self.ranks)

    @property
    def sp(self) -> int:
        """Sequence-parallel degree within one CFG branch."""
        return len(self.ranks) // self.cfg

    def branch_ranks(self, b: int) -> tuple[int, ...]:
        """Ordered ranks of CFG branch ``b``."""
        sp = self.sp
        return self.ranks[b * sp:(b + 1) * sp]

    def branch_of(self, rank: int) -> int:
        """CFG branch index that ``rank`` belongs to."""
        return self.ranks.index(rank) // self.sp

    def span(self, topo: ClusterTopology) -> int:
        """Hosts touched by this layout under `topo`."""
        return topo.span_of(self.ranks)

    def hosts(self, topo: ClusterTopology) -> tuple[int, ...]:
        return topo.hosts_of(self.ranks)

    def __post_init__(self):
        assert len(set(self.ranks)) == len(self.ranks), "duplicate ranks"
        assert self.cfg >= 1 and len(self.ranks) % self.cfg == 0, \
            f"cfg={self.cfg} must divide degree={len(self.ranks)}"


# ---------------------------------------------------------------------------
# Trajectory tasks
# ---------------------------------------------------------------------------

@dataclass
class TrajectoryTask:
    id: str
    request_id: str
    kind: str                       # "encode" | "denoise" | "decode"
    step_index: int = -1            # denoise step number
    inputs: list[str] = field(default_factory=list)    # artifact ids
    outputs: list[str] = field(default_factory=list)
    # shape metadata for cost estimation (model-adapter supplied)
    meta: dict[str, Any] = field(default_factory=dict)
    # runtime state
    state: str = "pending"          # pending|ready|running|done
    layout: Optional[ExecutionLayout] = None
    dispatch_time: float = -1.0
    complete_time: float = -1.0


@dataclass
class Request:
    """An incoming generation request (paper §6.1 workload classes)."""
    id: str
    model: str                      # "dit-image" | "dit-video"
    height: int
    width: int
    frames: int = 1                 # 1 -> image
    steps: int = 50
    arrival: float = 0.0
    deadline: Optional[float] = None
    size_class: str = "M"           # S | M | L
    # classifier-free guidance scale; None -> unguided (single branch,
    # pre-shape behavior byte-identical).  Guided requests run cond +
    # uncond branches — batched on one group (cfg=1) or split across
    # branch groups (cfg>=2), merged v = u + g*(c - u) each step.
    guidance: Optional[float] = None
    # filled by converter
    task_ids: list[str] = field(default_factory=list)
    done_time: Optional[float] = None
    failed: bool = False


@dataclass
class RequestGraph:
    """Tasks + artifacts of one request, with dependency state."""
    request: Request
    tasks: dict[str, TrajectoryTask]
    artifacts: dict[str, Artifact]

    def ready_tasks(self) -> list[TrajectoryTask]:
        out = []
        for t in self.tasks.values():
            if t.state != "pending":
                continue
            if all(self.artifacts[a].materialized for a in t.inputs):
                out.append(t)
        return out

    def total_tasks(self) -> int:
        return len(self.tasks)

    def remaining_tasks(self) -> list[TrajectoryTask]:
        return [t for t in self.tasks.values() if t.state != "done"]

    def is_done(self) -> bool:
        return all(t.state == "done" for t in self.tasks.values())
