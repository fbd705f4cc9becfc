"""Layout-aware artifact migration (paper §5.3).

Three steps, exactly as the paper describes:
  1. layout exchange — the source-group leader obtains source and
     destination views of each migrated artifact (codec-reported);
  2. migration planning — for each sharded tensor field, intersect every
     source-owned slice with every destination-required slice; each
     non-empty intersection becomes a TransferEntry;
  3. distributed execution — each rank extracts its local actions, packs
     ranges, exchanges data over GFC logical *pair* groups (never a
     silently-constructed process group), installs received ranges.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core.gfc import GroupDescriptor, GroupFreeComm
from repro_torch.core.trajectory import Artifact, ExecutionLayout, FieldSpec
from repro_torch.diffusion.adapters import FieldView, field_view


def np_dtype(name: str) -> np.dtype:
    """Resolve a FieldSpec dtype name to a numpy dtype.  ``bfloat16`` is
    not a native numpy type, and the port does not migrate it: every DiT
    field is float32.  Moving a bfloat16 field as float32 would silently
    change its values' type, so it raises until the slice that first
    moves one."""
    if name == "bfloat16":
        raise NotImplementedError(
            "migrating a bfloat16 field is a later slice of the port "
            "(the DiT serving path moves float32 fields only)")
    return np.dtype(name)


@dataclass(frozen=True)
class TransferEntry:
    field: str
    src_rank: int
    dst_rank: int
    src_range: tuple[int, int]      # (offset, size) in SOURCE-local coords
    dst_range: tuple[int, int]      # (offset, size) in DEST-local coords
    global_range: tuple[int, int]   # (offset, size) in global coords
    nbytes: int


def layout_moved(src: Optional[ExecutionLayout],
                 dst: ExecutionLayout) -> bool:
    """True when moving to ``dst`` requires data movement: a different
    rank set, or a reshape (cfg-dimension change, DESIGN.md §14) that
    re-slices sharded fields even on the SAME ranks — e.g. sp4 ->
    cfg2 x sp2 doubles every rank's slice and replicates it across
    branch peers."""
    if src is None:
        return False
    return src.ranks != dst.ranks or \
        getattr(src, "cfg", 1) != getattr(dst, "cfg", 1)


def plan_migration(fields: dict[str, FieldSpec],
                   src: ExecutionLayout,
                   dst: ExecutionLayout) -> list[TransferEntry]:
    """Derive the transfer plan by slice intersection (leader-side)."""
    entries: list[TransferEntry] = []
    for name, spec in fields.items():
        if spec.kind == "meta":
            continue
        sv = field_view(spec, src)
        dv = field_view(spec, dst)
        itemsize = {"float32": 4, "bfloat16": 2, "float16": 2,
                    "int32": 4}.get(spec.dtype, 4)
        row = itemsize
        for i, d in enumerate(spec.global_shape):
            if i != spec.shard_axis:
                row *= d
        if spec.kind == "replicated":
            # every destination rank needs a full copy; source rank 0 of
            # the view sends to each dst not already holding it
            src_holder = src.ranks[0]
            full = spec.global_shape[spec.shard_axis] \
                if spec.global_shape else 0
            for r in dst.ranks:
                if r in src.ranks:
                    continue
                entries.append(TransferEntry(
                    name, src_holder, r, (0, full), (0, full), (0, full),
                    full * row))
            continue
        # Destination-centric, replication-aware intersection: under a CFG
        # shape (DESIGN.md §14) several source ranks own the SAME global
        # range (branch peers hold bit-identical bytes), so a needed
        # segment is fetched from exactly ONE canonical owner — the
        # earliest in src.ranks order — and segments the destination
        # already holds locally are skipped (those are retains).  With
        # single-owner SP views the source slices are disjoint, so this
        # degenerates to the classic pairwise intersection plan.
        src_order = {r: i for i, r in enumerate(src.ranks)}
        owners = sorted(sv.slices.items(), key=lambda kv: src_order[kv[0]])
        for dr, (doff, dsize) in dv.slices.items():
            needed = [(doff, doff + dsize)]
            if dr in sv.slices:
                l0, s0 = sv.slices[dr]
                needed = _subtract(needed, l0, l0 + s0)
            for sr, (soff, ssize) in owners:
                if not needed:
                    break
                if sr == dr:
                    continue
                remaining = []
                for a, b in needed:
                    lo, hi = max(a, soff), min(b, soff + ssize)
                    if hi <= lo:
                        remaining.append((a, b))
                        continue
                    entries.append(TransferEntry(
                        name, sr, dr, (lo - soff, hi - lo),
                        (lo - doff, hi - lo), (lo, hi - lo),
                        (hi - lo) * row))
                    if a < lo:
                        remaining.append((a, lo))
                    if hi < b:
                        remaining.append((hi, b))
                needed = remaining
    return entries


def _subtract(segments: list[tuple[int, int]], lo: int,
              hi: int) -> list[tuple[int, int]]:
    """Remove [lo, hi) from a list of half-open segments."""
    out = []
    for a, b in segments:
        if hi <= a or b <= lo:
            out.append((a, b))
            continue
        if a < lo:
            out.append((a, lo))
        if hi < b:
            out.append((hi, b))
    return out


def local_retains(fields: dict[str, FieldSpec], src: ExecutionLayout,
                  dst: ExecutionLayout) -> list[tuple]:
    """(field, rank, src_range, dst_range) kept locally (no transfer)."""
    out = []
    for name, spec in fields.items():
        if spec.kind == "meta":
            continue
        sv, dv = field_view(spec, src), field_view(spec, dst)
        for r, (doff, dsize) in dv.slices.items():
            if r not in sv.slices:
                continue
            soff, ssize = sv.slices[r]
            lo, hi = max(soff, doff), min(soff + ssize, doff + dsize)
            if hi > lo:
                out.append((name, r, (lo - soff, hi - lo),
                            (lo - doff, hi - lo)))
    return out


def plan_bytes(entries: list[TransferEntry]) -> int:
    return sum(e.nbytes for e in entries)


def migration_cost(entries: list[TransferEntry], topo) -> float:
    """Topology-priced execution time of a transfer plan (DESIGN.md §10).

    Bytes are aggregated per physical link: an intra-host rank pair is
    its own link; all traffic between one host pair shares one
    inter-host link.  Distinct links transfer in parallel, so the plan's
    time is the slowest link plus one setup (inter-host setup when any
    slice crosses hosts).  This is how ``Reallocate`` across hosts is
    priced honestly: the same byte count costs
    ``intra_bw/inter_bw`` x more once it leaves the host.  Heterogeneous
    fabrics price each host pair at its own ``topo.inter_bw_of`` link
    speed (``ClusterTopology.inter_bw_map``); without overrides this is
    byte-identical to the flat ``inter_bw`` formula.
    """
    if not entries:
        return 0.0
    intra: dict[tuple[int, int], int] = {}
    inter: dict[tuple[int, int], int] = {}
    for e in entries:
        hs, hd = topo.host_of(e.src_rank), topo.host_of(e.dst_rank)
        if hs == hd:
            key = (min(e.src_rank, e.dst_rank), max(e.src_rank, e.dst_rank))
            intra[key] = intra.get(key, 0) + e.nbytes
        else:
            key = (min(hs, hd), max(hs, hd))
            inter[key] = inter.get(key, 0) + e.nbytes
    t_intra = max((b / topo.intra_bw for b in intra.values()), default=0.0)
    t_inter = max((b / topo.inter_bw_of(*pair)
                   for pair, b in inter.items()), default=0.0)
    setup = topo.inter_lat if inter else topo.intra_lat
    return setup + max(t_intra, t_inter)


# ---------------------------------------------------------------------------
# distributed execution over GFC pair groups
# ---------------------------------------------------------------------------

def execute_migration(comm: GroupFreeComm, artifact: Artifact,
                      dst: ExecutionLayout,
                      entries: list[TransferEntry]) -> None:
    """Move artifact.data (rank -> {field: shard}) into layout `dst`.

    Runs on the CONTROL thread for test simplicity: transfers execute
    sequentially over GFC pair groups (each edge still exercises the
    agreement protocol via send/recv on two worker-less inline calls).
    The thread-backend engine executes the same plan from worker threads.
    """
    src = artifact.layout
    new_data: dict[int, dict[str, np.ndarray]] = {r: {} for r in dst.ranks}
    # allocate destination shards
    for name, spec in artifact.fields.items():
        if spec.kind == "meta":
            for r in dst.ranks:
                new_data[r][name] = artifact.data[src.ranks[0]][name]
            continue
        dv = field_view(spec, dst)
        for r in dst.ranks:
            off, size = dv.slices[r]
            shape = list(spec.global_shape)
            shape[spec.shard_axis] = size
            # honor the codec-declared dtype: destination shards must not
            # silently up/down-cast bfloat16/int32 fields
            new_data[r][name] = np.zeros(shape, dtype=np_dtype(spec.dtype))
    # local retains
    for name, r, (soff, size), (doff, _) in local_retains(
            artifact.fields, src, dst):
        spec = artifact.fields[name]
        ax = spec.shard_axis
        src_arr = artifact.data[r][name]
        sl_src = [slice(None)] * src_arr.ndim
        sl_src[ax] = slice(soff, soff + size)
        sl_dst = [slice(None)] * src_arr.ndim
        sl_dst[ax] = slice(doff, doff + size)
        new_data[r][name][tuple(sl_dst)] = src_arr[tuple(sl_src)]
    # transfers (pair-group send/recv; inline = same memory plane)
    for e in entries:
        spec = artifact.fields[e.field]
        ax = spec.shard_axis
        pair = comm.register_group(tuple(sorted((e.src_rank, e.dst_rank))))
        src_arr = artifact.data[e.src_rank][e.field]
        sl = [slice(None)] * src_arr.ndim
        sl[ax] = slice(e.src_range[0], e.src_range[0] + e.src_range[1])
        payload = np.ascontiguousarray(src_arr[tuple(sl)])
        # inline both sides of the pair collective
        comm._stage_put(pair, 0, e.src_rank, payload)
        received = payload
        dl = [slice(None)] * src_arr.ndim
        dl[ax] = slice(e.dst_range[0], e.dst_range[0] + e.dst_range[1])
        new_data[e.dst_rank][e.field][tuple(dl)] = received
    artifact.data = new_data
    artifact.layout = dst
