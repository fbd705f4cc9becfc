"""Scheduling policies (paper §5.4 + Legacy baseline §6.2).

All policies speak the same interface: observe a SchedulerView, return a
list of control-plane actions (``Dispatch`` / ``Reallocate`` /
``Preempt`` / ``Cancel``, DESIGN.md §3).  They differ ONLY in ranking
and layout choice — dependency tracking, dispatch, dynamic groups, and
migration live in the runtime, which is the paper's central design claim.
The classic policies below emit only ``Dispatch``; :class:`ElasticPolicy`
exercises the full vocabulary.  :class:`PackingPolicy` (and
``ElasticPolicy(pack=True)``) additionally co-schedules batch-compatible
denoise steps from different requests via ``PackedDispatch``
(DESIGN.md §9 step packing).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.migration import migration_cost, plan_migration
from repro_torch.core.scheduler import (Action, Decision, Dispatch, PackedDispatch,
                                  Policy, Preempt, Reallocate, SchedulerView,
                                  pack_signature)
from repro_torch.core.trajectory import ClusterTopology, ExecutionLayout
from repro_torch.diffusion.feature_cache import cache_artifact


# ---------------------------------------------------------------------------
# locality-aware placement helpers (DESIGN.md §10)
# ---------------------------------------------------------------------------

def _by_host(free: list[int], topo: ClusterTopology) -> dict[int, list[int]]:
    out: dict[int, list[int]] = {}
    for r in free:
        out.setdefault(topo.host_of(r), []).append(r)
    return out


def _pick_ranks(free: list[int], k: int,
                topo: Optional[ClusterTopology] = None
                ) -> Optional[tuple[int, ...]]:
    """Pick k free ranks, preferring intra-host contiguous groups: the
    tightest-fitting single host first (leaving large pools intact for
    wide groups), spilling across the fewest hosts (largest pools first)
    only when no single host can satisfy the degree.  On a one-host
    topology this is exactly ``free[:k]`` — existing traces unchanged."""
    if k <= 0 or len(free) < k:
        return None
    if topo is None or topo.num_hosts == 1:
        return tuple(free[:k])
    pools = _by_host(free, topo)
    fits = [h for h, rs in pools.items() if len(rs) >= k]
    if fits:
        h = min(fits, key=lambda h: (len(pools[h]), h))
        return tuple(pools[h][:k])
    picked: list[int] = []
    for h in sorted(pools, key=lambda h: (-len(pools[h]), h)):
        take = min(k - len(picked), len(pools[h]))
        picked.extend(pools[h][:take])
        if len(picked) == k:
            break
    return tuple(sorted(picked))


def _grow_ranks(free: list[int], n: int, topo: Optional[ClusterTopology],
                base: tuple[int, ...]) -> tuple[int, ...]:
    """Pick n extra ranks to grow `base`, preferring ranks on hosts the
    layout already touches (growth should not widen the span when it
    doesn't have to).  Single-host: exactly ``free[:n]``."""
    if topo is None or topo.num_hosts == 1:
        return tuple(free[:n])
    base_hosts = {topo.host_of(r) for r in base}
    same = [r for r in free if topo.host_of(r) in base_hosts]
    if len(same) >= n:
        return tuple(same[:n])
    rest = [r for r in free if topo.host_of(r) not in base_hosts]
    spill = _pick_ranks(rest, n - len(same), topo) or \
        tuple(rest[:n - len(same)])
    return tuple(same) + tuple(spill)


def _shrink_ranks(ranks: tuple[int, ...], tgt: int,
                  topo: Optional[ClusterTopology] = None
                  ) -> tuple[int, ...]:
    """Keep tgt of `ranks`, dropping the hosts with the fewest members
    first so the shrunk pin *reduces* span whenever it can.  Original
    rank order is preserved.  Single-host: exactly ``ranks[:tgt]``."""
    if topo is None or topo.num_hosts == 1:
        return ranks[:tgt]
    count: dict[int, int] = {}
    for r in ranks:
        count[topo.host_of(r)] = count.get(topo.host_of(r), 0) + 1
    keep: set[int] = set()
    for h in sorted(count, key=lambda h: (-count[h], h)):
        for r in ranks:
            if topo.host_of(r) == h and len(keep) < tgt:
                keep.add(r)
        if len(keep) >= tgt:
            break
    return tuple(r for r in ranks if r in keep)


def _repin_ranks(lay_ranks: tuple[int, ...], free: list[int], k: int,
                 topo: ClusterTopology) -> Optional[tuple[int, ...]]:
    """A same-degree single-host replacement for a spanning layout,
    preferring the host already holding the most of the layout's ranks
    (fewest migrated bytes).  ``None`` when no host fits the degree."""
    best = None
    for h in range(topo.num_hosts):
        own = [r for r in lay_ranks if topo.host_of(r) == h]
        fr = [r for r in free if topo.host_of(r) == h]
        if len(own) + len(fr) < k:
            continue
        key = (-len(own), h)
        if best is None or key < best[0]:
            best = (key, own, fr)
    if best is None:
        return None
    _, own, fr = best
    return tuple(sorted((own + fr)[:k]))


def _pick_shape_ranks(free: list[int], degree: int, cfg: int,
                      topo: Optional[ClusterTopology] = None
                      ) -> Optional[tuple[int, ...]]:
    """Ranks for a ``(cfg x sp)`` shape (DESIGN.md §14): each CFG branch
    is an independent host-tight SP pick — branches exchange only the
    per-step merge, so the branch PAIR may straddle hosts while each
    branch's gather collectives stay intra-host whenever any host can
    seat ``sp`` ranks.  Branch 0 (cond) leads the tuple so
    ``ExecutionLayout.branch_ranks`` slices the concatenation back into
    branches."""
    if cfg <= 1:
        return _pick_ranks(free, degree, topo)
    sp = degree // cfg
    if sp < 1 or sp * cfg != degree:
        return None
    picked: list[int] = []
    pool = list(free)
    for _ in range(cfg):
        grp = _pick_ranks(pool, sp, topo)
        if grp is None:
            return None
        picked.extend(grp)
        pool = [r for r in pool if r not in set(grp)]
    return tuple(picked)


def _contiguous(free: list[int], k: int,
                topo: Optional[ClusterTopology] = None
                ) -> Optional[tuple[int, ...]]:
    """Pick k free ranks (ordered; locality-aware under a topology)."""
    return _pick_ranks(free, k, topo)


def _edf_key(trg) -> tuple:
    """EDF ordering with a tie-break on the REQUEST id: request ids are
    identical on both execution backends (the caller names them), while
    task ids come from a process-global counter whose lexicographic
    order differs between legs.  A request has at most one ready task
    (its trajectory is a chain), so this is a total order."""
    t, req, _ = trg
    return (req.deadline if req.deadline is not None else math.inf,
            req.arrival, req.id)


def _pack_slack_ok(view: SchedulerView, model: str, tokens: int,
                   degree: int, members: list, extra,
                   margin: float = 1.05) -> bool:
    """Deadline-slack admission rule (DESIGN.md §9): `extra` may join the
    pack only if no member of the enlarged pack is pushed past an SLO it
    could still meet — the batched step costs ``estimate_packed(b+1)``
    and each member then finishes its remaining trajectory solo.  A
    member whose deadline is unmeetable even at FULL parallelism never
    blocks admission: its deadline is sunk cost, and batching it is
    strictly cheaper for everyone else than a private rank set.  (The
    sunk test must use full parallelism, not the pack's degree — a
    request that only meets its SLO at a higher SP degree must fall
    through to a wide solo dispatch, not be absorbed into a narrow
    pack.)"""
    cost = view.cost
    trial = members + [extra]
    dur = cost.estimate_packed(model, "denoise", tokens, degree,
                               len(trial))
    step_solo = cost.estimate(model, "denoise", tokens, degree)
    for t, req, g in trial:
        if req.deadline is None:
            continue
        rest = max(cost.request_remaining(req.model, g, degree)
                   - step_solo, 0.0)
        if view.now + margin * (dur + rest) <= req.deadline:
            continue            # meets its SLO inside this pack
        if view.now + cost.request_remaining(req.model, g,
                                             view.num_ranks) \
                <= req.deadline:
            return False        # rescuable outside the pack — don't absorb
    return True


def _pending_denoise_index(view: SchedulerView) -> tuple[dict, set]:
    """Build once per schedule point: (signature -> live request ids
    with a pending denoise of that signature, request ids with any
    running task).  Makes per-task imminence queries O(peers) instead of
    O(requests x tasks)."""
    idx: dict[tuple, set] = {}
    for rid, req in view.requests.items():
        if req.failed or req.done_time is not None \
                or req.arrival > view.now:
            continue
        g = view.graphs.get(rid)
        if g is None:
            continue
        for t in g.tasks.values():
            if t.kind == "denoise" and t.state == "pending":
                idx.setdefault((req.model, t.meta.get("tokens", 4096)),
                               set()).add(rid)
    running_reqs = {task.request_id for task, _ in view.running.values()}
    return idx, running_reqs


def _imminent_peer(sig: tuple, exclude: set, dispatched_reqs: set,
                   peer_idx: dict, running_reqs: set) -> bool:
    """True when a same-signature request will reach its next denoise
    boundary without any new scheduling decision: its previous task is
    running (or was dispatched this schedule point), so waiting one
    boundary is guaranteed to offer a larger pack.  Purely structural —
    no wall-time thresholds — so simulator and thread backend agree
    (DESIGN.md §9)."""
    for rid in peer_idx.get(sig, ()):
        if rid in exclude:
            continue
        if rid in running_reqs or rid in dispatched_reqs:
            return True
    return False


class LegacyPolicy(Policy):
    """Native fixed-pipeline execution with static parallelism (§6.2):
    requests run one at a time, atomically, over the full machine."""
    name = "legacy"

    def __init__(self, sp_degree: Optional[int] = None):
        self.sp_degree = sp_degree
        self._active: Optional[str] = None

    def schedule(self, view: SchedulerView) -> list[Decision]:
        k = self.sp_degree or view.num_ranks
        if view.running:                      # machine-wide serial pipeline
            return []
        # oldest admitted request first; stick to it until it finishes
        ready = sorted(view.ready, key=lambda tr: (tr[1].arrival, tr[0].id))
        if not ready:
            return []
        if self._active is not None:
            for t, req, g in ready:
                if req.id == self._active and not g.is_done():
                    break
            else:
                self._active = None
        if self._active is None:
            self._active = ready[0][1].id
        for t, req, g in ready:
            if req.id == self._active:
                ranks = _contiguous(view.free_ranks, min(k, view.num_ranks),
                                    view.topology)
                if ranks is None:
                    return []
                return [Decision(t.id, ExecutionLayout(ranks))]
        return []


class FCFSPolicy(Policy):
    """FCFS with workload-aware group assignment (§5.4): the cluster is
    partitioned into fixed groups; each ready task goes to the feasible
    group with the lowest estimated queued workload."""
    name = "fcfs"

    def __init__(self, group_size: int = 1):
        self.group_size = group_size
        self._backlog: dict[tuple[int, ...], float] = {}

    def schedule(self, view: SchedulerView) -> list[Decision]:
        g = self.group_size
        groups = [tuple(range(i, i + g))
                  for i in range(0, view.num_ranks - g + 1, g)]
        for gr in groups:
            self._backlog.setdefault(gr, 0.0)
        free = set(view.free_ranks)
        avail = [gr for gr in groups if all(r in free for r in gr)]
        if not avail:
            return []
        out = []
        ready = sorted(view.ready, key=lambda tr: (tr[1].arrival, tr[0].id))
        for t, req, gph in ready:
            if not avail:
                break
            best = min(avail, key=lambda gr: self._backlog[gr])
            est = view.cost.estimate(req.model, t.kind,
                                     t.meta.get("tokens", 4096), g)
            self._backlog[best] += est
            avail.remove(best)
            out.append(Decision(t.id, ExecutionLayout(best)))
        # decay backlog estimates so they track completed work
        for gr in groups:
            self._backlog[gr] *= 0.98
        return out


class SRTFPolicy(Policy):
    """SRTF with per-rank local queues (§5.4): requests are pinned to the
    feasible rank-group with least queued work; each group orders its local
    tasks by shortest remaining trajectory work."""
    name = "srtf"

    def __init__(self, sp_degree: int = 1):
        self.sp_degree = sp_degree
        self._home: dict[str, tuple[int, ...]] = {}
        self._backlog: dict[tuple[int, ...], float] = {}

    def schedule(self, view: SchedulerView) -> list[Decision]:
        g = self.sp_degree if self.sp_degree > 0 else view.num_ranks
        groups = [tuple(range(i, i + g))
                  for i in range(0, view.num_ranks - g + 1, g)]
        for gr in groups:
            self._backlog.setdefault(gr, 0.0)
        # assign new requests to least-loaded group
        for t, req, gph in view.ready:
            if req.id not in self._home:
                best = min(groups, key=lambda gr: self._backlog[gr])
                self._home[req.id] = best
                self._backlog[best] += view.cost.request_remaining(
                    req.model, gph, g)
        free = set(view.free_ranks)
        out = []
        # per group: pick the ready task of the request with the shortest
        # remaining trajectory work
        for gr in groups:
            if not all(r in free for r in gr):
                continue
            cands = [(t, req, gph) for t, req, gph in view.ready
                     if self._home.get(req.id) == gr]
            if not cands:
                continue
            t, req, gph = min(
                cands, key=lambda trg: view.cost.request_remaining(
                    trg[1].model, trg[2], g))
            out.append(Decision(t.id, ExecutionLayout(gr)))
            free -= set(gr)
        return out


class EDFPolicy(Policy):
    """EDF with best-fit parallelism (§5.4): order by deadline; choose the
    smallest SP degree predicted to finish the request by its deadline,
    escalating at trajectory boundaries when a request is at risk."""
    name = "edf"

    def __init__(self, max_degree: Optional[int] = None,
                 candidate_degrees: Optional[list[int]] = None):
        self.max_degree = max_degree
        self.candidates = candidate_degrees

    def schedule(self, view: SchedulerView) -> list[Decision]:
        maxd = self.max_degree or view.num_ranks
        cands = self.candidates or \
            [d for d in (1, 2, 4, 8, 16, 32) if d <= maxd]
        ready = sorted(view.ready,
                       key=lambda tr: (tr[1].deadline if tr[1].deadline
                                       is not None else math.inf,
                                       tr[1].arrival))
        free = list(view.free_ranks)
        out = []
        for t, req, gph in ready:
            if not free:
                break
            feasible = [d for d in cands if d <= len(free)]
            if not feasible:
                continue
            choice = feasible[-1]          # largest, if nothing meets SLO
            if req.deadline is None:
                choice = feasible[0]
            else:
                for d in feasible:         # smallest that meets deadline
                    eta = view.now + view.cost.request_remaining(
                        req.model, gph, d)
                    if eta <= req.deadline:
                        choice = d
                        break
            ranks = _pick_ranks(free, choice, view.topology)
            free = [r for r in free if r not in set(ranks)]
            out.append(Decision(t.id, ExecutionLayout(ranks)))
        return out


class PackingPolicy(Policy):
    """TetriServe-style step packing (DESIGN.md §9).

    Denoise steps from different requests that share a
    :func:`pack_signature` (same model, same token shape) are
    co-scheduled as ONE batched executor call on a shared rank set.
    Packs are formed greedily in EDF order under a deadline-slack
    constraint: a task is never admitted if the enlarged pack's batched
    step would push any member past its SLO.  A pack below ``max_pack``
    may also *hold* for one trajectory boundary when a compatible peer is
    imminent (its previous task is running or was dispatched this very
    schedule point) and every member can afford the wait — a structural
    trigger, so both execution backends make the same call.  Encode and
    decode stages dispatch unpacked at degree 1.
    """
    name = "packing"

    def __init__(self, degree: int = 1, max_pack: int = 8,
                 hold_for_peers: bool = True, slack_margin: float = 1.05):
        self.degree = degree
        self.max_pack = max_pack
        self.hold_for_peers = hold_for_peers
        self.slack_margin = slack_margin

    # -- helpers -------------------------------------------------------
    def _form_pack(self, view: SchedulerView, sig: tuple, members: list,
                   dispatched_reqs: set, peer_idx: dict,
                   running_reqs: set) -> Optional[list]:
        """Pop a greedy, slack-feasible pack off the EDF-sorted member
        list; ``None`` means hold this group for an imminent peer."""
        model, tokens = sig
        cost = view.cost
        pack = [members.pop(0)]
        i = 0
        while i < len(members) and len(pack) < self.max_pack:
            if _pack_slack_ok(view, model, tokens, self.degree, pack,
                              members[i], self.slack_margin):
                pack.append(members.pop(i))
            else:
                i += 1
        if self.hold_for_peers and len(pack) < self.max_pack and \
                _imminent_peer(sig, {req.id for _, req, _ in pack},
                               dispatched_reqs, peer_idx, running_reqs):
            # waiting costs at most ~one solo step (the peer's boundary)
            step_solo = cost.estimate(model, "denoise", tokens, self.degree)
            dur = cost.estimate_packed(model, "denoise", tokens,
                                       self.degree, len(pack) + 1)
            can_wait = all(
                req.deadline is None or
                view.now + step_solo + self.slack_margin * (
                    dur + max(cost.request_remaining(req.model, g,
                                                     self.degree)
                              - step_solo, 0.0)) <= req.deadline
                for _, req, g in pack)
            if can_wait:
                members[:0] = pack          # put back in EDF position
                return None
        return pack

    # -- policy --------------------------------------------------------
    def schedule(self, view: SchedulerView) -> list[Action]:
        actions: list[Action] = []
        free = list(view.free_ranks)
        ready = sorted(view.ready, key=_edf_key)
        dispatched_reqs: set[str] = set()
        peer_idx, running_reqs = _pending_denoise_index(view)
        denoise = []
        for t, req, g in ready:
            if t.kind in ("encode", "decode"):
                if free:
                    pick = _pick_ranks(free, 1, view.topology)
                    free = [r for r in free if r not in set(pick)]
                    actions.append(Dispatch(t.id, ExecutionLayout(pick)))
                    dispatched_reqs.add(req.id)
            else:
                denoise.append((t, req, g))
        groups: dict[tuple, list] = {}
        for trg in denoise:
            groups.setdefault(pack_signature(trg[0], trg[1]),
                              []).append(trg)
        for sig in sorted(groups, key=lambda s: _edf_key(groups[s][0])):
            members = groups[sig]
            while members and len(free) >= self.degree:
                pack = self._form_pack(view, sig, members,
                                       dispatched_reqs, peer_idx,
                                       running_reqs)
                if pack is None:
                    break                   # held for an imminent peer
                # pack layouts rank by topology-priced cost: a pack's
                # collectives are paid once per step, so the minimal-span
                # placement _pick_ranks prefers is also the cheapest
                ranks = _pick_ranks(free, self.degree, view.topology)
                free = [r for r in free if r not in set(ranks)]
                dispatched_reqs.update(req.id for _, req, _ in pack)
                if len(pack) == 1:
                    actions.append(Dispatch(pack[0][0].id,
                                            ExecutionLayout(ranks)))
                else:
                    actions.append(PackedDispatch(
                        tuple(t.id for t, _, _ in pack),
                        ExecutionLayout(ranks)))
        return actions


class ElasticPolicy(Policy):
    """Elastic scheduling over the full action vocabulary (§3.2, §5.4).

    Requests with a deadline are SLO-critical; requests with
    ``deadline=None`` are best-effort.  Four behaviours, in priority
    order each schedule point:

    * **preempt** — when ready SLO work cannot start because best-effort
      tasks hold the machine, running best-effort tasks are preempted
      (requeued with inputs intact; their ranks free at the next device
      boundary);
    * **grow** — a running deadline request predicted to miss its SLO is
      granted additional free ranks via ``Reallocate``, effective at its
      next denoise boundary; an idle machine similarly grows a lone
      best-effort request to soak up free ranks;
    * **shrink** — when the ready queue outgrows the machine,
      over-provisioned running requests are shrunk at their next
      boundary, releasing ranks to drain the queue;
    * **dispatch** — EDF order with best-fit SP degree (smallest degree
      predicted to meet the deadline); best-effort work only uses ranks
      not reserved for incomplete SLO requests, which keeps it from
      thrashing against preemption.
    """
    name = "elastic"

    def __init__(self, candidate_degrees: Optional[list[int]] = None,
                 max_degree: Optional[int] = None,
                 shrink_queue_factor: float = 1.0,
                 preempt_min_degree: int = 2,
                 pack: bool = False, max_pack: int = 8,
                 topology_aware: bool = True,
                 cache_affinity: bool = False,
                 hybrid: bool = False):
        self.candidates = candidate_degrees
        self.max_degree = max_degree
        self.shrink_queue_factor = shrink_queue_factor
        # step packing (DESIGN.md §9): when on, compatible denoise
        # dispatches of one schedule point merge into PackedDispatch
        self.pack = pack
        self.max_pack = max_pack
        # feature-cache affinity (DESIGN.md §11): when on and the plane
        # serves with a staleness window, remaining-work estimates use
        # the refresh/hit cost mixture, denoise dispatches re-use a warm
        # cache's rank set when it is free, and a warm cache raises the
        # bar for shrink (the re-refresh tax must re-amortize) and for
        # re-pin (the snapshot's migration must pay for itself) — all
        # priced through the cost model, never by fiat.
        self.cache_affinity = cache_affinity
        # topology awareness (DESIGN.md §10): when on, placement prefers
        # intra-host groups, degree choice prices the span a candidate
        # layout would touch, and spanning requests re-pin onto one host
        # when capacity opens up.  ``False`` is the topology-blind
        # baseline (identical to pre-topology behavior on any cluster).
        self.topology_aware = topology_aware
        # hybrid shape search (DESIGN.md §14): when on, guided requests
        # are sized over (cfg x sp) shapes — the same total degree can
        # be spent as SP width or as a CFG branch split with one merge
        # exchange per step — priced through the shape-keyed cost
        # cells, and running guided work may Reallocate-RESHAPE to the
        # cheaper shape of its rank set at a denoise boundary.  ``False``
        # never emits a cfg>1 layout: scalar-SP behavior is untouched.
        self.hybrid = hybrid
        # Preemption takes effect at the victim's device boundary (the
        # in-flight slice cannot be killed on either backend), so evicting
        # a single-rank task frees its rank no earlier than letting it
        # finish — it only discards the slice.  Preempt only multi-rank
        # groups, whose ranks an SLO group genuinely needs en bloc.
        self.preempt_min_degree = preempt_min_degree

    # -- helpers -------------------------------------------------------
    def _cands(self, view: SchedulerView) -> list[int]:
        # cap candidate degrees at the ALIVE rank count: after a host
        # loss (DESIGN.md §13) no layout wider than the survivors can
        # ever dispatch, so sizing against it just wastes schedule points
        maxd = self.max_degree or max(view.num_alive, 1)
        return self.candidates or \
            [d for d in (1, 2, 4, 8, 16, 32) if d <= maxd]

    def _topo(self, view: SchedulerView) -> Optional[ClusterTopology]:
        """The topology placement/pricing should see (None when blind
        or single-host — both reduce to the pre-topology behavior)."""
        topo = view.topology
        if not self.topology_aware or topo is None or topo.num_hosts == 1:
            return None
        return topo

    def _min_span(self, view: SchedulerView, d: int) -> int:
        """Smallest span a degree-d layout can achieve on this cluster
        (what a locality-aware placement would produce)."""
        topo = self._topo(view)
        if topo is None:
            return 1
        return -(-d // topo.ranks_per_host)

    def _interval(self, view: SchedulerView) -> int:
        """Effective staleness window this policy prices with (1 when
        affinity is off or the plane serves uncached)."""
        return view.cache_interval if self.cache_affinity else 1

    def _warm(self, view: SchedulerView, rid: str):
        """The request's warm-cache entry, when affinity applies."""
        if self._interval(view) <= 1:
            return None
        return view.cache_residency.get(rid)

    def _remaining(self, view, req, g, d, span: int = 1,
                   cfg: int = 0) -> float:
        itv = self._interval(view) if d > 1 else 1
        return view.cost.request_remaining(req.model, g, d, span,
                                           cache_interval=itv, cfg=cfg)

    def _need_degree(self, view, req, g) -> int:
        """Smallest degree predicted to meet the deadline; the largest
        candidate when nothing meets it (degrade gracefully).  Candidate
        degrees are priced at the span their locality-aware placement
        would touch (DESIGN.md §10) — a spanning degree-8 layout is NOT
        assumed to cost the same as a host-local one."""
        cands = self._cands(view)
        if req.deadline is None:
            return 1
        if not any(t.kind == "denoise" and t.state == "pending"
                   for t in g.tasks.values()):
            return 1        # only single-rank encode/decode stages left
        for d in cands:
            if view.now + self._remaining(view, req, g, d,
                                          self._min_span(view, d)) \
                    <= req.deadline:
                return d
        return cands[-1]

    def _need_shape(self, view, req, g) -> tuple[int, int]:
        """Best-fit (degree, cfg) shape (DESIGN.md §14): the smallest
        TOTAL degree whose cheaper shape meets the deadline; shapes at
        one degree are tied by the shape-keyed remaining-work estimate
        (a comm-bound guided step favors the split — halved gather
        participants beat the halved per-branch FLOP share).  Reduces to
        ``(_need_degree, 1)`` exactly when shape search is off or the
        request is unguided, so scalar policies never see shapes."""
        if not self.hybrid or getattr(req, "guidance", None) is None:
            return self._need_degree(view, req, g), 1
        cands = self._cands(view)
        if not any(t.kind == "denoise" and t.state == "pending"
                   for t in g.tasks.values()):
            return 1, 1     # only single-rank encode/decode stages left
        best = (cands[-1], 1)
        for d in cands:
            shapes = [(d, 1)] + ([(d, 2)] if d >= 2 and d % 2 == 0
                                 else [])
            # both shapes price the span a locality-aware placement of d
            # ranks touches; the cost model derives the branch span from
            # it (analytical: branch_span = ceil(span / cfg))
            priced = sorted(
                (self._remaining(view, req, g, dd,
                                 self._min_span(view, dd), cfg=c), c)
                for dd, c in shapes)
            rem, c = priced[0]
            best = (d, c)
            if req.deadline is None:
                return 1, 1
            if view.now + rem <= req.deadline:
                return d, c
        return best

    def _pack_hold_ok(self, view, t, req, g, degree, dispatched,
                      peer_idx, running_reqs) -> bool:
        """Hold a lone denoise step for one boundary when a compatible
        peer is imminent, so the two chains align and co-batch from the
        next step on.  Never holds when enough peers are already ready
        to fill a pack, and never when waiting would cost a deadline
        still meetable at ANY parallelism (truly sunk deadlines hold
        freely — aligning them only helps throughput)."""
        sig = pack_signature(t, req)
        peers_ready = sum(
            1 for t2, r2, _ in view.ready if t2.kind == "denoise"
            and pack_signature(t2, r2) == sig)
        if peers_ready >= self.max_pack:
            return False
        if not _imminent_peer(sig, {req.id}, dispatched, peer_idx,
                              running_reqs):
            return False
        if req.deadline is None:
            return True
        cost = view.cost
        step_solo = cost.estimate(req.model, "denoise", sig[1], degree)
        rest = max(cost.request_remaining(req.model, g, degree)
                   - step_solo, 0.0)
        dur2 = cost.estimate_packed(req.model, "denoise", sig[1], degree, 2)
        if view.now + step_solo + 1.05 * (dur2 + rest) <= req.deadline:
            return True         # can afford the one-boundary wait
        # cannot afford the wait: hold only a truly sunk deadline
        return view.now + cost.request_remaining(req.model, g,
                                                 view.num_ranks) \
            > req.deadline

    # -- policy --------------------------------------------------------
    def schedule(self, view: SchedulerView) -> list[Action]:
        actions: list[Action] = []
        cands = self._cands(view)
        # ranks already promised to reallocation pins are not ours
        pin_reserved = set()
        for lay in view.pinned.values():
            pin_reserved |= set(lay.ranks)
        free = [r for r in view.free_ranks if r not in pin_reserved]

        run_by_req: dict[str, list] = {}
        for tid, (task, lay) in view.running.items():
            run_by_req.setdefault(task.request_id, []).append((task, lay))

        # pinned denoise work is auto-dispatched by the control plane
        ready = [trg for trg in view.ready
                 if not (trg[0].kind == "denoise"
                         and trg[1].id in view.pinned)]
        # tie-breaks use request ids (stable across backends; task ids
        # come from a process-global counter — see _edf_key)
        slo_ready = sorted(
            [trg for trg in ready if trg[1].deadline is not None],
            key=lambda trg: (trg[1].deadline, trg[1].arrival, trg[1].id))
        be_ready = sorted(
            [trg for trg in ready if trg[1].deadline is None],
            key=lambda trg: (trg[1].arrival, trg[1].id))

        queue_depth = len(view.ready)

        def effective_layout(rid):
            """The layout governing the request's NEXT denoise boundary:
            its reallocation pin if set, else its running layout."""
            if rid in view.pinned:
                return view.pinned[rid]
            den = [(t, lay) for t, lay in run_by_req.get(rid, [])
                   if t.kind == "denoise" and t.id not in view.preempting]
            return den[0][1] if den else None

        topo = self._topo(view)

        # ---- 1. shrink over-provisioned work when the queue grows ----
        # (a pin replacement keeps the victim progressing at a smaller
        # degree — strictly cheaper than preemption, which discards the
        # in-flight slice for ranks that free at the same boundary)
        shrink_reclaim = 0
        if queue_depth > self.shrink_queue_factor * view.num_ranks:
            itv = self._interval(view)
            # relief target: stop shrinking once the post-boundary free
            # pool could hand every queued task a rank (capped by the
            # machine) — shrinking further only slows victims without
            # draining the queue any faster
            relief = min(queue_depth, view.num_ranks)
            # warm-cache victims go LAST (DESIGN.md §11): when partial
            # relief suffices, cold requests give up their ranks first
            # and warm caches survive
            order = sorted(run_by_req,
                           key=lambda r: (self._warm(view, r)
                                          is not None, r))
            for rid in order:
                if len(free) + shrink_reclaim >= relief:
                    break
                req = view.requests[rid]
                if req.deadline is not None:
                    continue        # SLO work is already best-fit sized
                lay = effective_layout(rid)
                if lay is None:
                    continue
                g = view.graphs[rid]
                tgt = self._need_degree(view, req, g)
                if tgt >= lay.degree:
                    continue
                if tgt > 1 and self._warm(view, rid) is not None:
                    # a degree change invalidates the warm cache: the
                    # request pays ONE extra refresh (a full gather
                    # where a hit was due) before hits resume at the new
                    # degree.  The tax and the per-hit repayment are the
                    # same cost-model quantity (uncached - cached step),
                    # so the bar reduces to a structural runway test:
                    # skip the shrink only when fewer than ~itv/(itv-1)
                    # steps remain to repay the one lost hit.  When the
                    # calibrated hit cell is not actually cheaper
                    # (saving <= 0) the cache is worthless and the
                    # shrink proceeds; at tgt=1 there is no collective
                    # to refresh, so nothing is lost either way.
                    pend = [t for t in g.tasks.values()
                            if t.kind == "denoise" and t.state != "done"]
                    tok = pend[0].meta.get("tokens", 4096) if pend \
                        else 4096
                    saving = view.cost.estimate(
                        req.model, "denoise", tok, tgt) - \
                        view.cost.estimate(req.model, "denoise", tok,
                                           tgt, cached=True)
                    if saving > 0 and len(pend) * (itv - 1) <= itv:
                        continue
                # drop the minority hosts first: the shrunk pin
                # should reduce span whenever it can (DESIGN.md §10)
                if view.telemetry is not None:
                    # decision explanation (DESIGN.md §15): the beaten
                    # alternatives are structural; clock-derived numbers
                    # ride the auto-dropped "metrics" sub-dict
                    view.telemetry.stage("reallocate", rid, {
                        "why": "shrink", "from_degree": lay.degree,
                        "to_degree": tgt,
                        "alternatives": [
                            {"choice": "hold-degree"},
                            {"choice": "preempt"}],
                        "metrics": {"queue_depth": queue_depth,
                                    "relief": relief,
                                    "free": len(free)}})
                actions.append(Reallocate(
                    rid, ExecutionLayout(
                        _shrink_ranks(lay.ranks, tgt, topo))))
                shrink_reclaim += lay.degree - tgt

        # ---- 2. preempt best-effort work for SLO-critical arrivals ---
        # only when no reclaim (preempt drain or shrink boundary) is
        # already in flight: ranks free at boundaries either way, and one
        # elastic response per event avoids discard churn
        demand = sum(self._need_degree(view, req, g)
                     for _, req, g in slo_ready)
        pending_reclaim = sum(
            lay.degree for tid, (t, lay) in view.running.items()
            if tid in view.preempting)
        reclaiming = pending_reclaim + shrink_reclaim
        lack = min(demand, view.num_alive) - len(free) - reclaiming
        if reclaiming == 0:
            # tie-break on request id (stable across backends; at most
            # one running denoise per request — see _edf_key)
            victims = sorted(
                [(t, lay) for t, lay in view.running.values()
                 if view.requests[t.request_id].deadline is None
                 and t.id not in view.preempting
                 and lay.degree >= self.preempt_min_degree],
                key=lambda tl: (-tl[1].degree, tl[0].request_id,
                                tl[0].id))
            for t, lay in victims:
                if lack <= 0:
                    break
                if view.telemetry is not None:
                    view.telemetry.stage("preempt", t.id, {
                        "why": "slo-demand",
                        "victim_degree": lay.degree,
                        "alternatives": [
                            {"choice": "shrink",
                             "note": "no free boundary to pin"},
                            {"choice": "wait-for-boundary"}],
                        # view.alerts is READ-ONLY context (§16): the
                        # live monitor state rides the explanation's
                        # volatile metrics — observing it never branches
                        # the decision, so traces stay backend- and
                        # monitor-independent
                        "metrics": {"demand": demand, "lack": lack,
                                    "alerts_active": len(view.alerts)}})
                actions.append(Preempt(t.id))
                reclaiming += lay.degree
                lack -= lay.degree

        # ---- 3. grow under-provisioned running requests --------------
        shrunk = {a.request_id for a in actions
                  if isinstance(a, Reallocate)}
        for rid in sorted(run_by_req):
            req = view.requests[rid]
            g = view.graphs[rid]
            if rid in shrunk or not free:
                continue
            lay = effective_layout(rid)
            if lay is None:
                continue
            cur_span = topo.span_of(lay.ranks) if topo else 1
            if req.deadline is not None:
                # straggler: grant ranks so the next boundary can meet
                # (or come closest to) the deadline
                eta = view.now + self._remaining(view, req, g, lay.degree,
                                                 cur_span)
                if eta <= req.deadline:
                    continue
                # grow only when the larger degree actually rescues the
                # deadline — a lost deadline is sunk cost, and grabbing
                # the machine for it starves still-winnable requests.
                # The rescue test prices the span the grown layout would
                # actually touch (DESIGN.md §10).
                want, alts = None, []
                for d in cands:
                    if d <= lay.degree or d - lay.degree > len(free):
                        continue
                    ext = _grow_ranks(free, d - lay.degree, topo,
                                      lay.ranks)
                    span_d = topo.span_of(lay.ranks + ext) if topo else 1
                    eta_d = view.now + self._remaining(view, req, g, d,
                                                       span_d)
                    if view.telemetry is not None:
                        alts.append({"degree": d,
                                     "metrics": {
                                         "eta": eta_d,
                                         "rescues":
                                         eta_d <= req.deadline}})
                    if eta_d <= req.deadline:
                        want = d
                        break
            else:
                # idle machine, empty queue: let lone best-effort work
                # soak up free ranks
                if queue_depth or slo_ready or len(run_by_req) > 1:
                    continue
                bigger = [d for d in cands
                          if lay.degree < d <= lay.degree + len(free)]
                want = bigger[-1] if bigger else None
                alts = [{"degree": d} for d in bigger]
            if want is None or want <= lay.degree:
                continue
            if view.telemetry is not None:
                view.telemetry.stage("reallocate", rid, {
                    "why": ("grow-rescue" if req.deadline is not None
                            else "grow-soak"),
                    "from_degree": lay.degree, "to_degree": want,
                    "alternatives": alts})
            extra = _grow_ranks(free, want - lay.degree, topo, lay.ranks)
            free = [r for r in free if r not in set(extra)]
            actions.append(Reallocate(rid, ExecutionLayout(
                lay.ranks + extra)))

        # ---- 3b. topology: re-pin spanning work onto fewer hosts -----
        # A running request whose layout straddles hosts pays the
        # inter-host collective tax every step; once a single host can
        # seat its degree, a same-degree re-pin (preferring the host
        # already holding most of its ranks) reduces span at the next
        # boundary for one bounded migration (DESIGN.md §10).
        if topo is not None:
            realloced = {a.request_id for a in actions
                         if isinstance(a, Reallocate)}
            for rid in sorted(run_by_req):
                if rid in realloced or rid in view.pinned:
                    continue
                lay = effective_layout(rid)
                if lay is None or topo.span_of(lay.ranks) <= 1:
                    continue
                g = view.graphs[rid]
                # the re-pin migrates once but saves every remaining
                # step: only worth it with >= 2 denoise steps left
                pending = sum(1 for t in g.tasks.values()
                              if t.kind == "denoise"
                              and t.state == "pending")
                if pending < 2:
                    continue
                cand = _repin_ranks(lay.ranks, free, lay.degree, topo)
                if cand is None:
                    continue
                ent = self._warm(view, rid)
                if ent is not None and ent.layout.ranks == lay.ranks:
                    # a same-degree re-pin MOVES the warm snapshot
                    # (DESIGN.md §11): the span saving over the request's
                    # remaining steps must pay for shipping the cache's
                    # bytes across the cluster — priced from the actual
                    # transfer plan, like any migration
                    cart = cache_artifact(view.graphs[rid])
                    req = view.requests[rid]
                    move = migration_cost(
                        plan_migration(cart.fields, ent.layout,
                                       ExecutionLayout(cand)), topo) \
                        if cart is not None else 0.0
                    gain = self._remaining(
                        view, req, g, lay.degree,
                        topo.span_of(lay.ranks)) - self._remaining(
                        view, req, g, lay.degree, 1)
                    if move >= gain:
                        continue
                free = [r for r in free if r not in set(cand)]
                if view.telemetry is not None:
                    view.telemetry.stage("reallocate", rid, {
                        "why": "repin-span",
                        "from_span": topo.span_of(lay.ranks),
                        "to_span": topo.span_of(cand),
                        "pending_steps": pending,
                        "alternatives": [{"choice": "stay-spanning"}]})
                actions.append(Reallocate(rid, ExecutionLayout(cand)))

        # ---- 3c. hybrid: reshape running guided work (DESIGN.md §14) -
        # A guided request's degree can be spent two ways — SP width
        # (batched-CFG, B=2 through one group) or a CFG branch split
        # (B=1 per branch + one merge exchange).  When the OTHER shape
        # of the SAME rank set prices cheaper for the remaining chain,
        # Reallocate reshapes at the next denoise boundary; the latent
        # artifact re-slices through the ordinary §5 migration planner
        # (same ranks, different field views).
        if self.hybrid:
            reshaped_guard = {a.request_id for a in actions
                              if isinstance(a, Reallocate)}
            for rid in sorted(run_by_req):
                if rid in reshaped_guard or rid in view.pinned:
                    continue
                req = view.requests[rid]
                if getattr(req, "guidance", None) is None:
                    continue
                lay = effective_layout(rid)
                if lay is None or lay.degree < 2 or lay.degree % 2:
                    continue
                g = view.graphs[rid]
                pending = sum(1 for t in g.tasks.values()
                              if t.kind == "denoise"
                              and t.state == "pending")
                if pending < 2:
                    continue    # the re-slice migration needs runway
                cur = getattr(lay, "cfg", 1)
                alt = 2 if cur == 1 else 1
                span = topo.span_of(lay.ranks) if topo else 1
                rem_alt = self._remaining(view, req, g, lay.degree,
                                          span, cfg=alt)
                rem_cur = self._remaining(view, req, g, lay.degree,
                                          span, cfg=cur)
                if rem_alt < rem_cur:
                    if view.telemetry is not None:
                        view.telemetry.stage("reallocate", rid, {
                            "why": "reshape-cfg", "from_cfg": cur,
                            "to_cfg": alt, "degree": lay.degree,
                            "alternatives": [{"cfg": cur}],
                            "metrics": {"remaining_cur": rem_cur,
                                        "remaining_alt": rem_alt}})
                    actions.append(Reallocate(rid, ExecutionLayout(
                        lay.ranks, cfg=alt)))

        # ---- 4. dispatch ready tasks on what's left ------------------
        # count ranks an incomplete SLO request still needs beyond what
        # it holds; best-effort work may not eat into that reservation
        granted: dict[str, int] = {}    # ranks given out THIS pass
        # open packs of THIS pass: compatible denoise placements share
        # one rank set (DESIGN.md §9); a list, since two packs of the
        # same signature may coexist once the first fills to max_pack
        open_packs: list[dict] = []
        if self.pack:
            peer_idx, running_reqs = _pending_denoise_index(view)

        def try_join(t, req, g) -> bool:
            if not (self.pack and t.kind == "denoise"):
                return False
            if getattr(req, "guidance", None) is not None:
                return False    # packs refuse guided members (§14)
            sig = pack_signature(t, req)
            for pk in open_packs:
                if pk["sig"] != sig or len(pk["members"]) >= self.max_pack:
                    continue
                if _pack_slack_ok(view, sig[0], sig[1], pk["k"],
                                  pk["members"], (t, req, g)):
                    pk["members"].append((t, req, g))
                    granted[req.id] = granted.get(req.id, 0) + pk["k"]
                    if view.telemetry is not None:
                        view.telemetry.stage("dispatch", t.id, {
                            "why": "pack-join", "degree": pk["k"],
                            "pack_size": len(pk["members"]),
                            "alternatives": [{"choice": "solo-ranks"}]})
                    return True
            return False

        def dispatch(t, req, g, k, cfg: int = 1,
                     why: str = "sized") -> bool:
            # callers attempt try_join first; by this point the task
            # needs its own ranks (locality-aware under a topology)
            nonlocal free
            if k <= 0 or k > len(free):
                return False
            ranks, warm_seat = None, False
            if t.kind == "denoise" and k > 1 and cfg == 1:
                # cache affinity (DESIGN.md §11): re-seat a warm request
                # on the exact rank set its snapshot lives on — the next
                # step is then a hit instead of a migrate or refresh
                ent = self._warm(view, req.id)
                if ent is not None and ent.layout.degree == k and \
                        set(ent.layout.ranks) <= set(free):
                    ranks, warm_seat = ent.layout.ranks, True
            if ranks is None:
                ranks = _pick_shape_ranks(free, k, cfg, topo)
                if ranks is None:
                    return False
            if view.telemetry is not None:
                view.telemetry.stage("dispatch", t.id, {
                    "why": why, "degree": k, "cfg": cfg,
                    "warm_seat": warm_seat,
                    "alternatives": [
                        {"degree": d, "feasible": d <= len(free)}
                        for d in cands]})
            free = [r for r in free if r not in set(ranks)]
            granted[req.id] = granted.get(req.id, 0) + k
            if self.pack and t.kind == "denoise" and \
                    getattr(req, "guidance", None) is None:
                open_packs.append({"sig": pack_signature(t, req), "k": k,
                                   "members": [(t, req, g)],
                                   "ranks": ranks})
            else:
                actions.append(Dispatch(t.id,
                                        ExecutionLayout(ranks, cfg=cfg)))
            return True

        for t, req, g in slo_ready:
            if t.kind in ("encode", "decode"):
                if free:
                    dispatch(t, req, g, 1, why="io-step")
                continue
            if try_join(t, req, g):
                continue
            need, ncfg = self._need_shape(view, req, g)
            # bounded hold (DESIGN.md §9): wait one boundary for an
            # imminent compatible peer when that cannot cost the SLO
            if self.pack and ncfg == 1 and \
                    getattr(req, "guidance", None) is None and \
                    self._pack_hold_ok(view, t, req, g, need,
                                       set(granted), peer_idx,
                                       running_reqs):
                continue
            if not dispatch(t, req, g, need, ncfg, why="slo-sized"):
                if reclaiming:
                    continue        # preempted ranks arrive at a boundary
                feas = [d for d in cands if d <= len(free)]
                if not feas:
                    continue
                dispatch(t, req, g, feas[-1], why="slo-fallback")

        slo_reserve = 0
        for rid, req in sorted(view.requests.items()):
            if req.deadline is None or req.failed or \
                    req.done_time is not None or req.arrival > view.now:
                continue
            g = view.graphs.get(rid)
            if g is None or not g.remaining_tasks():
                continue
            held = sum(lay.degree for _, lay in run_by_req.get(rid, [])) \
                + granted.get(rid, 0)
            slo_reserve += max(
                self._need_degree(view, req, g) - held, 0)
        budget = max(len(free) - slo_reserve, 0)
        for t, req, g in be_ready:
            if t.kind in ("encode", "decode"):
                if budget >= 1 and free:
                    dispatch(t, req, g, 1, why="io-step")
                    budget -= 1
                continue
            # a best-effort step may ride along on an open pack even with
            # zero budget: it consumes no reserved ranks, and the slack
            # rule protects the pack's SLO members
            if try_join(t, req, g):
                continue
            if self.pack and getattr(req, "guidance", None) is None and \
                    self._pack_hold_ok(view, t, req, g, 1,
                                       set(granted), peer_idx,
                                       running_reqs):
                continue
            if budget <= 0:
                continue
            if slo_ready or queue_depth > view.num_ranks:
                k = 1
            elif self.pack and sum(
                    1 for t2, r2, _ in be_ready if t2.kind == "denoise"
                    and pack_signature(t2, r2) == pack_signature(t, req)
                    ) > 1:
                k = 1       # co-batch compatible peers instead of growing
            else:
                feas = [d for d in cands if d <= budget]
                k = feas[-1] if feas else 0
            if k <= 0:
                continue
            if dispatch(t, req, g, k, why="best-effort"):
                budget -= k

        # flush open packs (a pack of one is a plain dispatch)
        for pk in open_packs:
            ms = pk["members"]
            if len(ms) == 1:
                actions.append(Dispatch(ms[0][0].id,
                                        ExecutionLayout(pk["ranks"])))
            else:
                actions.append(PackedDispatch(
                    tuple(t.id for t, _, _ in ms),
                    ExecutionLayout(pk["ranks"])))
        return actions


def make_policy(name: str, num_ranks: int) -> Policy:
    """Registry used by benchmarks/examples (--policy flag).

    ``num_ranks`` stays a bare count (back-compat); policies read the
    cluster topology from their SchedulerView at schedule time.
    ``elastic-blind`` is the topology-blind baseline: identical to
    ``elastic`` on one host, but it places by bare rank index on
    multi-host clusters (benchmarks/policies_e2e.py --only multi-host).
    ``elastic-cache`` is the feature-cache-affine variant (DESIGN.md
    §11): identical to ``elastic`` on an uncached plane, but on a plane
    serving with a staleness window it prices remaining work as the
    refresh/hit mixture, re-seats warm requests on their snapshot's
    ranks, and raises the bar for shrink/re-pin of warm requests
    (benchmarks/policies_e2e.py --only cache).
    ``elastic-hybrid`` adds (cfg x sp) shape search for guided requests
    (DESIGN.md §14): identical to ``elastic`` on unguided workloads
    (it never emits a cfg>1 layout for them); on guided work it sizes
    over shapes and reshapes running requests via Reallocate
    (benchmarks/policies_e2e.py --only hybrid).
    """
    table = {
        "legacy": lambda: LegacyPolicy(),
        "fcfs-sp1": lambda: FCFSPolicy(group_size=1),
        "fcfs-sp4": lambda: FCFSPolicy(group_size=min(4, num_ranks)),
        "srtf-sp1": lambda: SRTFPolicy(sp_degree=1),
        "srtf-spmax": lambda: SRTFPolicy(sp_degree=num_ranks),
        "edf": lambda: EDFPolicy(),
        "elastic": lambda: ElasticPolicy(),
        "elastic-blind": lambda: ElasticPolicy(topology_aware=False),
        "elastic-pack": lambda: ElasticPolicy(pack=True),
        "elastic-cache": lambda: ElasticPolicy(cache_affinity=True),
        "elastic-hybrid": lambda: ElasticPolicy(hybrid=True),
        "packing": lambda: PackingPolicy(),
    }
    return table[name]()
