"""Runtime telemetry plane (DESIGN.md §15).

One :class:`Telemetry` instance observes a single serving run — either
backend — and derives every observability product the runtime offers:

* **rank state timelines** — idle / busy / migrating / collective / dead
  transitions per rank, with utilization and goodput-per-rank summaries;
* **request lifecycle spans** — queued → each denoise step at its shape
  → reallocations / preemptions / rollbacks → decode, exportable as a
  Chrome/Perfetto ``trace.json``;
* **decision records** — every applied control-plane action, stamped
  with the policy's staged explanation (the priced alternatives the
  chosen shape beat);
* **cost-model accuracy** — a predicted-vs-observed stream per
  shape-keyed cost cell with a rolling relative error;
* **GFC formation counters** — per-registration latency samples and a
  setup-latency histogram (the paper's ~60 µs group-setup claim).

Two contracts govern everything here (DESIGN.md §15):

1. **Zero overhead when disabled.**  The runtime holds ``telemetry``
   references that default to ``None``; every instrument site is a
   single ``if tel is not None`` guard.  Telemetry NEVER writes to
   ``ControlPlane.events`` — the decision trace (and therefore every
   ``trace_signature``) is byte-identical whether telemetry is attached
   or not.

2. **Clock-independent cross-backend identity.**  Identity-bearing
   streams (rank state sequences, decision records, lifecycle span
   structure) are recorded ONLY from control-plane-shared code at plane
   sequence points, so a sim run and a wall run of the same workload
   produce identical :meth:`clock_independent` projections — a second
   cross-backend gate alongside ``trace_signature``.  Clock-dependent
   data (timestamps, prices, loop counters, the wall-only collective
   overlay, cost accuracy) is kept in separate streams and excluded
   from the projection: the projection drops every float, every ``t``
   and ``task`` field (task ids are a process-global counter), every
   ``metrics`` sub-record (the staging convention for volatile
   numbers), and flattens pack ids to a bool.

Thread-safety: the control plane drives all identity streams from the
event-loop thread.  Wall-backend worker threads only ever *append* to
per-stream lists (``gfc_register``, ``span``) — GIL-atomic, no locks.
Sink fan-out (which worker threads can also reach) is serialized by a
re-entrant lock.

§16 additions (streaming at fleet scale): every instrument site also
fans its raw record out to attached
:class:`~repro.core.telemetry_sinks.TelemetrySink` objects
(``full_stream`` sinks see everything; raw exporters see only what the
:class:`~repro.core.telemetry_sinks.SamplingPolicy` retains), a
failing sink is detached — logged once, ``sink_detached`` counter
bumped — without ever failing the run, and under an active sampling
policy the in-memory streams go bounded: lifecycle spans only for
sampled-in requests, rank timelines collapsed to run-length-encoded
``mixed`` segments (busy seconds still tracked exactly, so
utilization answers stay precise), decisions/alerts/failures always
retained.  ``SamplingPolicy(rate=1.0)`` (or no policy) is
byte-identical to the §15 instrument.
"""
from __future__ import annotations

import json
import logging
import threading
from typing import Optional

from repro_torch.core.telemetry_sinks import RollupSink

log = logging.getLogger(__name__)


def _raw_info(info: dict) -> dict:
    """Raw-record projection of an instrument site's ``**info``: the
    envelope owns the ``"kind"`` key (record kind), so a task-kind info
    field is renamed ``"kind_"`` (never mutating the caller's dict —
    it is also stored verbatim in the in-memory streams)."""
    if "kind" not in info:
        return info
    out = dict(info)
    out["kind_"] = out.pop("kind")
    return out

#: rank states (DESIGN.md §15 taxonomy).  ``collective`` appears only in
#: the wall backend's overlay stream (the simulator never enters GFC),
#: which is excluded from the identity projection by construction.
RANK_STATES = ("idle", "busy", "migrating", "collective", "dead")

#: keys dropped from the identity projection (see module docstring)
_VOLATILE_KEYS = frozenset({"t", "task", "metrics", "lost"})

#: log2-spaced GFC setup-latency histogram bucket upper bounds (µs)
GFC_BUCKETS_US = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096,
                  float("inf"))


def _sanitize(v):
    """Recursive clock-independent projection of one record value."""
    if isinstance(v, float):
        return None
    if isinstance(v, dict):
        out = {}
        for k, x in v.items():
            if k in _VOLATILE_KEYS:
                continue
            if k == "pack":
                out[k] = bool(x)
                continue
            s = _sanitize(x)
            if s is not None:
                out[k] = s
        return out
    if isinstance(v, (list, tuple, set, frozenset)):
        items = sorted(v) if isinstance(v, (set, frozenset)) else v
        return tuple(s for s in (_sanitize(x) for x in items)
                     if s is not None)
    return v


class Telemetry:
    """Event bus for one serving run.  Construct, pass to
    ``ControlPlane(..., telemetry=tel)`` (or ``ServingEngine``), read the
    products afterwards.  One instance observes ONE plane."""

    def __init__(self, sinks=None, sampling=None):
        # wall anchor: the engine sets this to its WallClock.t0 so the
        # overlay streams (recorded in absolute monotonic time from
        # worker threads) align with plane-relative timestamps
        self.t0: Optional[float] = None
        self.topology = None
        self.num_ranks: Optional[int] = None
        # identity-bearing streams (plane-thread only)
        self.rank_states: dict[int, list] = {}   # r -> [(t, state, info)]
        self.request_order: list[str] = []
        self.lifecycle: dict[str, list] = {}     # rid -> [(t, phase, info)]
        self.decisions: list[dict] = []
        self._staged: dict[tuple, dict] = {}
        # clock-dependent streams
        self.cost_stream: list[dict] = []
        self.cost_cells: dict[str, dict] = {}
        self.counters: dict[str, int] = {}
        self.gfc_register_s: list[float] = []    # worker-thread appends
        self.overlay: dict[int, list] = {}       # r -> [(t, dur, op, size)]
        # §16 streaming: sinks + sampling governor + alert stream
        self.sampling = sampling
        self._sampled = sampling is not None and not sampling.full
        self.sinks: list = []
        self.alerts: list[dict] = []
        self._sink_lock = threading.RLock()
        self._t_last = 0.0                       # stream high-water mark
        # exact busy accounting when timelines go RLE under sampling
        self._rank_open: dict[int, tuple] = {}   # r -> (t, state)
        self._busy_acc: dict[int, float] = {}
        for s in (sinks or ()):
            self.attach_sink(s)

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def attach(self, num_ranks: int, topology=None):
        """Called once by the control plane; all ranks start idle."""
        self.num_ranks = num_ranks
        self.topology = topology
        for r in range(num_ranks):
            self.rank_states.setdefault(r, [(0.0, "idle", {})])

    # ------------------------------------------------------------------
    # sink fan-out (§16): isolation is the contract — a raising sink is
    # detached (logged once, `sink_detached` counter bumped) and the run
    # keeps serving
    # ------------------------------------------------------------------
    def attach_sink(self, sink):
        sink.bind(self)
        self.sinks.append(sink)
        return sink

    def _drop_sink(self, sink, exc) -> None:
        try:
            self.sinks.remove(sink)
        except ValueError:
            pass
        self.counter("sink_detached")
        log.warning("telemetry sink %s detached after error: %r",
                    type(sink).__name__, exc, exc_info=True)

    def _fan_out(self, rec: dict, kept: bool = True) -> None:
        """Forward one raw record: full-stream sinks always, raw
        exporters only when the sampling verdict retained it."""
        if not self.sinks:
            return
        with self._sink_lock:       # re-entrant: monitors emit alerts
            for sink in list(self.sinks):
                if kept or sink.full_stream:
                    try:
                        sink.on_event(rec)
                    except Exception as exc:    # noqa: BLE001 — isolate
                        self._drop_sink(sink, exc)

    def flush_sinks(self) -> None:
        with self._sink_lock:
            for sink in list(self.sinks):
                try:
                    sink.flush()
                except Exception as exc:        # noqa: BLE001 — isolate
                    self._drop_sink(sink, exc)

    def close_sinks(self) -> None:
        with self._sink_lock:
            for sink in list(self.sinks):
                try:
                    sink.close()
                except Exception as exc:        # noqa: BLE001 — isolate
                    self._drop_sink(sink, exc)

    # ------------------------------------------------------------------
    # alerts (§16): monitors re-enter the stream here; always retained
    # ------------------------------------------------------------------
    def alert(self, monitor: str, t: float, **fields) -> dict:
        rec = {"kind": "alert", "monitor": monitor, "t": t, **fields}
        self.alerts.append(rec)
        self.counter("alerts")
        self._fan_out(rec, True)
        return rec

    # ------------------------------------------------------------------
    # rank state timeline (identity-bearing; plane thread only)
    # ------------------------------------------------------------------
    def rank_state(self, t: float, rank: int, state: str, **info):
        seq = self.rank_states.setdefault(rank, [(0.0, "idle", {})])
        if t > self._t_last:
            self._t_last = t
        if not self._sampled:
            # idempotent states: a pack completion fans out per member,
            # each freeing the shared rank set — one idle transition,
            # not N
            if state in ("idle", "dead") and seq[-1][1] == state:
                return
            seq.append((t, state, info))
            if self.sinks:
                self._fan_out({"kind": "rank_state", "t": t, "rank": rank,
                               "state": state, **_raw_info(info)}, True)
            return
        # sampling active: dedup against the true open state (the stored
        # sequence may end in an RLE segment), accumulate busy seconds
        # exactly, and retain either the detail tuple (sampled-in) or a
        # merged `mixed` run-length segment (sampled-out)
        t_open, open_state = self._rank_open.get(rank, (0.0, "idle"))
        if state in ("idle", "dead") and open_state == state:
            return
        if open_state in ("busy", "migrating"):
            self._busy_acc[rank] = self._busy_acc.get(rank, 0.0) \
                + max(t - t_open, 0.0)
        self._rank_open[rank] = (t, state)
        rec = {"kind": "rank_state", "t": t, "rank": rank,
               "state": state, **_raw_info(info)}
        kept = self.sampling.keep(rec)
        if kept:
            seq.append((t, state, info))
        else:
            last = seq[-1]
            if last[1] == "mixed":
                last[2]["n"] += 1
                last[2]["t_end"] = t
            else:
                seq.append((t, "mixed", {"n": 1, "t_end": t}))
        self._fan_out(rec, kept)

    def ranks_idle(self, t: float, ranks):
        for r in sorted(ranks):
            self.rank_state(t, r, "idle")

    def ranks_dead(self, t: float, ranks):
        for r in sorted(ranks):
            self.rank_state(t, r, "dead")

    # ------------------------------------------------------------------
    # request lifecycle (identity-bearing; plane thread only)
    # ------------------------------------------------------------------
    def request_event(self, t: float, rid: str, phase: str, **info):
        if t > self._t_last:
            self._t_last = t
        if not self._sampled:
            if rid not in self.lifecycle:
                self.lifecycle[rid] = []
                self.request_order.append(rid)
            self.lifecycle[rid].append((t, phase, info))
            if self.sinks:
                self._fan_out({"kind": "request", "t": t, "req": rid,
                               "phase": phase, **_raw_info(info)}, True)
            return
        # sampling active: outcome counters stay exact (summary()-grade
        # answers must not depend on which requests were sampled in)
        if phase == "done":
            self.counters["requests_done"] = \
                self.counters.get("requests_done", 0) + 1
            if (info.get("metrics") or {}).get("violation"):
                self.counters["slo_violations"] = \
                    self.counters.get("slo_violations", 0) + 1
        elif phase == "failed":
            self.counters["requests_failed"] = \
                self.counters.get("requests_failed", 0) + 1
        rec = {"kind": "request", "t": t, "req": rid, "phase": phase,
               **_raw_info(info)}
        kept = self.sampling.keep(rec)
        if kept:
            if rid not in self.lifecycle:
                self.lifecycle[rid] = []
                self.request_order.append(rid)
            self.lifecycle[rid].append((t, phase, info))
        self._fan_out(rec, kept)

    # ------------------------------------------------------------------
    # decision records + staged explanations (identity-bearing)
    # ------------------------------------------------------------------
    def begin_schedule(self):
        """Called at every schedule point: explanations staged for
        actions the plane rejected (or the policy reconsidered) must not
        leak onto later, unrelated applications."""
        self._staged.clear()

    def stage(self, kind: str, key, record: dict):
        """Policy-side: stage the explanation for an action about to be
        emitted — ``kind`` in {dispatch, reallocate, preempt}, ``key``
        the action's task/request id.  Volatile numbers belong under the
        record's ``metrics`` sub-dict (dropped from the identity
        projection); structure (why / chosen / alternatives, listed in
        deterministic candidate order, NOT price order) is identity-
        bearing."""
        self._staged[(kind, key)] = record

    def record_action(self, action: str, ev: dict, *, key=None,
                      migrating: bool = False):
        """Plane-side, at action-APPLY time (the wall loop runs many
        more schedule points than the sim — applied actions are the
        stream both backends provably share)."""
        rec = {"action": action, "t": ev.get("t"), "req": ev.get("req")}
        for k in ("task", "kind", "step", "ranks", "cfg", "cache", "pack",
                  "realloc"):
            if ev.get(k) is not None:
                rec[k] = ev[k]
        if migrating:
            rec["migrating"] = True
        rec["explanation"] = self._staged.pop((action, key), None) \
            if key is not None else None
        self.decisions.append(rec)
        t = rec.get("t")
        if t is not None and t > self._t_last:
            self._t_last = t
        if self.sinks:
            drec = _raw_info(rec)       # decision's task-kind -> kind_
            if drec is rec:
                drec = dict(rec)
            drec["kind"] = "decision"
            self._fan_out(drec, True)   # decisions are always retained
        return rec

    # ------------------------------------------------------------------
    # cost-model accuracy (clock-dependent)
    # ------------------------------------------------------------------
    def observe_cost(self, key: str, predicted: float, observed: float,
                     *, t: Optional[float] = None,
                     req: Optional[str] = None):
        rel = abs(predicted - observed) / observed if observed else 0.0
        kept = True
        if self._sampled:       # per-request coherence: samples follow
            kept = self.sampling.keep({"kind": "cost", "req": req})
        if kept:
            self.cost_stream.append({"key": key, "predicted": predicted,
                                     "observed": observed, "rel_err": rel})
        # the per-cell aggregate stays exact regardless of sampling
        cell = self.cost_cells.setdefault(
            key, {"n": 0, "rel_err": rel, "sum_rel_err": 0.0})
        cell["n"] += 1
        cell["sum_rel_err"] += rel
        cell["rel_err"] = 0.5 * cell["rel_err"] + 0.5 * rel   # rolling EMA
        if self.sinks:
            self._fan_out({"kind": "cost",
                           "t": self._t_last if t is None else t,
                           "req": req, "key": key, "predicted": predicted,
                           "observed": observed, "rel_err": rel}, kept)

    # ------------------------------------------------------------------
    # counters + wall overlays (clock-dependent)
    # ------------------------------------------------------------------
    def counter(self, name: str, inc: int = 1):
        self.counters[name] = self.counters.get(name, 0) + inc
        if self.sinks:
            # counters are pure aggregates: rollups carry them, so raw
            # exporters drop them under sampling (keep() says False)
            self._fan_out({"kind": "counter", "t": self._t_last,
                           "name": name, "inc": inc},
                          not self._sampled)

    def gfc_register(self, seconds: float):
        self.gfc_register_s.append(seconds)     # GIL-atomic append
        if self.sinks:
            self._fan_out({"kind": "gfc", "t": self._t_last,
                           "s": seconds}, True)

    def span(self, rank: int, t_start: float, t_end: float, op: str,
             size: int = 0):
        """Wall-only overlay: a collective / p2p / migration interval in
        absolute monotonic time (re-anchored to ``t0`` when set)."""
        base = self.t0 or 0.0
        kept = True
        if self._sampled:
            kept = self.sampling.keep({"kind": "span", "rank": rank})
        if kept:
            self.overlay.setdefault(rank, []).append(
                (t_start - base, t_end - t_start, op, size))
        if self.sinks:
            self._fan_out({"kind": "span", "t": t_start - base,
                           "rank": rank, "dur": t_end - t_start,
                           "op": op, "size": size}, kept)

    # ------------------------------------------------------------------
    # products
    # ------------------------------------------------------------------
    def clock_independent(self) -> dict:
        """The cross-backend identity projection (DESIGN.md §15): rank
        state sequences, per-request decision records, and lifecycle
        span structure, grouped per request by arrival order (the global
        interleaving of events on disjoint rank sets is backend-
        dependent; per-request and per-rank orders are not)."""
        order = {rid: i for i, rid in enumerate(self.request_order)}
        decisions: dict[int, list] = {}
        for d in self.decisions:
            decisions.setdefault(order.get(d.get("req"), -1),
                                 []).append(_sanitize(d))
        lifecycle: dict[int, list] = {}
        for rid, seq in self.lifecycle.items():
            lifecycle[order[rid]] = [(phase, _sanitize(info))
                                     for _, phase, info in seq]
        ranks = {r: [(state, _sanitize(info)) for _, state, info in seq]
                 for r, seq in self.rank_states.items()}
        return {
            "rank_states": {r: ranks[r] for r in sorted(ranks)},
            "decisions": {i: decisions[i] for i in sorted(decisions)},
            "lifecycle": {i: lifecycle[i] for i in sorted(lifecycle)},
        }

    def _makespan(self) -> float:
        if self._sampled:
            # retained streams are partial: the high-water mark (tracked
            # on EVERY event, kept or not) is the true makespan
            return self._t_last
        ts = [t for seq in self.rank_states.values() for t, _, _ in seq]
        ts += [t for seq in self.lifecycle.values() for t, _, _ in seq]
        return max(ts, default=0.0)

    def busy_seconds(self) -> dict[int, float]:
        """Per-rank time spent busy/migrating (interval end = the next
        transition; a run quiesces with every live rank idle).  Under
        sampling the incremental accumulator is EXACT even though the
        retained timeline is run-length encoded."""
        if self._sampled:
            end = self._makespan()
            out = {r: 0.0 for r in self.rank_states}
            out.update(self._busy_acc)
            for r, (t_open, state) in self._rank_open.items():
                if state in ("busy", "migrating") and end > t_open:
                    out[r] = out.get(r, 0.0) + end - t_open
            return out
        end = self._makespan()
        out = {}
        for r, seq in self.rank_states.items():
            busy = 0.0
            for (t, state, _), nxt in zip(seq, seq[1:] + [(end, "", {})]):
                if state in ("busy", "migrating"):
                    busy += max(nxt[0] - t, 0.0)
            out[r] = busy
        return out

    def gfc_histogram(self) -> dict:
        """Setup-latency histogram over ``register_group`` samples:
        bucket label = inclusive upper bound in µs."""
        counts = [0] * len(GFC_BUCKETS_US)
        for s in self.gfc_register_s:
            us = s * 1e6
            for i, ub in enumerate(GFC_BUCKETS_US):
                if us <= ub:
                    counts[i] += 1
                    break
        return {("inf" if ub == float("inf") else f"{ub}us"): c
                for ub, c in zip(GFC_BUCKETS_US, counts)}

    def gfc_percentiles(self) -> dict:
        xs = sorted(self.gfc_register_s)
        if not xs:
            return {"n": 0}
        pick = lambda q: xs[min(int(q * (len(xs) - 1)), len(xs) - 1)]  # noqa: E731
        return {"n": len(xs), "p50_us": pick(0.50) * 1e6,
                "p90_us": pick(0.90) * 1e6, "p99_us": pick(0.99) * 1e6}

    def summary(self) -> dict:
        """Derived end-of-run aggregates (all clock-dependent)."""
        makespan = self._makespan()
        busy = self.busy_seconds()
        n = self.num_ranks or max(len(busy), 1)
        util = {r: (busy[r] / makespan if makespan else 0.0)
                for r in sorted(busy)}
        if self._sampled:
            # lifecycle retention is partial: outcome counters (bumped
            # on every event regardless of sampling) carry the truth
            completed = self.counters.get("requests_done", 0)
            failed = self.counters.get("requests_failed", 0)
            violations = self.counters.get("slo_violations", 0) + failed
        else:
            completed = failed = violations = 0
            for seq in self.lifecycle.values():
                for _, phase, info in seq:
                    if phase == "done":
                        completed += 1
                        if (info.get("metrics") or {}).get("violation"):
                            violations += 1
                    elif phase == "failed":
                        failed += 1
                        violations += 1     # unfinished == violation §6.1
        finished = completed + failed
        actions: dict[str, int] = {}
        for d in self.decisions:
            actions[d["action"]] = actions.get(d["action"], 0) + 1
        cells = {k: {"n": c["n"], "rel_err": c["rel_err"],
                     "mean_rel_err": c["sum_rel_err"] / c["n"]}
                 for k, c in self.cost_cells.items()}
        return {
            "makespan_s": makespan,
            "rank_utilization": (sum(util.values()) / len(util)
                                 if util else 0.0),
            "utilization_per_rank": util,
            "goodput_per_rank": (completed / (n * makespan)
                                 if makespan else 0.0),
            "completed": completed,
            "failed": failed,
            "violation_rate": violations / finished if finished else 0.0,
            "actions": actions,
            "cost_cells": cells,
            "gfc": {**self.gfc_percentiles(),
                    "histogram": self.gfc_histogram()},
            "counters": dict(self.counters),
        }

    # ------------------------------------------------------------------
    # Perfetto / Chrome trace export
    # ------------------------------------------------------------------
    def perfetto(self, path=None) -> dict:
        """Chrome/Perfetto ``trace.json``: pid = host, tid = rank, X
        slices for busy/dead rank intervals plus the wall collective
        overlay; the control plane gets its own process with one thread
        per request (lifecycle spans) and instant decision events."""
        topo = self.topology
        host_of = topo.host_of if topo is not None else (lambda r: 0)
        events: list[dict] = []
        end = self._makespan()
        us = lambda t: round(t * 1e6, 3)    # noqa: E731
        hosts = sorted({host_of(r) for r in self.rank_states}) or [0]
        for h in hosts:
            events.append({"ph": "M", "pid": h, "tid": 0,
                           "name": "process_name",
                           "args": {"name": f"host{h}"}})
        for r in sorted(self.rank_states):
            events.append({"ph": "M", "pid": host_of(r), "tid": r,
                           "name": "thread_name",
                           "args": {"name": f"rank{r}"}})
        for r, seq in self.rank_states.items():
            for (t, state, info), nxt in zip(seq, seq[1:]
                                             + [(end, "", {})]):
                if state == "idle":
                    continue
                t_next = nxt[0]
                if state == "busy":
                    name = (f"{info.get('req', '?')} "
                            f"{info.get('kind', '?')}"
                            f"[{info.get('step', 0)}]")
                elif state == "migrating":
                    name = "migrate-in"
                elif state == "mixed":
                    # RLE aggregate of sampled-out transitions (§16)
                    name = f"~{info.get('n', 1)} sampled-out"
                    t_next = info.get("t_end", t_next)
                else:
                    name = state.upper()
                events.append({"ph": "X", "pid": host_of(r), "tid": r,
                               "ts": us(t),
                               "dur": max(us(t_next) - us(t), 0.0),
                               "name": name, "cat": state,
                               "args": dict(info)})
        for r, spans in self.overlay.items():
            for t, dur, op, size in spans:
                events.append({"ph": "X", "pid": host_of(r), "tid": r,
                               "ts": us(t), "dur": us(dur), "name": op,
                               "cat": "collective",
                               "args": {"size": size}})
        cp_pid = hosts[-1] + 1
        events.append({"ph": "M", "pid": cp_pid, "tid": 0,
                       "name": "process_name",
                       "args": {"name": "control-plane"}})
        for d in self.decisions:
            events.append({"ph": "i", "s": "p", "pid": cp_pid, "tid": 0,
                           "ts": us(d.get("t") or 0.0),
                           "name": f"{d['action']} {d.get('req', '')}",
                           "cat": "decision",
                           "args": {k: v for k, v in d.items()
                                    if k != "t" and v is not None}})
        for i, rid in enumerate(self.request_order):
            tid = i + 1
            events.append({"ph": "M", "pid": cp_pid, "tid": tid,
                           "name": "thread_name", "args": {"name": rid}})
            seq = self.lifecycle[rid]
            t_first, t_last = seq[0][0], seq[-1][0]
            events.append({"ph": "X", "pid": cp_pid, "tid": tid,
                           "ts": us(t_first),
                           "dur": max(us(t_last) - us(t_first), 0.0),
                           "name": rid, "cat": "request", "args": {}})
            open_steps: dict[tuple, float] = {}
            for t, phase, info in seq:
                key = (info.get("kind"), info.get("step"))
                if phase == "step_start":
                    open_steps[key] = t
                elif phase == "step_end" and key in open_steps:
                    t_open = open_steps.pop(key)
                    events.append({
                        "ph": "X", "pid": cp_pid, "tid": tid,
                        "ts": us(t_open),
                        "dur": max(us(t) - us(t_open), 0.0),
                        "name": f"{key[0]}[{key[1]}]", "cat": "step",
                        "args": dict(info)})
                elif phase not in ("step_start",):
                    events.append({"ph": "i", "s": "t", "pid": cp_pid,
                                   "tid": tid, "ts": us(t), "name": phase,
                                   "cat": "lifecycle",
                                   "args": dict(info)})
        if self._sampled:
            # raw spans were sampled out: emit counter tracks from the
            # attached rollup windows so the trace still carries the
            # fleet-level signal (§16 satellite)
            for sink in self.sinks:
                if isinstance(sink, RollupSink):
                    for row in sink.timeseries():
                        for m in ("utilization", "violation_rate",
                                  "completed"):
                            events.append({"ph": "C", "pid": cp_pid,
                                           "tid": 0, "ts": us(row["t0"]),
                                           "name": f"rollup/{m}",
                                           "args": {m: row[m]}})
                    break
        for a in self.alerts:
            events.append({"ph": "i", "s": "g", "pid": cp_pid, "tid": 0,
                           "ts": us(a.get("t") or 0.0),
                           "name": f"ALERT {a['monitor']}",
                           "cat": "alert",
                           "args": {k: v for k, v in a.items()
                                    if k not in ("kind", "t")}})
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace
