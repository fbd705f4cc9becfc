"""The port's own host spans in a window, and what they split.

With a ``Telemetry`` attached (``ServingEngine.attach_telemetry``) the
port records, on the wall path only, each rank's ``pickup`` (the plane's
queue put to the rank taking the job) and ``call`` (the take to the
completion's post) with the pipeline's four phases inside
(``inputs``, ``forward``, ``sync``, ``writeback``), and the plane's
``wait``, ``apply``, ``schedule`` and ``dispatch`` spans.  They share
the serve's clock with :class:`perfbench.record.Record`: the engine
anchors the telemetry at the backend's ``t0``.

The functions below read a record and those spans: the card's idle time
inside a rank's calls by the phase the host was in, and each hand-off
between two calls of a rank split into the post, the plane's part and
the rank's pickup.  Each returns None when there is nothing to read (no
device trace, no hand-off).
"""
from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Optional

from perfbench import devtrace
from perfbench.record import Record

#: the overlay's key of the plane's spans (``repro_torch.core.telemetry``)
PLANE = -1
PHASES = ("inputs", "forward", "sync", "writeback")
#: the phases each idle reading counts; ``writeback`` also takes the part
#: of a call that none of its phases covers
IDLE_CLASSES = {"inputs": ("inputs",), "enqueue": ("forward", "sync"),
                "writeback": ("writeback",)}


@dataclass
class ProgramSpan:
    op: str
    rank: int                       # PLANE for the plane's
    t0: float
    t1: float
    size: int                       # bytes moved
    task: Optional[str]             # the task or pack id served
    seq: int                        # its dispatch seq
    reqs: tuple                     # its request ids


def program_spans(telemetry) -> list[ProgramSpan]:
    """The overlay's spans of one serve, sorted by start."""
    out = []
    for rank, seq in telemetry.overlay.items():
        for t, dur, op, size, cause in seq:
            c = cause or {}
            out.append(ProgramSpan(op, rank, t, t + dur, size,
                                   c.get("task"), c.get("seq", 0),
                                   tuple(c.get("reqs", ()))))
    return sorted(out, key=lambda s: s.t0)


def subtract(a: list, b: list) -> list[tuple[float, float]]:
    """The union ``a`` less the union ``b`` (both merged and sorted)."""
    out, j = [], 0
    for lo, hi in a:
        t = lo
        while j < len(b) and b[j][1] <= t:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            if b[k][0] > t:
                out.append((t, b[k][0]))
            t = max(t, b[k][1])
            k += 1
        if t < hi:
            out.append((t, hi))
    return out


def _rank_spans(spans, ops) -> list[tuple[float, float]]:
    return devtrace.union((s.t0, s.t1) for s in spans
                          if s.rank != PLANE and s.op in ops)


def idle_by_phase(rec: Record, spans: list) -> Optional[dict]:
    """Seconds of the measured interval in which no operation ran on the
    card while a rank's host was in each of :data:`IDLE_CLASSES`."""
    if rec.kernels is None:
        return None
    lo, hi = rec.measured
    idle = subtract([(lo, hi)], devtrace.busy(rec.kernels, lo, hi))
    rest = subtract(_rank_spans(spans, ("call",)),
                    _rank_spans(spans, PHASES))
    out = {}
    for name, ops in IDLE_CLASSES.items():
        held = _rank_spans(spans, ops)
        if name == "writeback":
            held = devtrace.union(held + rest)
        out[name] = devtrace.overlap(idle, devtrace.clip(held, lo, hi))
    return out


def idle_ms(rec: Record, spans: list, name: str) -> Optional[float]:
    """:func:`idle_by_phase`'s ``name`` in ms a finished window request."""
    by_phase = idle_by_phase(rec, spans)
    done = sum(r.done is not None for r in rec.requests.values())
    if by_phase is None or not done:
        return None
    return 1e3 * by_phase[name] / done


def call_share(rec: Record, spans: list) -> Optional[float]:
    """Share of the card's busy time in the measured interval that lies
    inside a rank's ``call`` spans."""
    if rec.kernels is None:
        return None
    lo, hi = rec.measured
    busy = devtrace.busy(rec.kernels, lo, hi)
    total = devtrace.length(busy)
    if total <= 0:
        return None
    return devtrace.overlap(busy, _rank_spans(spans, ("call",))) / total


def handoffs(rec: Record, spans: list) -> list[dict]:
    """Each hand-off from a rank's call to its next in the measured
    interval at whose start a request (not the one just finished) was in
    the system, as ``dispatch_gap_ms`` counts them: ``post`` (the last
    phase's end to the completion's post), ``plane`` (the post to the
    queue put of the rank's next job), ``pickup`` (the put to the next
    call's start), in seconds, with the two calls."""
    lo, hi = rec.measured
    stay = [(r.arrival, r.done if r.done is not None else math.inf)
            for r in rec.requests.values()]
    key = lambda s: (s.rank, s.task, s.seq)    # noqa: E731
    pickups = {key(s): s for s in spans if s.op == "pickup"}
    last: dict[tuple, float] = {}
    for s in spans:
        if s.op in PHASES and s.rank != PLANE:
            last[key(s)] = max(last.get(key(s), s.t1), s.t1)
    by_rank: dict[int, list] = {}
    for s in spans:
        if s.op == "call" and s.t0 >= lo - 1e-9 and s.t1 <= hi + 1e-9:
            by_rank.setdefault(s.rank, []).append(s)
    out = []
    for calls in by_rank.values():
        for a, b in zip(calls, calls[1:]):
            t = a.t1
            p = pickups.get(key(b))
            if p is None or not any(arr <= t and done > t + 0.005
                                    for arr, done in stay):
                continue
            out.append({"rank": a.rank, "post": t - last.get(key(a), t),
                        "plane": p.t0 - t, "pickup": b.t0 - p.t0,
                        "prev": a, "next": b})
    return out


def _median_ms(rec: Record, spans: list, part: str) -> Optional[float]:
    hs = handoffs(rec, spans)
    return 1e3 * statistics.median(h[part] for h in hs) if hs else None


def reconcile(rec: Record, spans: list) -> list[tuple[float, float]]:
    """For each hand-off, (the benchmark's own gap from the end of the
    wrapped pipeline call to the start of the next, post + plane +
    pickup), in seconds: the benchmark's spans lie inside the calls."""
    steps: dict[int, list] = {}
    for s in rec.spans:
        steps.setdefault(s.rank, []).append(s)

    def inside(call):
        return next((s for s in steps.get(call.rank, ())
                     if call.t0 <= s.t0 and s.t1 <= call.t1), None)
    out = []
    for h in handoffs(rec, spans):
        a, b = inside(h["prev"]), inside(h["next"])
        if a is not None and b is not None:
            out.append((b.t0 - a.t1, h["post"] + h["plane"] + h["pickup"]))
    return out


# -- the five readings (each a per-layer metric's arithmetic) ----------

def inputs_idle_ms(rec: Record, spans: list) -> Optional[float]:
    """Card idle ms a finished window request while a rank's host is in
    an ``inputs`` span (every call kind)."""
    return idle_ms(rec, spans, "inputs")


def enqueue_idle_ms(rec: Record, spans: list) -> Optional[float]:
    """The same in ``forward`` and ``sync`` spans: kernel boundaries and
    stretches the launches pace."""
    return idle_ms(rec, spans, "enqueue")


def writeback_idle_ms(rec: Record, spans: list) -> Optional[float]:
    """The same in ``writeback`` spans and in the part of a ``call`` that
    none of its phases covers."""
    return idle_ms(rec, spans, "writeback")


def plane_handoff_ms(rec: Record, spans: list) -> Optional[float]:
    """Median ms from a rank's completion post to the plane's queue put
    of the rank's next job, over :func:`handoffs`."""
    return _median_ms(rec, spans, "plane")


def rank_pickup_ms(rec: Record, spans: list) -> Optional[float]:
    """Median ms from that queue put to the rank starting the call."""
    return _median_ms(rec, spans, "pickup")


READINGS = {"inputs_idle_ms": inputs_idle_ms,
            "enqueue_idle_ms": enqueue_idle_ms,
            "writeback_idle_ms": writeback_idle_ms,
            "plane_handoff_ms": plane_handoff_ms,
            "rank_pickup_ms": rank_pickup_ms}
