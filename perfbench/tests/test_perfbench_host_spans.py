"""The readings of the port's own host spans (``perfbench/hostspans.py``):
by hand on a record with placed spans and kernels, and on a CPU window
of the tiny interactive cell, where each hand-off's post + plane +
pickup tiles the benchmark's own gap between two calls."""
from __future__ import annotations

import statistics

import pytest

from perfbench import harness, hostspans, readers, spec, traffic
from perfbench.hostspans import PLANE, ProgramSpan, subtract
from perfbench.record import Record, RequestRecord, Span


def _span(op, t0, t1, task, rank=0, size=0):
    return ProgramSpan(op, rank, t0, t1, size, task, 1, ("r0",))


def _call(task, pickup, t0, marks, t1):
    """A call's pickup, the call, and its four phases between marks."""
    out = [_span("pickup", pickup, t0, task), _span("call", t0, t1, task)]
    out += [_span(op, a, b, task)
            for op, a, b in zip(hostspans.PHASES, marks, marks[1:])]
    return out


def _record(kernels):
    reqs = {"r0": RequestRecord("r0", "S", 1024, 4, 0.0, 1.0),
            "r1": RequestRecord("r1", "S", 1024, 4, 0.0, 2.0)}
    steps = [Span("encode", 0, 0.101, 0.485, (("r0", 0),), 1024),
             Span("denoise", 0, 0.601, 0.885, (("r0", 0),), 1024)]
    return Record(cell="c", config={}, mix={}, seconds=2.0, setup_s=0.0,
                  requests=reqs, events=[], spans=steps, window=(0.0, 2.0),
                  measured=(0.0, 2.0), kernels=kernels)


#: two calls on rank 0 and a plane span; the card busy in four stretches
#: inside the calls and one between them
SPANS = sorted(_call("a", 0.09, 0.10, (0.10, 0.12, 0.40, 0.45, 0.48), 0.50)
               + _call("b", 0.55, 0.60, (0.60, 0.62, 0.80, 0.85, 0.88),
                       0.90)
               + [ProgramSpan("wait", PLANE, 0.50, 0.52, 0, "a", 1,
                              ("r0",))], key=lambda s: s.t0)
KERNELS = [("k", 0.115, 0.35), ("k", 0.36, 0.42), ("k", 0.52, 0.535),
           ("k", 0.63, 0.79), ("k", 0.81, 0.84)]


def test_subtract():
    assert subtract([(0, 10)], [(1, 2), (3, 4), (9, 12)]) == \
        [(0, 1), (2, 3), (4, 9)]
    assert subtract([(0, 1), (5, 6)], []) == [(0, 1), (5, 6)]
    assert subtract([(0, 1)], [(-1, 2)]) == []


def test_readings_by_hand():
    rec = _record(KERNELS)
    # idle [0.10, 0.115] and [0.60, 0.62] in inputs: 35 ms over 2 requests
    assert hostspans.inputs_idle_ms(rec, SPANS) == pytest.approx(17.5)
    # forward and sync [0.12, 0.45], [0.62, 0.85]: idle 0.35-0.36,
    # 0.42-0.45, 0.62-0.63, 0.79-0.81, 0.84-0.85
    assert hostspans.enqueue_idle_ms(rec, SPANS) == pytest.approx(40.0)
    # writeback and each call's tail: [0.45, 0.50], [0.85, 0.90], idle
    assert hostspans.writeback_idle_ms(rec, SPANS) == pytest.approx(50.0)
    # post 0.48 -> 0.50, plane 0.50 -> 0.55, pickup 0.55 -> 0.60
    h, = hostspans.handoffs(rec, SPANS)
    assert (h["post"], h["plane"], h["pickup"]) == pytest.approx(
        (0.02, 0.05, 0.05))
    assert hostspans.plane_handoff_ms(rec, SPANS) == pytest.approx(50.0)
    assert hostspans.rank_pickup_ms(rec, SPANS) == pytest.approx(50.0)
    # 0.485 s of the 0.5 s busy lies inside the calls
    assert hostspans.call_share(rec, SPANS) == pytest.approx(0.97)
    (gap, parts), = hostspans.reconcile(rec, SPANS)
    assert (gap, parts) == pytest.approx((0.116, 0.12))


def test_no_handoff_once_the_system_is_empty():
    rec = _record(KERNELS)
    for r in rec.requests.values():
        r.done = 0.5
    assert hostspans.handoffs(rec, SPANS) == []
    assert hostspans.plane_handoff_ms(rec, SPANS) is None


def test_idle_readings_need_a_device_trace():
    rec = _record(None)
    for name in ("inputs_idle_ms", "enqueue_idle_ms", "writeback_idle_ms"):
        assert hostspans.READINGS[name](rec, SPANS) is None
    assert hostspans.call_share(rec, SPANS) is None
    assert hostspans.plane_handoff_ms(rec, SPANS) == pytest.approx(50.0)


def test_cpu_window_splits_every_gap(tiny_root):
    import torch
    from perfbench.tools.host_spans import window
    cell = spec.load(tiny_root, "tiny-interactive")
    served = harness.prepare(cell, 2 ** 31 + 91, torch.device("cpu"))
    try:
        line, rec, spans = window(served, 2 ** 31 + 91, 3.0, True,
                                  torch.device("cpu"))
    finally:
        served.engine.shutdown()
    assert line["drained"] and line["finished"] == line["requests"] > 0
    for name in ("plane_handoff_ms", "rank_pickup_ms"):
        assert line[name] is not None and line[name] > 0
    for name in ("inputs_idle_ms", "enqueue_idle_ms", "writeback_idle_ms",
                 "call_share"):
        assert line[name] is None
    hands = hostspans.handoffs(rec, spans)
    pairs = hostspans.reconcile(rec, spans)
    # dispatch_gap_ms's gaps (its rule reads the wrapped call's end, the
    # spans the post, so a request done ~5 ms after either may count on
    # one side only), each tiled in order: last phase end <= wrapped
    # call's end <= post <= queue put <= call start <= wrapped call's start
    assert len(pairs) == len(hands) > 0
    assert 1e3 * statistics.median(g for g, _ in pairs) == \
        pytest.approx(readers.dispatch_gap_ms(rec), rel=0.25)
    for h in hands:
        a, b = h["prev"], h["next"]
        wrapped = [s for s in rec.spans if s.rank == a.rank
                   and a.t0 <= s.t0 and s.t1 <= a.t1]
        nxt = [s for s in rec.spans if s.rank == b.rank
               and b.t0 <= s.t0 and s.t1 <= b.t1]
        assert len(wrapped) == len(nxt) == 1
        assert a.t1 - h["post"] <= wrapped[0].t1 <= a.t1
        assert h["plane"] >= 0 and h["pickup"] >= 0
        assert b.t0 <= nxt[0].t0
    assert statistics.median(abs(g - p) for g, p in pairs) < 5e-4
    # the window's requests are the cell's, served to their end
    assert len(rec.requests) == len(traffic.generate(
        cell.mix, cell.config["model"], served.model_name, cell.cost,
        2 ** 31 + 91, 3.0))
