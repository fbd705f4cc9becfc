"""The metric arithmetic: percentiles over all requests (a failed one
counts as missing), the completion-aligned and step-aligned rates, the
readers on a hand-made record, and the device timeline's unions, idle
share and idle gaps."""
from __future__ import annotations

import math
import statistics

import pytest

from perfbench import devtrace, readers, stats
from perfbench.record import Record, RequestRecord, Span


def test_percentile_over_all_requests():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 0.5) == 3.0
    assert stats.percentile(xs, 0.9) == pytest.approx(4.6)
    assert stats.percentile(list(range(1, 101)), 0.9) == pytest.approx(90.1)
    # numpy's default and statistics' inclusive method agree
    data = [0.3, 0.9, 0.1, 0.5, 0.7, 0.2]
    assert stats.percentile(data, 0.25) == pytest.approx(
        statistics.quantiles(data, n=4, method="inclusive")[0])
    # a request that never finished is missing: it sorts last
    assert stats.percentile([1.0, 2.0, math.inf], 0.5) == 2.0
    assert stats.percentile([1.0, 2.0, math.inf], 0.9) == math.inf


def test_completion_and_step_windows():
    n, rate = stats.completion_rate(0.0, [1.0, 2.0, 4.0, 11.0], 10.0)
    assert (n, rate) == (3, 3 / 4.0)
    assert stats.step_window([2.0, 9.0, 16.0, 23.0], 10.0) == (2.0, 16.0, 2)
    assert stats.step_window([2.0, 9.0], 10.0) is None
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def _rec(**kw) -> Record:
    reqs = {"a": RequestRecord("a", "S", 1024, 4, 0.0, 0.3),
            "b": RequestRecord("b", "S", 1024, 4, 0.1, 0.6),
            "c": RequestRecord("c", "M", 4096, 4, 0.2, None)}
    spans = [Span("encode", 0, 0.00, 0.01, (("a", -1),), 1024),
             Span("denoise", 0, 0.02, 0.10, (("a", 0),), 1024),
             Span("denoise", 0, 0.12, 0.30, (("a", 1), ("b", 0)), 1024),
             Span("decode", 0, 0.40, 0.45, (("b", -1),), 1024)]
    events = [{"t": 0.0, "ev": "dispatch", "req": "a", "kind": "encode"},
              {"t": 0.15, "ev": "dispatch", "req": "b", "kind": "encode"},
              {"t": 0.12, "ev": "packed_dispatch", "batch": 2,
               "reqs": ["a", "b"]},
              {"t": 0.12, "ev": "dispatch", "req": "a", "kind": "denoise",
               "pack": "p"},
              {"t": 0.02, "ev": "dispatch", "req": "a", "kind": "denoise"}]
    base = dict(cell="x", config={}, mix={}, seconds=1.0, setup_s=3.0,
                requests=reqs, events=events, spans=spans,
                window=(0.0, 1.0), measured=(0.0, 0.5))
    base.update(kw)
    return Record(**base)


def test_readers_on_a_record():
    rec = _rec()
    assert readers.latency_p(rec, 0.5) == pytest.approx(0.5)
    assert readers.latency_p(rec, 0.9) is None       # c never finished
    assert readers.images_per_s(rec) == pytest.approx(2 / 0.6)
    assert readers.queue_wait_p50_s(rec) == pytest.approx(0.025)
    assert readers.pack_size_mean(rec) == pytest.approx(1.5)
    # gaps 0.01, 0.02 and 0.10 all start with work waiting
    assert readers.dispatch_gap_ms(rec) == pytest.approx(20.0)
    assert readers.gemm_roofline(rec) is None        # no device trace
    rec = _rec(window=(0.02, 0.30), measured=(0.02, 0.30))
    assert readers.step_s(rec) == pytest.approx(0.28 / 2)


def test_device_timeline():
    ks = [("gemm_a", 0.0, 1.0), ("attn_mma_kernel", 0.5, 1.5),
          ("Memcpy HtoD", 3.0, 3.5), ("gemv", 6.0, 7.0)]
    merged = devtrace.union((s, e) for _, s, e in ks)
    assert merged == [(0.0, 1.5), (3.0, 3.5), (6.0, 7.0)]
    assert devtrace.overlap(merged, [(1.0, 3.25)]) == pytest.approx(0.75)
    assert devtrace.idle_share(ks, [(0.0, 4.0)]) == pytest.approx(0.5)
    assert devtrace.idle_share(ks, []) is None
    cats = devtrace.by_category(ks, 0.0, 10.0)
    assert cats == {"gemm": 2.0, "attention": 1.0, "copy": 0.5}
    # idle gaps (1.5, 3), (3.5, 6), (7, 8); the first inside a call, the
    # second with requests in the system until 5
    spans = [Span("denoise", 0, 0.0, 2.5, (), 0)]
    gaps = dict((k.split(" x")[0], v) for k, v in devtrace.idle_gaps(
        ks, spans, [(0.0, 5.0)], 0.0, 8.0))
    assert gaps == pytest.approx({
        "inside a denoise call (host work in the pipeline)": 1.5,
        "between pipeline calls, requests waiting (control plane)": 1.5,
        "no request in the system": 2.0})
