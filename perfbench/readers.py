"""The arithmetic the metric readers share (each metric's own reader in
``perfbench/metrics/`` names the function it reads with).  Every reader
takes a :class:`perfbench.record.Record` and returns a number, or None
when the record holds nothing to read (a per-layer metric outside a
``--trace 1`` run, a window that never closed)."""
from __future__ import annotations

import math
import statistics
from typing import Optional

from perfbench import devtrace, flops, stats
from perfbench.record import Record


def _finite(x) -> Optional[float]:
    return x if x is not None and math.isfinite(x) else None


# -- end to end -------------------------------------------------------

def latency_p(rec: Record, q: float) -> Optional[float]:
    """The q-th quantile of done - due arrival over every request due in
    the window; a request that never finished counts as missing."""
    if not rec.requests:
        return None
    return _finite(stats.percentile(
        stats.latencies({r: q_.arrival for r, q_ in rec.requests.items()},
                        {r: q_.done for r, q_ in rec.requests.items()}), q))


def images_per_s(rec: Record) -> Optional[float]:
    """Requests finished in the window over the time from its opening to
    the last of those completions."""
    lo, hi = rec.window
    n, rate = stats.completion_rate(
        lo, [r.done for r in rec.requests.values() if r.done is not None],
        hi)
    return rate if n else None


def step_s(rec: Record) -> Optional[float]:
    """The step-aligned window over the denoise steps inside it."""
    lo, hi = rec.window
    if not (math.isfinite(lo) and math.isfinite(hi)):
        return None
    n = len(rec.spans_in(lo, hi, "denoise"))
    return (hi - lo) / n if n else None


# -- control plane ----------------------------------------------------

def queue_wait_p50_s(rec: Record) -> Optional[float]:
    """Median over the window's requests of due arrival -> the first
    dispatch of any of its tasks (the plane's ``dispatch`` events)."""
    first: dict[str, float] = {}
    for e in rec.events:
        if e.get("ev") == "dispatch" and e["req"] in rec.requests:
            first.setdefault(e["req"], e["t"])
    waits = [first[r] - q.arrival for r, q in rec.requests.items()
             if r in first]
    return statistics.median(waits) if waits else None


def pack_size_mean(rec: Record) -> Optional[float]:
    """Requests a denoise dispatch carries, over the dispatches in the
    window: a ``packed_dispatch`` carries its ``batch``, a denoise
    ``dispatch`` outside a pack one."""
    lo, hi = rec.window
    sizes = [e["batch"] for e in rec.events
             if e.get("ev") == "packed_dispatch" and lo <= e["t"] <= hi]
    sizes += [1 for e in rec.events
              if e.get("ev") == "dispatch" and e.get("kind") == "denoise"
              and "pack" not in e and lo <= e["t"] <= hi]
    return statistics.fmean(sizes) if sizes else None


# -- executor and pipeline --------------------------------------------

def dispatch_gap_ms(rec: Record) -> Optional[float]:
    """Median host time, in ms, from the end of a pipeline call on a rank
    to the start of its next call, over the gaps in the measured
    interval at whose start a request (not the one just finished) was
    in the system."""
    lo, hi = rec.measured
    by_rank: dict[int, list] = {}
    for s in rec.spans_in(lo, hi):
        by_rank.setdefault(s.rank, []).append(s)
    stay = [(r.arrival, r.done if r.done is not None else math.inf)
            for r in rec.requests.values()]
    gaps = []
    for calls in by_rank.values():
        for a, b in zip(calls, calls[1:]):
            t = a.t1
            if any(arr <= t and done > t + 0.005 for arr, done in stay):
                gaps.append(b.t0 - t)
    return 1e3 * statistics.median(gaps) if gaps else None


# -- model step -------------------------------------------------------

def denoise_mfu(rec: Record) -> Optional[float]:
    """Denoise FLOPs over the summed host spans of the denoise calls in
    the measured interval times the fp32-accurate peak, in %."""
    calls = rec.spans_in(*rec.measured, kind="denoise")
    t = sum(s.t1 - s.t0 for s in calls)
    if t <= 0:
        return None
    work = sum(flops.span_work(rec.config, s).total for s in calls)
    return 100.0 * work / (t * flops.PEAK_FP32_ACCURATE_FLOPS)


def _trace_sum(rec: Record, cat: str) -> Optional[float]:
    if rec.kernels is None:
        return None
    lo, hi = rec.measured
    return devtrace.by_category(rec.kernels, lo, hi).get(cat, 0.0)


def gemm_roofline(rec: Record) -> Optional[float]:
    """Product FLOPs of every pipeline call in the measured interval over
    the fp32-accurate peak, over the device time of the matrix-product
    kernels there, in %."""
    t = _trace_sum(rec, "gemm")
    if not t:
        return None
    work = sum(flops.span_work(rec.config, s).linear
               for s in rec.spans_in(*rec.measured))
    return 100.0 * work / flops.PEAK_FP32_ACCURATE_FLOPS / t


def k2_roofline(rec: Record) -> Optional[float]:
    """The least time attention's work could take (each call's FLOPs at
    the fp32-accurate peak or its bytes at HBM bandwidth, the larger),
    over the device time of the attention kernels, in %."""
    t = _trace_sum(rec, "attention")
    if not t:
        return None
    bound = sum(flops.span_work(rec.config, s).attn_bound_s
                for s in rec.spans_in(*rec.measured))
    return 100.0 * bound / t


# -- card -------------------------------------------------------------

def idle_share(rec: Record) -> Optional[float]:
    """Share of the measured interval's time with a request in the
    system in which no operation ran on the card, in %."""
    if rec.kernels is None:
        return None
    active = devtrace.clip(devtrace.union(rec.in_system()), *rec.measured)
    share = devtrace.idle_share(rec.kernels, active)
    return None if share is None else 100.0 * share
