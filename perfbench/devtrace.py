"""The card's timeline in a ``--trace 1`` run, and its arithmetic.

:class:`DeviceTrace` runs ``torch.profiler`` with CUDA activity only
(kernels, copies and sets; no host operator events) around the window's
serve.  A ``spin_kernel`` (``torch.cuda._sleep``) launched on an idle
card at a known host time ties the profiler's clock to the host's
``time.monotonic``.  Nothing is written to disk.

The functions below reduce lists of (start, end) intervals: unions,
overlaps, and the card's busy and idle time while work was in the
system.
"""
from __future__ import annotations

import bisect
import collections
import time
from typing import Iterable, Optional

MARKER = "spin_kernel"


def category(name: str) -> str:
    """A device operation's layer, by kernel name."""
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "attn_" in low and "bwd" not in low:
        return "attention"
    if "adaln" in low:
        return "adaln"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "xmma", "nvjet",
                              "splitkreduce")):
        return "gemm"
    return "other"


class DeviceTrace:
    """Context manager: ``kernels`` is a list of (name, start, end) in
    host ``time.monotonic`` seconds once it exits."""

    def __init__(self):
        self.kernels: list[tuple[str, float, float]] = []
        self.t_start = 0.0

    def _mark(self) -> float:
        import torch
        torch.cuda.synchronize()
        t = time.monotonic()
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        return t

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t_start = self._mark()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        self.kernels = self._read()
        self._prof = None
        return False

    def _read(self) -> list[tuple[str, float, float]]:
        from torch.autograd import DeviceType
        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            raw.append((e.name(), e.start_ns(), e.start_ns()
                        + e.duration_ns()))
        marks = sorted(s for n, s, _ in raw if MARKER in n)
        if not marks:
            raise RuntimeError("the device trace holds no marker kernel")
        # the marker starts a few microseconds after its launch
        off = self.t_start - marks[0] * 1e-9
        return sorted((n, s * 1e-9 + off, e * 1e-9 + off)
                      for n, s, e in raw if MARKER not in n)


def union(intervals: Iterable[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(merged: list[tuple[float, float]]) -> float:
    return sum(b - a for a, b in merged)


def overlap(a: list[tuple[float, float]],
            b: list[tuple[float, float]]) -> float:
    """Length of the intersection of two unions."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def clip(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in merged
            if min(b, hi) > max(a, lo)]


def busy(kernels, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of the device's operations within [lo, hi]."""
    return clip(union((s, e) for _, s, e in kernels), lo, hi)


def by_category(kernels, lo: float, hi: float) -> dict[str, float]:
    """Device seconds by :func:`category` of the operations that start
    within [lo, hi]."""
    out: dict[str, float] = collections.defaultdict(float)
    for n, s, e in kernels:
        if lo <= s <= hi:
            out[category(n)] += e - s
    return dict(out)


def idle_share(kernels, active: list[tuple[float, float]]) -> Optional[float]:
    """Share of the time in ``active`` (a union) with no device
    operation running; None when ``active`` is empty."""
    span = length(active)
    if span <= 0:
        return None
    return 1.0 - overlap(union((s, e) for _, s, e in kernels), active) / span


def top_ops(kernels, lo: float, hi: float, n: int = 10):
    """The n device operations (by name, template arguments kept) that
    took most time within [lo, hi], as [name, seconds]."""
    out: dict[str, float] = collections.defaultdict(float)
    for name, s, e in kernels:
        if lo <= s <= hi:
            out[name[:120]] += e - s
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(kernels, spans, active, lo: float, hi: float, n: int = 10):
    """Idle gaps of the device within [lo, hi], summed by what the host
    was doing: inside a pipeline call (by kind), between calls with work
    in the system, or with no request in the system."""
    merged = busy(kernels, lo, hi)
    gaps, t = [], lo
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    calls = sorted((s.t0, s.t1, s.kind) for s in spans)
    starts = [c[0] for c in calls]
    active = union(active)
    out: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])

    def add(label, seconds):
        if seconds > 0:
            out[label][0] += seconds
            out[label][1] += 1
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and calls[i][1] >= mid:
            add(f"inside a {calls[i][2]} call (host work in the pipeline)",
                b - a)
            continue
        waiting = length(clip(active, a, b))
        add("between pipeline calls, requests waiting (control plane)",
            waiting)
        add("no request in the system", b - a - waiting)
    return [[f"{k} x{c}", v] for k, (v, c) in
            sorted(out.items(), key=lambda kv: -kv[1][0])[:n]]
