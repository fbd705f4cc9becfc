"""The arithmetic of the end-to-end metrics: percentiles over all
requests, and rates over aligned windows."""
from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th quantile (0 <= q <= 1) by linear interpolation between
    order statistics (numpy's default, ``statistics.quantiles``'
    ``inclusive`` method).  A missing value (a request that failed) is
    +inf and sorts last; a quantile that touches one is +inf."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = q * (len(xs) - 1)
    lo, hi = math.floor(pos), math.ceil(pos)
    if math.isinf(xs[hi]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latencies(arrivals: dict[str, float],
              done: dict[str, Optional[float]]) -> list[float]:
    """done - due arrival of every request; +inf where it never finished."""
    return [done[r] - a if done.get(r) is not None else math.inf
            for r, a in arrivals.items()]


def completion_rate(t_open: float, done_times: Sequence[float],
                    t_close: float) -> tuple[int, float]:
    """(completions in [t_open, t_close], their count over the time from
    t_open to the last of them).  Completion-aligned: the window's tail
    after the last completion is not counted."""
    inside = [t for t in done_times if t_open <= t <= t_close]
    if not inside:
        return 0, 0.0
    return len(inside), len(inside) / (max(inside) - t_open)


def step_window(boundaries: Sequence[float], seconds: float
                ) -> Optional[tuple[float, float, int]]:
    """Step-aligned window over sorted step boundaries (completion times
    of consecutive steps): it opens at the first boundary and closes at
    the first one at or after ``seconds`` later.  Returns (open, close,
    steps inside) or None if no boundary closes it."""
    if not boundaries:
        return None
    t_open = boundaries[0]
    for i, t in enumerate(boundaries[1:], start=1):
        if t >= t_open + seconds:
            return t_open, t, i
    return None


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles over the median
    (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
