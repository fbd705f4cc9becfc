"""Live SLO burn-rate monitors over the telemetry stream (DESIGN.md §16).

A monitor is a full-stream :class:`~repro.core.telemetry_sinks.
TelemetrySink` that folds request outcomes into a sliding window and
emits structured ``alert`` events back into the SAME stream (via
``Telemetry.alert``) when the windowed signal crosses its declared
threshold.  Alerts are always retained by every
:class:`~repro.core.telemetry_sinks.SamplingPolicy` and are surfaced
read-only to policies through ``SchedulerView.alerts`` — *observing*
them is allowed this PR; *acting* on them belongs to the
admission-control arc (ROADMAP).

Monitors are clock-dependent by construction (windows are seconds), so
nothing they produce enters the cross-backend identity projection, and
because no shipped policy reads ``view.alerts`` into a decision,
attaching monitors leaves control-plane traces byte-identical
(gated by benchmarks/telemetry_scale.py).

Memory: one deque of (t, outcome) per monitor, evicted past the window
— bounded by the window's event count, never by run length.

* :class:`SloBurnRateMonitor` — violation-rate burn: windowed SLO
  violation rate divided by the error budget (the violation rate the
  operator planned for).  Burn ≥ ``threshold`` ⇒ the budget is being
  consumed ``threshold``× too fast — the classic SRE burn-rate pager.
* :class:`GoodputMonitor` — goodput-per-rank floor: completed requests
  per rank-second over the window; alerts when a warmed-up window
  falls below ``floor``.
"""
from __future__ import annotations

from collections import deque
from typing import Optional

from repro_torch.core.telemetry_sinks import TelemetrySink


class _WindowMonitor(TelemetrySink):
    """Shared sliding-window machinery + one-shot alert arming: a
    monitor fires when its signal crosses the threshold and re-arms only
    after the signal recovers (hysteresis — a sustained breach is one
    alert, not one per event)."""

    full_stream = True

    def __init__(self, name: str, window_s: float, min_events: int = 5):
        self.name = name
        self.window_s = window_s
        self.min_events = min_events
        self._events: deque = deque()
        self._tel = None
        self._armed = True
        self.alerts_fired = 0

    def bind(self, telemetry) -> None:
        self._tel = telemetry

    def _evict(self, now: float) -> None:
        w = self._events
        while w and w[0][0] < now - self.window_s:
            w.popleft()

    def _maybe_alert(self, now: float, value: float, threshold: float,
                     breach: bool, **extra) -> None:
        if breach and self._armed:
            self._armed = False
            self.alerts_fired += 1
            if self._tel is not None:
                self._tel.alert(self.name, now, value=value,
                                threshold=threshold,
                                window_s=self.window_s, **extra)
        elif not breach:
            self._armed = True


class SloBurnRateMonitor(_WindowMonitor):
    """Sliding-window SLO violation-rate burn monitor.

    ``budget`` is the violation rate the SLO tolerates (e.g. 0.05 = 5%
    of requests may miss); burn = windowed violation rate / budget.
    Fires when burn ≥ ``threshold`` over a window with at least
    ``min_events`` finished requests.
    """

    def __init__(self, *, window_s: float = 30.0, budget: float = 0.05,
                 threshold: float = 2.0, min_events: int = 5,
                 name: str = "slo-burn"):
        super().__init__(name, window_s, min_events)
        if budget <= 0:
            raise ValueError("budget must be positive")
        self.budget = budget
        self.threshold = threshold

    def on_event(self, rec: dict) -> None:
        if rec.get("kind") != "request":
            return
        phase = rec.get("phase")
        if phase == "done":
            violated = bool((rec.get("metrics") or {}).get("violation"))
        elif phase == "failed":
            violated = True             # unfinished == violation (§6.1)
        else:
            return
        t = rec.get("t") or 0.0
        self._events.append((t, violated))
        self._evict(t)
        n = len(self._events)
        if n < self.min_events:
            return
        rate = sum(1 for _, v in self._events if v) / n
        burn = rate / self.budget
        self._maybe_alert(t, burn, self.threshold,
                          burn >= self.threshold,
                          violation_rate=rate, budget=self.budget,
                          finished_in_window=n)

    def burn_rate(self) -> Optional[float]:
        """Current windowed burn (None before ``min_events``)."""
        n = len(self._events)
        if n < self.min_events:
            return None
        return sum(1 for _, v in self._events if v) / n / self.budget


class GoodputMonitor(_WindowMonitor):
    """Sliding-window goodput-per-rank floor monitor: completions per
    rank-second over the window (num_ranks read from the bound
    Telemetry).  Fires when a warmed-up window (stream time past one
    full window) falls below ``floor``."""

    def __init__(self, *, window_s: float = 30.0, floor: float = 0.01,
                 min_events: int = 1, name: str = "goodput-floor"):
        super().__init__(name, window_s, min_events)
        self.floor = floor
        self._t_max = 0.0

    def _goodput(self) -> float:
        n_ranks = (self._tel.num_ranks if self._tel is not None
                   and self._tel.num_ranks else 1)
        return len(self._events) / (self.window_s * n_ranks)

    def on_event(self, rec: dict) -> None:
        if rec.get("kind") != "request":
            return
        t = rec.get("t") or 0.0
        self._t_max = max(self._t_max, t)
        if rec.get("phase") == "done":
            self._events.append((t, True))
        self._evict(self._t_max)
        if self._t_max < self.window_s:
            return                      # warm-up: window not yet full
        g = self._goodput()
        self._maybe_alert(self._t_max, g, self.floor, g < self.floor)

    def goodput_per_rank(self) -> float:
        return self._goodput()
