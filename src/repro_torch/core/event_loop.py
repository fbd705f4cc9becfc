"""Shared event-driven serving core (paper §5.1 / §5.5, DESIGN.md §6).

One :class:`EventLoop` drives BOTH execution backends.  The loop body is
*literally identical* for the simulator and the thread runtime — every
difference between "virtual clock" and "wall clock" serving lives behind
the :class:`Clock` interface:

* ``ControlPlane.run``      -> ``EventLoop(plane, VirtualClock(plane))``
* ``ServingEngine.serve``   -> ``EventLoop(plane, WallClock())``

Each iteration performs the same sequence on either backend:

1. sync the control-plane clock,
2. release arrivals and scripted failure events that have come due,
3. invoke ``schedule_point`` (policy actions: dispatch / reallocate /
   preempt / cancel) — this is also the re-invocation point after every
   completion, requeue, and reallocation boundary,
4. wait for the next event (clock-specific: the virtual clock jumps to
   the earliest completion/arrival; the wall clock blocks briefly on the
   completion queue with an idle backoff so it never busy-spins),
5. apply completions (a completion keyed by a pack id fans out into
   per-member completions inside the control plane — DESIGN.md §9 — so
   the loop body itself is packing-agnostic).

This replaces the former hand-rolled wall-clock loop in
``ServingEngine.serve`` which duplicated arrival release, polling, and
termination logic — strengthening the §5.5 claim that a policy selected
offline in simulation deploys on the real engine unchanged.
"""
from __future__ import annotations

import math
import time
from typing import Optional


class Clock:
    """Timebase + event-wait strategy for one :class:`EventLoop`."""

    #: True when time is advanced by the loop rather than by the world.
    virtual: bool = False

    def now(self) -> float:
        raise NotImplementedError

    def wait(self, backend, next_arrival: Optional[float]):
        """Block/advance until the next event.

        Returns a list of :class:`~repro.core.scheduler.Completion` to
        apply (possibly empty when only an arrival released), or ``None``
        when no event source remains and the loop should terminate.
        """
        raise NotImplementedError


class VirtualClock(Clock):
    """Simulator timebase: jumps straight to the next completion or
    arrival, whichever is earlier (the plane's ``now`` IS the clock)."""

    virtual = True

    def __init__(self, plane):
        self.plane = plane

    def now(self) -> float:
        return self.plane.now

    def wait(self, backend, next_arrival):
        nc = backend.peek()
        if nc is not None and (next_arrival is None or nc <= next_arrival):
            return backend.poll()
        if next_arrival is not None:
            self.plane.now = max(self.plane.now, next_arrival)
            return []
        return None                     # no events left: quiesce


class WallClock(Clock):
    """Real timebase anchored at construction; waiting polls the backend
    completion queue and backs off exponentially while idle (but never
    sleeps past the next arrival release)."""

    virtual = False

    def __init__(self, t0: Optional[float] = None, max_pause: float = 0.01):
        self.t0 = time.monotonic() if t0 is None else t0
        self.max_pause = max_pause
        self._idle = 0

    def now(self) -> float:
        return time.monotonic() - self.t0

    def wait(self, backend, next_arrival):
        out = backend.poll()            # blocks a few ms when empty
        if out:
            self._idle = 0
            return out
        self._idle += 1
        pause = min(0.0005 * (1 << min(self._idle, 5)), self.max_pause)
        if next_arrival is not None:
            pause = min(pause, max(next_arrival - self.now(), 0.0))
        if pause > 0:
            time.sleep(pause)
        return []


class EventLoop:
    """The single serving loop shared by simulator and thread runtime."""

    def __init__(self, plane, clock: Clock):
        self.plane = plane
        self.clock = clock

    def run(self, until: float = math.inf, max_events: int = 10 ** 7):
        plane, clock = self.plane, self.clock
        backend = plane.backend
        # loop-health counters (DESIGN.md §15): clock-DEPENDENT by
        # construction — the wall clock polls through many more
        # iterations than the virtual clock jumps — so they live in the
        # counter stream, never in the identity projection
        tel = getattr(plane, "telemetry", None)
        for _ in range(max_events):
            plane.now = max(plane.now, clock.now())
            if plane.now >= until:
                break
            plane.release_arrivals()
            plane.release_failures()
            plane.schedule_point()
            if plane.quiescent():
                break                   # nothing running, nothing arriving
            # wait no further than the next timed event — an arrival OR a
            # scripted failure (DESIGN.md §13): the virtual clock jumps to
            # it, the wall clock bounds its idle pause by it
            completions = clock.wait(backend, plane.next_timed())
            if completions is None:
                break                   # event sources exhausted
            if tel is not None:
                tel.counter("loop_iterations")
                if completions:
                    tel.counter("completions", len(completions))
            for c in completions:
                plane.on_completion(c)
        return plane
