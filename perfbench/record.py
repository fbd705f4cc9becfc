"""What a run leaves for the metric readers: its requests, the control
plane's events, the benchmark's spans around each step the pipeline ran,
and the device trace of a ``--trace 1`` run.  Every time is in seconds
of the serve's own clock (0 at the window's serve call)."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class RequestRecord:
    id: str
    cls: str
    tokens: int
    steps: int
    arrival: float                  # when it was due
    done: Optional[float]           # None: never finished


@dataclass
class Span:
    """One call of the pipeline on a rank: an encode, a decode, a denoise
    step or a pack of them (``members``: (request id, step index))."""
    kind: str
    rank: int
    t0: float
    t1: float
    members: tuple
    tokens: int


@dataclass
class Record:
    cell: str
    config: dict
    mix: dict
    seconds: float
    setup_s: float
    requests: dict                  # id -> RequestRecord (the window's)
    events: list                    # the control plane's events
    spans: list                     # [Span], sorted by start
    window: tuple                   # (open, close) of the measured window
    measured: tuple                 # interval the per-layer readers cover
    kernels: Optional[list] = None  # [(name, t0, t1)] in --trace 1 runs

    def spans_in(self, lo: float, hi: float, kind: Optional[str] = None):
        return [s for s in self.spans if s.t0 >= lo - 1e-9 and
                s.t1 <= hi + 1e-9 and (kind is None or s.kind == kind)]

    def in_system(self) -> list[tuple[float, float]]:
        """[arrival, done] of every window request (to the end of the
        measured interval where it never finished)."""
        end = self.measured[1]
        return [(r.arrival, r.done if r.done is not None else end)
                for r in self.requests.values()]


class StepSpans:
    """Wraps a pipeline's ``execute`` and ``execute_packed`` (the calls the
    rank threads make) with host-clock spans, on the instance only."""

    def __init__(self, pipeline):
        self._lock = threading.Lock()
        self._raw: list[tuple] = []
        self._done: set = set()
        run, packed = pipeline.execute, pipeline.execute_packed

        def execute(task, layout, rank, comm, graph, desc):
            t0 = time.monotonic()
            try:
                return run(task, layout, rank, comm, graph, desc)
            finally:
                self._add(task.kind, rank, t0,
                          ((graph.request.id, task.step_index),),
                          task.meta.get("tokens", 0), (task.id,))

        def execute_packed(members, layout, rank, comm, desc):
            t0 = time.monotonic()
            try:
                return packed(members, layout, rank, comm, desc)
            finally:
                self._add("denoise", rank, t0,
                          tuple((g.request.id, t.step_index)
                                for t, g in members),
                          members[0][0].meta.get("tokens", 0),
                          tuple(t.id for t, _ in members))

        pipeline.execute = execute
        pipeline.execute_packed = execute_packed

    def _add(self, kind, rank, t0, members, tokens, task_ids):
        with self._lock:
            self._raw.append((kind, rank, t0, time.monotonic(), members,
                              tokens))
            self._done.update(task_ids)

    def clear(self):
        with self._lock:
            self._raw.clear()
            self._done.clear()

    def wait_for(self, task_ids: set, timeout: float) -> bool:
        """Wait until every task in ``task_ids`` has finished a call;
        False on timeout."""
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            with self._lock:
                if task_ids <= self._done:
                    return True
            time.sleep(0.01)
        return False

    def spans(self, t_base: float) -> list[Span]:
        with self._lock:
            raw = list(self._raw)
        return sorted((Span(k, r, t0 - t_base, t1 - t_base, m, tok)
                       for k, r, t0, t1, m, tok in raw),
                      key=lambda s: s.t0)
