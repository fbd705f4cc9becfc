"""Streaming telemetry sinks + sampling (DESIGN.md §16).

PR 9's :class:`~repro.core.telemetry.Telemetry` was an in-memory,
end-of-run instrument; this module turns the same event stream into a
live, bounded-cost signal source for fleet-scale serving:

* :class:`TelemetrySink` — the fan-out protocol.  Every instrument site
  in :class:`Telemetry` forwards a flat raw record (``{"kind": ...}``)
  to the attached sinks.  A sink declares ``full_stream``: ``True``
  sinks (aggregators, monitors) see EVERY event before sampling;
  ``False`` sinks (raw exporters) see only the retained stream.
* :class:`JsonlSink` — incremental out-of-process export: one JSON line
  per retained event, flushed on an event-count / stream-time watermark
  so a crash loses at most one watermark worth of events.
* :class:`RollupSink` — a bounded-memory windowed aggregator: folds the
  FULL stream into per-window rollups (rank busy seconds → utilization,
  completion/violation counts, span latency histograms over fixed
  HDR-style log buckets, decision counts by ``why``, cost-model error
  histograms, GFC setup bins) with O(windows × ranks) memory, so
  ``Telemetry.summary()``-grade answers survive raw-event sampling.
* :class:`SamplingPolicy` — governs raw-event retention: decisions,
  alerts, and failure/rollback/cancel events are ALWAYS kept;
  request-lifecycle spans are head-sampled at rate ``p`` with
  per-request coherence (a sampled request keeps its whole span,
  including its rank-timeline transitions and cost samples); everything
  sampled out of the rank timelines collapses into run-length-encoded
  aggregate segments inside :class:`Telemetry`.

**Failure isolation.** A sink that raises must never fail the serving
run: the fan-out logs the exception once, detaches the sink, bumps the
``sink_detached`` counter, and keeps serving (gated by
tests/test_telemetry_sinks.py).

**Observation-only.** Sinks never touch ``ControlPlane.events`` or any
policy input; control-plane traces are byte-identical with sinks
attached or detached (gated by benchmarks/telemetry_scale.py).
"""
from __future__ import annotations

import json
from typing import Optional

#: fixed log2-spaced latency histogram bucket upper bounds (seconds) —
#: HDR-style: ~2x resolution per decade is enough for p50/p90/p99-grade
#: answers while keeping every window O(len(buckets)).
LATENCY_BUCKETS_S = tuple(2.0 ** e for e in range(-10, 13)) + (float("inf"),)

#: relative-error histogram bucket upper bounds (cost-model accuracy)
REL_ERR_BUCKETS = (0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, float("inf"))

#: request-lifecycle phases that are ALWAYS retained regardless of the
#: sampling verdict for their request (failures and rollbacks are the
#: debugging surface — sampling them out would blind the operator to
#: exactly the events that matter)
ALWAYS_KEEP_PHASES = frozenset({"failed", "cancel", "rollback"})


def _bucket_index(buckets: tuple, x: float) -> int:
    for i, ub in enumerate(buckets):
        if x <= ub:
            return i
    return len(buckets) - 1


def _quantile_from_bins(buckets: tuple, counts: list, q: float
                        ) -> Optional[float]:
    """Quantile estimate from a fixed-bucket histogram: the upper bound
    of the bucket holding the q-th sample (None on an empty histogram)."""
    n = sum(counts)
    if not n:
        return None
    target = q * (n - 1)
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        if acc > target:
            ub = buckets[i]
            return ub if ub != float("inf") else buckets[-2]
    return buckets[-2]


class TelemetrySink:
    """Base sink: override :meth:`on_event`; ``flush``/``close`` are
    optional.  ``full_stream=True`` sinks receive every event before
    sampling (aggregators); ``False`` sinks receive the retained stream
    only (raw exporters)."""

    full_stream: bool = False

    def bind(self, telemetry) -> None:
        """Called once when attached; monitors use it to emit alerts
        back into the stream via ``telemetry.alert(...)``."""

    def on_event(self, rec: dict) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


# ---------------------------------------------------------------------------
# sampling (raw-event retention)
# ---------------------------------------------------------------------------

def _fnv1a(s: str) -> int:
    """Deterministic 64-bit FNV-1a — NOT Python's ``hash`` (randomized
    per process): the kept-set for a given (seed, rate) must be
    identical across processes and execution backends."""
    h = 0xCBF29CE484222325
    for ch in s.encode():
        h = ((h ^ ch) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _mix64(h: int) -> int:
    """Murmur3 fmix64 finalizer.  Raw FNV-1a has NO final avalanche:
    ids differing only in the trailing character hash within ~2^11 of
    each other, so thresholding them directly makes the kept fraction
    wildly off ``rate`` (whole workloads all-in or all-out).  The
    finalizer diffuses every input bit across the word."""
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & 0xFFFFFFFFFFFFFFFF
    return h ^ (h >> 33)


class SamplingPolicy:
    """Head-based request-coherent sampling of the raw telemetry stream.

    The verdict for a request is a pure function of ``(seed, request
    id)`` — decided once when the request is first seen (head sampling)
    and identical on both execution backends, so the same (seed, rate)
    yields the same kept-set everywhere.  ``rate >= 1.0`` is full
    retention, byte-identical to the pre-§16 instrument.
    """

    def __init__(self, rate: float = 1.0, seed: int = 0):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"sample rate must be in [0, 1], got {rate}")
        self.rate = rate
        self.seed = seed
        self._verdict: dict[str, bool] = {}
        #: rank -> was the transition that opened the current rank state
        #: retained? (idle transitions carry no request id; they close a
        #: busy interval and are retained iff that interval was)
        self._rank_open_kept: dict[int, bool] = {}

    @property
    def full(self) -> bool:
        return self.rate >= 1.0

    def sample_request(self, rid: str) -> bool:
        v = self._verdict.get(rid)
        if v is None:
            threshold = int(self.rate * (1 << 32))
            h = _mix64(_fnv1a(f"{self.seed}:{rid}"))
            v = (h & 0xFFFFFFFF) < threshold
            self._verdict[rid] = v
        return v

    def keep(self, rec: dict) -> bool:
        """Raw-event retention verdict for one stream record."""
        if self.full:
            return True
        kind = rec.get("kind")
        if kind in ("decision", "alert"):
            return True                 # always: the control-plane story
        if kind == "request":
            if rec.get("phase") in ALWAYS_KEEP_PHASES:
                return True
            return self.sample_request(rec["req"])
        if kind == "rank_state":
            if rec.get("state") == "dead":
                return True             # failure-domain transitions
            rid = rec.get("req")
            if rid is not None:
                kept = self.sample_request(rid)
            else:
                # req-less transition (idle after completion): retained
                # iff it closes a retained interval
                kept = self._rank_open_kept.get(rec.get("rank"), False)
            self._rank_open_kept[rec.get("rank")] = kept
            return kept
        if kind == "cost":
            rid = rec.get("req")
            # pack samples carry no single request id: keep (rare)
            return True if rid is None else self.sample_request(rid)
        if kind == "counter":
            return False                # aggregable: rollups carry them
        if kind == "span":
            # overlay spans follow the retention verdict of the rank
            # interval they decorate (coherent with the timeline)
            return self._rank_open_kept.get(rec.get("rank"), False)
        return True                     # gfc / unknown: low volume


# ---------------------------------------------------------------------------
# raw exporters
# ---------------------------------------------------------------------------

class JsonlSink(TelemetrySink):
    """Incremental JSONL export of the retained stream.

    The file opens lazily on the first event (so a bad path is a sink
    failure, isolated by the fan-out, not a serving failure) and flushes
    whenever ``flush_every`` events are buffered OR the stream clock
    advances ``flush_period`` past the last flush — the crash-durability
    watermark.  ``close()`` flushes and closes.
    """

    full_stream = False

    def __init__(self, path, *, flush_every: int = 256,
                 flush_period: float = 1.0):
        self.path = str(path)
        self.flush_every = max(int(flush_every), 1)
        self.flush_period = flush_period
        self.lines_written = 0
        self._buf: list[str] = []
        self._file = None
        self._last_flush_t = 0.0

    def on_event(self, rec: dict) -> None:
        self._buf.append(json.dumps(rec, default=str))
        t = rec.get("t")
        due = len(self._buf) >= self.flush_every or (
            t is not None and t - self._last_flush_t >= self.flush_period)
        if due:
            if t is not None:
                self._last_flush_t = t
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        if self._file is None:
            self._file = open(self.path, "w")
        self._file.write("\n".join(self._buf) + "\n")
        self._file.flush()
        self.lines_written += len(self._buf)
        self._buf.clear()

    def close(self) -> None:
        self.flush()
        if self._file is not None:
            self._file.close()
            self._file = None


class CountingSink(TelemetrySink):
    """Full-stream event counter (+ serialized-size estimate from every
    ``sample_every``-th record) — measures what FULL retention would
    cost without storing anything.  Used by benchmarks/telemetry_scale.py
    to compare against the sampled+rollup footprint."""

    full_stream = True

    def __init__(self, sample_every: int = 97):
        self.events = 0
        self.by_kind: dict[str, int] = {}
        self.sample_every = max(sample_every, 1)
        self._sampled_bytes = 0
        self._sampled_n = 0

    def on_event(self, rec: dict) -> None:
        self.events += 1
        k = rec.get("kind", "?")
        self.by_kind[k] = self.by_kind.get(k, 0) + 1
        if self.events % self.sample_every == 0:
            self._sampled_bytes += len(json.dumps(rec, default=str)) + 1
            self._sampled_n += 1

    def estimated_bytes(self) -> int:
        if not self._sampled_n:
            return 0
        return int(self.events * self._sampled_bytes / self._sampled_n)


# ---------------------------------------------------------------------------
# bounded-memory windowed rollups
# ---------------------------------------------------------------------------

class RollupSink(TelemetrySink):
    """Fold the full raw stream into per-window rollups.

    One window (keyed by ``floor(t / window_s)``) holds fixed-size
    aggregates only — scalars, per-rank busy seconds, and fixed-bucket
    histograms — so total memory is O(windows × ranks + windows ×
    buckets) regardless of request count.  Open intervals (a rank's
    current state, a request's in-flight step) are O(ranks + in-flight),
    not O(history).

    Per window:
      * ``busy_s[rank]``   — busy/migrating seconds (split exactly
        across window boundaries) → rank utilization;
      * ``completed`` / ``violations`` / ``failed`` — request outcomes
        landing in the window → goodput and SLO violation rate;
      * ``step_hist`` / ``latency_hist`` — denoise-step and end-to-end
        latency counts over :data:`LATENCY_BUCKETS_S`;
      * ``decisions[why]`` — decision counts keyed by the staged
        explanation's ``why`` (or the bare action);
      * ``cost_err_hist`` — relative-error counts over
        :data:`REL_ERR_BUCKETS` → error quantiles;
      * ``gfc_hist`` — setup-latency counts over the §15 µs buckets;
      * ``counters`` — counter increments attributed to the window.
    """

    full_stream = True

    def __init__(self, window_s: float = 10.0):
        if window_s <= 0:
            raise ValueError("window_s must be positive")
        self.window_s = window_s
        self.windows: dict[int, dict] = {}
        self.t_max = 0.0
        self._rank_open: dict[int, tuple[float, str]] = {}
        self._open_steps: dict[tuple, float] = {}
        self._req_start: dict[str, float] = {}

    # -- window plumbing ----------------------------------------------
    def _win(self, t: float) -> dict:
        w = int(t // self.window_s)
        win = self.windows.get(w)
        if win is None:
            win = self.windows[w] = {
                "busy_s": {}, "completed": 0, "violations": 0,
                "failed": 0, "decisions": {},
                "step_hist": [0] * len(LATENCY_BUCKETS_S),
                "latency_hist": [0] * len(LATENCY_BUCKETS_S),
                "cost_err_hist": [0] * len(REL_ERR_BUCKETS),
                "gfc_hist": {}, "counters": {},
            }
        return win

    def _add_busy(self, rank: int, t0: float, t1: float) -> None:
        """Attribute a busy interval across the windows it spans."""
        t = t0
        while t < t1:
            w_end = (int(t // self.window_s) + 1) * self.window_s
            seg_end = min(t1, w_end)
            win = self._win(t)
            win["busy_s"][rank] = win["busy_s"].get(rank, 0.0) \
                + (seg_end - t)
            t = seg_end

    # -- event fold ----------------------------------------------------
    def on_event(self, rec: dict) -> None:
        kind = rec.get("kind")
        t = rec.get("t") or 0.0
        self.t_max = max(self.t_max, t)
        if kind == "rank_state":
            r = rec["rank"]
            prev = self._rank_open.get(r)
            if prev is not None and prev[1] in ("busy", "migrating"):
                self._add_busy(r, prev[0], t)
            self._rank_open[r] = (t, rec["state"])
        elif kind == "request":
            phase, rid = rec.get("phase"), rec.get("req")
            if phase == "queued":
                self._req_start[rid] = t
            elif phase == "step_start":
                self._open_steps[(rid, rec.get("kind_"),
                                  rec.get("step"))] = t
            elif phase == "step_end":
                t0 = self._open_steps.pop(
                    (rid, rec.get("kind_"), rec.get("step")), None)
                if t0 is not None:
                    win = self._win(t)
                    win["step_hist"][
                        _bucket_index(LATENCY_BUCKETS_S, t - t0)] += 1
            elif phase == "done":
                win = self._win(t)
                win["completed"] += 1
                m = rec.get("metrics") or {}
                if m.get("violation"):
                    win["violations"] += 1
                t0 = self._req_start.pop(rid, None)
                lat = m.get("latency",
                            t - t0 if t0 is not None else None)
                if lat is not None:
                    win["latency_hist"][
                        _bucket_index(LATENCY_BUCKETS_S, lat)] += 1
            elif phase == "failed":
                win = self._win(t)
                win["failed"] += 1
                win["violations"] += 1      # unfinished == violation §6.1
                self._req_start.pop(rid, None)
        elif kind == "decision":
            ex = rec.get("explanation")
            why = (ex or {}).get("why") or rec.get("action", "?")
            win = self._win(t)
            win["decisions"][why] = win["decisions"].get(why, 0) + 1
        elif kind == "cost":
            win = self._win(t)
            win["cost_err_hist"][
                _bucket_index(REL_ERR_BUCKETS, rec.get("rel_err", 0.0))] \
                += 1
        elif kind == "gfc":
            us = rec.get("s", 0.0) * 1e6
            win = self._win(t)
            # log2 µs bucket label, matching telemetry.GFC_BUCKETS_US
            b = 1
            while b < us and b < 1 << 20:
                b <<= 1
            win["gfc_hist"][b] = win["gfc_hist"].get(b, 0) + 1
        elif kind == "counter":
            win = self._win(t)
            win["counters"][rec["name"]] = \
                win["counters"].get(rec["name"], 0) + rec.get("inc", 1)

    # -- derived answers ----------------------------------------------
    def _settle(self) -> None:
        """Close open busy intervals at the stream high-water mark."""
        for r, (t0, state) in list(self._rank_open.items()):
            if state in ("busy", "migrating") and self.t_max > t0:
                self._add_busy(r, t0, self.t_max)
                self._rank_open[r] = (self.t_max, state)

    def busy_seconds(self) -> dict[int, float]:
        self._settle()
        out: dict[int, float] = {}
        for win in self.windows.values():
            for r, s in win["busy_s"].items():
                out[r] = out.get(r, 0.0) + s
        return out

    def summary(self, num_ranks: Optional[int] = None) -> dict:
        """Whole-run aggregates derived ONLY from the rollup windows —
        the ``Telemetry.summary()``-grade answers that must survive raw
        sampling (gated within tolerance by telemetry_scale.py)."""
        self._settle()
        busy = self.busy_seconds()
        n = num_ranks or max(len(busy), 1)
        makespan = self.t_max
        completed = sum(w["completed"] for w in self.windows.values())
        failed = sum(w["failed"] for w in self.windows.values())
        violations = sum(w["violations"] for w in self.windows.values())
        finished = completed + failed
        step_hist = [0] * len(LATENCY_BUCKETS_S)
        err_hist = [0] * len(REL_ERR_BUCKETS)
        decisions: dict[str, int] = {}
        for w in self.windows.values():
            for i, c in enumerate(w["step_hist"]):
                step_hist[i] += c
            for i, c in enumerate(w["cost_err_hist"]):
                err_hist[i] += c
            for why, c in w["decisions"].items():
                decisions[why] = decisions.get(why, 0) + c
        return {
            "windows": len(self.windows),
            "window_s": self.window_s,
            "makespan_s": makespan,
            "rank_utilization": (sum(busy.values()) / (n * makespan)
                                 if makespan else 0.0),
            "utilization_per_rank": {r: busy[r] / makespan
                                     for r in sorted(busy)} if makespan
            else {},
            "completed": completed,
            "failed": failed,
            "violation_rate": violations / finished if finished else 0.0,
            "goodput_per_rank": (completed / (n * makespan)
                                 if makespan else 0.0),
            "decisions_by_why": decisions,
            "step_p50_s": _quantile_from_bins(LATENCY_BUCKETS_S,
                                              step_hist, 0.50),
            "step_p99_s": _quantile_from_bins(LATENCY_BUCKETS_S,
                                              step_hist, 0.99),
            "cost_err_p50": _quantile_from_bins(REL_ERR_BUCKETS,
                                                err_hist, 0.50),
            "cost_err_p99": _quantile_from_bins(REL_ERR_BUCKETS,
                                                err_hist, 0.99),
        }

    def timeseries(self) -> list[dict]:
        """Per-window rows (sorted by window start) for dashboards and
        the Perfetto counter tracks (DESIGN.md §16)."""
        self._settle()
        out = []
        for w in sorted(self.windows):
            win = self.windows[w]
            busy = sum(win["busy_s"].values())
            n = max(len(win["busy_s"]), 1)
            finished = win["completed"] + win["failed"]
            out.append({
                "t0": w * self.window_s,
                "utilization": busy / (n * self.window_s),
                "completed": win["completed"],
                "failed": win["failed"],
                "violation_rate": (win["violations"] / finished
                                   if finished else 0.0),
                "decisions": sum(win["decisions"].values()),
            })
        return out
