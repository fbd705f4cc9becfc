"""Paper §6.1 workloads: S/M/L request classes, arrival traces, SLOs.

Wan2.2 (dit-video)  S/M/L: 480x832x49f / 480x832x81f / 720x1280x81f
Qwen-Image (dit-image) S/M/L: 512 / 1024 / 1536 px squares
SLO: deadline = arrival + alpha_c * T_c (profiled standalone service time),
alpha = 2.0/2.5/3.5 (video), 1.5/2.0/6.0 (image), + fixed allowance.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.cost_model import CostModel
from repro_torch.core.trajectory import Request, fresh_id

CLASSES = {
    "dit-video": {
        "S": dict(height=480, width=832, frames=49),
        "M": dict(height=480, width=832, frames=81),
        "L": dict(height=720, width=1280, frames=81),
    },
    "dit-image": {
        "S": dict(height=512, width=512, frames=1),
        "M": dict(height=1024, width=1024, frames=1),
        "L": dict(height=1536, width=1536, frames=1),
    },
}

SLO_ALPHA = {
    "dit-video": {"S": 2.0, "M": 2.5, "L": 3.5},
    "dit-image": {"S": 1.5, "M": 2.0, "L": 6.0},
}
SLO_ALLOWANCE = {"dit-video": 5.0, "dit-image": 1.0}


def request_tokens(model: str, cls: str, patch: int = 2,
                   steps: int = 50) -> int:
    c = CLASSES[model][cls]
    f = c["frames"]
    f_lat = max(1, (f + 3) // 4) if f > 1 else 1
    return f_lat * (c["height"] // 8 // patch) * (c["width"] // 8 // patch)


def standalone_service_time(model: str, cls: str, cost: CostModel,
                            steps: int = 50, degree: int = 1) -> float:
    """Profiled single-request service time T_c (for SLO deadlines)."""
    tok = request_tokens(model, cls)
    t = cost.estimate(model, "encode", tok, 1)
    t += steps * cost.estimate(model, "denoise", tok, degree)
    t += cost.estimate(model, "decode", tok, degree)
    return t


def make_request(model: str, cls: str, arrival: float, cost: CostModel,
                 steps: int = 50) -> Request:
    c = CLASSES[model][cls]
    t_c = standalone_service_time(model, cls, cost, steps)
    deadline = arrival + SLO_ALPHA[model][cls] * t_c + SLO_ALLOWANCE[model]
    return Request(id=fresh_id("req"), model=model, height=c["height"],
                   width=c["width"], frames=c["frames"], steps=steps,
                   arrival=arrival, deadline=deadline, size_class=cls)


# ---------------------------------------------------------------------------
# Traces (Fig. 7): "short" mixed-arrival and "foreground-burst"
# ---------------------------------------------------------------------------

def _lcg(seed: int):
    state = seed or 1

    def rand():
        nonlocal state
        state = (1103515245 * state + 12345) % (1 << 31)
        return state / (1 << 31)
    return rand


def short_trace(model: str, cost: CostModel, *, duration: float = 120.0,
                load: float = 0.7, num_ranks: int = 4, steps: int = 50,
                seed: int = 7) -> list[Request]:
    """Compact mixed-arrival period: Poisson arrivals, class mix
    60/30/10 S/M/L, rate calibrated to `load` x estimated capacity."""
    rand = _lcg(seed)
    mix = [("S", 0.6), ("M", 0.3), ("L", 0.1)]
    mean_t = sum(w * standalone_service_time(model, c, cost, steps)
                 for c, w in mix)
    rate = load * num_ranks / mean_t          # requests/s at target load
    out, t = [], 0.0
    while t < duration:
        t += -math.log(max(rand(), 1e-9)) / rate
        u, cls = rand(), "L"
        acc = 0.0
        for c, w in mix:
            acc += w
            if u <= acc:
                cls = c
                break
        out.append(make_request(model, cls, t, cost, steps))
    return out


def mixed_burst_trace(cost: CostModel, *, duration: float = 240.0,
                      load: float = 1.0, num_ranks: int = 4,
                      steps: int = 25, video_steps: Optional[int] = None,
                      seed: int = 13) -> list[Request]:
    """Bursty MIXED image/video trace (elastic-policy showcase):

    * a best-effort ``dit-video`` background stream (``deadline=None``)
      that soaks up idle ranks and is preemptible,
    * a Poisson ``dit-image`` M stream with standard SLO deadlines,
    * periodic dense bursts of S images with tight deadlines arriving
      while background work is in flight.
    """
    rand = _lcg(seed)
    video_steps = video_steps or max(steps // 3, 4)
    out: list[Request] = []
    # best-effort video background: one every ~sixth of the window
    t = duration * 0.02
    t_vid = standalone_service_time("dit-video", "S", cost, video_steps)
    while t < duration:
        r = make_request("dit-video", "S", t, cost, video_steps)
        r.deadline = None                     # best-effort
        out.append(r)
        t += max(duration / 6.0, t_vid * 0.25)
    # SLO image stream (M class)
    t_m = standalone_service_time("dit-image", "M", cost, steps)
    rate = load * num_ranks / t_m * 0.5
    t = 0.0
    while t < duration:
        t += -math.log(max(rand(), 1e-9)) / rate
        out.append(make_request("dit-image", "M", t, cost, steps))
    # dense S-image bursts with tight deadlines
    t_s = standalone_service_time("dit-image", "S", cost, steps)
    for bt in (duration * f for f in (0.2, 0.45, 0.7, 0.9)):
        for i in range(max(3, num_ranks * 2)):
            r = make_request("dit-image", "S", bt + i * t_s * 0.05, cost,
                             steps)
            r.deadline = r.arrival + 1.2 * t_s + SLO_ALLOWANCE["dit-image"]
            out.append(r)
    out.sort(key=lambda r: r.arrival)
    return out


def small_image_burst_trace(cost: CostModel, *, duration: float = 90.0,
                            load: float = 2.5, num_ranks: int = 4,
                            steps: int = 20, seed: int = 17
                            ) -> list[Request]:
    """Many-small-images burst (step-packing showcase, DESIGN.md §9):
    a dense Poisson stream of S-class images at `load` x the machine's
    single-task serving capacity.  Every request shares one pack
    signature, so a packing policy can co-batch denoise steps across the
    whole backlog; a one-task-per-rank-set policy saturates at
    ``num_ranks`` concurrent steps and drowns.  SLOs are the standard
    S-class deadlines — tight enough that the unpacked policy's queueing
    delay violates them, loose enough that a packed step (slightly slower
    than a solo step) still fits."""
    rand = _lcg(seed)
    t_s = standalone_service_time("dit-image", "S", cost, steps)
    rate = load * num_ranks / t_s
    out: list[Request] = []
    t = 0.0
    while t < duration:
        t += -math.log(max(rand(), 1e-9)) / rate
        out.append(make_request("dit-image", "S", t, cost, steps))
    return out


def multi_host_trace(cost: CostModel, *, duration: float = 240.0,
                     load: float = 1.0, num_ranks: int = 8,
                     steps: int = 25, seed: int = 23,
                     m_alpha: float = 0.8, s_alpha: float = 1.5
                     ) -> list[Request]:
    """Topology-stress workload (DESIGN.md §10): a Poisson M-image SLO
    stream plus periodic dense S-image bursts on a multi-host cluster.

    Deadlines are tight enough that requests need SP degrees of 2-4 —
    placements that FIT inside one host of a 2-host x 4-rank cluster but
    only if the policy packs them there.  A topology-blind policy grabs
    free ranks by bare index, routinely straddling hosts; every such
    step pays the inter-host collective tax, which is exactly the margin
    between meeting and missing these SLOs."""
    rand = _lcg(seed)
    out: list[Request] = []
    t_m = standalone_service_time("dit-image", "M", cost, steps)
    rate = load * num_ranks / t_m * 0.55
    t = 0.0
    while t < duration:
        t += -math.log(max(rand(), 1e-9)) / rate
        r = make_request("dit-image", "M", t, cost, steps)
        r.deadline = r.arrival + m_alpha * t_m + SLO_ALLOWANCE["dit-image"]
        out.append(r)
    t_s = standalone_service_time("dit-image", "S", cost, steps)
    for bt in (duration * f for f in (0.2, 0.45, 0.7, 0.9)):
        for i in range(8):
            r = make_request("dit-image", "S", bt + i * t_s * 0.05, cost,
                             steps)
            r.deadline = r.arrival + s_alpha * t_s \
                + SLO_ALLOWANCE["dit-image"]
            out.append(r)
    out.sort(key=lambda r: r.arrival)
    return out


def cache_trace(cost: CostModel, *, duration: float = 240.0,
                load: float = 1.0, num_ranks: int = 4, steps: int = 25,
                seed: int = 29, alpha: float = 1.1) -> list[Request]:
    """Feature-cache stress workload (DESIGN.md §11): a Poisson stream
    of M-class images whose deadlines are only meetable at SP degrees
    >= 2 — every denoise step therefore runs a multi-rank KV all-gather,
    which is exactly the cost a staleness window removes.  ``load`` is
    calibrated against UNCACHED degree-4 capacity, so the uncached
    baseline saturates while a cached plane (collectives skipped on
    interval-1 of every interval steps) clears the same stream with
    margin — the throughput headroom the acceptance gate measures."""
    rand = _lcg(seed)
    t_m = standalone_service_time("dit-image", "M", cost, steps)
    t_m4 = standalone_service_time("dit-image", "M", cost, steps,
                                   degree=4)
    # the uncached machine serves this stream as num_ranks/4 concurrent
    # degree-4 requests (deadlines rule out degree 1)
    rate = load * max(num_ranks / 4.0, 1.0) / t_m4
    out: list[Request] = []
    t = 0.0
    while t < duration:
        t += -math.log(max(rand(), 1e-9)) / rate
        r = make_request("dit-image", "M", t, cost, steps)
        # tight deadline: misses at degree 1, met at higher degrees
        r.deadline = r.arrival + alpha * t_m4 + 0.25 * t_m \
            + SLO_ALLOWANCE["dit-image"]
        out.append(r)
    return out


def chaos_trace(cost: CostModel, *, duration: float = 240.0,
                load: float = 0.9, num_ranks: int = 8, steps: int = 25,
                seed: int = 31, alpha: float = 1.6) -> list[Request]:
    """Failure-domain workload (DESIGN.md §13): a steady Poisson M-image
    SLO stream sized so a healthy cluster clears it with margin — the
    margin whole-host losses then eat.  The chaos gate serves this trace
    under a seeded :class:`~repro.core.failures.FailureInjector` kill
    script: with recovery on, requests touching a dead host fail out,
    roll back to their last denoise snapshot, and finish on the
    survivors inside their (alpha-padded) deadlines; the blind baseline
    writes every touched request off.  Deadlines are deliberately loose
    (``alpha`` standalone times + allowance) so the comparison measures
    survival, not scheduling finesse."""
    rand = _lcg(seed)
    t_m = standalone_service_time("dit-image", "M", cost, steps)
    rate = load * num_ranks / t_m * 0.5
    out: list[Request] = []
    t = 0.0
    while t < duration:
        t += -math.log(max(rand(), 1e-9)) / rate
        r = make_request("dit-image", "M", t, cost, steps)
        r.deadline = r.arrival + alpha * t_m + SLO_ALLOWANCE["dit-image"]
        out.append(r)
    return out


def hybrid_trace(cost: CostModel, *, duration: float = 240.0,
                 load: float = 0.9, num_ranks: int = 8, steps: int = 25,
                 seed: int = 37, alpha: float = 1.35,
                 guidance: float = 5.0) -> list[Request]:
    """Hybrid-shape workload (DESIGN.md §14): a Poisson stream of
    GUIDED M-class images — classifier-free guidance doubles the
    denoise work — plus a best-effort video background stream (mixed
    image/video).

    At these token counts the batched-CFG shape pays a B=2 KV gather
    every step, while the split shape runs each branch's gather over
    half the ranks and exchanges ONE velocity array per step — the
    split prices 2-3x cheaper at the same total degree.  Deadlines are
    set against the SPLIT cfg2 x sp2 rate (``alpha`` margin), so a
    shape-searching policy clears the stream as concurrent split-shape
    requests while a scalar policy — whose best batched ETA misses
    these deadlines at ANY degree — degrades to machine-wide
    dispatches.  That gap is what the --only hybrid gate measures."""
    rand = _lcg(seed)
    tok = request_tokens("dit-image", "M")
    t_split = cost.estimate("dit-image", "encode", tok, 1) \
        + steps * cost.estimate("dit-image", "denoise", tok, 4, cfg=2) \
        + cost.estimate("dit-image", "decode", tok, 4)
    # capacity: num_ranks/4 concurrent cfg2 x sp2 requests
    rate = load * max(num_ranks / 4.0, 1.0) / t_split
    out: list[Request] = []
    t = 0.0
    while t < duration:
        t += -math.log(max(rand(), 1e-9)) / rate
        r = make_request("dit-image", "M", t, cost, steps)
        r.guidance = guidance
        r.deadline = r.arrival + alpha * t_split \
            + SLO_ALLOWANCE["dit-image"]
        out.append(r)
    # best-effort unguided video background: soaks idle ranks and
    # exercises shrink/preempt alongside the guided stream
    for bt in (duration * f for f in (0.1, 0.5, 0.8)):
        r = make_request("dit-video", "S", bt, cost, steps)
        r.deadline = None
        out.append(r)
    out.sort(key=lambda r: r.arrival)
    return out


def open_loop_trace(cost: CostModel, *, n_requests: int = 20000,
                    load: float = 0.7, num_ranks: int = 16,
                    steps: int = 6, seed: int = 43, degree: int = 8,
                    alpha: float = 1.25) -> list[Request]:
    """Fleet-scale open-loop stream (DESIGN.md §16): a fixed-count
    Poisson stream of M-class images whose deadlines are calibrated
    against degree-``degree`` service — EDF then serves the stream as
    ``num_ranks/degree`` concurrent wide requests, so every step fans
    out ~2x``degree`` rank-timeline transitions.  That event volume is
    the point: this is the stress input for the telemetry streaming
    layer (benchmarks/telemetry_scale.py), sized so full in-memory
    retention is measurably unreasonable and sampling's always-keep
    floor (one decision per dispatch) still leaves a >=10x reduction.
    ``load`` just under capacity keeps the backlog bounded while queue
    fluctuations under tight ``alpha`` still produce a real (~10-30%)
    SLO violation rate for the burn-rate monitors to chew on."""
    rand = _lcg(seed)
    t_d = standalone_service_time("dit-image", "M", cost, steps,
                                  degree=degree)
    rate = load * max(num_ranks / degree, 1.0) / t_d
    out: list[Request] = []
    t = 0.0
    for _ in range(n_requests):
        t += -math.log(max(rand(), 1e-9)) / rate
        r = make_request("dit-image", "M", t, cost, steps)
        # no fixed allowance: at these sizes the standard allowance
        # dwarfs the degree gap and EDF happily serves at degree 1-2,
        # defeating the fan-out this trace exists to generate
        r.deadline = r.arrival + alpha * t_d
        out.append(r)
    return out


def foreground_burst_trace(model: str, cost: CostModel, *,
                           duration: float = 120.0, load: float = 0.5,
                           num_ranks: int = 4, steps: int = 50,
                           seed: int = 11) -> list[Request]:
    """Bursts of short requests arriving while longer requests are in
    flight: background M/L Poisson stream + periodic dense S bursts."""
    rand = _lcg(seed)
    out: list[Request] = []
    # background stream of M/L
    mean_t = 0.5 * (standalone_service_time(model, "M", cost, steps)
                    + standalone_service_time(model, "L", cost, steps))
    rate = load * num_ranks / mean_t * 0.5
    t = 0.0
    while t < duration:
        t += -math.log(max(rand(), 1e-9)) / rate
        out.append(make_request(model, "M" if rand() < 0.6 else "L", t,
                                cost, steps))
    # foreground bursts: every ~duration/4, a burst of short requests
    burst_times = [duration * f for f in (0.15, 0.4, 0.65, 0.85)]
    t_s = standalone_service_time(model, "S", cost, steps)
    for bt in burst_times:
        n_burst = max(3, int(num_ranks * 2))
        for i in range(n_burst):
            out.append(make_request(model, "S", bt + i * t_s * 0.05,
                                    cost, steps))
    out.sort(key=lambda r: r.arrival)
    return out
