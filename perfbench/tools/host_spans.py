#!/usr/bin/env python3
"""Split a cell's traced windows by the port's own host spans.

    python3 perfbench/tools/host_spans.py --workload image-interactive \\
        --seed N [--seconds 51] [--legs off,on] [--out FILE]

One set-up (as a run of the cell), then one window a leg on the same
engine, each under the device trace (on a card), with a ``Telemetry``
attached (``on``) or not (``off``).  Each leg prints one JSON line: the
cell's end-to-end and per-layer metrics, read by the benchmark's own
readers; with telemetry also the five readings of
``perfbench/hostspans.py``, the share of the card's busy time inside
the rank's ``call`` spans, the breakdown's idle seconds inside calls
beside the three idle readings' sum, and how each hand-off's post +
plane + pickup compares with the benchmark's own gap.  An ``off`` leg
is what the benchmark measures; ``on`` beside it is what the spans
cost.  On the card (torch 2.11) a second profiler session in one process
lost its marker kernel in 6 of 12 tries: such a leg prints its error and
the next leg runs.  ``--device cpu`` runs the legs without a device
trace.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _quartiles_ms(xs) -> dict:
    xs = sorted(xs)
    pick = lambda q: 1e3 * xs[min(int(q * len(xs)), len(xs) - 1)]  # noqa: E731
    return {"p50": pick(0.5), "p90": pick(0.9),
            "mean": 1e3 * statistics.fmean(xs),
            "over_1ms": sum(x > 1e-3 for x in xs) / len(xs)}


def plane_parts(spans, hands) -> dict:
    """The plane's part of each hand-off, split by its spans: ``wait``
    (post to take), ``apply``, ``to_dispatch`` (the apply's end to the
    dispatch's start: the loop and the schedule point's policy) and
    ``dispatch`` (its start to the queue put), each as ms quantiles."""
    from perfbench.hostspans import PLANE
    by = {(s.op, s.task, s.seq): s for s in spans if s.rank == PLANE}
    rows = []
    for h in hands:
        a, b = h["prev"], h["next"]
        w, ap = by.get(("wait", a.task, a.seq)), by.get(("apply", a.task,
                                                          a.seq))
        d = by.get(("dispatch", b.task, b.seq))
        if w is None or ap is None or d is None:
            continue
        rows.append({"wait": w.t1 - w.t0, "apply": ap.t1 - ap.t0,
                     "to_dispatch": d.t0 - ap.t1,
                     "dispatch": a.t1 + h["plane"] - d.t0})
    if not rows:
        return {}
    return {k: _quartiles_ms([r[k] for r in rows]) for k in rows[0]}


def idle_by_kind(rec, spans) -> dict:
    """``idle_by_phase`` of each call kind, in ms a call of that kind,
    and the KB a call's ``inputs`` and ``sync`` moved."""
    from perfbench import hostspans
    kind = {e["task"]: e["kind"] for e in rec.events
            if e.get("ev") == "dispatch"}
    kind.update((e["pack"], "denoise") for e in rec.events
                if e.get("ev") == "packed_dispatch")
    out = {}
    for k in ("encode", "denoise", "decode"):
        sub = [s for s in spans if kind.get(s.task) == k]
        calls = sum(s.op == "call" for s in sub)
        by_phase = hostspans.idle_by_phase(rec, sub)
        if calls and by_phase is not None:
            out[k] = {"calls": calls, **{p: 1e3 * v / calls
                                         for p, v in by_phase.items()}}
            for op in ("inputs", "sync"):
                out[k][f"{op}_kb"] = sum(s.size for s in sub
                                         if s.op == op) / calls / 1024
    return out


def span_readings(rec, spans) -> dict:
    """The hostspans readings of one window and their checks."""
    from perfbench import devtrace, hostspans, readers
    out = {name: fn(rec, spans) for name, fn in hostspans.READINGS.items()}
    out["call_share"] = hostspans.call_share(rec, spans)
    by_phase = hostspans.idle_by_phase(rec, spans)
    if by_phase is not None:
        lo, hi = rec.measured
        inside = sum(v for k, v in devtrace.idle_gaps(
            rec.kernels, rec.spans, rec.in_system(), lo, hi, n=100)
            if k.startswith("inside a"))
        out["idle_in_phases_s"] = by_phase
        out["breakdown_inside_calls_s"] = inside
        out["idle_ms_a_call"] = idle_by_kind(rec, spans)
    pairs = hostspans.reconcile(rec, spans)
    hands = hostspans.handoffs(rec, spans)
    if pairs:
        resid = [abs(g - r) for g, r in pairs]
        out["handoffs"] = {
            "n": len(hands), "matched": len(pairs),
            "within_0.1ms": sum(x <= 1e-4 for x in resid) / len(resid),
            "max_abs_ms": 1e3 * max(resid),
            "median_gap_ms": 1e3 * statistics.median(g for g, _ in pairs),
            "dispatch_gap_ms": readers.dispatch_gap_ms(rec),
            "post_ms": 1e3 * statistics.median(h["post"] for h in hands)}
        out["plane_parts"] = plane_parts(spans, hands)
    return out


def window(served, seed: int, seconds: float, attach: bool, dev):
    """One traced window of the cell on the prepared engine: its JSON
    line, its record and the program's spans (None without telemetry)."""
    from perfbench import devtrace, harness, hostspans, traffic
    from repro_torch.core.telemetry import Telemetry
    cell = served.cell
    harness.restart(served)
    tel = Telemetry() if attach else None
    served.engine.attach_telemetry(tel)
    specs_w = traffic.generate(cell.mix, cell.config["model"],
                               served.model_name, cell.cost, seed, seconds)
    tracer = devtrace.DeviceTrace() if dev.type == "cuda" else None
    drained = harness.serve_window(
        served, specs_w, harness.window_timeout(served, specs_w, seconds),
        tracer)
    rec = harness.record(served, specs_w, seconds, 0.0, tracer)
    served.engine.attach_telemetry(None)
    line = {"telemetry": attach, "seed": seed, "drained": drained,
            "requests": len(rec.requests),
            "finished": sum(r.done is not None
                            for r in rec.requests.values())}
    for m in cell.end_to_end + cell.per_layer:
        if m["name"] != "setup_s":
            line[m["name"]] = cell.reader(m["name"]).read(rec)
    spans = None
    if tel is not None:
        spans = hostspans.program_spans(tel)
        line["spans"] = len(spans)
        line.update(span_readings(rec, spans))
    return line, rec, spans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="image-interactive")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--legs", default="off,on")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness, spec

    legs = args.legs.split(",")
    if set(legs) - {"on", "off"}:
        ap.error("--legs takes on and off")
    dev = torch.device(args.device)
    cell = spec.load(Path(args.root), args.workload)
    t = time.monotonic()
    served = harness.prepare(cell, args.seed, dev)
    head = {"workload": cell.name, "setup_s": time.monotonic() - t}
    if dev.type == "cuda":
        head["device"] = torch.cuda.get_device_name(dev)
    print(json.dumps(head), flush=True)
    lines = [head]
    try:
        for leg in legs:
            try:
                line, _, _ = window(served, args.seed, args.seconds,
                                    leg == "on", dev)
            except RuntimeError as e:   # the device trace lost its marker
                line = {"telemetry": leg == "on", "error": str(e)}
            print(json.dumps(line), flush=True)
            lines.append(line)
    finally:
        served.engine.shutdown()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
