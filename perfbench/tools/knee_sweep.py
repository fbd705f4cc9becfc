#!/usr/bin/env python3
"""Sweep an open-loop cell's arrival rate on the card, once, to find its
knee: the highest rate served without a backlog that grows through the
window.

    python3 perfbench/tools/knee_sweep.py --workload image-interactive \\
        --rates 1.6,2.0,2.4 --seconds 40 --seed N \\
        [--poisson-seeds A,B,C] [--out FILE]

One set-up (as a run of the cell), then one window a rate on the same
engine.  Each rate prints one JSON line: requests, the median and 90th
percentile latency, the mean number of requests in the system over the
first and the second half of the arrivals, the drain (last completion
after the last arrival), and the denoise dispatches and packs.  The
knee is the highest rate below the first whose second half holds more
than 1.1 times its first; a last line gives it and the cell's rate, 0.8
of it.  With ``--poisson-seeds``, windows of the benchmark's
``run_seconds`` follow at the cell's rate, for each seed one with the
mix's own schedule and one with arrivals drawn from the seed as a
Poisson process (``"schedule": "poisson"``), to set the two side by
side.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def in_system_mean(reqs, lo: float, hi: float, n: int = 400) -> float:
    """Mean number of requests arrived and not done over [lo, hi]."""
    ts = [lo + (hi - lo) * (i + 0.5) / n for i in range(n)]
    return statistics.fmean(
        sum(1 for r in reqs if r.arrival <= t and (r.done is None
                                                   or r.done > t))
        for t in ts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="image-interactive")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--poisson-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness, readers, spec, traffic

    root = Path(args.root)
    cell = spec.load(root, args.workload)
    served = harness.prepare(cell, args.seed, torch.device(args.device))
    lines = []

    def window(rate, seed, seconds, schedule):
        cell.mix["rate_per_s"] = rate
        cell.mix["schedule"] = schedule
        harness.restart(served)
        specs_w = traffic.generate(cell.mix, cell.config["model"],
                                   served.model_name, cell.cost, seed,
                                   seconds)
        harness.serve_window(served, specs_w, harness.window_timeout(
            served, specs_w, seconds))
        rec = harness.record(served, specs_w, seconds, 0.0)
        reqs = rec.requests
        last = max(s.arrival for s in specs_w)
        done = [r.done for r in reqs.values() if r.done is not None]
        half = last / 2
        line = {
            "rate_per_s": rate, "schedule": schedule, "seed": seed,
            "requests": len(reqs), "finished": len(done),
            "latency_p50_s": readers.latency_p(rec, 0.5),
            "latency_p90_s": readers.latency_p(rec, 0.9),
            "in_system_first_half": in_system_mean(reqs.values(), 0, half),
            "in_system_second_half": in_system_mean(reqs.values(), half,
                                                    last),
            "drain_s": (max(done) - last) if done else None,
            "queue_wait_p50_s": readers.queue_wait_p50_s(rec),
            "dispatch_gap_ms": readers.dispatch_gap_ms(rec),
            "denoise_dispatches": sum(
                1 for e in rec.events if e.get("ev") == "dispatch"
                and e.get("kind") == "denoise"),
            "packs": sum(1 for e in rec.events
                         if e.get("ev") == "packed_dispatch")}
        lines.append(line)
        print(json.dumps(line), flush=True)
        return line

    schedule = cell.mix.get("schedule", "stratified")
    swept = [window(float(r), args.seed, args.seconds, schedule)
             for r in args.rates.split(",")]
    knee = swept[0]["rate_per_s"]
    for a, b in zip(swept, swept[1:]):
        if b["in_system_second_half"] > 1.1 * b["in_system_first_half"]:
            break
        knee = b["rate_per_s"]
    rate = round(0.8 * knee, 2)
    print(json.dumps({"knee_per_s": knee, "cell_rate_per_s": rate}),
          flush=True)
    seconds = json.loads((root / "BENCHMARK.json").read_text())[
        "run_seconds"]
    for seed in (int(x) for x in args.poisson_seeds.split(",") if x):
        window(rate, seed, seconds, schedule)
        window(rate, seed, seconds, "poisson")
    served.engine.shutdown()
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines)
                                  + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
