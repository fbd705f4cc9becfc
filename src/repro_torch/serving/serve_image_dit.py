"""End-to-end serving driver on the port (``examples/serve_image_dit.py``
on PyTorch): six S/M/L image requests through the GF-DiT runtime —
thread workers, GFC sequence parallelism, layout migration — on a
reduced image DiT, producing decoded images.

    python -m repro_torch.serving.serve_image_dit            # the card
    python -m repro_torch.serving.serve_image_dit --device cpu \\
        --cache-interval 3 --min-degree 2

``--cache-interval`` enables the cross-step feature cache (DESIGN.md
§11): multi-rank denoise steps reuse the previous step's gathered remote
KV shards and skip the GFC all-gather for up to interval-1 steps between
full refresh gathers.  ``--min-degree`` floors the SP degree (emulating
per-rank activation memory limits); at the default of 1 a lightly-loaded
machine serves at SP1, where there is no collective for the cache to
skip.  ``--cfg-split`` serves GUIDED requests (classifier-free guidance)
under the hybrid shape-searching policy (DESIGN.md §14): each denoise
step runs cond/uncond branches — batched through one group, or split as
a ``cfg2 x sp`` shape with one merge exchange per step, whichever the
shape-keyed cost model prices cheaper.  ``--emit-trace PATH`` attaches
the telemetry plane (DESIGN.md §15) and writes a Perfetto/Chrome
``trace.json`` of the run (per-rank busy/migrating timelines, per-request
lifecycle spans, policy decision instants) and prints an end-of-run
utilization and decision summary.  ``--stream-telemetry PATH`` streams
retained telemetry events to ``PATH`` as JSONL while the run goes
(DESIGN.md §16), folds the full stream into rollup windows and runs the
SLO burn-rate and goodput monitors; ``--sample-rate P`` head-samples
request spans at rate ``P`` (decisions, failures and rollbacks are
always kept).  ``--device`` picks the torch device (default: the card;
``cpu`` runs the kernels' plain versions).  The JAX driver's
``--use-pallas`` has no counterpart: the port always runs its kernels.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.dit_models import DIT_IMAGE
from repro_torch.core.policies import EDFPolicy, ElasticPolicy, make_policy
from repro_torch.core.trajectory import Request
from repro_torch.serving.engine import ServingEngine

NUM_RANKS = 4


def _policy(name: str, num_ranks: int, min_degree: int):
    if min_degree <= 1:
        return make_policy(name, num_ranks)
    cands = [d for d in (1, 2, 4, 8, 16, 32)
             if min_degree <= d <= num_ranks]
    if name == "edf":
        return EDFPolicy(candidate_degrees=cands)
    if name in ("elastic", "elastic-cache", "elastic-hybrid"):
        return ElasticPolicy(candidate_degrees=cands,
                             cache_affinity=name == "elastic-cache",
                             hybrid=name == "elastic-hybrid")
    raise SystemExit(f"--min-degree supports edf/elastic/elastic-cache/"
                     f"elastic-hybrid, not {name!r}")


def _requests(cfg_split: bool) -> list[Request]:
    classes = {"S": 128, "M": 192, "L": 256}
    out = []
    for i in range(6):
        cls = "SML"[i % 3]
        res = classes[cls]
        out.append(Request(
            id=f"req-{i}", model="dit-image", height=res, width=res,
            frames=1, steps=4, arrival=i * 0.3,
            deadline=i * 0.3 + 120.0, size_class=cls,
            # alternate guided/unguided under --cfg-split: the guided
            # half exercises shapes, the rest the scalar (and cached)
            # paths in the same mix
            guidance=4.0 if cfg_split and i % 2 == 0 else None))
    return out


def _print_telemetry(telemetry, args, stream_sinks, rollup) -> None:
    s = telemetry.summary()
    dest = args.emit_trace or "(in-memory)"
    print(f"\ntelemetry summary (trace -> {dest}):")
    print(f"  makespan: {s['makespan_s']:.2f}s   "
          f"rank utilization: {s['rank_utilization']:.1%}   "
          f"goodput/rank: {s['goodput_per_rank']:.4f} req/rank-s")
    print("  rank | utilization")
    for r, u in sorted(s["utilization_per_rank"].items()):
        print(f"  {r:>4} | {'#' * int(u * 40):<40} {u:.1%}")
    print("  decisions by action: " + ", ".join(
        f"{k} x{v}" for k, v in sorted(s["actions"].items())))
    whys = {}
    for d in telemetry.decisions:
        ex = d.get("explanation")
        if ex is not None:
            whys[ex["why"]] = whys.get(ex["why"], 0) + 1
    if whys:
        print("  explained decisions: " + ", ".join(
            f"{k} x{v}" for k, v in sorted(whys.items())))
    if args.stream_telemetry:
        jsonl = stream_sinks[0]
        print(f"  streamed {jsonl.lines_written} retained events -> "
              f"{args.stream_telemetry} "
              f"(sample_rate={args.sample_rate}, "
              f"{len(rollup.windows)} rollup windows, "
              f"{len(telemetry.alerts)} alerts)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--policy", default="edf",
                    help="scheduling policy (see core/policies.py "
                         "registry; e.g. edf, elastic, elastic-cache)")
    ap.add_argument("--cache-interval", type=int, default=None,
                    help="feature-cache staleness window (DESIGN.md §11)"
                         "; omit to serve uncached")
    ap.add_argument("--min-degree", type=int, default=1,
                    help="minimum SP degree (emulates per-rank memory "
                         "limits; degree >= 2 exercises the cached "
                         "KV-gather path)")
    ap.add_argument("--cfg-split", action="store_true",
                    help="serve guided requests (classifier-free "
                         "guidance) under the hybrid shape-searching "
                         "policy (DESIGN.md §14)")
    ap.add_argument("--emit-trace", metavar="PATH", default=None,
                    help="attach the telemetry plane and write a "
                         "Perfetto/Chrome trace.json of the run here "
                         "(DESIGN.md §15)")
    ap.add_argument("--stream-telemetry", metavar="PATH", default=None,
                    help="stream retained telemetry events to PATH as "
                         "JSONL and fold the full stream into rollup "
                         "windows + SLO monitors (DESIGN.md §16); "
                         "implies telemetry")
    ap.add_argument("--sample-rate", type=float, default=1.0,
                    help="head-sampling rate for raw request-span "
                         "retention (DESIGN.md §16); 1.0 keeps every "
                         "event, decisions/failures are always kept")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    if not 0.0 <= args.sample_rate <= 1.0:
        raise SystemExit("--sample-rate must be in [0, 1]")

    if args.cfg_split:
        if args.policy == "edf":
            args.policy = "elastic-hybrid"  # shapes need a shape searcher
        # floor the degree at a branch pair: at degree 1 there is
        # nothing to split, and at these reduced token counts degree 1
        # legitimately wins on cost — the flag is here to SHOW shapes
        args.min_degree = max(args.min_degree, 2)

    telemetry = None
    stream_sinks = []
    rollup = None
    if args.emit_trace or args.stream_telemetry or args.sample_rate < 1.0:
        from repro_torch.core.telemetry import Telemetry
        from repro_torch.core.telemetry_sinks import SamplingPolicy
        if args.stream_telemetry:
            from repro_torch.core.slo_monitor import (GoodputMonitor,
                                                      SloBurnRateMonitor)
            from repro_torch.core.telemetry_sinks import (JsonlSink,
                                                          RollupSink)
            rollup = RollupSink(window_s=2.0)
            stream_sinks = [JsonlSink(args.stream_telemetry), rollup,
                            SloBurnRateMonitor(), GoodputMonitor()]
        sampling = (SamplingPolicy(rate=args.sample_rate)
                    if args.sample_rate < 1.0 else None)
        telemetry = Telemetry(sinks=stream_sinks, sampling=sampling)
    engine = ServingEngine(DIT_IMAGE.reduced(),
                           _policy(args.policy, NUM_RANKS, args.min_degree),
                           num_ranks=NUM_RANKS,
                           cache_interval=args.cache_interval,
                           telemetry=telemetry, device=args.device)
    try:
        requests = _requests(args.cfg_split)
        label = f"{args.policy} policy" + (
            f", cache_interval={args.cache_interval}"
            if args.cache_interval else ", uncached") + (
            ", cfg-split guidance" if args.cfg_split else "")
        print(f"serving {len(requests)} requests on {NUM_RANKS} ranks "
              f"({label}) on {engine.pipeline.device}...")
        metrics = engine.serve(requests, timeout=600)
        for k, v in metrics.items():
            print(f"  {k}: {v:.3f}" if isinstance(v, float)
                  else f"  {k}: {v}")
        for req in requests[:2]:
            px = engine.result_pixels(req)
            print(f"{req.id}: decoded image {px.shape}, "
                  f"range [{px.min():.2f}, {px.max():.2f}]")
        events = engine.cp.events
        sizes = {len(ev["ranks"]) for ev in events if ev["ev"] == "dispatch"}
        print(f"group sizes used across tasks: {sorted(sizes)}")
        if args.cfg_split:
            shapes = {}
            for ev in events:
                if ev["ev"] == "dispatch" and ev["kind"] == "denoise":
                    c = ev.get("cfg", 1)
                    sp = len(ev["ranks"]) // c
                    key = f"cfg{c}x sp{sp}" if c > 1 else f"sp{sp}"
                    shapes[key] = shapes.get(key, 0) + 1
            print("denoise shapes dispatched: "
                  + ", ".join(f"{k} x{v}" for k, v in sorted(shapes.items())))
        if args.cache_interval:
            modes = [str(ev.get("cache", "")) for ev in events
                     if ev["ev"] == "dispatch"]
            print(f"feature cache: "
                  f"{sum(m.startswith('hit') for m in modes)} hit steps "
                  f"(all-gather skipped), {modes.count('refresh')} refresh "
                  f"steps")
        if telemetry is not None:
            if args.emit_trace:
                telemetry.perfetto(args.emit_trace)
            _print_telemetry(telemetry, args, stream_sinks, rollup)
    finally:
        engine.shutdown()
    return metrics


if __name__ == "__main__":
    main()
