"""One run of one cell: set-up, the measured window, the metrics, and the
comparison that decides ``correct``.

Set-up builds the port's ``ServingEngine`` (one rank, the
configuration's policy, the frozen cost table), copies the seed's
weights into its modules, and serves the traffic mix's warm-up bursts
through the same engine, so every shape the window uses has run.  The
window is one ``ServingEngine.serve`` call of the mix's requests on the
engine's own clock.  Once it has closed and the last step in flight has
finished, the peak memory is read, the engine is shut down, and the
reference recomputes a sample of what the window produced.
"""
from __future__ import annotations

import dataclasses
import gc
import logging
import math
import sys
import time
from pathlib import Path

import torch

from perfbench import check, devtrace, spec, stats, traffic, weights
from perfbench.record import Record, RequestRecord, StepSpans
from perfbench.reference import param_specs
from perfbench.reference.arith import Arith

#: top-level modules that the process printing a result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: seconds a warm-up burst may take, and the calls still running at a
#: window's close may take to finish
WARMUP_TIMEOUT_S = 600.0
DRAIN_WAIT_S = 120.0


class RunError(RuntimeError):
    """The run cannot produce a result (no card, a missing file, ...)."""


def port_config(conf: dict):
    """The port's ModelConfig for a configuration file: the port's own
    configuration of that name, with the file's sizes."""
    from repro_torch.configs.registry import get_config
    base = get_config(conf["port_config"])
    m = conf["model"]
    dit = dataclasses.replace(base.dit, patch_size=m["patch_size"],
                              in_channels=m["in_channels"],
                              cond_dim=m["cond_dim"])
    return dataclasses.replace(
        base, num_layers=m["num_layers"], d_model=m["d_model"],
        num_heads=m["num_heads"], num_kv_heads=m["num_kv_heads"],
        head_dim=m["head_dim"], d_ff=m["d_ff"], dit=dit)


def to_request(s: traffic.RequestSpec, model_name: str):
    from repro_torch.core.trajectory import Request
    return Request(id=s.id, model=model_name, height=s.height,
                   width=s.width, frames=s.frames, steps=s.steps,
                   arrival=s.arrival, deadline=s.deadline, size_class=s.cls)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _data(art, key):
    """The first rank's copy of an artifact field."""
    for rank_data in art.data.values():
        if key in rank_data:
            return rank_data[key]
    raise KeyError(key)


def _tasks(graph, kind):
    return sorted((t for t in graph.tasks.values() if t.kind == kind),
                  key=lambda t: t.step_index)


@dataclasses.dataclass
class Served:
    """A cell's engine after set-up: weights loaded, warm-up served, the
    plane's clock ready to start again at 0."""
    cell: spec.Cell
    engine: object
    spans: StepSpans
    warm: list              # the warm-up's spans
    model_name: str
    sizes: dict
    specs: dict             # parameter specs by module
    build_s: float


def prepare(cell: spec.Cell, seed: int, dev: torch.device) -> Served:
    """Set-up: the kernel library, the engine, the seed's weights, the
    traffic mix's warm-up bursts."""
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: this benchmark runs on the card")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(f"{cell.name} needs {cell.chips} cards, "
                           f"{torch.cuda.device_count()} found")
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.policies import make_policy
    from repro_torch.serving.engine import ServingEngine

    conf, mix = cell.config, cell.mix
    model_name = conf["port_config"]
    sizes = {k: conf[k] for k in ("model", "text_encoder", "vae")}
    specs = param_specs(sizes)
    build_s = 0.0
    t = time.monotonic()
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.load()
        build_s = time.monotonic() - t if build.build_info["seconds"] else 0.0
        torch.cuda.reset_peak_memory_stats()
    phases = [("kernel library", time.monotonic() - t)]
    ranks = conf["ranks"]
    # a traffic mix may name the policy its deployment serves with
    policy = mix.get("policy", conf["policy"])
    t = time.monotonic()
    engine = ServingEngine(port_config(conf), make_policy(policy, ranks),
                           ranks, cost=CostModel.load(cell.cost_path),
                           seed=seed, device=dev)
    pipe = engine.pipeline
    phases.append(("engine", time.monotonic() - t))
    t = time.monotonic()
    weights.load({"dit": pipe.dit, "txt": pipe.text_encoder,
                  "vae": pipe.vae}, specs, seed, dev)
    phases.append(("weights", time.monotonic() - t))
    spans = StepSpans(pipe)
    t = time.monotonic()
    for burst in traffic.warmup(mix, conf["model"], model_name, cell.cost,
                                seed):
        engine.serve([to_request(s, model_name) for s in burst],
                     timeout=WARMUP_TIMEOUT_S)
    phases.append(("warm-up", time.monotonic() - t))
    print("set-up: " + ", ".join(f"{n} {s:.2f} s" for n, s in phases),
          file=sys.stderr)
    served = Served(cell, engine, spans, spans.spans(0.0), model_name,
                    sizes, specs, build_s)
    restart(served)
    return served


def restart(served: Served) -> None:
    """Start the plane's clock at 0 again for the next serve, with no
    events or spans of earlier serves."""
    served.engine.cp.now = 0.0
    served.engine.cp.events.clear()
    served.spans.clear()


def window_timeout(served: Served, specs_w: list, seconds: float) -> float:
    """How long the window's serve may run: an open loop to its last
    arrival plus ``drain_s``; a backlog to the window's close; a
    step-aligned window one step past the close it expects from the
    warm-up's encode and step."""
    mix = served.cell.mix
    if mix["kind"] == "open_loop":
        return max(s.arrival for s in specs_w) + mix["drain_s"]
    if mix["kind"] == "backlog":
        return seconds
    step = max(s.t1 - s.t0 for s in served.warm if s.kind == "denoise")
    enc = max(s.t1 - s.t0 for s in served.warm if s.kind == "encode")
    return enc + step + seconds + 2.0 * step


def serve_window(served: Served, specs_w: list, timeout: float,
                 tracer=None) -> bool:
    """Serve the window's requests; wait for the calls still running when
    the serve returned.  False if they did not finish."""
    mix, engine = served.cell.mix, served.engine
    reqs = [to_request(s, served.model_name) for s in specs_w]
    if mix["kind"] != "open_loop":
        # the window closes on requests still queued or running: the
        # engine's list of them is no failure here
        logging.getLogger("repro_torch.serving.engine").setLevel(
            logging.ERROR)
    if tracer is not None:
        tracer.__enter__()
    engine.serve(reqs, timeout=timeout)
    running = {t.id for t, _ in engine.cp.running.values()}
    drained = served.spans.wait_for(running, DRAIN_WAIT_S)
    if tracer is not None:
        tracer.__exit__(None, None, None)
    return drained


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        t_process: float, device: str = "cuda", log=print) -> dict:
    """Run ``workload`` and return its result line (a dict)."""
    cell = spec.load(root, workload)
    dev = torch.device(device)
    served = prepare(cell, seed, dev)
    specs_w = traffic.generate(cell.mix, cell.config["model"],
                               served.model_name, cell.cost, seed, seconds)
    tracer = devtrace.DeviceTrace() if trace and dev.type == "cuda" else None
    drained = serve_window(served, specs_w,
                           window_timeout(served, specs_w, seconds), tracer)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    rec = record(served, specs_w, seconds, t_process, tracer)
    programs = outputs(served, specs_w, rec, seed)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = cell.reader(m["name"]).read(rec)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    attempted, failed = _counts(rec, cell.mix["kind"])
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": _device(dev, cell.chips, memory_peak)}
    if tracer is not None:
        lo, hi = rec.measured
        result["device"]["busy_s"] = devtrace.length(
            devtrace.busy(rec.kernels, lo, hi))
        result["device"]["window_s"] = hi - lo
        result["breakdown"] = {
            "device_ops": devtrace.top_ops(rec.kernels, lo, hi),
            "idle_gaps": devtrace.idle_gaps(rec.kernels, rec.spans,
                                            rec.in_system(), lo, hi)}
    result["build_s"] = served.build_s

    # free the program, then run the reference on the card
    errors = list(served.engine.backend.errors)
    served.engine.shutdown()
    served.engine = served.spans = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_ref = time.monotonic()
    mode = cell.mix["check"]["mode"]
    params = weights.make(served.specs, seed, dev)
    numbers = check.compare(mode, params, served.sizes, programs, dev,
                            Arith())
    del params
    limits = cell.config["limits"][mode]
    result["correct"] = (check.verdict(numbers, limits) and drained
                         and not errors and failed == 0 and attempted > 0)
    result["checks"] = {n: {"value": numbers.get(n), "limit": lim}
                        for n, lim in limits.items()}
    result["checks"]["failed_requests"] = {"value": failed, "limit": 0}
    log(f"reference: {len(programs)} compared in "
        f"{time.monotonic() - t_ref:.1f} s", file=sys.stderr)
    for e in errors[:3]:
        log(e, file=sys.stderr)
    return result


def record(served: Served, specs_w: list, seconds: float, t_process: float,
           tracer=None) -> Record:
    """The window's record, on the serve's clock."""
    engine, mix = served.engine, served.cell.mix
    cp, t0 = engine.cp, engine.backend.t0
    requests = {s.id: RequestRecord(s.id, s.cls, s.tokens, s.steps,
                                    s.arrival, cp.requests[s.id].done_time)
                for s in specs_w}
    spans = served.spans.spans(t0)
    end = max((s.t1 for s in spans), default=0.0)
    if mix["kind"] == "closed":
        boundaries = sorted(
            t.complete_time for s in specs_w
            for t in _tasks(cp.graphs[s.id], "denoise") if t.state == "done")
        win = stats.step_window(boundaries, seconds)
        window = (win[0], win[1]) if win else (math.nan, math.nan)
        measured = window
    else:
        window, measured = (0.0, seconds), (0.0, end)
    rec = Record(cell=served.cell.name, config=served.cell.config, mix=mix,
                 seconds=seconds, setup_s=t0 + window[0] - t_process,
                 requests=requests, events=list(cp.events), spans=spans,
                 window=window, measured=measured)
    if tracer is not None:
        rec.kernels = [(n, a - t0, b - t0) for n, a, b in tracer.kernels]
    return rec


def outputs(served: Served, specs_w: list, rec: Record, seed: int) -> list:
    """What the timed path produced that the reference is compared with:
    a sample of the finished requests (``requests`` mode), or each
    request's encode, step 0, and the window's last step with others of
    the window's steps drawn from the seed, each with its input
    (``steps``)."""
    engine, mix = served.engine, served.cell.mix
    cp = engine.cp
    by_id = {s.id: s for s in specs_w}
    programs = []
    if mix["check"]["mode"] == "requests":
        # a backlog's window closes on requests still being served
        finished = [r for r, q in rec.requests.items() if q.done is not None
                    and (mix["kind"] != "backlog" or q.done <= rec.window[1])]
        packed = {r for e in rec.events if e.get("ev") == "packed_dispatch"
                  for r in e["reqs"]}
        for rid in check.sample(finished, {r: q.tokens for r, q in
                                           rec.requests.items()}, packed,
                                mix["check"]["sample"], seed):
            g = cp.graphs[rid]
            programs.append({
                "spec": by_id[rid],
                "embeds": _data(g.artifacts[_tasks(g, "encode")[0]
                                            .outputs[0]], "embeds"),
                "latent": _data(g.artifacts[_tasks(g, "decode")[0]
                                            .inputs[0]], "latent"),
                "pixels": engine.result_pixels(cp.requests[rid])})
    elif math.isfinite(rec.window[1]):
        lo, hi = rec.window
        for s in specs_w:
            g = cp.graphs[s.id]
            steps = [t for t in _tasks(g, "denoise") if t.state == "done"]
            in_window = {t.step_index: t for t in steps
                         if lo + 1e-9 < t.complete_time <= hi + 1e-9}
            picked = check.sample_steps(sorted(in_window),
                                        mix["check"]["window_steps"], seed)
            programs.append({
                "spec": s,
                "embeds": _data(g.artifacts[_tasks(g, "encode")[0]
                                            .outputs[0]], "embeds"),
                "step0": _data(g.artifacts[steps[0].outputs[0]], "latent"),
                "window": [
                    (k, _data(g.artifacts[in_window[k].inputs[1]], "latent"),
                     _data(g.artifacts[in_window[k].outputs[0]], "latent"))
                    for k in picked]})
    return programs


def _counts(rec: Record, kind: str) -> tuple[int, int]:
    """(attempted, failed): for an open loop every request due in the
    window, failed if it never finished; for a backlog the requests
    finished in the window or in flight at its close; for step-aligned
    windows the denoise steps inside the window."""
    reqs = rec.requests.values()
    if kind == "open_loop":
        return len(rec.requests), sum(r.done is None for r in reqs)
    if kind == "backlog":
        started = {m[0] for s in rec.spans for m in s.members
                   if s.kind == "denoise" and s.t0 <= rec.window[1]}
        return len(started), 0
    lo, hi = rec.window
    if not math.isfinite(hi):
        return 0, 0
    return len(rec.spans_in(lo, hi, "denoise")), 0


def _device(dev: torch.device, chips: int, memory_peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(memory_peak)}
