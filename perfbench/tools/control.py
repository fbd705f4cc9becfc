#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
program's place and computed in TF32 (every product's operands rounded
to TF32, accumulated in float32), the precision below the float32 the
configurations state.  It has to come out as not correct.

    python3 perfbench/tools/control.py --workload W --seeds A,B,C
        [--device cuda|cpu] [--root DIR]

For each seed: the cell's weights and window requests, the sample the
check would compare (``requests`` mode: the longest request and others
drawn from the seed; ``steps`` mode: step 0 from the request's start and
step 1 from the float32 reference's latent after step 0), computed by
the float32 reference and by the TF32 control.  Prints one JSON line a
seed with each number the run compares, the control's against the
reference's, beside the configuration's limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def readings(root: Path, workload: str, seed: int, device: str,
             seconds: float) -> dict:
    """The control's numbers for one seed of ``workload``."""
    import torch

    from perfbench import check, spec, traffic, weights
    from perfbench.reference import param_specs, pipeline
    from perfbench.reference.arith import Arith

    cell = spec.load(root, workload)
    conf, mix = cell.config, cell.mix
    dev = torch.device(device)
    sizes = {k: conf[k] for k in ("model", "text_encoder", "vae")}
    params = weights.make(param_specs(sizes), seed, dev)
    specs_w = traffic.generate(mix, conf["model"], conf["port_config"],
                               cell.cost, seed, seconds)
    fp32, tf32 = Arith(), Arith(tf32=True)
    worst: dict[str, float] = {}
    with torch.no_grad():
        if mix["check"]["mode"] == "requests":
            by_id = {s.id: s for s in specs_w}
            ids = check.sample(list(by_id), {s.id: s.tokens
                                             for s in specs_w}, set(),
                               mix["check"]["sample"], seed)
            for rid in ids:
                ref = check.reference_request(params, sizes, by_id[rid], dev,
                                              fp32)
                ctl = check.reference_request(params, sizes, by_id[rid], dev,
                                              tf32)
                for k, v in check.requests_numbers(ctl, ref).items():
                    worst[k] = max(worst.get(k, 0.0), v)
        else:
            s = specs_w[0]
            x0 = check.initial(sizes, s, dev)
            emb = pipeline.embeds(params, sizes, s.id, dev, fp32)
            x1 = pipeline.step(params, sizes, x0, emb, s.steps, 0, fp32)
            ref = check.reference_steps(params, sizes, s, [(1, x1)], dev,
                                        fp32)
            ctl = check.reference_steps(params, sizes, s, [(1, x1)], dev,
                                        tf32)
            worst = check.steps_numbers(
                dict(ctl, window=[(1, x1, ctl["window"][0])]), ref, x0)
    limits = conf["limits"][mix["check"]["mode"]]
    return {"workload": workload, "seed": seed,
            "mode": mix["check"]["mode"], "control": worst, "limits": limits,
            "fails": not check.verdict(worst, limits)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="window length the requests are drawn for "
                         "(default: BENCHMARK.json's run_seconds)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    root = Path(args.root)
    seconds = args.seconds or json.loads(
        (root / "BENCHMARK.json").read_text())["run_seconds"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        line = readings(root, args.workload, seed, args.device, seconds)
        line["seconds"] = time.monotonic() - t
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
