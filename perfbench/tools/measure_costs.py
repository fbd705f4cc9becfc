#!/usr/bin/env python3
"""Measure a configuration's frozen cost table on the card, once.

    python3 perfbench/tools/measure_costs.py --config wan2.1-t2v-1.3b [--out DIR]

Each stage of the port's pipeline (text encode, one denoise forward at
every pack size the configuration's ``cost_cells`` list, VAE decode) is
timed as the mean of warm calls between ``torch.cuda.synchronize``
calls, one call first, on the configuration's weights for seed 0: the
method of the port's ``benchmarks/sim_fidelity.py`` (``_timeit``,
``_profile_costs``).  The table, in the port's ``CostModel.save``
format, is written beside the configuration file
(``<config>.cost.json``) and, with ``--out``, to that directory.  The policies price with it
and the deadlines are computed from it, so both sides of a comparison
get the same limits.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _timeit(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--out", help="a directory for a second copy of the table")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness, traffic, weights
    from perfbench.reference import param_specs
    from repro_torch.diffusion.pipeline import TorchDiTPipeline
    from repro_torch.models import dit, text_encoder, vae

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    file = ROOT / {c["name"]: c for c in bench["configs"]}[args.config]["file"]
    conf = json.loads(file.read_text())
    cfg = harness.port_config(conf)
    name = conf["port_config"]
    dev = torch.device("cuda")
    sizes = {k: conf[k] for k in ("model", "text_encoder", "vae")}
    pipe = TorchDiTPipeline(cfg, seed=0, device=dev)
    weights.load({"dit": pipe.dit, "txt": pipe.text_encoder,
                  "vae": pipe.vae}, param_specs(sizes), 0, dev)
    m = conf["model"]
    pd = m["patch_size"] ** 2 * m["in_channels"]
    table, pack_table, rows = {}, {}, []
    with torch.inference_mode():
        for cell in conf["cost_cells"]:
            h, w, f = cell["height"], cell["width"], cell["frames"]
            n = traffic.token_count(m, h, w, f)
            toks = torch.zeros((1, 77), dtype=torch.int64, device=dev)
            enc = _timeit(lambda: text_encoder.encode(
                pipe.text_encoder, toks, pipe.txt_cfg, dtype=torch.float32),
                cell.get("reps", 3))
            f_lat = max(1, (f + 3) // 4) if f > 1 else 1
            lat = torch.zeros((1, f_lat, h // 8, w // 8, m["in_channels"]),
                              device=dev)
            dec = _timeit(lambda: vae.decode(pipe.vae, lat, cfg),
                          cell.get("reps", 3))
            table[traffic.cost_key(name, "encode", n)] = enc
            table[traffic.cost_key(name, "decode", n)] = dec
            row = {"tokens": n, "encode": enc, "decode": dec}
            for b in [1, *cell.get("packs", [])]:
                x = torch.zeros((b, n, pd), device=dev)
                txt = torch.zeros((b, 77, m["cond_dim"]), device=dev)
                t = torch.full((b,), 500.0, device=dev)
                dt = _timeit(lambda: dit.forward_sp_tokens(
                    pipe.dit, x, t, txt, cfg, pos_offset=0, n_total=n,
                    kv_gather=lambda k, v, layer: (k, v)),
                    cell.get("reps", 3))
                if b == 1:
                    table[traffic.cost_key(name, "denoise", n)] = dt
                else:
                    pack_table[traffic.cost_key(name, "denoise", n, 1,
                                                b)] = dt
                row[f"denoise_b{b}"] = dt
                del x, txt
            rows.append(row)
            print(json.dumps({"config": args.config, **row}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"table": table, "calibration": {}, "pack_table": pack_table,
           "pack_calibration": {},
           "measured_on": f"{smi}; torch {torch.__version__}",
           "method": "mean of warm calls between synchronisations, "
                     "seed-0 weights, perfbench/tools/measure_costs.py"}
    text = json.dumps(out, indent=1, sort_keys=True) + "\n"
    file.with_name(file.stem + ".cost.json").write_text(text)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / f"{args.config}.cost.json").write_text(text)
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
