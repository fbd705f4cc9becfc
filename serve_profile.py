#!/usr/bin/env python3
"""Where the serving path's time goes on one NVIDIA GPU.

    python3 serve_profile.py          # DiT-image serving
    python3 serve_profile.py --video  # DiT-video serving (class S, SP-4)
    python3 serve_profile.py --lm     # mamba2-1.3b prefill and decode
    python3 serve_profile.py --hybrid # zamba2-7b prefill and decode
    python3 serve_profile.py --train  # a DIT_IMAGE and a yi-6b train step

Serves the requests of chip_smoke.py's serve phase (DIT_IMAGE at full
width, SP-4 on four rank threads, cache_interval=2, steps=4: two 512 px
and one 1024 px request) twice, each time through chip_smoke's own serve
helper on a fresh engine with the same weights.  The first pass warms
up (kernel build, cuBLAS handles, allocator); the second runs under
``torch.profiler`` with CUDA activity only.  Prints the wall time, the
card's busy time (the sum of its kernel and copy times: every rank shares
one stream, so they do not overlap) and idle share, and the busy time by
category: the port's kernels, matrix products, host<->device copies and
the rest, with the largest kernels of each, and the bytes each kind of
copy moved (from the exported trace).

With ``--video`` it profiles leg (a) of chip_smoke.py's video phase:
DIT_VIDEO at full width and depth (7.39 B parameters), one request of
480x832, 49 frames (20,280 tokens), 2 steps, uncached, SP-4; the warm-up
pass serves the same request with one step.

With ``--lm`` it profiles chip_smoke.py's lm phase instead: mamba2-1.3b
at full width (seeded, livened weights), bf16, batch 4: one prefill of
2048 tokens and, separately, 8 greedy decode steps, each after a warm-up
run of the same work.  ``--hybrid`` does the same for the hybrid phase's
zamba2-7b (81 Mamba2 layers and 13 shared-attention applications).

With ``--train`` it profiles one step of each of chip_smoke.py's train
phase models (DIT_IMAGE at full width and depth on its one batch, bf16;
yi-6b at full width, 4 layers, 2 x 2048 tokens), after two warm-up
steps; the port's backward kernels and the optimizer's ``_foreach``
kernels are categories of their own.

Every run also prints the port's kernels (``csrc/``) one by one: device
seconds and launches by kernel name, its template arguments summed.
``--src DIR`` imports ``repro_torch`` from another checkout's ``src``
(read by ``chip_smoke`` when it is imported), so this script profiles
that tree's kernels, for parent-against-change runs in one call.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import re
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke
from repro_torch.configs.dit_models import DIT_IMAGE, DIT_VIDEO
from repro_torch.kernels import build
from repro_torch.models import dit, get_model, ssm
from repro_torch.serving import serve_loop
from repro_torch.training import optimizer, train_loop
from repro_torch.training.data import TokenPipeline


def category(name: str) -> str:
    low = name.lower()
    if "gfdit" in low:
        return ("port backward kernels (csrc/)" if "bwd" in low
                else "port kernels (csrc/)")
    if "multi_tensor_apply" in low:
        return "optimizer (_foreach kernels)"
    if "memcpy" in low or "memset" in low:
        return "host<->device copies"
    if any(k in low for k in ("gemm", "gemv", "cutlass", "sm90_xmma",
                              "nvjet")):
        return "matrix products (cuBLAS)"
    return "other (elementwise, reductions, ...)"


def report(prof, wall: float) -> None:
    """Device busy time and idle share over ``wall``, by category."""
    by_cat = collections.defaultdict(float)
    top = collections.defaultdict(list)
    for avg in prof.key_averages():
        us = avg.self_device_time_total
        if us <= 0:
            continue
        cat = category(avg.key)
        by_cat[cat] += us
        top[cat].append((us, avg.count, avg.key))
    busy = sum(by_cat.values()) / 1e6
    print(f"device busy {busy:.4f} s of {wall:.4f} s wall: idle share "
          f"{1 - busy / wall:.3f}")
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat}: {us / 1e6:.4f} s ({us / 1e6 / wall:.3f} of wall)")
        for k_us, count, name in sorted(top[cat], reverse=True)[:5]:
            print(f"      {k_us / 1e6:.4f} s  {count:6d} x  {name[:90]}")
    port = collections.defaultdict(lambda: [0.0, 0])
    for cat in ("port kernels (csrc/)", "port backward kernels (csrc/)"):
        for us, count, name in top[cat]:
            m = re.search(r"gfdit::(\w+)", name)
            k = port[m[1] if m else name]
            k[0] += us
            k[1] += count
    if port:
        print("  port kernels by name: " + ", ".join(
            f"{name} {us / 1e6:.4f} s ({count} x)" for name, (us, count)
            in sorted(port.items(), key=lambda kv: -kv[1][0])))


def copy_bytes(prof) -> None:
    """Bytes moved by each kind of copy, summed from the exported trace
    (each memcpy event carries its size), with the rate over its device
    time."""
    with tempfile.TemporaryDirectory(prefix="gfdit-prof-") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    moved = collections.defaultdict(lambda: [0, 0.0, 0])
    for e in events:
        if e.get("cat") == "gpu_memcpy":
            m = moved[e["name"]]
            m[0] += int(e.get("args", {}).get("bytes", 0))
            m[1] += float(e.get("dur", 0.0))
            m[2] += 1
    for name, (nbytes, us, count) in sorted(moved.items()):
        print(f"  {name}: {count} copies, {nbytes / 1e9:.3f} GB in "
              f"{us / 1e6:.4f} s ({nbytes / max(us, 1e-9) / 1e3:.2f} GB/s)")


def serve_dit(cfg, requests, cache_interval, warmup=None) -> None:
    """Serve ``requests()`` on a fresh SP-4 engine twice, the first
    (``warmup()``'s requests if given) to warm up, the second under the
    profiler; print the walls and the device split."""
    prof = profile(activities=[ProfilerActivity.CUDA])
    for run in ("warm-up", "profiled"):
        reqs = (warmup or requests)() if run == "warm-up" else requests()
        res = smoke._serve(
            cfg, smoke.FixedSP(4), reqs, cache_interval=cache_interval,
            during=(lambda: prof) if run == "profiled"
            else contextlib.nullcontext)
        del res["engine"]
        wall = res["wall"]
        lat = {rid: round(t, 3) for rid, t in res["latency"].items()}
        print(f"{run}: {len(lat)} of {len(reqs)} done, wall {wall:.3f} s, "
              f"latency {lat}", flush=True)
    report(prof, wall)
    copy_bytes(prof)


def profile_lm(cfg, decode_steps: int = 8) -> None:
    family = get_model(cfg)
    model = family.init(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    ssm.init_published_a_dt(model)
    prompt = torch.randint(0, cfg.vocab_size,
                           (smoke.LM_BATCH, smoke.LM_PROMPT),
                           generator=torch.Generator().manual_seed(1)).cuda()
    prefill = serve_loop.make_prefill_step(cfg)
    step = serve_loop.make_serve_step(cfg)

    def run_prefill():
        return prefill(model, prompt, family.init_cache(
            cfg, smoke.LM_BATCH, smoke.LM_PROMPT + decode_steps))

    def run_decode(cache, tok):
        for i in range(decode_steps):
            pos = torch.full((smoke.LM_BATCH,), smoke.LM_PROMPT + i,
                             device="cuda")
            lg, cache = step(model, tok, cache, pos)
            tok = lg[:, -1].argmax(-1, keepdim=True)
        return cache, tok

    for label in ("prefill", f"{decode_steps} decode steps"):
        for run in ("warm-up", "profiled"):
            lg, cache = run_prefill()          # the cache decode starts from
            tok = lg[:, -1].argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CUDA])
            with prof if run == "profiled" else contextlib.nullcontext():
                t0 = time.perf_counter()
                if label == "prefill":
                    run_prefill()
                else:
                    run_decode(cache, tok)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            print(f"{cfg.name} {label} ({run}): wall {wall:.4f} s",
                  flush=True)
        report(prof, wall)


def profile_train(warm_steps: int = 2) -> None:
    """One profiled train step of DIT_IMAGE and of yi-6b (4 layers)."""
    dcfg = DIT_IMAGE
    model = dit.init(dcfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    dit.liven_adaln(model, dcfg.d_model)
    batch = train_loop.synth_batch(
        dcfg, smoke.DIT_TRAIN_BATCH, 0, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1))
    runs = [(dcfg, model, lambda: batch, smoke.DIT_TRAIN_LR)]
    pipe = TokenPipeline(smoke.YI_TRAIN, smoke.YI_TRAIN_BATCH,
                         smoke.YI_TRAIN_SEQ, seed=0)

    def yi_batch():
        return {k: torch.from_numpy(v).cuda() for k, v in next(pipe).items()}
    runs.append((smoke.YI_TRAIN, None, yi_batch, smoke.TRAIN_LR))
    try:
        for cfg, model, next_batch, lr in runs:
            if model is None:
                model = get_model(cfg).init(cfg, generator=torch.Generator(
                    device="cuda").manual_seed(0))
            opt = optimizer.adamw_init(dict(model.named_parameters()))
            step = train_loop.make_train_step(cfg, remat="none", lr=lr)
            for i in range(warm_steps + 1):
                b = next_batch()
                prof = profile(activities=[ProfilerActivity.CUDA])
                torch.cuda.synchronize()
                with prof if i == warm_steps else contextlib.nullcontext():
                    t0 = time.perf_counter()
                    model, opt, m = step(model, opt, b)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                print(f"{cfg.name} train step {i} ("
                      f"{'profiled' if i == warm_steps else 'warm-up'}): "
                      f"wall {wall:.4f} s, loss {float(m['loss']):.5f}",
                      flush=True)
            report(prof, wall)
            del model, opt, step
            torch.cuda.empty_cache()
    finally:
        pipe.close()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lm", action="store_true",
                        help="profile the mamba2-1.3b prefill and decode")
    parser.add_argument("--hybrid", action="store_true",
                        help="profile the zamba2-7b prefill and decode")
    parser.add_argument("--train", action="store_true",
                        help="profile a DIT_IMAGE and a yi-6b train step")
    parser.add_argument("--video", action="store_true",
                        help="profile DIT_VIDEO serving one class-S "
                        "request at SP-4")
    parser.add_argument("--src", help="import repro_torch from this src "
                        "directory (default: the one beside this script)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("serve_profile: needs a CUDA device", file=sys.stderr)
        return 2
    smoke.phase_device()
    build.load()
    if args.lm or args.hybrid:
        profile_lm(smoke.MAMBA if args.lm else smoke.ZAMBA)
    elif args.train:
        profile_train()
    elif args.video:
        serve_dit(DIT_VIDEO,
                  lambda: [smoke.video_request("S", smoke.VIDEO_S)], None,
                  warmup=lambda: [smoke.video_request("S", smoke.VIDEO_S,
                                                      steps=1)])
    else:
        serve_dit(DIT_IMAGE, smoke.serve_requests, 2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
