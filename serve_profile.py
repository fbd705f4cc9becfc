#!/usr/bin/env python3
"""Where the serving path's time goes on one NVIDIA GPU.

    python3 serve_profile.py

Serves the requests of chip_smoke.py's serve phase (DIT_IMAGE at full
width, SP-4 on four rank threads, cache_interval=2, steps=4: two 512 px
and one 1024 px request) twice, each time through chip_smoke's own serve
helper on a fresh engine with the same weights.  The first pass warms
up (kernel build, cuBLAS handles, allocator); the second runs under
``torch.profiler`` with CUDA activity only.  Prints the wall time, the
card's busy time (the sum of its kernel and copy times: every rank shares
one stream, so they do not overlap) and idle share, and the busy time by
category: the port's kernels, matrix products, host<->device copies and
the rest, with the largest kernels of each.
"""
from __future__ import annotations

import collections
import contextlib
import sys

import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke
from repro_torch.configs.dit_models import DIT_IMAGE
from repro_torch.kernels import build


def category(name: str) -> str:
    low = name.lower()
    if "gfdit" in low:
        return "port kernels (adaLN, attention, splice)"
    if "memcpy" in low or "memset" in low:
        return "host<->device copies"
    if "gemm" in low or "cutlass" in low or "sm90_xmma" in low:
        return "matrix products (cuBLAS)"
    return "other (elementwise, reductions, ...)"


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_profile: needs a CUDA device", file=sys.stderr)
        return 2
    smoke.phase_device()
    build.load()
    prof = profile(activities=[ProfilerActivity.CUDA])
    for run in ("warm-up", "profiled"):
        reqs = smoke.serve_requests()
        res = smoke._serve(
            DIT_IMAGE, smoke.FixedSP(4), reqs, cache_interval=2,
            during=(lambda: prof) if run == "profiled"
            else contextlib.nullcontext)
        del res["engine"]
        wall = res["wall"]
        lat = {rid: round(t, 3) for rid, t in res["latency"].items()}
        print(f"{run}: {len(lat)} of {len(reqs)} done, wall {wall:.3f} s, "
              f"latency {lat}", flush=True)

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
    print(f"device busy {busy:.3f} s of {wall:.3f} s wall: idle share "
          f"{1 - busy / wall:.3f}")
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat}: {us / 1e6:.3f} s ({us / 1e6 / wall:.3f} of wall)")
        for k_us, count, name in sorted(top[cat], reverse=True)[:3]:
            print(f"      {k_us / 1e6:.3f} s  {count:6d} x  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
