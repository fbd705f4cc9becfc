"""Table 1 analogue: dynamic-group setup costs of the port.

Twin of ``benchmarks/group_setup.py``.  Paper (NCCL, 8 GPUs): new_group
~0.5 ms; FIRST collective 217-778 ms cold init + ~0.5 GB/GPU; warm
collective fast; GFC registration ~60 µs.

    python -m repro_torch.benchmarks.group_setup [--device cpu] [--out PATH]

prints one ``name,value_us,note`` row per measurement (the JAX twin's
names) and writes the measurements as JSON to ``--out`` only.  On the
card (the default), for a world of 8 ranks as GFC's threads on the one
device:

  cold_compile   = capture the CUDA graph of a collective for a NEW key
                   (the analogue of NCCL's cold init and of XLA's compile)
  cache_hit      = 50 binds of same-size, different-member groups through
                   the compile-once-per-group-shape executable cache
  gfc_register   = GFC logical-descriptor registration (metadata only),
                   with p50/p99 from the telemetry plane's samples
  warm_collective= a bound collective's call (copy in, replay, copy out),
                   timed by CUDA events

for JAX's shard (1024,) fp32 (the rows without a prefix) and for
DIT_IMAGE's per-layer K/V shard at SP-4, (1, 1024, 24, 64), in fp32
(``kv_fp32``) and bf16 (``kv_bf16``): the payload the DiT path
all-gathers, at full width.  On the card it adds the mechanism behind
the paper's 778 ms: ``dist.new_group([0])`` and the first
``all_reduce`` on it under the ``nccl`` backend, at world size 1 (the
card's machine has one GPU).  ``--device cpu`` prepares the collectives
without graphs: its times are the host's, not a device's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.benchmarks.common import card
from repro_torch.core.executable_cache import ExecutableCache, resolve_device
from repro_torch.core.gfc import GroupFreeComm
from repro_torch.core.telemetry import Telemetry

WORLD = 8
SIZES = (2, 4, 8)
KV_SHARD = (1, 1024, 24, 64)       # DIT_IMAGE, 1024 px, SP-4: one layer
PAYLOADS = {"": ((1024,), torch.float32),
            "kv_fp32": (KV_SHARD, torch.float32),
            "kv_bf16": (KV_SHARD, torch.bfloat16)}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_us(fn, *args, iters: int = 20) -> float:
    """µs a call of ``fn(*args)`` after one warm-up: CUDA events around
    ``iters`` calls on the card, the host clock on the CPU."""
    device = args[0].device
    fn(*args)
    sync(device)
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters * 1e6


def cold_ms(op: str, size: int, shape, dtype, device) -> float:
    """One capture (CPU: preparation) of a new key, in a fresh cache."""
    cache = ExecutableCache(device)
    t0 = time.perf_counter()
    cache.get(op, size, shape, dtype)
    return (time.perf_counter() - t0) * 1e3


def hit_us(cache: ExecutableCache, comm: GroupFreeComm, op: str, size: int,
           shape, dtype, reps: int = 50) -> float:
    """The first group of ``size`` pays the capture; then ``reps``
    same-size groups of other members bind to it (the JAX twin's
    member choice)."""
    d1 = comm.register_group(tuple(range(size)))
    cache.bind(op, d1, shape, dtype)
    t0 = time.perf_counter()
    for i in range(reps):
        ranks = tuple((i + j) % WORLD for j in range(size))
        d2 = comm.register_group(tuple(sorted(set(ranks)))[:size]
                                 if len(set(ranks)) >= size else d1.ranks)
        cache.bind(op, d2, shape, dtype)
    return (time.perf_counter() - t0) / reps * 1e6


def nccl_world1_cold(device: torch.device) -> dict:
    """ms of ``dist.new_group([0])`` and of the first ``all_reduce`` on
    it (the communicator's cold init), under ``nccl`` at world size 1."""
    if dist.is_initialized():
        raise RuntimeError("nccl_world1_cold needs no process group set up")
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            x = torch.ones(1024, device=device)
            sync(device)
            t0 = time.perf_counter()
            group = dist.new_group([0])
            t1 = time.perf_counter()
            dist.all_reduce(x, group=group)
            sync(device)
            t2 = time.perf_counter()
            if not bool((x == 1).all()):
                raise AssertionError("nccl world-1 all_reduce changed x")
        finally:
            dist.destroy_process_group()
    return {"nccl_world1_new_group_ms": (t1 - t0) * 1e3,
            "nccl_world1_first_collective_ms": (t2 - t1) * 1e3}


def run(device=None) -> dict:
    device = resolve_device(device)
    torch.zeros(1, device=device)
    sync(device)
    out: dict = {"device": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                 "card": card() if device.type == "cuda" else None}
    comm = GroupFreeComm(WORLD)
    for tag, (shape, dtype) in PAYLOADS.items():
        p = f"{tag}_" if tag else ""
        # cold path: a new key of each size -> capture
        for size in SIZES:
            out[f"{p}cold_compile_size{size}_ms"] = cold_ms(
                "all_gather", size, shape, dtype, device)
        # executable cache: the first group pays the capture, same-size
        # different members are a metadata bind
        cache = ExecutableCache(device)
        for size in SIZES:
            out[f"{p}cache_hit_size{size}_us"] = hit_us(
                cache, comm, "all_gather", size, shape, dtype)
        # warm collective through a bound executable
        runner = cache.bind("all_gather", comm.register_group((0, 1, 2, 3)),
                            shape, dtype)
        x = torch.randn((4 * shape[0],) + shape[1:], device=device) \
            .to(dtype)
        out[f"{p}warm_collective_us"] = warm_us(runner, x)
        out[f"{p}compiles"] = cache.stats["compiles"]

    # GFC descriptor registration (the paper's ~60 µs number), each call
    # also sampled through the telemetry plane for the distribution
    tel = Telemetry()
    comm.telemetry = tel
    t0 = time.perf_counter()
    reps = 2000
    for i in range(reps):
        comm.register_group((i % WORLD, (i + 3) % WORLD))
    out["gfc_register_us"] = (time.perf_counter() - t0) / reps * 1e6
    comm.telemetry = None
    pct = tel.gfc_percentiles()
    out["gfc_register_p50_us"] = pct["p50_us"]
    out["gfc_register_p90_us"] = pct["p90_us"]
    out["gfc_register_p99_us"] = pct["p99_us"]
    out["gfc_register_hist"] = tel.gfc_histogram()
    if device.type == "cuda":
        out.update(nccl_world1_cold(device))
    return out


def rows(data: dict) -> list[tuple[str, float, str]]:
    out = []
    for tag in PAYLOADS:
        p, n = (f"{tag}_", f"{tag}.") if tag else ("", "")
        for size in SIZES:
            out.append((f"group_setup.{n}cold_compile_size{size}",
                        data[f"{p}cold_compile_size{size}_ms"] * 1e3,
                        "paper_first_coll_217-778ms"))
            out.append((f"group_setup.{n}cache_hit_size{size}",
                        data[f"{p}cache_hit_size{size}_us"],
                        "descriptor_bind_same_size"))
        out.append((f"group_setup.{n}warm_collective",
                    data[f"{p}warm_collective_us"], "steady_state"))
    out.append(("group_setup.gfc_register", data["gfc_register_us"],
                "paper_60us"))
    hist = data.get("gfc_register_hist", {})
    nonzero = ";".join(f"{k}={v}" for k, v in hist.items() if v)
    out.append(("group_setup.gfc_register_p50",
                data["gfc_register_p50_us"], "telemetry_histogram"))
    out.append(("group_setup.gfc_register_p99",
                data["gfc_register_p99_us"],
                nonzero or "telemetry_histogram"))
    if "nccl_world1_new_group_ms" in data:
        out.append(("group_setup.nccl_world1_new_group",
                    data["nccl_world1_new_group_ms"] * 1e3,
                    "paper_new_group_0.5ms;world_size=1"))
        out.append(("group_setup.nccl_world1_first_collective",
                    data["nccl_world1_first_collective_ms"] * 1e3,
                    "paper_first_coll_217-778ms;world_size=1"))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cpu to run without a card (default: cuda)")
    parser.add_argument("--out", help="write the measurements here as JSON")
    args = parser.parse_args(argv)
    data = run(args.device)
    print(f"# {data['device']}"
          + (f"; {data['card']}" if data["card"] else ""))
    for name, us, note in rows(data):
        print(f"{name},{us:.2f},{note}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(data, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
