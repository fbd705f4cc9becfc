"""Fig. 9 analogue: steady-state GFC collective latency vs baseline across
per-rank message sizes (BF16 all-to-all and all-gather).

Baseline = the executable-cache compiled collective (analogue of warm NCCL
with pre-initialized groups).  GFC-staged = the symmetric-buffer staged
path with chunked staging.  Paper's qualitative claim: GFC is competitive
at diffusion-serving sizes (>= 1 MB), slower for tiny messages.

Twin of ``benchmarks/gfc_collectives.py`` on the port: GFC's shared-
memory plane moves numpy buffers between rank threads on the host and
takes no device; its byte counts equal the JAX script's, its times are
the host's.

    python -m repro_torch.benchmarks.gfc_collectives [--out DIR]
"""
from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core.gfc import GroupFreeComm

RESULTS = common.RESULTS

SIZES = [4 << 10, 64 << 10, 1 << 20, 4 << 20]       # bytes per rank
WORLD = 4
REPS = 10


def _run_threaded(comm, desc, op, payload_per_rank):
    times = []

    def worker(r):
        x = payload_per_rank[r]
        t0 = time.perf_counter()
        for _ in range(REPS):
            if op == "all_gather":
                comm.all_gather(desc, r, x)
            else:
                comm.all_to_all(desc, r,
                                list(np.split(x, desc.size)))
        times.append((time.perf_counter() - t0) / REPS)

    ts = [threading.Thread(target=worker, args=(r,))
          for r in desc.ranks]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return max(times)


def run(out_dir=None) -> dict:
    out = {}
    comm = GroupFreeComm(WORLD)
    desc = comm.register_group(tuple(range(WORLD)))
    for size in SIZES:
        n = size // 2                                  # bf16 elements
        payloads = [np.zeros(n, np.float16) + r for r in range(WORLD)]
        for op in ("all_gather", "all_to_all"):
            dt = _run_threaded(comm, desc, op, payloads)
            out[f"gfc_{op}_{size}B_us"] = dt * 1e6
        # baseline: single-copy bandwidth bound (memcpy of the payload,
        # the shared-memory analogue of a warm in-fabric collective)
        x = payloads[0]
        t0 = time.perf_counter()
        for _ in range(REPS * 4):
            y = x.copy()
        out[f"memcpy_{size}B_us"] = (time.perf_counter() - t0) \
            / (REPS * 4) * 1e6
    (common.out_dir(out_dir, RESULTS) / "gfc_collectives.json").write_text(
        json.dumps(out, indent=1))
    return out


def rows(data: dict):
    out = []
    for size in SIZES:
        for op in ("all_gather", "all_to_all"):
            key = f"gfc_{op}_{size}B_us"
            base = data[f"memcpy_{size}B_us"]
            ratio = data[key] / max(base, 1e-9)
            out.append((f"gfc.{op}.{size >> 10}KiB", data[key],
                        f"vs_memcpy_x{ratio:.1f}"))
    return out


if __name__ == "__main__":
    sys.exit(common.main(sys.modules[__name__]))
