#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout: ``BENCHMARK.json`` there names the cell's
configuration and traffic mix, the port is imported from ``src/``, and
every build and kernel cache goes under ``build/`` in the checkout.
Needs a CUDA card (as many as the cell asks for); exits non-zero and
prints no result without one, or if the process has loaded the JAX
package, ``jax``, ``jaxlib`` or ``flax`` by the time the result is due.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last the numbers compared, each with its limit under
``checks``); the same numbers close standard error.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

T_START = time.monotonic()
ROOT = Path(__file__).resolve().parents[1]


def _since_process_start() -> float:
    """Seconds since this process started (from /proc; 0 without it)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def _caches() -> None:
    """Fixed cache directories inside the checkout, for whatever the
    program or its libraries build or compile."""
    cache = ROOT / "build" / "perfbench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_process = T_START - _since_process_start()
    print(f"set-up: interpreter {T_START - t_process:.2f} s", file=sys.stderr)
    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import json

    from perfbench import harness
    print(f"set-up: imports {time.monotonic() - T_START:.2f} s",
          file=sys.stderr)
    try:
        result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), t_process)
    except harness.RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the process holds {', '.join(found)}: the "
              "benchmark runs the port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
