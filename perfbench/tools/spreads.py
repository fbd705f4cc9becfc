#!/usr/bin/env python3
"""Spreads of a cell's end-to-end metrics over sets of runs, and the
bound they suggest.

    python3 perfbench/tools/spreads.py SET_A_FILES... -- SET_B_FILES...

Each file holds a run's standard output (the result is its last line).
For each metric: each set's median and spread (the distance between the
first and third quartiles over the median, ``statistics.quantiles(n=4)``),
the spread of each set without its run farthest from the median, the
widest spread, and five times it (the bound: never under 1%, never over
25%).
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench.stats import spread  # noqa: E402


def _values(files: list[str]) -> dict[str, list[float]]:
    out: dict[str, list[float]] = {}
    for f in files:
        line = Path(f).read_text().strip().splitlines()[-1]
        for name, m in json.loads(line)["metrics"].items():
            out.setdefault(name, []).append(m["value"])
    return out


def _trimmed(values: list[float]) -> list[float]:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    cut = args.index("--") if "--" in args else len(args)
    sets = [_values(args[:cut])]
    if args[cut + 1:]:
        sets.append(_values(args[cut + 1:]))
    for name in sets[0]:
        row = {"metric": name}
        widest = 0.0
        for i, s in enumerate(sets):
            v = s.get(name, [])
            if len(v) < 3:
                continue
            row[f"median_{i}"] = statistics.median(v)
            row[f"spread_{i}"] = spread(v)
            row[f"spread_trimmed_{i}"] = spread(_trimmed(v))
            widest = max(widest, row[f"spread_{i}"])
        row["widest"] = widest
        row["bound"] = min(0.25, max(0.01, 5 * widest))
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
