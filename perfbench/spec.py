"""Everything a cell is made of, found by name from ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix:

* the configuration's ``file`` (given in ``configs``), with its frozen
  cost table beside it (``<file stem>.cost.json``);
* the traffic mix ``perfbench/traffic/<traffic>.json``;
* every metric (end-to-end and per-layer) is read by
  ``perfbench/metrics/<metric name>.py``, a module with a ``read(record)``
  function that returns a number or None.

``root`` is the checkout's root, so a cell made of new files alone loads
the same way as the committed ones.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict            # the configuration file
    cost: dict              # its frozen cost table
    cost_path: Path
    mix: dict               # the traffic mix
    end_to_end: list        # BENCHMARK.json metric entries of this cell
    per_layer: list
    root: Path

    def reader(self, metric: str) -> ModuleType:
        path = self.root / "perfbench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"perfbench_metric_{metric.replace('.', '_')}", path)
        if spec is None or not path.exists():
            raise FileNotFoundError(f"no reader for metric {metric}: {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    file = root / conf["file"]
    cost_path = file.with_name(file.stem + ".cost.json")
    return Cell(
        name=workload, chips=w["chips"], config_name=w["config"],
        traffic_name=w["traffic"],
        config=json.loads(file.read_text()),
        cost=json.loads(cost_path.read_text()), cost_path=cost_path,
        mix=json.loads((root / "perfbench" / "traffic"
                        / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        root=root)
