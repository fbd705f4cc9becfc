"""Benchmark orchestrator — one function per paper table/figure.

Runs the FULL perf trajectory by default — the microbenches (group
setup, GFC collectives, migration, roofline), the end-to-end policy
suite (policies_e2e, including the step-packing, multi-host, and
feature-cache workloads), and the cross-backend fidelity suite
(sim_fidelity).  ``--suite`` substring-filters the listing for a quick
single-suite run, e.g. ``--suite fidelity`` or ``--suite policies``.

Prints ``name,us_per_call,derived`` CSV per the harness contract, and
appends every suite's headline rows to the consolidated perf-trajectory
file ``trajectory.json`` of the output directory — one entry per
orchestrator invocation, keyed by UTC timestamp, so the bench history
accumulates across runs.

Twin of ``benchmarks/run.py`` on the port, over the port's twins: the
device legs run on the card unless ``--device cpu``; every suite writes
into ``--out`` (default ``build/bench/``).  Exits 1 when any suite
raised:

    python -m repro_torch.benchmarks.run [--suite S] [--device cpu]
        [--out DIR]
"""
from __future__ import annotations

import json
import sys
import time
import traceback
from pathlib import Path

from repro_torch.benchmarks import common

RESULTS = common.RESULTS


def _append_trajectory(entry: dict, results: Path) -> None:
    """Best-effort append to the consolidated history (a corrupt or
    missing file starts a fresh history, never fails the bench run)."""
    path = results / "trajectory.json"
    try:
        history = json.loads(path.read_text())
        if not isinstance(history, list):
            history = []
    except (OSError, ValueError):
        history = []
    history.append(entry)
    path.write_text(json.dumps(history, indent=1, default=str))


def main(argv=None) -> int:
    from repro_torch.benchmarks import (arrival_scaling, gfc_collectives,
                                        group_setup, migration_overhead,
                                        overhead_fcfs_sp4, policies_e2e,
                                        roofline, sim_fidelity,
                                        stage_scaling, telemetry_scale,
                                        telemetry_suite)
    suites = [
        ("group_setup(Table1)", group_setup),
        ("policies_e2e(Fig6)", policies_e2e),
        ("gfc_collectives(Fig9)", gfc_collectives),
        ("arrival_scaling(Fig10)", arrival_scaling),
        ("sim_fidelity(Fig11)", sim_fidelity),
        ("stage_scaling(Fig3)", stage_scaling),
        ("migration_overhead(S5.3)", migration_overhead),
        ("overhead_fcfs_sp4(Fig8)", overhead_fcfs_sp4),
        ("roofline_kernels(deliverable_g)", roofline),
        ("telemetry(S15)", telemetry_suite),
        ("telemetry_scale(S16)", telemetry_scale),
    ]
    ap = common.parser(sys.modules[__name__])
    ap.add_argument("--suite", default=None,
                    help="run only suites whose label contains this "
                         "substring (default: all)")
    args = ap.parse_args(argv)
    if args.suite:
        suites = [(label, mod) for label, mod in suites
                  if args.suite.lower() in label.lower()]
        if not suites:
            print(f"no suite matches {args.suite!r}", file=sys.stderr)
            return 2
    results = common.out_dir(args.out, RESULTS)
    print("name,us_per_call,derived")
    failures = 0
    entry = {"utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
             "suites": {}}
    for label, mod in suites:
        try:
            data = common.run_suite(mod, args.device, results)
            suite_rows = list(mod.rows(data))
            common.print_rows(suite_rows)
            entry["suites"][label] = [
                {"name": name, "us_per_call": us, "derived": derived}
                for name, us, derived in suite_rows]
        except Exception as e:   # noqa: BLE001
            failures += 1
            print(f"{label},nan,ERROR:{type(e).__name__}:{e}")
            traceback.print_exc(file=sys.stderr)
            entry["suites"][label] = [
                {"name": label, "us_per_call": None,
                 "derived": f"ERROR:{type(e).__name__}:{e}"}]
    _append_trajectory(entry, results)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
