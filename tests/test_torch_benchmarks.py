"""The port's twins of ``benchmarks/`` (``repro_torch.benchmarks``)
against the JAX scripts, on the CPU.

Each JAX script is loaded by path with its ``RESULTS`` pointed at a
temporary directory, so no test writes into ``benchmarks/results/``; the
twins write into ``out_dir``.  Both sides are shrunk alike (one load,
fewer requests, fewer steps, shorter traces through the workloads'
trace functions), and the results must be equal on every field no clock
enters.  The clock fields left
out: ``*_sched_us_per_dispatch`` (overhead_fcfs_sp4), ``exec_us_*``
(migration_overhead), every field of gfc_collectives (its numbers are
host times; the keys are compared), ``serve_wall_s`` (telemetry_scale),
and the ``*_hbm_s`` times of the kernel-traffic table, which divide the
same bytes by another chip's HBM rate.
"""
import importlib
import importlib.util
import itertools
import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_threads import few_threads  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
#: telemetry_scale's open-loop stream shrunk from 20000 requests: its
#: three gates hold (10.9x fewer events retained at p=0.01)
SCALE_REQUESTS = 500
#: trace functions shortened in both packages, by this factor of duration
TRACE_FNS = ("short_trace", "foreground_burst_trace",
                  "mixed_burst_trace", "small_image_burst_trace",
                  "multi_host_trace", "cache_trace", "chaos_trace",
                  "hybrid_trace")
SHORTEN = 0.1


@pytest.fixture(autouse=True)
def same_request_ids(monkeypatch):
    """Both packages number requests from 0 (``trajectory.fresh_id``'s
    counter), whatever ran in this process before: the ids are inputs
    (telemetry_scale's sampling hashes them, and ties break on them)."""
    for pkg in ("repro", "repro_torch"):
        monkeypatch.setattr(
            importlib.import_module(f"{pkg}.core.trajectory"), "_ids",
            itertools.count())


def _jax(name, monkeypatch, tmp_path):
    """The JAX script ``benchmarks/<name>.py``, its results redirected."""
    spec = importlib.util.spec_from_file_location(
        f"jax_bench_{name}", REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "RESULTS", tmp_path / "jax")
    return module


def _port(name, monkeypatch, tmp_path):
    module = importlib.import_module(f"repro_torch.benchmarks.{name}")
    monkeypatch.setattr(module, "RESULTS", tmp_path / "port")
    return module


def _same(a, b):
    """Equal as JSON (NaN equal to NaN, tuples to lists)."""
    return json.dumps(a, sort_keys=True, default=str) == \
        json.dumps(b, sort_keys=True, default=str)


def _drop(d: dict, clock) -> dict:
    return {k: v for k, v in d.items() if not clock(k)}


@pytest.fixture
def short_traces(monkeypatch):
    """Every trace function of both packages' ``diffusion.workloads``
    serves SHORTEN of its duration (the scripts import them inside their
    slice functions, or by name at the top, patched too below)."""
    for pkg in ("repro", "repro_torch"):
        workloads = importlib.import_module(f"{pkg}.diffusion.workloads")
        for name in TRACE_FNS:
            build = getattr(workloads, name)

            def shorter(*args, _build=build, **kwargs):
                kwargs["duration"] = kwargs["duration"] * SHORTEN
                return _build(*args, **kwargs)
            monkeypatch.setattr(workloads, name, shorter)
    return monkeypatch


#: policies_e2e's denoise steps a request (25), cut alike in both
E2E_STEPS = 6


def _pair(name, monkeypatch, tmp_path):
    jax_mod, port = (_jax(name, monkeypatch, tmp_path),
                     _port(name, monkeypatch, tmp_path))
    if name == "policies_e2e":
        for module in (jax_mod, port):
            monkeypatch.setattr(module, "STEPS", E2E_STEPS)
    workloads = [importlib.import_module(f"{pkg}.diffusion.workloads")
                 for pkg in ("repro", "repro_torch")]
    for module, wl in zip((jax_mod, port), workloads):
        for fn in TRACE_FNS:       # imported by name at the top
            if hasattr(module, fn):
                monkeypatch.setattr(module, fn, getattr(wl, fn))
    return jax_mod, port


CLOCK_FIELDS = {
    "arrival_scaling": lambda k: False,
    "overhead_fcfs_sp4": lambda k: k.endswith("_sched_us_per_dispatch"),
    "stage_scaling": lambda k: False,
    "migration_overhead": lambda k: k.startswith("exec_us_"),
}


@pytest.mark.parametrize("name", sorted(CLOCK_FIELDS))
def test_simulator_twin_equals_jax(name, short_traces, tmp_path):
    jax_mod, port = _pair(name, short_traces, tmp_path)
    if name == "arrival_scaling":
        for module in (jax_mod, port):
            short_traces.setattr(module, "LOADS", [1.3])
    want, got = jax_mod.run(), port.run(out_dir=tmp_path / "out")
    clock = CLOCK_FIELDS[name]
    assert got.keys() == want.keys()
    assert _same(_drop(got, clock), _drop(want, clock))
    assert [r[0] for r in port.rows(got)] == [r[0] for r in
                                              jax_mod.rows(want)]
    assert (tmp_path / "out" / f"{name}.json").exists()
    assert not (tmp_path / "port").exists()


def test_gfc_collectives_twin_has_jax_keys(monkeypatch, tmp_path):
    jax_mod, port = _pair("gfc_collectives", monkeypatch, tmp_path)
    for module in (jax_mod, port):
        monkeypatch.setattr(module, "SIZES", [4 << 10, 64 << 10])
    want, got = jax_mod.run(), port.run(out_dir=tmp_path)
    assert got.keys() == want.keys()
    assert all(v > 0 for v in got.values())
    assert [r[0] for r in port.rows(got)] == [r[0] for r in
                                              jax_mod.rows(want)]


def test_telemetry_scale_twin_equals_jax(monkeypatch, tmp_path):
    jax_mod, port = _pair("telemetry_scale", monkeypatch, tmp_path)
    for module in (jax_mod, port):
        monkeypatch.setattr(module, "N_REQUESTS", SCALE_REQUESTS)
    want, got = jax_mod.run(), port.run(out_dir=tmp_path / "out")
    for d in (want, got):
        for leg in ("full", "sampled"):
            assert d[leg].pop("serve_wall_s") > 0
    assert _same(got, want)
    assert got["gates"]["trace_match"]
    assert got["gates"]["reduction_x"] >= port.MEM_REDUCTION_GATE
    assert (tmp_path / "out" / "telemetry_stream.jsonl").read_text() == \
        (tmp_path / "jax" / "telemetry_stream.jsonl").read_text()


def _no_probe(monkeypatch):
    """The cache slice's wall-clock pixel probe left out on both sides
    (held to JAX's in its own test below)."""
    for pkg in ("repro", "repro_torch"):
        demo = importlib.import_module(f"{pkg}.serving.cache_demo")
        monkeypatch.setattr(demo, "pixel_error_report",
                            lambda *a, **k: {"probe": "skipped"})


@pytest.mark.parametrize("slice_fn", [
    "_run_small_burst", "_run_multi_host", "_run_cache", "_run_chaos",
    "_run_hybrid", "_run_mixed"])
def test_policies_e2e_slice_equals_jax(slice_fn, short_traces, tmp_path):
    jax_mod, port = _pair("policies_e2e", short_traces, tmp_path)
    _no_probe(short_traces)
    want, got = {}, {}
    getattr(jax_mod, slice_fn)(want)
    getattr(port, slice_fn)(got)
    assert want and _same(got, want)


def test_policies_e2e_run_and_rows_equal_jax(short_traces, tmp_path):
    """The whole run (every slice and the model x workload x policy grid)
    and its rows, against the JAX script's."""
    jax_mod, port = _pair("policies_e2e", short_traces, tmp_path)
    _no_probe(short_traces)
    want = jax_mod.run()
    got = port.run(device="cpu", out_dir=tmp_path / "out")
    assert _same(got, want)
    for d in (got, want):       # rows() reads the probe's numbers
        d["cache|error"] = {"rel_l2_err": 0.0, "interval1_exact": True,
                            "hits": 0, "refreshes": 0}
    assert _same(port.rows(got), jax_mod.rows(want))
    assert json.loads((tmp_path / "out" / "policies_e2e.json").read_text())


def test_pixel_error_report_matches_jax():
    from repro.configs.dit_models import DIT_IMAGE as JAX_DIT
    from repro.serving.cache_demo import pixel_error_report as jax_report
    from repro_torch.configs.dit_models import DIT_IMAGE
    from repro_torch.serving.cache_demo import pixel_error_report
    want = jax_report(JAX_DIT.reduced(), interval=4)
    got = pixel_error_report(DIT_IMAGE.reduced(), interval=4, device="cpu")
    for k in ("cache_interval", "hits", "refreshes", "interval1_exact"):
        assert got[k] == want[k], k
    assert want["hits"] > 0 and want["interval1_exact"]
    assert abs(got["rel_l2_err"] - want["rel_l2_err"]) <= 1e-4
    assert got["interval1_rel_l2"] <= 1e-4


def test_kernel_traffic_bytes_equal_jax(monkeypatch, tmp_path):
    jax_mod, port = _pair("roofline", monkeypatch, tmp_path)
    want, got = jax_mod.kernel_traffic(), port.kernel_traffic()
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert _same(_drop(g, lambda k: k.endswith("_hbm_s")),
                     _drop(w, lambda k: k.endswith("_hbm_s")))
        assert g["fused_hbm_s"] == g["fused_bytes"] / port.HBM_BW
        assert g["fused_bytes"] < g["unfused_bytes"]


def test_roofline_reads_the_dry_run_cells(monkeypatch, tmp_path):
    """A dry-run JSON (the port's ``CellResult`` fields), a directory of
    ``cells-*.json``, and the terms with the H100's constants; the
    useful-work ratio equals JAX's at the 16x16 mesh JAX assumes."""
    jax_mod, port = _pair("roofline", monkeypatch, tmp_path)
    cell = {"arch": "yi-6b", "shape": "train_4k", "mesh": "16x16",
            "ok": True, "error": "", "compile_s": 1.0, "flops": 5.2e15,
            "hlo_bytes": 3.1e12, "collective_bytes": {"all_reduce": 2e10},
            "per_device_memory_bytes": 2.0**36, "output_bytes": 0.0}
    failed = dict(cell, shape="decode_32k", ok=False)
    (tmp_path / "cells-yi-6b.json").write_text(json.dumps([cell, failed]))
    (tmp_path / "other.json").write_text(json.dumps([cell]))
    assert port.load_cells(tmp_path) == [cell]
    assert port.load_cells(tmp_path / "other.json") == [cell]
    assert port.load_cells(tmp_path / "missing.json") == []
    (got,), (want,) = port.analyze([cell]), jax_mod.analyze([cell])
    assert got["compute_s"] == cell["flops"] / port.PEAK_FLOPS
    assert got["memory_s"] == cell["hlo_bytes"] / port.HBM_BW
    assert got["collective_s"] == 2e10 / port.ICI_BW
    assert got["useful_ratio"] == want["useful_ratio"]
    assert got["model_flops_per_dev"] == want["model_flops_per_dev"]
    data = port.run(out_dir=tmp_path / "out", cells=tmp_path)
    assert [r[0] for r in port.rows(data)][0] == "roofline.yi-6b.train_4k"


def test_sim_fidelity_cpu_leg(monkeypatch, tmp_path):
    """``--device cpu`` on DIT_IMAGE.reduced() under one policy: every
    request completes on the thread runtime and on the simulator, the
    saved cost table has the JAX script's profiled keys, and the rows
    have the JAX script's names."""
    jax_mod = _jax("sim_fidelity", monkeypatch, tmp_path)
    port = _port("sim_fidelity", monkeypatch, tmp_path)
    monkeypatch.setattr(port, "POLICIES", ["edf"])
    got = port.run(device="cpu", out_dir=tmp_path / "out", demos=False)
    m = got["edf"]
    assert m["real_completed"] == m["sim_completed"] == m["requests"] == 12
    assert 0 <= m["gap_pp"] <= 100 and math.isfinite(m["real_mean_lat"])
    from repro.configs.dit_models import DIT_IMAGE as JAX_DIT
    want_keys = set(jax_mod._profile_costs(JAX_DIT.reduced()).table)
    table = json.loads((tmp_path / "out" / "cost_table_cpu.json")
                       .read_text())
    assert set(table["table"]) == want_keys
    assert table["calibration"]           # the real run calibrated it
    policy = {"edf": {k: m[k] for k in ("real_slo", "sim_slo", "gap_pp")}}
    assert [r[0] for r in port.rows(got)] == \
        [r[0] for r in jax_mod.rows(policy)] == ["sim_fidelity.edf.gap"]
    assert set(got["stage_costs"]) == {"S", "M"}
    assert json.loads((tmp_path / "out" / "sim_fidelity.json").read_text())


def test_sim_fidelity_has_no_cpu_fallback(monkeypatch):
    from repro_torch.benchmarks import common
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        common.device_of(None)
    assert common.device_of("cpu").type == "cpu"


def test_run_orchestrates_the_twins(monkeypatch, tmp_path, capsys):
    """``python -m repro_torch.benchmarks.run --suite`` runs the matching
    suites, prints their rows and appends to ``trajectory.json``; a
    suite that raises makes it exit 1."""
    from repro_torch.benchmarks import migration_overhead, run
    assert run.main(["--suite", "migration", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [line.split(",")[0] for line in out[1:]] == [
        "migration.4to2", "migration.2to4", "migration.4to2_disjoint",
        "migration.1to4", "migration.4to4"]
    history = json.loads((tmp_path / "trajectory.json").read_text())
    assert list(history[0]["suites"]) == ["migration_overhead(S5.3)"]
    assert run.main(["--suite", "nothing-matches", "--out",
                     str(tmp_path)]) == 2

    def fail(out_dir=None):
        raise RuntimeError("a gate failed")
    monkeypatch.setattr(migration_overhead, "run", fail)
    assert run.main(["--suite", "migration", "--out", str(tmp_path)]) == 1
    assert "ERROR:RuntimeError:a gate failed" in capsys.readouterr().out
    assert len(json.loads((tmp_path / "trajectory.json").read_text())) == 2


def test_no_twin_writes_into_benchmarks_results():
    for path in (REPO / "src" / "repro_torch" / "benchmarks").glob("*.py"):
        assert "benchmarks/results" not in path.read_text().replace(
            "never\nto ``benchmarks/results/``", ""), path
