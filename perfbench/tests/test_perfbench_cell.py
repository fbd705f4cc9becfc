"""A cell made of new files alone (configuration, cost table, traffic
mixes, a metric reader) loads by name and runs end to end on the CPU,
with the reference deciding ``correct``."""
from __future__ import annotations

import time

import pytest

from perfbench import harness, spec


def test_new_files_load_by_name(tiny_root):
    cell = spec.load(tiny_root, "tiny-interactive")
    assert cell.config["model"]["d_model"] == 128
    assert cell.mix["kind"] == "open_loop"
    assert [m["name"] for m in cell.per_layer] == ["requests_finished"]
    assert cell.reader("requests_finished").read is not None


@pytest.mark.parametrize("workload,seconds,trace,metrics", [
    ("tiny-interactive", 3.0, False, {"latency_p50_s", "latency_p90_s",
                                  "setup_s"}),
    ("tiny-interactive", 3.0, True, {"requests_finished"}),
    ("tiny-backlog", 2.0, False, {"images_per_s", "setup_s"}),
    ("tiny-backlog", 2.0, True, {"pack_size_mean.backlog"}),
    ("tiny-closed", 0.3, False, {"video_step_s", "setup_s"}),
    ("tiny-closed", 0.3, True, {"denoise_mfu.video"}),
])
def test_cell_runs_on_the_cpu(tiny_root, workload, seconds, trace, metrics):
    res = harness.run(tiny_root, workload, 2 ** 31 + 77, seconds, trace,
                      time.monotonic(), device="cpu", log=lambda *a, **k: 0)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == metrics
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(c["value"] is not None and c["value"] <= c["limit"]
               for c in res["checks"].values())
    if workload == "tiny-backlog" and trace:
        assert res["metrics"]["pack_size_mean.backlog"]["value"] == 8.0
