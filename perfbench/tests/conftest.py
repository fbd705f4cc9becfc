"""Fixtures of the benchmark's tests: the import path, a cell made of new
files alone at a size the CPU runs in seconds, and the card's check."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the reduced DiT (the port's DIT_IMAGE.reduced() sizes) and its stand-ins
TINY_MODEL = {"num_layers": 2, "d_model": 128, "num_heads": 4,
              "num_kv_heads": 4, "head_dim": 32, "d_ff": 256,
              "patch_size": 2, "in_channels": 16, "cond_dim": 64}
TINY_TEXT = {"num_layers": 2, "d_model": 64, "num_heads": 4,
             "num_kv_heads": 4, "head_dim": 16, "d_ff": 128, "vocab": 512,
             "norm_eps": 1e-6, "rope_theta": 10000.0}


@pytest.fixture
def cuda():
    """Skips the test without a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def roomy_step_window(monkeypatch):
    """A step-aligned window closes at a step end found before the
    serve's timeout, which the harness sets from the warm-up's step with
    two steps to spare: the card's steps repeat within 0.2%, but a
    CPU's steps in a loaded test run drift by more.  Here the serve gets
    twice the window's seconds more."""
    from perfbench import harness
    timeout = harness.window_timeout

    def roomy(served, specs_w, seconds):
        extra = 2.0 * seconds if served.cell.mix["kind"] == "closed" else 0.0
        return timeout(served, specs_w, seconds) + extra
    monkeypatch.setattr(harness, "window_timeout", roomy)


def _cost(model: str, cells: dict) -> dict:
    """A made-up cost table: cells maps a token count to its denoise
    seconds; encode and decode 2 ms; packs (0.6 + 0.4 b) x the step."""
    out = {"table": {}, "pack_table": {}, "calibration": {},
           "pack_calibration": {}}
    for tok, d in cells.items():
        b = 1 << (tok.bit_length() - 1)
        out["table"][f"{model}|encode|{b}|1"] = 0.002
        out["table"][f"{model}|decode|{b}|1"] = 0.002
        out["table"][f"{model}|denoise|{b}|1"] = d
        for k in range(2, 9):
            out["pack_table"][f"{model}|denoise|{b}|1|b{k}"] = \
                d * (0.6 + 0.4 * k)
    return out


def make_root(root: Path) -> Path:
    """A checkout root holding only new files: BENCHMARK.json, a tiny
    configuration (and its cost table), three traffic mixes and a metric
    reader of its own, beside copies of the committed readers."""
    pb = root / "perfbench"
    for d in ("configs", "traffic"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "perfbench" / "metrics", pb / "metrics",
                    dirs_exist_ok=True)
    (pb / "metrics" / "requests_finished.py").write_text(
        '"""Requests of the window that finished."""\n\n\n'
        "def read(rec):\n"
        "    return sum(r.done is not None for r in rec.requests.values())\n")
    base = {"port_config": "dit-image", "dtype": "float32", "ranks": 1,
            "policy": "elastic-pack", "source": "test", "reduced": [],
            "assumed": [], "model": TINY_MODEL, "text_encoder": TINY_TEXT,
            "vae": {"hidden": 32}}
    img = dict(base, limits={"requests": {"embeds_rel_l2": 2e-5,
                                          "latent_rel_l2": 3e-5,
                                          "pixels_rel_l2": 5e-5}})
    vid = dict(base, limits={"steps": {"embeds_rel_l2": 2e-5,
                                       "step0_rel_l2": 6e-5,
                                       "stepk_rel_l2": 6e-5}})
    (pb / "configs" / "tiny.json").write_text(json.dumps(img))
    (pb / "configs" / "tiny.cost.json").write_text(
        json.dumps(_cost("dit-image", {16: 0.05, 64: 0.1})))
    (pb / "configs" / "tinyv.json").write_text(json.dumps(vid))
    (pb / "configs" / "tinyv.cost.json").write_text(
        json.dumps(_cost("dit-image", {192: 0.05})))
    s, m = ({"height": 64, "width": 64, "frames": 1},
            {"height": 128, "width": 128, "frames": 1})
    mixes = {
        "tiny_open": {
            "kind": "open_loop", "rate_per_s": 4.0, "shuffle_block": 10,
            "schedule_seed": 5,
            "classes": {"S": dict(s, share=0.9), "M": dict(m, share=0.1)},
            "steps": 4, "deadline": {"alpha": {"S": 1.5, "M": 2.0},
                                     "allowance_s": 1.0},
            "drain_s": 60.0, "warmup": [{"class": "S", "count": 1}],
            "check": {"mode": "requests", "sample": 3}},
        "tiny_backlog": {
            "kind": "backlog", "policy": "packing",
            "classes": {"S": dict(s, share=1.0)}, "steps": 4, "pack": 8,
            "count_factor": 1.95, "warmup": [{"class": "S", "count": 8}],
            "check": {"mode": "requests", "sample": 3}},
        "tiny_closed": {
            "kind": "closed", "clients": 1,
            "classes": {"S": {"height": 128, "width": 128, "frames": 9,
                              "share": 1.0}},
            "steps": 50, "warmup": [{"class": "S", "count": 1, "steps": 1}],
            "check": {"mode": "steps", "window_steps": 2}}}
    for name, mix in mixes.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    e2e = [{"name": n, "unit": u, "better": b, "bound": 0.25,
            "source": "host_clock", "workloads": w} for n, u, b, w in (
        ("latency_p50_s", "s", "lower", ["tiny-interactive"]),
        ("latency_p90_s", "s", "lower", ["tiny-interactive"]),
        ("images_per_s", "images/s", "higher", ["tiny-backlog"]),
        ("video_step_s", "s", "lower", ["tiny-closed"]))]
    e2e.append({"name": "setup_s", "unit": "s", "better": "lower",
                "bound": 0.25, "source": "host_clock"})
    per_layer = [{"name": "requests_finished", "unit": "requests",
                  "better": "higher", "source": "host_clock",
                  "layer": "control plane", "moves": "latency_p50_s",
                  "workloads": ["tiny-interactive"]},
                 {"name": "pack_size_mean.backlog", "unit": "requests",
                  "better": "higher", "source": "program_counter",
                  "layer": "control plane", "moves": "images_per_s",
                  "workloads": ["tiny-backlog"]},
                 {"name": "denoise_mfu.video", "unit": "%",
                  "better": "higher", "source": "host_clock",
                  "layer": "model step", "moves": "video_step_s",
                  "workloads": ["tiny-closed"]}]
    bench = {
        "command": ["python3", "perfbench/run.py"], "paths": ["perfbench"],
        "run_seconds": 2,
        "configs": [{"name": "tiny", "source": "test",
                     "file": "perfbench/configs/tiny.json", "reduced": [],
                     "why": "test"},
                    {"name": "tinyv", "source": "test",
                     "file": "perfbench/configs/tinyv.json", "reduced": [],
                     "why": "test"}],
        "workloads": [
            {"name": "tiny-interactive", "config": "tiny",
             "traffic": "tiny_open", "chips": 1, "why": "test"},
            {"name": "tiny-backlog", "config": "tiny",
             "traffic": "tiny_backlog", "chips": 1, "why": "test"},
            {"name": "tiny-closed", "config": "tinyv",
             "traffic": "tiny_closed", "chips": 1, "why": "test"}],
        "end_to_end": e2e, "per_layer": per_layer}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path / "checkout")
