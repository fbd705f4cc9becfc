"""The port's serving driver (``python -m
repro_torch.serving.serve_image_dit``) on the CPU: six S/M/L requests
complete, ``--emit-trace`` writes a Perfetto trace with one track a
rank, ``--stream-telemetry`` streams JSONL, and ``--cfg-split`` with
``--cache-interval`` serves split guidance shapes and cache hits."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.serving import serve_image_dit  # noqa: E402


def test_emit_trace_and_stream_telemetry(tmp_path, capsys):
    trace, stream = tmp_path / "trace.json", tmp_path / "stream.jsonl"
    metrics = serve_image_dit.main([
        "--device", "cpu", "--emit-trace", str(trace),
        "--stream-telemetry", str(stream)])
    assert metrics["completed"] == 6 and metrics["failed"] == 0
    events = json.loads(trace.read_text())["traceEvents"]
    ranks = sorted(e["args"]["name"] for e in events
                   if e.get("name") == "thread_name"
                   and e["args"]["name"].startswith("rank"))
    assert ranks == ["rank0", "rank1", "rank2", "rank3"]
    lines = stream.read_text().splitlines()
    assert lines and all(json.loads(ln) for ln in lines)
    assert "telemetry summary" in capsys.readouterr().out


def test_cfg_split_with_the_feature_cache(capsys):
    metrics = serve_image_dit.main(["--device", "cpu", "--cfg-split",
                                    "--cache-interval", "2"])
    assert metrics["completed"] == 6
    out = capsys.readouterr().out
    assert "cfg2x" in out and "hit steps" in out


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_image_dit.main([])
