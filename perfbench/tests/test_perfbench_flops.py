"""The FLOP and byte counts against hand sums, product by product."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from perfbench import flops
from perfbench.record import Span

REPO = Path(__file__).resolve().parents[2]
IMAGE = json.loads((REPO / "perfbench/configs/wan2.1-t2v-1.3b.json").read_text())


def mm(m, k, n):
    return 2.0 * m * k * n


def test_denoise_by_hand():
    n, lt, d, ff, pd, c = 1024, 77, 1536, 8960, 64, 1024
    per_layer = (4 * mm(n, d, d)                      # self q, k, v, o
                 + 2 * mm(n, d, d) + 2 * mm(lt, d, d)  # cross q, o; k, v
                 + 3 * mm(n, d, ff)                    # SwiGLU
                 + mm(1, d, 6 * d))                    # adaLN
    head = (mm(n, pd, d) + mm(1, 256, d) + mm(1, d, d) + mm(lt, c, d)
            + mm(1, d, 2 * d) + mm(n, d, pd))
    attn = 30 * (4.0 * n * n * d + 4.0 * n * lt * d)
    w = flops.denoise(IMAGE["model"], n, batch=2)
    assert w.linear == pytest.approx(2 * (30 * per_layer + head))
    assert w.attn == pytest.approx(2 * attn)
    # an S step is ~3.64 TFLOP
    assert flops.denoise(IMAGE["model"], n).total == pytest.approx(3.64e12,
                                                                   rel=0.01)


def test_attention_bound():
    # self attention at 1024 tokens, 24 x 64: FLOP-bound
    w = flops.attention(1, 1024, 1024, 24, 24, 64)
    assert w.attn == 4.0 * 1024 * 1024 * 24 * 64
    assert w.attn_bound_s == pytest.approx(w.attn / (495e12 / 3))
    # cross attention to 77 tokens: bound by its bytes (q, k, v, o once)
    w = flops.attention(1, 1024, 77, 24, 24, 64)
    nbytes = 4 * 64 * 24 * (2 * 1024 + 2 * 77)
    assert w.attn_bound_s == pytest.approx(nbytes / 3.35e12)


def test_encode_decode_and_spans():
    t = IMAGE["text_encoder"]
    d, ff = t["d_model"], t["d_ff"]
    lin = 2 * (4 * mm(77, d, d) + 3 * mm(77, d, ff))
    assert flops.encode(t).linear == pytest.approx(lin)
    assert flops.encode(t).attn == pytest.approx(2 * 4.0 * 77 * 77 * d)
    h = 32
    px = 64 * 64                          # a 512 px image's latent
    dec = (mm(px, 16, h) + mm(px, 9 * h, 4 * h) + mm(4 * px, 9 * h, 4 * h)
           + mm(16 * px, 9 * h, 12))
    assert flops.decode(IMAGE["vae"], 16, px).linear == pytest.approx(dec)
    span = Span("decode", 0, 0.0, 1.0, (("r", -1),), 1024)
    assert flops.span_work(IMAGE, span).linear == pytest.approx(dec)
    pack = Span("denoise", 0, 0.0, 1.0, (("a", 0), ("b", 0)), 1024)
    assert flops.span_work(IMAGE, pack).total == pytest.approx(
        flops.denoise(IMAGE["model"], 1024, 2).total)
