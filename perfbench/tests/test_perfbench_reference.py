"""The plain reference against the port (its kernels' plain versions on
the CPU) at the reduced DiT's sizes, on the benchmark's seeded weights:
the DiT forward (self and cross attention, head dims 32 and 64), a batch
of three as a pack runs it, the text encoder, the VAE decode, the flow
step, and a request's prompt tokens and initial latent as the port draws
them from its id."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import harness, weights
from perfbench.reference import dit as rdit
from perfbench.reference import flow, param_specs, pipeline
from perfbench.reference import text_encoder as rtext
from perfbench.reference import vae as rvae
from perfbench.reference.arith import Arith, round_tf32
from perfbench.tests.conftest import TINY_MODEL, TINY_TEXT

SIZES = {"model": TINY_MODEL, "text_encoder": TINY_TEXT,
         "vae": {"hidden": 32}}


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.fixture(scope="module")
def both():
    from repro_torch.diffusion.pipeline import TorchDiTPipeline
    conf = dict(SIZES, port_config="dit-image")
    cfg = harness.port_config(conf)
    pipe = TorchDiTPipeline(cfg, seed=0, device="cpu")
    specs = param_specs(SIZES)
    weights.load({"dit": pipe.dit, "txt": pipe.text_encoder,
                  "vae": pipe.vae}, specs, 2 ** 31 + 5, "cpu")
    return cfg, pipe, weights.make(specs, 2 ** 31 + 5, "cpu")


@pytest.mark.parametrize("batch,n", [(1, 16), (3, 64)])
def test_dit_forward(both, batch, n):
    from repro_torch.models import dit
    cfg, pipe, params = both
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(batch, n, 64, generator=gen)
    txt = torch.randn(batch, 77, 64, generator=gen)
    t = torch.tensor([900.0, 500.0, 20.0][:batch])
    with torch.no_grad():
        got = dit.forward_sp_tokens(pipe.dit, x, t, txt, cfg, pos_offset=0,
                                    n_total=n,
                                    kv_gather=lambda k, v, layer: (k, v))
        ref = rdit.forward(params["dit"], x, t, txt, SIZES["model"])
    assert _rel(got, ref) < 1e-5
    # the drawn adaLN modulation makes every block count
    gated = dict(params["dit"])
    gated["blocks.1.ada_w"] = torch.zeros_like(gated["blocks.1.ada_w"])
    with torch.no_grad():
        assert _rel(rdit.forward(gated, x, t, txt, SIZES["model"]), ref) > 0.01


def test_text_encoder(both):
    from repro_torch.models import text_encoder
    _, pipe, params = both
    toks = torch.randint(0, 512, (2, 77), generator=torch.Generator()
                         .manual_seed(3))
    with torch.no_grad():
        got = text_encoder.encode(pipe.text_encoder, toks, pipe.txt_cfg,
                                  dtype=torch.float32)
        ref = rtext.encode(params["txt"], toks, TINY_TEXT)
    assert _rel(got, ref) < 1e-5


def test_vae_decode(both):
    from repro_torch.models import vae
    cfg, pipe, params = both
    lat = torch.randn(1, 3, 8, 8, 16, generator=torch.Generator()
                      .manual_seed(4))
    with torch.no_grad():
        got = vae.decode(pipe.vae, lat, cfg)
        ref = rvae.decode(params["vae"], lat)
    assert got.shape == ref.shape == (1, 3, 64, 64, 3)
    assert _rel(got, ref) < 1e-5


def test_flow_and_request_inputs(both):
    from repro_torch.core.trajectory import Request
    from repro_torch.diffusion import schedule
    _, pipe, _ = both
    for steps in (4, 50):
        np.testing.assert_array_equal(schedule.flow_sigmas(steps),
                                      flow.flow_sigmas(steps))
    x, v = torch.randn(16, 64), torch.randn(16, 64)
    assert torch.equal(schedule.flow_step(x, v, 0.9, 0.7),
                       flow.flow_step(x, v, 0.9, 0.7))
    req = Request(id="r2147483700-00003", model="dit-image", height=64,
                  width=64)
    assert torch.equal(pipe._prompt_tokens(req),
                       flow.prompt_tokens(req.id, 512))
    noise = pipe._initial_noise(req, (16, 64))
    want = torch.as_tensor(np.asarray(noise) * schedule.flow_sigmas(4)[0]
                           ).float()
    assert torch.equal(flow.initial_latent(req.id, 16, 64, 4), want)


def test_whole_request_matches_the_served_one(both):
    """A request served by the port's engine (one rank) against
    :func:`pipeline.serve`."""
    from repro_torch.core.policies import make_policy
    from repro_torch.core.trajectory import Request
    from repro_torch.serving.engine import ServingEngine
    cfg, _, params = both
    eng = ServingEngine(cfg, make_policy("fcfs-sp1", 1), 1, seed=0,
                        device="cpu")
    specs = param_specs(SIZES)
    weights.load({"dit": eng.pipeline.dit, "txt": eng.pipeline.text_encoder,
                  "vae": eng.pipeline.vae}, specs, 2 ** 31 + 5, "cpu")
    req = Request(id="r9-00001", model="dit-image", height=64, width=64,
                  steps=4)
    eng.serve([req], timeout=120)
    got = torch.as_tensor(eng.result_pixels(req))
    eng.shutdown()
    ref = pipeline.serve(params, SIZES, req.id, 64, 64, 1, 4, "cpu")
    assert _rel(got, ref["pixels"]) < 1e-5


def test_weights_must_match_the_program(both):
    _, pipe, _ = both
    specs = param_specs(dict(SIZES, vae={"hidden": 16}))
    with pytest.raises(ValueError, match="vae"):
        weights.load({"dit": pipe.dit, "txt": pipe.text_encoder,
                      "vae": pipe.vae}, specs, 1, "cpu")


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12,
                      3.0e38])
    got = round_tf32(x)
    # ties to even at 10 mantissa bits
    assert got.tolist()[:4] == [1.0, 1.0, 1.0 + 2 ** -9, -1.0]
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(1))
    rel = _rel(Arith(tf32=True).mm(a, a), a @ a)
    assert 1e-4 < rel < 3e-3
