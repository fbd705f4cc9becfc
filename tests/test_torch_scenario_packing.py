"""The port's step-packing scenario (``repro_torch.serving.packing_demo``)
on the CPU: tests/test_packing_backends.py's assertions, and the sim leg
against the JAX package's.

* Identical ``trace_signature`` on the wall and sim legs, pack
  membership included (exact), and every denoise step one full pack.
* Each packed request's final latent against the same request served
  alone at the pack's degree: max |difference| <= 1e-6 of the largest
  |latent| (fp32 batched against unbatched products; the JAX test asks
  for bit equality, which holds for JAX's CPU GEMMs but is not promised
  by PyTorch's or cuBLAS's choice of kernel by batch size).
* Across packages, the sim legs give an identical signature (exact).

Every engine's DiT is livened (``repro_torch.serving.cache_demo._liven``):
with its zero-initialised gates and output head the DiT's velocity is
exactly zero and every latent comparison would hold trivially.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.dit_models import DIT_IMAGE as JAX_DIT_IMAGE  # noqa: E402
from repro.serving import packing_demo as jdemo  # noqa: E402
from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.core.trajectory import Request  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import packing_demo as tdemo  # noqa: E402
from repro_torch.serving.cache_demo import _liven  # noqa: E402
from repro_torch.serving.elastic_demo import _FixedDegree  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

CFG = DIT_IMAGE.reduced()
LATENT_TOL = 1e-6


class Livened(torch_engine.TorchDiTPipeline):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        _liven(self)


@pytest.fixture(scope="module")
def livened():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_engine, "TorchDiTPipeline", Livened)
        yield


@pytest.fixture(scope="module")
def demo(livened):
    return tdemo.run_demo(CFG, device="cpu")


def test_traces_identical_across_backends(demo):
    assert demo["trace_match"], (
        demo["wall"]["signature"], demo["sim"]["signature"])


def test_packs_form_on_both_backends(demo):
    for leg in ("wall", "sim"):
        packs = demo["packs"][leg]
        # the hold-for-peers rule aligns all chains: every denoise step
        # runs as one full pack on the shared rank set
        assert len(packs) == tdemo.STEPS, (leg, packs)
        for e in packs:
            assert e["batch"] == tdemo.N_REQS, (leg, e)
            assert len(e["ranks"]) == tdemo.PACK_DEGREE, (leg, e)


def test_all_requests_complete_on_both_backends(demo):
    assert demo["wall"]["metrics"]["completed"] == tdemo.N_REQS
    assert demo["sim"]["metrics"]["completed"] == tdemo.N_REQS


def test_pack_membership_recorded_in_signature(demo):
    sig = demo["wall"]["signature"]
    withpack = [rec for _, seq in sig for rec in seq if len(rec) == 5]
    assert withpack, sig
    assert all(len(rec[4]) == len(demo["packs"]["wall"][0]["reqs"])
               for rec in withpack)


def test_packed_latents_match_solo_engine(demo, livened):
    """N compatible tasks as one pack give each task's latents as if it
    ran alone (same degree, same rank set, batched GFC collectives)."""
    for rid, packed in demo["wall"]["latents"].items():
        assert packed is not None
        eng = ServingEngine(CFG, _FixedDegree(tdemo.PACK_DEGREE),
                            tdemo.NUM_RANKS, seed=0, device="cpu")
        req = Request(id=rid, model="dit-image", height=tdemo.RES,
                      width=tdemo.RES, frames=1, steps=tdemo.STEPS,
                      arrival=0.0)
        eng.serve([req], timeout=240)
        solo = tdemo._final_latents(eng.cp, [req])[rid]
        eng.shutdown()
        err = np.abs(solo - packed).max() / np.abs(solo).max()
        assert err <= LATENT_TOL, (rid, err)


def test_no_cross_request_latent_leakage(demo):
    lats = demo["wall"]["latents"]
    ids = sorted(lats)
    for a, b in zip(ids, ids[1:]):
        assert not np.array_equal(lats[a], lats[b]), (a, b)


def test_sim_legs_identical_across_packages():
    jsim = jdemo.run_sim(JAX_DIT_IMAGE.reduced(), jdemo.scenario_requests())
    tsim = tdemo.run_sim(CFG, tdemo.scenario_requests())
    assert tsim["signature"] == jsim["signature"]
    assert tsim["metrics"]["completed"] == tdemo.N_REQS
