"""The port's feature-cache scenario (``repro_torch.serving.cache_demo``)
on the CPU: tests/test_cache_backends.py's assertions, and the sim leg
against the JAX package's.

* The wall and sim legs make IDENTICAL cache hit/refresh/migrate calls
  (``trace_signature``, exact), through a mid-trace same-degree
  Reallocate that migrates a warm cache.
* ``cache_interval=1`` matches the uncached runtime within 1e-4 pixel
  rel-L2 (the JAX test asks for bit equality; the port's budget holds on
  the card, where cuBLAS picks its kernel by shape); stale reuse stays
  in (0, 5e-2] rel-L2 of the exact output (the JAX test's bound); the
  shifted and stay-put cached runs agree bit for bit.
* Across packages, the sim legs give identical signatures, cache modes
  and migrated bytes (exact).

The JAX test's two ``use_pallas`` cases have no counterpart: the port
has one path, its kernels (plain versions on the CPU).
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs.dit_models import DIT_IMAGE as JAX_DIT_IMAGE  # noqa: E402
from repro.serving import cache_demo as jdemo  # noqa: E402
from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.serving import cache_demo as tdemo  # noqa: E402

CFG = DIT_IMAGE.reduced()


@pytest.fixture(scope="module")
def demo():
    return tdemo.run_demo(CFG, device="cpu")


def test_trace_signatures_identical(demo):
    assert demo["trace_match"], (
        demo["wall"]["signature"], demo["sim"]["signature"])


def test_cache_mode_schedule(demo):
    # refresh -> hit -> (Reallocate) hit+mig -> window expiry refresh ->
    # hit -> hit: every §11 transition in one six-step chain
    assert demo["modes"] == [(0, "refresh"), (1, "hit"), (2, "hit+mig"),
                             (3, "refresh"), (4, "hit"), (5, "hit")]
    assert demo["sim"]["modes"] == demo["modes"]


def test_interval_one_matches_uncached(demo):
    assert demo["interval1_exact"], demo["interval1_rel_l2"]
    assert demo["interval1_rel_l2"] <= tdemo.PIXEL_BUDGET == 1e-4
    assert isinstance(demo["interval1_bitexact"], bool)


def test_stale_reuse_error_within_budget(demo):
    assert 0.0 < demo["rel_l2_err"] <= 5e-2, demo["rel_l2_err"]


def test_warm_cache_migrates_bit_identically(demo):
    assert demo["migration_bitexact"]
    assert demo["sim_migrated_bytes"] > 0


def test_both_backends_complete(demo):
    assert demo["wall"]["metrics"]["completed"] == 1
    assert demo["sim"]["metrics"]["completed"] == 1


def test_sim_legs_identical_across_packages():
    reqs = jdemo.scenario_requests()
    jsim = jdemo.run_sim(JAX_DIT_IMAGE.reduced(), reqs,
                         cache_interval=jdemo.CACHE_INTERVAL)
    tsim = tdemo.run_sim(CFG, tdemo.scenario_requests(),
                         cache_interval=tdemo.CACHE_INTERVAL)
    assert tsim["signature"] == jsim["signature"]
    assert tsim["modes"] == jsim["modes"]
    assert tsim["migrated_bytes"] == jsim["migrated_bytes"]


def test_liven_draws_the_same_values_on_every_call():
    """Every leg's engine gets the same livened gates (the stale-reuse
    error is a measurement, not an artefact of different weights)."""
    from repro_torch.diffusion.pipeline import TorchDiTPipeline
    pipes = [TorchDiTPipeline(CFG, seed=0, device="cpu") for _ in range(2)]
    for p in pipes:
        tdemo._liven(p)
    a, b = (p.dit.state_dict() for p in pipes)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["final_out"].abs().max() > 0
