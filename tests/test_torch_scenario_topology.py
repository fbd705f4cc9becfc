"""The port's 2-host x 2-rank topology scenario
(``repro_torch.serving.topology_demo``) on the CPU:
tests/test_topology_backends.py's assertions, and the sim leg against
the JAX package's.

* Identical ``trace_signature`` on the wall, flat-wall and sim legs
  (exact): spanning dispatches, the cross-host Reallocate boundary, the
  pinned re-dispatches.
* The wall leg runs hierarchical two-stage collectives; the flat
  one-host leg never does.
* Hierarchical and flat pixels agree within 1e-4 rel-L2 (the JAX test
  asks for bit equality; the port's budget holds on the card, where
  cuBLAS picks its kernel by shape).
* Across packages, the sim legs give identical signatures and migrated
  bytes (exact).

Every engine's DiT is livened (``repro_torch.serving.cache_demo._liven``)
so that the pixel comparison is not one of two zero velocities.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs.dit_models import DIT_IMAGE as JAX_DIT_IMAGE  # noqa: E402
from repro.serving import topology_demo as jdemo  # noqa: E402
from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import topology_demo as tdemo  # noqa: E402
from repro_torch.serving.cache_demo import _liven  # noqa: E402

CFG = DIT_IMAGE.reduced()


class Livened(torch_engine.TorchDiTPipeline):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        _liven(self)


@pytest.fixture(scope="module")
def demo():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_engine, "TorchDiTPipeline", Livened)
        return tdemo.run_demo(CFG, device="cpu")


def test_trace_identical_across_backends(demo):
    assert demo["trace_match"], (
        demo["wall"]["signature"], demo["sim"]["signature"])


def test_hierarchical_collectives_ran_on_wall_leg(demo):
    assert demo["wall"]["hierarchical_collectives"] > 0
    # the flat one-host reference leg must never take the spanning path
    assert demo["flat"]["hierarchical_collectives"] == 0


def test_pixels_match_flat_run(demo):
    assert demo["pixels_match"], demo["pixels_rel_l2"]
    assert demo["pixels_rel_l2"] <= 1e-4
    assert isinstance(demo["pixels_bitexact"], bool)


def test_cross_host_migration_priced_and_executed(demo):
    assert demo["sim"]["migrated_bytes"] > 0
    for leg in ("wall", "sim"):
        assert demo[leg]["metrics"]["completed"] == 1
        realloc = [e for e in demo[leg]["events"]
                   if e["ev"] == "dispatch" and e.get("realloc")]
        assert realloc and all(tuple(e["ranks"]) == (0, 1)
                               for e in realloc)
    spans = {tuple(e["ranks"])
             for e in demo["sim"]["events"]
             if e["ev"] == "dispatch" and e["kind"] == "denoise"}
    assert (0, 1, 2, 3) in spans and (0, 1) in spans


def test_sim_legs_identical_across_packages():
    jsim = jdemo.run_sim(JAX_DIT_IMAGE.reduced(), jdemo.scenario_requests())
    tsim = tdemo.run_sim(CFG, tdemo.scenario_requests())
    assert tsim["signature"] == jsim["signature"]
    assert tsim["migrated_bytes"] == jsim["migrated_bytes"]
