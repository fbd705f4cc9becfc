"""The port's hybrid-shape scenario (``repro_torch.serving.hybrid_demo``)
on the CPU: the demo cases of tests/test_hybrid_shapes.py, and the sim
leg against the JAX package's.

* The scripted sp4 -> Reallocate-RESHAPE -> cfg2 x sp2 chain gives an
  identical ``trace_signature`` and identical ``clock_independent()``
  telemetry on the wall and sim legs (exact), cfg dimension included.
* The split run's pixels match the shard-size-matched batched-CFG
  control within 1e-4 rel-L2 (the JAX test asks for bit equality; the
  port's budget holds on the card, where cuBLAS picks its kernel by M
  and batch).
* ``ElasticPolicy(hybrid=True)`` on an unguided workload is
  byte-identical to scalar ``ElasticPolicy()`` (exact).
* Across packages, the sim legs give identical signatures, telemetry,
  timelines and migrated bytes (exact).

Every engine's DiT is livened (``repro_torch.serving.cache_demo._liven``)
so that the guidance merge acts on non-zero velocities.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.configs.dit_models import DIT_IMAGE as JAX_DIT_IMAGE  # noqa: E402
from repro.core.telemetry import Telemetry as JaxTelemetry  # noqa: E402
from repro.serving import hybrid_demo as jdemo  # noqa: E402
from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.core.telemetry import Telemetry  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import hybrid_demo as tdemo  # noqa: E402
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


def test_demo_split_pixels_match_batched_control(demo):
    assert demo["pixels_match"], demo["pixels_rel_l2"]
    assert demo["pixels_rel_l2"] <= 1e-4
    assert isinstance(demo["pixels_bitexact"], bool)


def test_demo_sim_wall_traces_identical(demo):
    assert demo["trace_match"]
    assert demo["wall"]["timeline"] == [(0, "sp4"), (1, "sp4"),
                                        (2, "cfg2x sp2"),
                                        (3, "cfg2x sp2")]
    assert demo["control"]["timeline"] == [(0, "sp4"), (1, "sp4"),
                                           (2, "sp2"), (3, "sp2")]


def test_demo_sim_wall_telemetry_identical(demo):
    assert demo["telemetry_match"]
    assert demo["wall"]["telemetry"] == demo["sim"]["telemetry"]
    flat = [d for recs in demo["wall"]["telemetry"]["decisions"].values()
            for d in recs]
    # the scripted mid-flight reshape shows up as a reallocate decision
    # whose structural record carries the new cfg dimension
    reshapes = [d for d in flat
                if d["action"] == "reallocate" and d.get("cfg") == 2]
    assert reshapes, flat


def test_demo_shape_search_off_is_scalar(demo):
    assert demo["scalar_identical"]


def test_both_legs_complete(demo):
    for leg in ("wall", "sim", "control"):
        assert demo[leg]["metrics"]["completed"] == 1, leg


def test_sim_legs_identical_across_packages():
    jsim = jdemo.run_sim(JAX_DIT_IMAGE.reduced(), jdemo.scenario_requests(),
                         jdemo.SPLIT, telemetry=JaxTelemetry())
    tsim = tdemo.run_sim(CFG, tdemo.scenario_requests(), tdemo.SPLIT,
                         telemetry=Telemetry())
    for key in ("signature", "telemetry", "timeline", "migrated_bytes"):
        assert tsim[key] == jsim[key], key
