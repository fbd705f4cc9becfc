"""The port's elastic scenario (``repro_torch.serving.elastic_demo``) on
the CPU: tests/test_elastic_backends.py's assertions, plus two checks
against the JAX package.

* Preempt, requeue and Reallocate happen on both backends, and the
  wall and sim legs give an identical ``trace_signature`` and identical
  ``clock_independent()`` telemetry (exact).
* The preempted, requeued and reallocated ``bg`` decodes to the pixels
  of an undisturbed SP-1 run: rel-L2 <= 1e-4 and max abs <= 1e-5 (the
  JAX test's ``atol``).
* Across packages, one frozen cost table gives identical sim-leg
  signatures and telemetry (exact).
* The port's wall-leg pixels for ``bg`` are within 1e-4 rel-L2 of the
  JAX wall leg's: every engine of both packages carries the same JAX
  weights, livened by ``repro.serving.cache_demo._liven`` and carried
  into the port by ``load_jax_params``, and the port draws JAX's prompt
  tokens and noise (as in tests/test_torch_engine.py).

The scenario's arrival margin is a quarter of a degree-4 denoise step of
the 1024-token ``bg``: ~11 ms at ``DIT_IMAGE.reduced()``'s two layers on
an idle host, at the JAX test's 10 ms floor.  So both packages run the
reduced width at eight layers (a margin of ~35 ms), and the port's
engines with one intra-op thread, so that the margins are not eaten by
oversubscribed cores.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.dit_models import DIT_IMAGE as JAX_DIT_IMAGE  # noqa: E402
from repro.core.cost_model import CostModel as JaxCostModel  # noqa: E402
from repro.core.telemetry import Telemetry as JaxTelemetry  # noqa: E402
from repro.diffusion.pipeline import DiTPipeline as JaxPipeline  # noqa: E402
from repro.serving import elastic_demo as jdemo  # noqa: E402
from repro.serving.cache_demo import _liven  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.convert import load_jax_params  # noqa: E402
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.core.telemetry import Telemetry  # noqa: E402
from repro_torch.serving import elastic_demo as tdemo  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving.cache_demo import rel_l2  # noqa: E402
from test_torch_engine import JaxDraws, _numpy_tree  # noqa: E402

PIXEL_BUDGET = 1e-4         # rel-L2 on decoded pixels (DESIGN.md §12)
LAYERS = 8
CFG = DIT_IMAGE.reduced(num_layers=LAYERS)
JAX_CFG = JAX_DIT_IMAGE.reduced(num_layers=LAYERS)

# one frozen calibration for the cross-package sim check: the cells the
# scenario dispatches (bg 1024 tokens, slo 16), copied across degrees as
# elastic_demo.calibrate does
TABLE = {}
for _tok, _den in ((1024, 0.40), (16, 0.03)):
    for _d in (1, 2, 4):
        TABLE[f"dit-image|encode|{_tok}|{_d}"] = 0.02
        TABLE[f"dit-image|decode|{_tok}|{_d}"] = 0.01
        TABLE[f"dit-image|denoise|{_tok}|{_d}"] = _den


class _Livened(JaxEngine):
    """The JAX engine with the livened weights every engine here uses."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        _liven(self.pipeline)


@pytest.fixture(scope="module")
def jax_weights():
    p = JaxPipeline(JAX_CFG, seed=0)
    _liven(p)
    return {"dit": _numpy_tree(p.dit_params),
            "text_encoder": _numpy_tree(p.txt_params),
            "vae": _numpy_tree(p.vae_params)}


@pytest.fixture(scope="module")
def demo(jax_weights):
    class WithJaxWeights(JaxDraws):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            for name, tree in jax_weights.items():
                load_jax_params(getattr(self, name), tree)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch_engine, "TorchDiTPipeline", WithJaxWeights)
            res = tdemo.run_demo(CFG, device="cpu")
            res["sp1_pixels"] = tdemo.sp1_pixels(CFG, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return res


def test_margins_are_safe(demo):
    # the two timing margins the deterministic scenario rests on
    assert demo["margins"]["decode_before_denoise"], demo["margins"]
    assert demo["margins"]["arrival_margin_s"] > 0.01, demo["margins"]


def test_both_backends_complete(demo):
    assert demo["wall"]["metrics"]["completed"] == 2
    assert demo["sim"]["metrics"]["completed"] == 2


def test_rank_set_changes_mid_trajectory_on_both_backends(demo):
    for leg in ("wall", "sim"):
        evs = demo[leg]["events"]
        kinds = {e["ev"] for e in evs}
        assert {"preempt", "requeued", "reallocate"} <= kinds, (leg, kinds)
        bg_ranks = [tuple(e["ranks"]) for e in evs
                    if e["ev"] == "dispatch" and e["kind"] == "denoise"
                    and e["req"] == "bg"]
        # full machine -> preempted -> single rank -> reallocated to four
        assert len(set(bg_ranks)) >= 3, (leg, bg_ranks)
        assert any(len(r) == 4 for r in bg_ranks), (leg, bg_ranks)
        assert any(len(r) == 1 for r in bg_ranks), (leg, bg_ranks)


def test_traces_identical_across_backends(demo):
    assert demo["trace_match"]
    assert demo["wall"]["signature"] == demo["sim"]["signature"]
    assert 1 <= demo["attempts"] <= 3


def test_telemetry_identical_across_backends(demo):
    assert demo["telemetry_match"]
    assert demo["wall"]["telemetry"] == demo["sim"]["telemetry"]
    assert demo["wall"]["telemetry"]["decisions"]  # non-vacuous


def test_preempted_request_output_still_correct(demo):
    """Inputs intact through requeue, migration correct through two
    layout changes: ``bg`` decodes to the undisturbed SP-1 pixels."""
    px, ref = demo["wall"]["pixels"]["bg"], demo["sp1_pixels"]
    assert px is not None and np.abs(ref).max() > 0
    assert rel_l2(px, ref) <= PIXEL_BUDGET
    np.testing.assert_allclose(ref, px, atol=1e-5)


def test_sim_legs_identical_across_packages():
    """Same frozen cost table: the port's and JAX's simulator legs make
    the same decisions and record the same telemetry."""
    jcost, tcost = JaxCostModel(table=dict(TABLE)), CostModel(
        table=dict(TABLE))
    jsim = jdemo.run_sim(jcost, JAX_CFG,
                         jdemo.scenario_requests(jcost),
                         telemetry=JaxTelemetry())
    tsim = tdemo.run_sim(tcost, CFG, tdemo.scenario_requests(tcost),
                         telemetry=Telemetry())
    assert tsim["signature"] == jsim["signature"]
    assert tsim["telemetry"] == jsim["telemetry"]
    assert tsim["metrics"]["completed"] == 2
    assert {"preempt", "reallocate"} <= {e["ev"] for e in tsim["events"]}


def test_wall_pixels_match_the_jax_wall_leg(demo, monkeypatch):
    """bg's pixels do not depend on the layouts it ran on, so the JAX
    wall leg (its own decisions, the same weights and draws) must give
    the port's pixels within the budget."""
    monkeypatch.setattr(jdemo, "ServingEngine", _Livened)
    jcost = JaxCostModel(table=dict(TABLE))
    jwall = jdemo.run_wall(JAX_CFG, jcost,
                           jdemo.scenario_requests(jcost))
    want, got = jwall["pixels"]["bg"], demo["wall"]["pixels"]["bg"]
    assert want is not None and np.abs(want).max() > 0
    assert rel_l2(got, want) <= PIXEL_BUDGET
