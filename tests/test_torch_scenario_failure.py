"""The port's host-loss scenario (``repro_torch.serving.failure_demo``)
on the CPU: the failure-demo cases of tests/test_failures.py, and the
sim leg against the JAX package's.

* ``HostDown`` mid-step 3 on both backends: the step fails out, the
  request rolls back to step 2 from the step-1 snapshot (not to step 0)
  and completes on host 1; the wall and sim legs give an identical
  ``trace_signature`` and identical ``clock_independent()`` telemetry
  (exact).
* The wall leg's restore reads the snapshot back from disk, through the
  port's ``CheckpointManager`` in the JAX package's layout.
* The recovered pixels match the undisturbed control run within 1e-4
  rel-L2 (the JAX demo asks for bit equality; the port's budget holds on
  the card, where cuBLAS picks its kernel by shape).
* Across packages, one frozen cost table gives identical sim legs.

The scenario's margins are half a denoise step of a 64-token request,
a few milliseconds of CPU time at ``DIT_IMAGE.reduced()``: less than the
swings of the host's load while other test processes share its cores.
So every task here first sleeps ``PAD_S`` seconds, a stand-in for a
device step whose time does not depend on the host's load; calibration
and wall legs alike include it, the computation itself is unchanged,
and the margins become ~0.1 s.  Every engine's DiT is livened
(``repro_torch.serving.cache_demo._liven``) so that the pixel comparison
is not one of two zero velocities.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.dit_models import DIT_IMAGE as JAX_DIT_IMAGE  # noqa: E402
from repro.core.cost_model import CostModel as JaxCostModel  # noqa: E402
from repro.core.telemetry import Telemetry as JaxTelemetry  # noqa: E402
from repro.serving import failure_demo as jdemo  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.core.failures import SnapshotStore  # noqa: E402
from repro_torch.core.telemetry import Telemetry  # noqa: E402
from repro_torch.core.trajectory import ExecutionLayout  # noqa: E402
from repro_torch.diffusion.adapters import convert_request  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import failure_demo as tdemo  # noqa: E402
from repro_torch.serving.cache_demo import _liven  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402

CFG = DIT_IMAGE.reduced()
PAD_S = 0.2
TABLE = {"dit-image|encode|64|1": 0.03, "dit-image|denoise|64|2": 0.10,
         "dit-image|decode|64|1": 0.02}


class Livened(torch_engine.TorchDiTPipeline):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        _liven(self)

    def execute(self, *args, **kw):
        time.sleep(PAD_S)
        return super().execute(*args, **kw)


@pytest.fixture(scope="module")
def demo():
    restores = []
    real = checkpoint.CheckpointManager.restore

    def counted(mgr, template, step=None):
        tree, meta = real(mgr, template, step)
        restores.append((mgr.dir, step, meta["step"]))
        return tree, meta

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_engine, "TorchDiTPipeline", Livened)
        mp.setattr(checkpoint.CheckpointManager, "restore", counted)
        res = tdemo.run_demo(CFG, device="cpu")
    res["disk_restores"] = restores
    return res


def test_traces_and_telemetry_identical_across_backends(demo):
    assert demo["trace_match"]
    assert demo["telemetry_match"]
    assert 1 <= demo["attempts"] <= 3


def test_recovery_resumes_at_the_snapshot(demo):
    assert demo["completed"] == 1
    assert demo["snapshot_step"] == 1 and demo["resumed_step"] == 2
    assert demo["recovery"] == demo["sim"]["recovery"]
    assert demo["recovery"][:4] == [("snapshot", 1), ("host_down", None),
                                    ("failout", 3), ("rollback", 2)]
    post = [tuple(e["ranks"]) for e in demo["wall"]["events"]
            if e["ev"] == "dispatch" and e["kind"] == "denoise"
            and e["t"] > demo["t_fail"]]
    assert post and all(r == tdemo.LAYOUT_B.ranks for r in post)


def test_restore_came_from_the_on_disk_snapshot(demo):
    """At most one restore a wall attempt (the control leg loses no
    host); the last, the winning attempt's, read the step-1 snapshot
    from the request's checkpoint directory."""
    assert 1 <= len(demo["disk_restores"]) <= demo["attempts"]
    directory, step, got = demo["disk_restores"][-1]
    assert step == got == 1
    assert directory.name == "victim"


def test_recovered_pixels_match_the_undisturbed_run(demo):
    assert demo["pixels_match"], demo["pixels_rel_l2"]
    assert demo["pixels_rel_l2"] <= 1e-4
    assert isinstance(demo["pixels_bitexact"], bool)


def test_sim_legs_identical_across_packages():
    jcost, tcost = JaxCostModel(table=dict(TABLE)), CostModel(
        table=dict(TABLE))
    t_fail = tdemo.fail_time(tcost)
    assert t_fail == jdemo.fail_time(jcost)
    jsim = jdemo.run_sim(JAX_DIT_IMAGE.reduced(), jcost,
                         [jdemo._request("victim")], t_fail,
                         telemetry=JaxTelemetry())
    tsim = tdemo.run_sim(CFG, tcost,
                         [tdemo._request("victim")], t_fail,
                         telemetry=Telemetry())
    for key in ("signature", "recovery", "telemetry"):
        assert tsim[key] == jsim[key], key
    assert ("rollback", 2) in tsim["recovery"]


def test_snapshot_store_round_trips_through_port_checkpoints(tmp_path):
    """The port's SnapshotStore writes the latent through its
    CheckpointManager; the restore rematerializes it bit for bit on the
    lowest alive rank, and the JAX package reads the same files."""
    store = SnapshotStore(2, directory=tmp_path)
    req = tdemo._request("r0")
    g = convert_request(req, DIT_IMAGE.reduced())
    den1 = next(t for t in g.tasks.values()
                if t.kind == "denoise" and t.step_index == 1)
    art = g.artifacts[den1.outputs[0]]
    spec = art.fields["latent"]
    full = np.random.default_rng(11).standard_normal(
        spec.global_shape).astype(np.float32)
    half = spec.global_shape[spec.shard_axis] // 2
    layout = ExecutionLayout((0, 1))
    art.data = {0: {"latent": full[:half], "sigma": 0.5},
                1: {"latent": full[half:], "sigma": 0.5}}
    art.layout, art.materialized = layout, True
    store.capture(den1, g, layout)
    assert (tmp_path / "r0" / "step_1" / "latent.npy").exists()
    tree, meta = jckpt.CheckpointManager(tmp_path / "r0").restore(
        {"latent": np.zeros_like(full)})
    assert np.array_equal(tree["latent"], full)
    assert meta["extra"] == {"req": "r0", "sigma": 0.5}

    class _Plane:
        num_ranks = 4
        dead_ranks = {0, 1}
    art.materialized, art.layout, art.data = False, None, None
    assert store.restore(_Plane(), g, req.id) == 1
    assert art.materialized and art.layout.ranks == (2,)
    assert np.array_equal(art.data[2]["latent"], full)
    assert art.data[2]["sigma"] == 0.5
