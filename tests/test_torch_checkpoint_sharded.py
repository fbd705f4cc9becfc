"""``shardings=`` in the port's checkpoint restore and ``ResilientTrainer``
(the JAX package's elastic restart onto another mesh), on the CPU.

* ``CheckpointManager.restore(template, step, shardings=)`` on a 2x4
  ``FakeStore`` mesh, as ranks 0 and 5 see it (a mesh with a rank 5):
  every leaf given a ``NamedSharding`` comes back a ``DTensor`` of the
  saved global shape whose local shard is the numpy slice of the rank's
  coordinate; a leaf given None comes back whole, as without
  ``shardings``.
* ``ResilientTrainer.run(..., shardings=)`` on a world-1 gloo 1x1 mesh,
  the parameters and AdamW moments ``DTensor`` values: a crash at step 5
  and a restart from the step-4 checkpoint end with the uninterrupted
  run's parameters and moments, bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch import nn  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate,  # noqa: E402
                                      distribute_tensor)
from torch.distributed.tensor.experimental import \
    implicit_replication  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.sharding import NamedSharding, P  # noqa: E402
from repro_torch.training import data, fault_tolerance  # noqa: E402
from repro_torch.training import optimizer, train_loop  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402


def _tree():
    rng = np.random.default_rng(3)
    return {"w": rng.standard_normal((8, 12)).astype(np.float32),
            "b": rng.standard_normal((12,)).astype(np.float32),
            "opt": {"m": rng.standard_normal((4, 6)).astype(np.float32),
                    "step": np.int32(7)}}


@pytest.mark.parametrize("rank", [0, 5])
def test_restore_onto_a_mesh(tmp_path, rank):
    saved = _tree()
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(3, saved)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    try:
        mesh = make_local_mesh(2, 4, device="cpu")
        shardings = {"w": NamedSharding(mesh, P("data", "model")),
                     "b": NamedSharding(mesh, P("model")),
                     "opt": {"m": NamedSharding(mesh, P(None, "data")),
                             "step": None}}
        got, meta = mgr.restore(_tree(), shardings=shardings)
        assert meta["step"] == 3
        di, mi = mesh.get_coordinate()
        want = {"w": saved["w"][4 * di:4 * di + 4, 3 * mi:3 * mi + 3],
                "b": saved["b"][3 * mi:3 * mi + 3],
                "m": saved["opt"]["m"][:, 3 * di:3 * di + 3]}
        for key, leaf in (("w", got["w"]), ("b", got["b"]),
                          ("m", got["opt"]["m"])):
            assert isinstance(leaf, DTensor), key
            assert leaf.device_mesh is mesh
            glob = saved["opt"]["m"] if key == "m" else saved[key]
            assert tuple(leaf.shape) == glob.shape, key
            np.testing.assert_array_equal(leaf.to_local().numpy(),
                                          want[key])
        assert got["opt"]["step"] == saved["opt"]["step"]
        assert not isinstance(got["opt"]["step"], torch.Tensor)
    finally:
        dist.destroy_process_group()


def _tiny_lm():
    kw = dict(num_layers=1, d_model=64, d_ff=128, vocab_size=128,
              num_heads=2, num_kv_heads=2, head_dim=32)
    return get_config("yi-6b").reduced(**kw)


def test_resilient_trainer_restarts_onto_a_mesh(tmp_path):
    cfg = _tiny_lm()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, 1, device="cpu")
        whole = [Replicate(), Replicate()]
        inner = train_loop.make_train_step(cfg, remat="none", lr=1e-3)

        def step_fn(module, opt, batch):
            with implicit_replication():
                return inner(module, opt, batch)

        def init_state():
            m = get_model(cfg).init(cfg, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
            for mod in m.modules():
                for name, p in list(mod._parameters.items()):
                    mod._parameters[name] = nn.Parameter(
                        distribute_tensor(p.detach(), mesh, whole),
                        requires_grad=False)
            return m, optimizer.adamw_init(dict(m.named_parameters()))

        def shardings_of(state):
            module, _ = state
            spec = {n: NamedSharding(mesh, P(*[None] * p.ndim))
                    for n, p in module.named_parameters()}
            return spec, optimizer.AdamWState(None, dict(spec), dict(spec))

        class Batches:                    # numpy batches -> tensors
            def __init__(self):
                self.p = data.TokenPipeline(cfg, batch=2, seq=16, seed=9)

            def __next__(self):
                return {k: torch.from_numpy(v) for k, v in
                        next(self.p).items()}

            def seek(self, s):
                self.p.seek(s)

            def cursor(self):
                return self.p.cursor()

        shardings = shardings_of(init_state())
        ref = fault_tolerance.ResilientTrainer(
            tmp_path / "ref", step_fn, init_state, save_every=100,
            async_save=False).run(Batches(), num_steps=8)
        tr = fault_tolerance.ResilientTrainer(
            tmp_path / "crash", step_fn, init_state, save_every=2,
            async_save=False)
        with pytest.raises(RuntimeError, match="simulated crash"):
            tr.run(Batches(), num_steps=8, crash_at=5)
        out = fault_tolerance.ResilientTrainer(
            tmp_path / "crash", step_fn, init_state, save_every=2,
            async_save=False).run(Batches(), num_steps=8,
                                  shardings=shardings)
        (m1, o1), (m2, o2) = ref["state"], out["state"]
        assert int(o1.step) == int(o2.step) == 8
        p1, p2 = dict(m1.named_parameters()), dict(m2.named_parameters())
        assert p1.keys() == p2.keys()
        for name in p1:
            for a, b in ((p1[name], p2[name]), (o1.m[name], o2.m[name]),
                         (o1.v[name], o2.v[name])):
                assert isinstance(b, DTensor), name
                assert torch.equal(a.to_local(), b.to_local()), name
    finally:
        dist.destroy_process_group()
