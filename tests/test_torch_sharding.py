"""The port's sharding layer (``repro_torch.sharding``, ``launch.mesh``)
against the JAX package's, on the CPU.

* ``spec_for``: the divisibility fallback and the use-each-mesh-axis-once
  rule (the twin of ``tests/test_sharding.py``) on a 2x2 ``FakeStore``
  mesh.
* For every arch in ``ASSIGNED_ARCHS`` (and DiT-image) at full size
  (built on the ``meta`` device) under both rule sets: the port's spec
  of every parameter equals JAX's ``tree_param_specs`` of the matching
  leaf, less the leading ``"layers"`` entries of the JAX stacks; this
  also holds the port's logical axes to JAX's ``pspec``s.  The
  ``DTensor`` placements shard only dims that divide.
* ``constrain``: ``x`` itself without a context or a DTensor; under a
  2x2 context a replicated DTensor comes back with ``spec_for``'s
  placements.  The mesh builders give JAX's shapes and axis names.
* ``flash_decode`` on four gloo processes against JAX's on a (1, 4)
  mesh of host devices (one subprocess): fp32 within 1e-5 rel-L2, every
  rank's cache shard exactly equal, the write in shard 0, in a middle
  shard and on a shard's last row.
* A yi-6b.reduced() ``sp_decode`` serve step under a 1x1 mesh (gloo,
  world size 1) against JAX's under its (1, 1) mesh and the plain step.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate, Shard,  # noqa: E402
                                      distribute_tensor)
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro import sharding as jsharding  # noqa: E402
from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import text_encoder as jtext  # noqa: E402
from repro.models import vae as jvae  # noqa: E402
from repro.sharding.ctx import activation_sharding as jax_sharding  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import STACKED, load_jax_params  # noqa: E402
from repro_torch.launch.mesh import (make_local_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.models import get_model, text_encoder, vae  # noqa: E402
from repro_torch.sharding import (SERVE_RULES, TRAIN_RULES,  # noqa: E402
                                  activation_sharding, constrain,
                                  param_shardings, spec_for,
                                  tree_param_specs)
from repro_torch.sharding.specs import P, param_axes  # noqa: E402
from repro_torch.serving import serve_loop  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
RULES = {"train": (TRAIN_RULES, jsharding.TRAIN_RULES),
         "serve": (SERVE_RULES, jsharding.SERVE_RULES)}
TOL = 1e-5


@pytest.fixture
def mesh22():
    """A 2x2 ("data", "model") mesh of a fake process group (shapes
    only: its collectives move nothing)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield make_local_mesh(2, 2, device="cpu")
    finally:
        dist.destroy_process_group()


def test_divisibility_fallback(mesh22):
    # kv_heads=3 cannot shard over model=2 -> None; heads=4 shards
    assert spec_for((8, 3, 16), ("embed", "kv_heads", "head_dim"),
                    TRAIN_RULES, mesh22) == P("data", None, None)
    assert spec_for((8, 4, 16), ("embed", "heads", "head_dim"),
                    TRAIN_RULES, mesh22) == P("data", "model", None)
    # a tuple target whose axis the mesh lacks ("pod") -> None
    assert spec_for((4, 8), ("act_batch", "act_seq"), TRAIN_RULES,
                    mesh22) == P(None, "model")


def test_axis_used_once(mesh22):
    # both dims map to "model": second falls back to None
    assert spec_for((4, 4), ("heads", "mlp"), TRAIN_RULES,
                    mesh22) == P("model", None)


def test_mesh_builders_take_jax_shapes_and_names():
    for world, multi_pod, shape, names in (
            (256, False, (16, 16), ("data", "model")),
            (512, True, (2, 16, 16), ("pod", "data", "model"))):
        dist.init_process_group("fake", store=FakeStore(), rank=5,
                                world_size=world)
        try:
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            assert tuple(mesh.shape) == shape
            assert mesh.mesh_dim_names == names
            assert mesh.device_type == "cpu"
            # a tuple target shards on both of its mesh dims
            spec = spec_for((64, 8), ("act_batch", None), TRAIN_RULES, mesh)
            want = ("pod", "data") if multi_pod else None
            assert spec == P(want, None)
        finally:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# parameter specs of every arch against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def arch_pairs():
    """Per arch, built once: JAX's abstract full-size init (values, axes)
    and the port's model on the meta device."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, cfg = jax_get_config(arch), get_config(arch)
            cache[arch] = (
                jL.split_params(jax.eval_shape(lambda: jax_get_model(
                    jcfg).init(jax.random.PRNGKey(0), jcfg))),
                get_model(cfg).init(cfg, generator=torch.Generator(),
                                    device="meta"))
        return cache[arch]
    return get


def _jax_specs(values, axes, rules: str) -> dict:
    """JAX's spec of every leaf, by dotted name, on test_sharding.py's
    2x2 mesh of one host device."""
    mesh = Mesh(np.array([jax.devices()[0]] * 4).reshape(2, 2),
                ("data", "model"))
    specs = jsharding.tree_param_specs(values, axes, RULES[rules][1], mesh)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {".".join(k.key for k in path): tuple(spec)
            for path, spec in flat[0]}


def _jax_leaf(name: str) -> tuple[str, int]:
    """The JAX leaf of a port parameter, and its leading stacked axes."""
    parts = name.split(".")
    n = STACKED.get(parts[0], 0)
    return ".".join(parts[:1] + parts[1 + n:]), n


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + ["dit-image"])
def test_param_specs_equal_jax(mesh22, arch_pairs, arch, rules):
    (values, axes), model = arch_pairs(arch)
    specs = tree_param_specs(model, RULES[rules][0], mesh22)
    want = _jax_specs(values, axes, rules)
    leaves = set()
    for name, p in model.named_parameters():
        leaf, n = _jax_leaf(name)
        leaves.add(leaf)
        assert len(specs[name]) == p.ndim
        assert tuple(specs[name]) == want[leaf][n:], name
    assert leaves == set(want)
    sizes = dict(zip(mesh22.mesh_dim_names, mesh22.shape))
    params = dict(model.named_parameters())
    for name, pl in param_shardings(model, RULES[rules][0], mesh22).items():
        for d in range(params[name].ndim):
            n = int(np.prod([sizes[a] for a, s in zip(mesh22.mesh_dim_names,
                                                      pl) if s == Shard(d)]))
            assert params[name].shape[d] % n == 0, (name, pl)


def test_text_encoder_and_vae_axes_equal_jax():
    """The DiT pipeline's other modules carry JAX's ``pspec`` axes."""
    txt = text_encoder.encoder_config(64)
    gen = torch.Generator()
    for port, init in (
            (text_encoder.TextEncoder(txt, generator=gen, device="meta"),
             lambda: jtext.init(jax.random.PRNGKey(0), txt)),
            (vae.VAE(DIT_IMAGE, hidden=32, generator=gen, device="meta"),
             lambda: jvae.init(jax.random.PRNGKey(0), DIT_IMAGE, 32))):
        _, axes = jL.split_params(jax.eval_shape(init))
        want = {".".join(k.key for k in path): a for path, a in
                jax.tree_util.tree_flatten_with_path(
                    axes, is_leaf=lambda x: isinstance(x, tuple))[0]}
        got = param_axes(port)
        assert {_jax_leaf(n)[0] for n in got} == set(want)
        for name, a in got.items():
            leaf, n = _jax_leaf(name)
            assert a == want[leaf][n:], name


# ---------------------------------------------------------------------------
# constrain
# ---------------------------------------------------------------------------

def test_constrain_is_x_itself_without_a_context(mesh22):
    x = torch.ones((4, 8))
    assert constrain(x, "act_batch", None) is x
    dx = distribute_tensor(x, mesh22, [Replicate(), Replicate()])
    assert constrain(dx, "act_batch", "act_seq") is dx


def test_constrain_redistributes_a_dtensor_under_a_context(mesh22):
    x = torch.arange(32.0).reshape(4, 8)
    dx = distribute_tensor(x, mesh22, [Replicate(), Replicate()])
    with activation_sharding(mesh22, TRAIN_RULES):
        y = constrain(dx, "embed", "act_seq")
        assert tuple(y.placements) == (Shard(0), Shard(1))
        assert constrain(dx, "embed") is dx              # rank mismatch
        assert constrain(x, "embed", "act_seq") is x     # a local tensor
    assert isinstance(y, DTensor) and y.to_local().shape == (2, 4)


# ---------------------------------------------------------------------------
# flash_decode over a sequence-sharded cache: four gloo ranks vs JAX
# ---------------------------------------------------------------------------

B, S, H, KV, HD, WORLD = 2, 32, 4, 2, 16, 4
# cache_len of each batch row; row 0's is the write position (shard of 8)
CASES = {"shard0": [3, 3], "middle": [13, 11], "last_row": [23, 23],
         "last_shard": [30, 26]}


def _fd_inputs() -> dict:
    rng = np.random.default_rng(7)
    out = {}
    for case, lens in CASES.items():
        for name, shape in (("q", (B, 1, H, HD)), ("k_new", (B, 1, KV, HD)),
                            ("v_new", (B, 1, KV, HD)),
                            ("cache_k", (B, S, KV, HD)),
                            ("cache_v", (B, S, KV, HD))):
            out[f"{case}/{name}"] = rng.standard_normal(shape) \
                .astype(np.float32)
        out[f"{case}/len"] = np.array(lens, np.int32)
    return out


_JAX_CHILD = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
from repro.sharding.sp import flash_decode
inp = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((1, 4), ("data", "model"))
fd = jax.jit(lambda *a: flash_decode(*a, mesh=mesh))
out = {}
for case in json.loads(sys.argv[3]):
    o, ck, cv = fd(*(inp[f"{case}/{n}"] for n in (
        "q", "k_new", "v_new", "cache_k", "cache_v", "len")))
    out[f"{case}/out"], out[f"{case}/cache_k"], out[f"{case}/cache_v"] = (
        np.asarray(o), np.asarray(ck), np.asarray(cv))
np.savez(sys.argv[2], **out)
"""

_RANK = r"""
import json, sys
import numpy as np
import torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, src, dst = sys.argv[1:6]
rank, world = int(rank), int(world)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.sharding.sp import flash_decode
mesh = make_local_mesh(1, world, device="cpu")
inp = dict(np.load(src))
out = {}
for case in json.loads(sys.argv[6]):
    t = {n: torch.from_numpy(inp[f"{case}/{n}"]) for n in (
        "q", "k_new", "v_new", "len")}
    s_loc = inp[f"{case}/cache_k"].shape[1] // world
    ck, cv = (torch.from_numpy(inp[f"{case}/{n}"][:, rank * s_loc:
                                                   (rank + 1) * s_loc].copy())
              for n in ("cache_k", "cache_v"))
    o, ck2, cv2 = flash_decode(t["q"], t["k_new"], t["v_new"], ck, cv,
                               t["len"], mesh=mesh)
    assert ck2 is ck and cv2 is cv
    out[f"{case}/out"] = o.numpy()
    out[f"{case}/cache_k"], out[f"{case}/cache_v"] = ck.numpy(), cv.numpy()
np.savez(dst, **out)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def flash_decode_runs(tmp_path_factory):
    """JAX's results (one subprocess, four host devices) and each gloo
    rank's (four processes meeting through a FileStore), all cases."""
    tmp = tmp_path_factory.mktemp("flash_decode")
    np.savez(tmp / "in.npz", **_fd_inputs())
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cases = json.dumps(list(CASES))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), str(WORLD), str(tmp / "store"),
         str(tmp / "in.npz"), str(tmp / f"rank{r}.npz"), cases], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    jax_run = subprocess.run(
        [sys.executable, "-c", _JAX_CHILD, str(tmp / "in.npz"),
         str(tmp / "jax.npz"), cases], env=env, capture_output=True,
        text=True, timeout=300)
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"gloo rank {r} did not finish in 120 s")
        if p.returncode:
            errors.append(f"rank {r}: {err[-2000:]}")
    assert not errors, errors
    assert jax_run.returncode == 0, jax_run.stderr[-3000:]
    return (dict(np.load(tmp / "jax.npz")),
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)])


@pytest.mark.parametrize("case", CASES)
def test_flash_decode_on_four_gloo_ranks_equals_jax(flash_decode_runs, case):
    want, ranks = flash_decode_runs
    s_loc = S // WORLD
    for r, got in enumerate(ranks):
        o, w = got[f"{case}/out"], want[f"{case}/out"]
        assert o.shape == w.shape == (B, 1, H, HD)
        err = np.linalg.norm(o - w) / np.linalg.norm(w)
        assert err <= TOL, (r, err)
        for n in ("cache_k", "cache_v"):
            np.testing.assert_array_equal(
                got[f"{case}/{n}"],
                want[f"{case}/{n}"][:, r * s_loc:(r + 1) * s_loc])
    # the new row landed in its owner's shard, at row 0's position
    pos = CASES[case][0]
    owner = ranks[pos // s_loc][f"{case}/cache_k"]
    np.testing.assert_array_equal(owner[:, pos % s_loc],
                                  _fd_inputs()[f"{case}/k_new"][:, 0])


# ---------------------------------------------------------------------------
# the serve step with sp_decode under a 1x1 mesh
# ---------------------------------------------------------------------------

@pytest.fixture
def mesh11(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_local_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_sp_decode_step_under_a_mesh_equals_jax_and_the_plain_step(mesh11):
    """yi-6b.reduced(), fp32: a prefill of 8 tokens, then 4 decode steps
    with ``sp_decode=True`` under a 1x1 mesh (flash_decode's path), in
    both packages; logits and caches within 1e-5 of JAX's and of the
    port's plain decode."""
    jcfg = jax_get_config("yi-6b").reduced()
    cfg = get_config("yi-6b").reduced()
    jm = jax_get_model(jcfg)
    tree = jax.tree.map(np.asarray, jL.split_params(
        jm.init(jax.random.PRNGKey(0), jcfg))[0])
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 12))

    jcache = jm.init_cache(jcfg, 2, 16, dtype=jnp.float32)
    _, jcache = jax.jit(lambda p, t, c: jm.prefill(
        p, t, c, jcfg, dtype=jnp.float32))(tree, toks[:, :8], jcache)
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    with jax_sharding(jmesh, jsharding.SERVE_RULES):
        jstep = jax.jit(lambda p, t, c, pos: jm.decode_step(
            p, t, c, pos, jcfg, dtype=jnp.float32, sp_decode=True))
        jlogits = []
        for i in range(8, 12):
            lg, jcache = jstep(tree, toks[:, i:i + 1], jcache,
                               jnp.array([i, i]))
            jlogits.append(np.asarray(lg))

    model = get_model(cfg).init(cfg, device="cpu")
    load_jax_params(model, tree)
    prefill = serve_loop.make_prefill_step(cfg, dtype=torch.float32)
    got = {}
    for sp in (True, False):
        cache = get_model(cfg).init_cache(cfg, 2, 16, dtype=torch.float32,
                                          device="cpu")
        _, cache = prefill(model, torch.from_numpy(toks[:, :8]), cache)
        step = serve_loop.make_serve_step(cfg, dtype=torch.float32,
                                          sp_decode=sp)
        logits = []
        with activation_sharding(mesh11, SERVE_RULES):
            for i in range(8, 12):
                lg, cache = step(model, torch.from_numpy(toks[:, i:i + 1]),
                                 cache, torch.tensor([i, i]))
                logits.append(lg.numpy())
        got[sp] = (np.stack(logits), cache)

    def close(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= TOL * np.abs(b).max()

    close(got[True][0], np.stack(jlogits))
    close(got[True][0], got[False][0])
    for key in ("k", "v", "len"):
        close(got[True][1]["blocks"]["pos0"][key],
              jcache["blocks"]["pos0"][key])
