"""The port's GFC realizations against the JAX package's, on the CPU.

* ``ExecutableCache``: every op (all_gather, all_reduce, all_to_all) at
  group sizes 2 and 4, shard shapes (4,) and (8, 3), fp32 and int32, on
  the same group-global input: ints equal, fp32 within 1e-6 rel-L2 of
  JAX's compiled collective.  A sequence of binds gives the same
  ``compiles``/``hits`` after every bind as JAX's cache.
* ``build_grouped_ops``: both ops at W = 4 over 20 random memberships
  (and ``tests/test_gfc_jax_native.py``'s two), ints equal and fp32
  within 1e-6; one preparation per op and shape across all of them.
* The group-setup twin (``repro_torch.benchmarks.group_setup``) runs on
  the CPU and writes JSON only where it is told.

JAX's references come from one subprocess with four host devices (as
``tests/test_gfc_jax_native.py`` runs them); a module-scoped fixture
shares its ``.npz``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import group_setup  # noqa: E402
from repro_torch.core.executable_cache import ExecutableCache  # noqa: E402
from repro_torch.core.gfc import GroupFreeComm  # noqa: E402
from repro_torch.core.grouped import build_grouped_ops  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-6
OPS = ("all_gather", "all_reduce", "all_to_all")
DTYPES = {"float32": torch.float32, "int32": torch.int32}
CACHE_CASES = [(op, size, shape, dt) for op in OPS for size in (2, 4)
               for shape in ((4,), (8, 3)) for dt in DTYPES]
# (op, ranks, shard shape, dtype): same-size groups of other members hit
BINDS = [("all_reduce", (0, 1), (4,), "float32"),
         ("all_reduce", (2, 3), (4,), "float32"),
         ("all_gather", (0, 1, 2, 3), (4,), "float32"),
         ("all_gather", (3, 2, 1, 0), (4,), "float32"),
         ("all_gather", (1, 3), (8, 3), "int32"),
         ("all_to_all", (0, 2), (4,), "float32"),
         ("all_reduce", (1, 3), (4,), "int32"),
         ("all_reduce", (0, 3), (4,), "float32"),
         ("all_to_all", (3, 1), (4,), "float32")]
WORLD = 4
MEMBERSHIPS = 20


def _key(op, size, shape, dt):
    return f"{op}-{size}-{'x'.join(map(str, shape))}-{dt}"


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    out = {}
    for op, size, shape, dt in CACHE_CASES:
        gshape = (size * shape[0],) + shape[1:]
        out["cache/" + _key(op, size, shape, dt)] = (
            rng.standard_normal(gshape).astype(np.float32)
            if dt == "float32" else
            rng.integers(-1000, 1000, gshape).astype(np.int32))
    out["gids"] = rng.integers(0, WORLD, (MEMBERSHIPS, WORLD, 1)) \
        .astype(np.int32)
    out["grouped/float32"] = rng.standard_normal((WORLD, 2, 3)) \
        .astype(np.float32)
    out["grouped/int32"] = rng.integers(-1000, 1000, (WORLD, 2, 3)) \
        .astype(np.int32)
    return out


_CHILD = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from repro.core.executable_cache import ExecutableCache
from repro.core.gfc import GroupFreeComm
from repro.core.grouped import build_grouped_ops

inp = dict(np.load(sys.argv[1]))
binds = json.loads(sys.argv[3])
out = {}
cache = ExecutableCache()
for key, x in inp.items():
    if key.startswith("cache/"):
        op, size, shape, dt = key[6:].split("-")
        shape = tuple(int(s) for s in shape.split("x"))
        out[key] = np.asarray(cache.get(op, int(size), shape, dt)(x))

cache, comm = ExecutableCache(), GroupFreeComm(4)
stats = []
for op, ranks, shape, dt in binds:
    cache.bind(op, comm.register_group(tuple(ranks)), tuple(shape), dt)
    stats.append([cache.stats["compiles"], cache.stats["hits"]])
out["bind_stats"] = np.array(stats)

ops = {k: jax.jit(f) for k, f in
       build_grouped_ops(jax.make_mesh((4,), ("g",))).items()}
for dt in ("float32", "int32"):
    x = inp[f"grouped/{dt}"]
    for op in ("all_reduce", "all_gather"):
        out[f"grouped/{op}/{dt}"] = np.stack(
            [np.asarray(ops[op](x, g)) for g in inp["gids"]])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gfc_jax")
    inputs = _inputs()
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tmp / "in.npz"),
         str(tmp / "out.npz"), json.dumps(BINDS)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return inputs, dict(np.load(tmp / "out.npz"))


def _match(got, want, dt):
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if dt == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= TOL, err


@pytest.mark.parametrize("op", OPS)
def test_executable_cache_equals_jax(jax_ref, op):
    inputs, ref = jax_ref
    cache = ExecutableCache(device="cpu")
    for c_op, size, shape, dt in CACHE_CASES:
        if c_op != op:
            continue
        key = "cache/" + _key(op, size, shape, dt)
        got = cache.get(op, size, shape, DTYPES[dt])(
            torch.from_numpy(inputs[key]))
        _match(got, ref[key], dt)
    assert cache.stats["compiles"] == 8 and cache.stats["hits"] == 0


def test_executable_cache_binds_count_as_jax(jax_ref):
    """The key is (op, size, shape, dtype), never the members: the same
    binds compile and hit as JAX's cache, bind for bind."""
    cache, comm = ExecutableCache(device="cpu"), GroupFreeComm(WORLD)
    stats = []
    for op, ranks, shape, dt in BINDS:
        run = cache.bind(op, comm.register_group(ranks), shape, DTYPES[dt])
        assert run.descriptor.ranks == ranks
        stats.append([cache.stats["compiles"], cache.stats["hits"]])
    np.testing.assert_array_equal(np.array(stats), jax_ref[1]["bind_stats"])
    assert cache.stats["bind_seconds"] > 0 and \
        cache.stats["compile_seconds"] > 0


def test_executable_cache_jax_native_cases():
    """``tests/test_gfc_jax_native.py``'s cache case: two same-size
    groups share one prepared all_reduce, and it sums over 2 ranks."""
    cache, comm = ExecutableCache(device="cpu"), GroupFreeComm(WORLD)
    r1 = cache.bind("all_reduce", comm.register_group((0, 1)), (4,),
                    torch.float32)
    cache.bind("all_reduce", comm.register_group((2, 3)), (4,),
               torch.float32)
    assert cache.stats["compiles"] == 1 and cache.stats["hits"] >= 1
    assert float(r1(torch.ones(8))[0]) == 2.0


def test_executable_cache_returns_fresh_tensors_and_checks_input():
    cache = ExecutableCache(device="cpu")
    run = cache.get("all_to_all", 2, (4,), torch.int32)
    a = run(torch.arange(8, dtype=torch.int32))
    b = run(torch.zeros(8, dtype=torch.int32))
    assert a.tolist() == [0, 1, 4, 5, 2, 3, 6, 7] and b.tolist() == [0] * 8
    with pytest.raises(ValueError, match="prepared for"):
        run(torch.zeros(8, dtype=torch.float32))
    with pytest.raises(ValueError, match="does not split"):
        cache.get("all_to_all", 4, (2,), torch.float32)
    with pytest.raises(ValueError, match="unknown collective"):
        cache.get("broadcast", 2, (4,), torch.float32)


@pytest.mark.parametrize("dt", DTYPES)
def test_grouped_ops_equal_jax_with_one_preparation(jax_ref, dt):
    inputs, ref = jax_ref
    ops = build_grouped_ops(WORLD, device="cpu")
    x = torch.from_numpy(inputs[f"grouped/{dt}"])
    for op in ("all_reduce", "all_gather"):
        got = torch.stack([ops[op](x, torch.from_numpy(g))
                           for g in inputs["gids"]])
        _match(got, ref[f"grouped/{op}/{dt}"], dt)
        assert ops["stats"][op] == {"captures": 1, "calls": MEMBERSHIPS}


def test_grouped_ops_jax_native_cases():
    """``tests/test_gfc_jax_native.py``'s membership-as-data case."""
    ops = build_grouped_ops(WORLD, device="cpu")
    x = torch.arange(4, dtype=torch.float32).reshape(4, 1) + 1.0
    red = ops["all_reduce"](x, torch.tensor([[0], [0], [1], [1]],
                                            dtype=torch.int32))
    red2 = ops["all_reduce"](x, torch.tensor([[0], [1], [1], [0]],
                                             dtype=torch.int32))
    assert red.ravel().tolist() == [3.0, 3.0, 7.0, 7.0]
    assert red2.ravel().tolist() == [5.0, 5.0, 5.0, 5.0]
    assert ops["stats"]["all_reduce"]["captures"] == 1
    with pytest.raises(ValueError, match="world of 4"):
        ops["all_gather"](x[:3], torch.zeros((3, 1), dtype=torch.int32))


def test_group_setup_twin_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(group_setup, "PAYLOADS",
                        {"": ((1024,), torch.float32),
                         "kv_bf16": ((1, 16, 2, 8), torch.bfloat16)})
    out = tmp_path / "gs.json"
    assert group_setup.main(["--device", "cpu", "--out", str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["compiles"] == 3 and data["kv_bf16_compiles"] == 3
    names = [r[0] for r in group_setup.rows(data)]
    assert "group_setup.cache_hit_size8" in names
    assert "group_setup.kv_bf16.warm_collective" in names
    assert "nccl_world1_new_group_ms" not in data
    assert data["gfc_register_p99_us"] >= data["gfc_register_p50_us"]
