"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) against the
JAX package's (``repro.launch.dryrun``), on the CPU.

* Input specs: for every live cell of ``ASSIGNED_ARCHS`` x ``SHAPES``
  (34), ``serve_loop.input_specs`` (with ``cache_specs``) gives JAX's
  shapes and dtypes leaf by leaf (JAX's side ``eval_shape``: no compile).
* Shardings: ``_batch_spec`` and ``cache_sharding_for`` give JAX's specs
  for every live cell on the 16x16 and 2x16x16 meshes (JAX's side on an
  ``AbstractMesh``; a one-axis tuple, which JAX folds into its name, is
  folded on both sides).
* ``depth_variants`` equal JAX's for every arch.
* Argument bytes: rank 0's at 2x2, one cell per family and kind (train,
  prefill, decode) on reduced configs, equal
  ``compiled.memory_analysis().argument_size_in_bytes`` of JAX's
  ``_lower_cell`` on 4 forced host devices (one subprocess), compiled
  with ``keep_unused=True`` (by default ``jit`` drops the arguments a
  step never reads: whisper's encoder in a decode step, the SSM state a
  prefill overwrites, which stay resident all the same).  A train cell's
  differ by 4 bytes: the port's AdamW step counter lives on the host.
* FLOPs: ``extract_costs`` equals a full-depth trace's; on reduced yi-6b
  and mamba2-1.3b train cells at 1x1 the port counts 0.902 and 0.561 of
  JAX's ``cost_analysis`` FLOPs (depth-extrapolated as JAX's dry run
  does): XLA also counts elementwise work, and JAX's SSD is the jnp
  chunked form, whose intra-chunk products cover the whole L x L block
  where K4 counts its causal triangle.  Held to [0.88, 1] and
  [0.55, 1].
* Collective bytes of a two-product tensor-parallel toy on 2x2: its one
  all-reduce, exactly.
* The twins of ``tests/test_dryrun_harness.py``'s two slow tests at full
  size on 2x2 (not marked slow): yi-6b train_4k and mixtral-8x7b
  decode_32k.
* The kernels' shape-only branch: outputs' shapes and dtypes, forward and
  backward, at ``ops.HEAD_DIMS`` and K4's shapes, its scratch the card
  path's, its counts ``kernels.cost``'s; a CPU operand never takes it.
  The ``DTensor`` entries run each rank's local tensors: with operands
  already placed as the rule wants, rank 0's output is the plain version
  of its shards.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial,  # noqa: E402
                                      Replicate, Shard)

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.serving import serve_loop as jsl  # noqa: E402
from repro.sharding import SERVE_RULES as JSERVE  # noqa: E402
from repro.sharding import TRAIN_RULES as JTRAIN  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES,  # noqa: E402
                                 cell_is_applicable, get_config)
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.kernels import cost, ops, ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.serving import serve_loop  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.sharding import (SERVE_RULES, TRAIN_RULES,  # noqa: E402
                                  NamedSharding, P)
from repro_torch.sharding.ctx import index_write, lookup, product  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
LIVE = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES
        if cell_is_applicable(get_config(a), s)[0]]
FAMILIES = ["yi-6b", "mixtral-8x7b", "mamba2-1.3b", "zamba2-7b",
            "whisper-medium", "paligemma-3b"]
KINDS = ["train", "prefill", "decode"]
SMALL = {kind: ShapeCell(kind, 64, 8, kind) for kind in KINDS}
FLOPS_RATIO = {"yi-6b": (0.88, 1.0), "mamba2-1.3b": (0.55, 1.0)}


def _jax_dryrun():
    """JAX's dry-run module, imported without its forced device count
    (it sets ``XLA_FLAGS`` on import; this process's backend keeps its
    one device)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jd
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jd


# JAX's side of the compiled comparisons, in one subprocess started when
# this module is collected, so that it compiles while the tests below run
_JAX_COMPILED = r"""
import functools, json, os, sys
os.environ["REPRO_DEVICE_COUNT"] = "4"
from repro.launch import dryrun as jd
import jax
from repro.configs import get_config
from repro.configs.base import ShapeCell
jax.jit = functools.partial(jax.jit, keep_unused=True)
auto = (jax.sharding.AxisType.Auto,) * 2
families, kinds, flops_archs = json.loads(sys.argv[1])
out = {"args": {}, "flops": {}}
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=auto)
for arch in families:
    cfg = get_config(arch).reduced()
    for kind in kinds:
        cell = ShapeCell(kind, 64, 8, kind)
        ma = jd._lower_cell(cfg, cell, mesh, "full", "").compile() \
            .memory_analysis()
        out["args"][f"{arch} {kind}"] = ma.argument_size_in_bytes
one = jax.make_mesh((1, 1), ("data", "model"), axis_types=auto)
for arch in flops_archs:
    cell = ShapeCell("train", 64, 8, "train")
    out["flops"][arch] = jd.extract_costs(get_config(arch).reduced(), cell,
                                          one, "full", "")[0]
print(json.dumps(out))
"""


def _start_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-c", _JAX_COMPILED,
         json.dumps([FAMILIES, KINDS, list(FLOPS_RATIO)])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


_JAX: dict = {}


@pytest.fixture(scope="module", autouse=True)
def module_setup():
    """Starts JAX's compiles (they run while the tests below do).  The
    dry run sets up its own ``FakeStore`` group (one a mesh size), which
    is destroyed when the module ends."""
    _JAX["proc"] = _start_jax()
    yield
    if _JAX["proc"].poll() is None:
        _JAX["proc"].kill()
    if dist.is_initialized():
        dist.destroy_process_group()
    dryrun._MESHES.clear()


@pytest.fixture(scope="module")
def jax_compiled():
    proc = _JAX["proc"]
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def _mesh(shape):
    return dryrun._make_mesh(False, shape, "cpu")[0]


def _jax_flat(tree):
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = x
    return out


def _port_flat(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_flat(v, prefix + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_port_flat(v, prefix + (str(i),)))
    elif tree is not None:
        out["/".join(prefix)] = tree
    return out


def _sig(x) -> tuple:
    return tuple(x.shape), str(x.dtype).split(".")[-1]


def _norm(spec) -> tuple:
    """A spec with each one-axis tuple folded into its name."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in spec)


# ---------------------------------------------------------------------------
# input specs, shardings and depth variants against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", LIVE)
def test_input_specs_equal_jax(arch, shape):
    want = _jax_flat(jsl.input_specs(jax_get_config(arch), JSHAPES[shape]))
    got = _port_flat(serve_loop.input_specs(get_config(arch), SHAPES[shape]))
    assert got.keys() == want.keys()
    for key in want:
        assert _sig(got[key]) == _sig(want[key]), key
        assert got[key].is_meta, key


def test_specs_of_gives_meta_tensors_of_each_leaf():
    cfg = get_config("mamba2-1.3b").reduced()
    cache = get_model(cfg).init_cache(cfg, 2, 8, device="cpu")
    got = _port_flat(serve_loop._specs_of({"cache": cache, "n": 3}))
    want = _port_flat({"cache": cache, "n": 3})
    assert got.keys() == want.keys() and got["n"] == 3
    for key in want:
        if key != "n":
            assert got[key].is_meta and _sig(got[key]) == _sig(want[key])
    assert _port_flat(serve_loop.cache_specs(cfg, 2, 8)).keys() == \
        _port_flat(cache).keys()


def test_live_cells_are_the_harness_count():
    assert list(dryrun.live_cells()) == LIVE
    assert len(LIVE) == 34


@pytest.mark.parametrize("arch,shape", LIVE)
def test_shardings_equal_jax(arch, shape):
    jd = _jax_dryrun()
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jin = jsl.input_specs(jcfg, JSHAPES[shape])
    tin = serve_loop.input_specs(cfg, SHAPES[shape])
    kind = SHAPES[shape].kind
    jrules, trules = (JTRAIN, TRAIN_RULES) if kind == "train" else \
        (JSERVE, SERVE_RULES)
    batch = SHAPES[shape].global_batch
    for multi_pod in (False, True):
        shp = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        jmesh = AbstractMesh(shp, axes)
        mesh = _mesh(shp)
        for key in jin:
            if key == "cache":
                want = jd.cache_sharding_for(jcfg, jin[key], jmesh, batch)
                got = dryrun.cache_sharding_for(cfg, tin[key], mesh, batch)
            else:
                want = jd._batch_spec(jin[key], jmesh, jrules)
                got = dryrun._batch_spec(tin[key], mesh, trules)
            want, got = _jax_flat(want), _port_flat(got)
            assert got.keys() == want.keys(), key
            for leaf in want:
                assert isinstance(got[leaf], NamedSharding)
                assert got[leaf].mesh is mesh
                assert _norm(got[leaf].spec) == _norm(want[leaf].spec), (
                    multi_pod, key, leaf)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_depth_variants_equal_jax(arch):
    units = {"yi-6b": 32, "gemma3-12b": 8, "zamba2-7b": 13,
             "whisper-medium": 24, "deepseek-v2-236b": 59,
             "mamba2-1.3b": 48}
    jd = _jax_dryrun()
    got = dryrun.depth_variants(get_config(arch))
    want = jd.depth_variants(jax_get_config(arch))
    assert got[2] == want[2] == units.get(arch, want[2])
    for g, w in zip(got[:2], want[:2]):
        assert (g.num_layers, g.num_encoder_layers, g.scan_unroll) == \
            (w.num_layers, w.num_encoder_layers, w.scan_unroll)


# ---------------------------------------------------------------------------
# rank 0's figures against JAX's compiled ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [("yi-6b", "train"),
                                       ("zamba2-7b", "prefill"),
                                       ("whisper-medium", "train")])
def test_extracted_flops_equal_full_trace(arch, kind):
    """Every layer is counted in eager mode, so the depth extrapolation
    of two shallow traces is the full trace's count."""
    cfg = get_config(arch).reduced()
    cfg = cfg.with_(num_layers=3 * (cfg.shared_attn_every or 1),
                    num_encoder_layers=3 if cfg.family == "encdec" else 0)
    mesh = _mesh((2, 2))
    flops, _, coll = dryrun.extract_costs(cfg, SMALL[kind], mesh, "full",
                                          "")
    trace, _ = dryrun._trace_cell(cfg, SMALL[kind], mesh, "full", "")
    assert flops == trace.flops > 0
    assert coll == trace.collectives


def test_tensor_parallel_toy_collective_bytes():
    """x (8, 16), its batch over "data"; a column-parallel (16, 32) then
    a row-parallel (32, 16) product over "model": one all-reduce of rank
    0's (4, 16) fp32 result, and 2 x 4 x 16 x 16 operations a product."""
    mesh = _mesh((2, 2))

    def placed(shape, *spec):
        return dryrun.distribute_abstract(torch.empty(shape, device="meta"),
                                          NamedSharding(mesh, P(*spec)))
    x = placed((8, 16), "data", None)
    w1 = placed((16, 32), None, "model")
    w2 = placed((32, 16), "model", None)
    assert x.to_local().shape == (4, 16)
    trace = dryrun._Trace()
    with trace:
        y = (x @ w1) @ w2
        assert y.placements == (Shard(0), Partial())
        y = y.redistribute(placements=[Shard(0), Replicate()])
    assert trace.collectives == {"all-reduce": 4 * 16 * 4}
    assert trace.flops == 2 * (2 * 4 * 16 * 16)


def test_dryrun_train_cell_twin():
    """``tests/test_dryrun_harness.py``'s yi-6b train_4k at 2x2."""
    r = dryrun.run_cell("yi-6b", "train_4k", False, mesh_shape=(2, 2),
                        device="cpu")
    assert r.ok, r.error
    assert r.mesh == "2x2"
    assert r.flops > 1e15                 # extrapolated, not body-once
    assert r.collective_bytes             # TP/FSDP collectives present


def test_dryrun_decode_cell_twin():
    """... and its mixtral-8x7b decode_32k."""
    r = dryrun.run_cell("mixtral-8x7b", "decode_32k", False,
                        mesh_shape=(2, 2), device="cpu")
    assert r.ok, r.error
    assert r.per_device_memory_bytes > 0


def test_cli_writes_json(tmp_path):
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "mamba2-1.3b", "--shape", "decode_32k",
                        "--mesh", "2,2", "--device", "cpu", "--no-extract",
                        "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert [(r["arch"], r["shape"], r["mesh"], r["ok"]) for r in rows] == \
        [("mamba2-1.3b", "decode_32k", "2x2", True)]
    assert set(rows[0]) == {f.name for f in dataclasses.fields(
        dryrun.CellResult)}


# ---------------------------------------------------------------------------
# the kernels' shape-only branch and DTensor rules
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ops.HEAD_DIMS)
def test_shape_only_attention(d, dtype):
    ops.shape_only.clear()
    q, do = _meta(2, 40, 8, d, dtype=dtype), _meta(2, 40, 8, d, dtype=dtype)
    k, v = _meta(2, 40, 2, d, dtype=dtype), _meta(2, 40, 2, d, dtype=dtype)
    out = ops.attention(q, k, v, causal=True)
    o, lse = ops.attention_lse(q, k, v, causal=True)
    dq, dk, dv = ops.attention_bwd(q, k, v, o, lse, do, causal=True)
    kf, vf = _meta(2, 10, 2, d, dtype=dtype), _meta(2, 10, 2, d, dtype=dtype)
    sp = ops.splice_attention(q, k, v, kf, vf, offset=20)
    for t, like in ((out, q), (o, q), (dq, q), (dk, k), (dv, v), (sp, q)):
        assert t.is_meta and _sig(t) == _sig(like)
    assert lse.is_meta and _sig(lse) == ((2, 8, 40), "float32")
    es = q.element_size()
    assert ops.shape_only == [
        ("attention", *cost.attention(2, 40, 40, 8, 2, d, True, es)),
        ("attention", *cost.attention(2, 40, 40, 8, 2, d, True, es, True)),
        ("attention_bwd", *cost.attention_bwd(2, 40, 40, 8, 2, d, True,
                                              es)),
        ("splice_attention", *cost.splice_attention(2, 40, 40, 8, 2, d,
                                                    es))]
    ops.shape_only.clear()
    with pytest.raises(ValueError, match="unsupported head_dim"):
        ops.attention(_meta(2, 40, 8, d + 1), _meta(2, 40, 2, d + 1),
                      _meta(2, 40, 2, d + 1))


@pytest.mark.parametrize("variant", [dict(), dict(shift=1, scale=1),
                                     dict(gate=1, ln=False),
                                     dict(shift=1, scale=1, gate=1)])
def test_shape_only_adaln(variant):
    ops.shape_only.clear()
    x, dy = _meta(2, 12, 64), _meta(2, 12, 64)
    kw = {k: (_meta(2, 64) if v == 1 else v) for k, v in variant.items()}
    fwd = dict(kw, residual=_meta(2, 12, 64)) if "gate" in kw else kw
    out = ops.fused_adaln(x, **fwd)
    grads = ops.fused_adaln_bwd(x, dy=dy, **kw)
    assert out.is_meta and _sig(out) == _sig(x)
    for name, g in zip(("x", "shift", "scale", "gate", "residual"), grads):
        want = x if name in ("x", "residual") else kw.get(name)
        if name == "residual":
            want = dy if "gate" in kw else None
        assert (g is None) == (want is None), name
        if g is not None:
            assert _sig(g) == _sig(want), name
    flags = dict(ln=kw.get("ln", True), mod="shift" in kw,
                 gated="gate" in kw, es=4)
    assert ops.shape_only == [
        ("fused_adaln", *cost.adaln(2, 12, 64, **flags)),
        ("fused_adaln_bwd", *cost.adaln_bwd(2, 12, 64, **flags))]
    ops.shape_only.clear()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,n,c", ops.SSD_SHAPES)
def test_shape_only_ssd_and_its_scratch(p, n, c, dtype):
    """K4's outputs, the forward's scratch (the card path's parts) and
    the backward's work buffer, allocated on meta in the trace."""
    ops.shape_only.clear()
    b, l, h = 2, 3 * c + 5, 3                   # a ragged last chunk
    x, dy = _meta(b, l, h, p, dtype=dtype), _meta(b, l, h, p, dtype=dtype)
    dt, A = _meta(b, l, h), _meta(h)
    B, C = _meta(b, l, n, dtype=dtype), _meta(b, l, n, dtype=dtype)
    y, state, scratch = ops.ssd_for_grad(x, dt, A, B, C, chunk=c)
    assert _sig(y) == _sig(x) and _sig(state) == ((b, h, p, n), "float32")
    assert scratch.numel() == sum(ops._ssd_scratch_sizes(b, l, h, p, n, c))
    trace = dryrun._Trace(keep_ops=True)
    with trace:
        grads = ops.ssd_bwd(x, dt, A, B, C, dy, chunk=c, scratch=scratch)
    for g, like in zip(grads, (x, dt, A, B, C)):
        assert g.is_meta and _sig(g) == _sig(like)
    work = ops.ssd_bwd_scratch(b, l, h, p, n, c)
    assert any(line.endswith(f"float32[{work}]") for line in trace.ops)
    nc = -(-l // c)
    assert work == b * nc * h * (n * p + n // min(n, 1024 // p)
                                 + 2 * c * n + 1)
    es = x.element_size()
    assert ops.shape_only == [
        ("ssd", *cost.ssd(b, l, h, p, n, c, es)),
        ("ssd_bwd", *cost.ssd_bwd(b, l, h, p, n, c, es))]
    ops.shape_only.clear()


def test_shape_only_never_takes_cpu_operands():
    ops.shape_only.clear()
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 16, 2, 32, generator=gen)
    out = ops.attention(q, q, q, causal=True)
    assert torch.equal(out, ref.attention_ref(q, q, q, causal=True))
    assert ops.shape_only == []
    with pytest.raises(ValueError, match="all on CUDA or all on meta"):
        ops.attention(_meta(1, 16, 2, 32), q, q)


def test_dtensor_entries_run_the_local_shards():
    """On a 2x2 fake mesh (its collectives move nothing) with operands
    already placed as the rule wants (batch over "data", heads over
    "model"), no redistribution happens and rank 0's output is the plain
    version of rank 0's shards."""
    mesh = _mesh((2, 2))
    gen = torch.Generator().manual_seed(1)
    pl = (Shard(0), Shard(2))

    def local(*shape):
        return torch.randn(shape, generator=gen)
    ql, kl, vl = local(1, 12, 2, 32), local(1, 12, 1, 32), local(1, 12, 1, 32)

    def dt(t, placements=pl):
        return DTensor.from_local(t, mesh, placements, run_check=False)
    out = ops.attention(dt(ql), dt(kl), dt(vl), causal=True)
    assert isinstance(out, DTensor) and out.placements == pl
    assert torch.equal(out.to_local(),
                       ref.attention_ref(ql, kl, vl, causal=True))
    x, sh, sc = local(1, 5, 16), local(1, 16), local(1, 16)
    y = ops.fused_adaln(dt(x, (Shard(0), Shard(1))),
                        dt(sh, (Shard(0), Replicate())),
                        dt(sc, (Shard(0), Replicate())))
    assert y.placements == (Shard(0), Shard(1))
    assert torch.equal(y.to_local(), ref.adaln_ref(x, sh, sc))
    xs, dts = local(1, 20, 2, 16), local(1, 20, 2).abs()
    A, B, C = -local(2).abs(), local(1, 20, 16), local(1, 20, 16)
    ys, st = ops.ssd(dt(xs), dt(dts), dt(A, (Replicate(), Shard(0))),
                     dt(B, (Shard(0), Replicate())),
                     dt(C, (Shard(0), Replicate())), chunk=16)
    assert ys.placements == pl and st.placements == (Shard(0), Shard(1))
    want_y, want_s = ref.ssd_ref(xs, dts, A, B, C, chunk=16)
    assert torch.equal(ys.to_local(), want_y)
    assert torch.equal(st.to_local(), want_s)
    # the backward entries follow their forward's rule; a gradient summed
    # over a sharded dim is a partial sum of the ranks' plain gradients
    o, lse = ref.attention_ref(ql, kl, vl), ref.attention_lse_ref(ql, kl)
    do = local(1, 12, 2, 32)
    got = ops.attention_bwd(dt(ql), dt(kl), dt(vl), dt(o), dt(
        lse, (Shard(0), Shard(1))), dt(do))
    for g, w in zip(got, ref.attention_bwd_ref(ql, kl, vl, o, lse, do)):
        assert g.placements == pl and torch.equal(g.to_local(), w)
    dy = local(1, 5, 16)
    row = (Shard(0), Replicate())
    got = ops.fused_adaln_bwd(dt(x, (Shard(0), Shard(1))), dt(sh, row),
                              dt(sc, row), dy=dt(dy, (Shard(0), Shard(1))))
    want = ref.adaln_bwd_ref(x, sh, sc, None, dy)
    assert got[0].placements == (Shard(0), Shard(1))
    assert got[1].placements == (Shard(0), Partial())
    assert got[3] is None and got[4] is None
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g.to_local(), w)
    dys = local(1, 20, 2, 16)
    got = ops.ssd_bwd(dt(xs), dt(dts), dt(A, (Replicate(), Shard(0))),
                      dt(B, (Shard(0), Replicate())),
                      dt(C, (Shard(0), Replicate())), dt(dys), chunk=16)
    want = ref.ssd_bwd_ref(xs, dts, A, B, C, dys, chunk=16)
    assert [g.placements for g in got] == [
        pl, pl, (Partial(), Shard(0)), (Shard(0), Partial()),
        (Shard(0), Partial())]
    for g, w in zip(got, want):
        assert torch.equal(g.to_local(), w)


def test_sharding_helpers_run_the_local_shards():
    """``sharding.ctx.product``, ``lookup`` and ``index_write`` on a 2x2
    fake mesh with operands already placed as their rules want: rank 0's
    result is the plain op on its shards (and exactly the plain op on
    plain tensors)."""
    mesh = _mesh((2, 2))
    gen = torch.Generator().manual_seed(2)
    x, w = torch.randn(2, 3, 16, generator=gen), torch.randn(16, 5,
                                                             generator=gen)
    assert torch.equal(product(x, w), x @ w)
    got = product(DTensor.from_local(x, mesh, (Shard(0), Replicate()),
                                     run_check=False),
                  DTensor.from_local(w, mesh, (Replicate(), Shard(1)),
                                     run_check=False))
    assert got.placements == (Shard(0), Shard(2))
    assert torch.equal(got.to_local(), x @ w)
    table, ids = torch.randn(6, 4, generator=gen), torch.tensor([[0, 7, 5]])
    out = lookup(DTensor.from_local(table, mesh, (Replicate(), Shard(0)),
                                    run_check=False),
                 DTensor.from_local(ids, mesh, (Shard(0), Replicate()),
                                    run_check=False))
    assert out.placements == (Shard(0), Partial())
    want = torch.stack([table[0], torch.zeros(4), table[5]])[None]
    assert torch.equal(out.to_local(), want)    # id 7: another shard's
    dst = torch.zeros(2, 3, 4)
    key = (torch.tensor([[0], [1]]), torch.tensor([[2, 0], [1, 1]]))
    val = torch.randn(2, 2, 4, generator=gen)
    want = index_write(dst.clone(), key, val)
    got = index_write(DTensor.from_local(dst, mesh, (Replicate(), Shard(2)),
                                         run_check=False), key,
                      DTensor.from_local(val, mesh, (Replicate(), Shard(2)),
                                         run_check=False))
    assert got.placements == (Replicate(), Shard(2))
    assert torch.equal(got.to_local(), want)


@pytest.mark.parametrize("arch,shape,variant", [
    ("yi-6b", "decode_32k", "sp_decode"),
    ("yi-6b", "decode_32k", "serve_bf16"),
    ("deepseek-v2-236b", "decode_32k", "mla_absorbed"),
    ("mamba2-1.3b", "prefill_32k", "ssd_bf16"),
    ("mamba2-1.3b", "prefill_32k", "ssd_bf16_hb16")])
def test_variants_trace(arch, shape, variant):
    cfg = get_config(arch).reduced()
    r = dryrun.run_cell(arch, shape, False, variant=variant, extrapolate=False,
                        mesh_shape=(2, 2), device="cpu", cfg=cfg)
    assert r.ok, r.error
    assert r.per_device_memory_bytes > 0


def test_meta_init_needs_no_generator():
    for arch in ("yi-6b", "mamba2-1.3b", "zamba2-7b", "whisper-medium",
                 "dit-image"):
        cfg = get_config(arch).reduced()
        model = get_model(cfg).init(cfg, device="meta")
        assert all(p.is_meta for p in model.parameters()), arch


# ---------------------------------------------------------------------------
# against JAX's compiles (last: they finish while the tests above run)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_argument_bytes_equal_jax(arch, kind, jax_compiled):
    mesh = _mesh((2, 2))
    with torch.inference_mode(kind != "train"):
        _, args, _ = dryrun.cell_arguments(get_config(arch).reduced(),
                                           SMALL[kind], mesh)
        got = dryrun.local_bytes(args)
    host = 4 if kind == "train" else 0       # the AdamW step counter
    assert got + host == jax_compiled["args"][f"{arch} {kind}"]


@pytest.mark.parametrize("arch", list(FLOPS_RATIO))
def test_flops_near_jax(arch, jax_compiled):
    mesh = _mesh((1, 1))
    got = dryrun.extract_costs(get_config(arch).reduced(), SMALL["train"],
                               mesh, "full", "")[0]
    lo, hi = FLOPS_RATIO[arch]
    assert lo <= got / jax_compiled["flops"][arch] <= hi
