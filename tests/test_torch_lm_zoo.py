"""The port's decoder LM families (``hybrid``, ``dense``, ``vlm``) against
the JAX package's, on the CPU, in fp32, from one JAX parameter tree
(``repro_torch.convert.load_jax_params``).

* Forward logits of ``zamba2-7b``, ``yi-6b``, ``minitron-8b``,
  ``gemma3-12b``, ``mistral-large-123b`` and ``paligemma-3b`` at
  ``.reduced()``: max abs error over max abs reference <= 1e-5.  The
  port's full attention is the flash-attention kernel's plain version,
  JAX's the jnp ``sdpa``; both fp32.
* Prefill of 8 tokens plus 4 decode steps through the serve-loop steps
  against the port's own forward: max abs difference < 5e-4, the JAX
  package's rule (``tests/test_arch_smoke.py``).
* The hybrid with A and dt in Mamba2's published ranges
  (``ssm.init_published_a_dt``, copied into the JAX tree), so the SSD
  state carried across chunks is not negligible, and a tail layer:
  forward, prefill and decode against JAX's within 1e-4 (the port's SSD
  is the sequential recurrence, JAX's the chunked ``ssd_chunked``: K4's
  budget for two summation orders).
* SWA: gemma3 reduced with an 8-key window, a prefill longer than the
  window, then decode steps across the ring buffer's wrap: logits and
  the ring's contents against JAX's within 1e-5.
* K2 at head dim 112 (zamba2-7b's) and 32, causal and GQA, and K4 at
  (p, n, chunk) = (64, 64, 128) over two chunks: the plain versions
  against the JAX package's Pallas kernels in interpret mode and its
  oracles (1e-5; the sequential SSD against the chunked kernel 1e-4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd import ssd_scan  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving import serve_loop as jax_serve_loop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import load_jax_params  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import get_model, hybrid, ssm  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import serve_loop  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401

TOL = 1e-5
SSD_TOL = 1e-4
DECODE_TOL = 5e-4
ARCHS = ["zamba2-7b", "yi-6b", "minitron-8b", "gemma3-12b",
         "mistral-large-123b", "paligemma-3b"]


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _pair(arch, **overrides):
    """The JAX params of ``arch``.reduced(**overrides) (numpy leaves),
    the port's model holding them, and both configs."""
    jcfg = jax_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    params, _ = jL.split_params(
        jax_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg))
    tree = jax.tree.map(np.asarray, params)
    model = get_model(cfg).init(cfg, device="cpu")
    load_jax_params(model, tree)
    return tree, model, jcfg, cfg


def _extra(cfg, seed=1):
    """The VLM's stub patch embeddings (numpy), else nothing."""
    if cfg.family != "vlm":
        return ()
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, cfg.frontend_seq, cfg.d_model))
            .astype(np.float32),)


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, n))


def _port_forward(model, cfg, toks, extra):
    with torch.inference_mode():
        out, _ = get_model(cfg).forward(
            model, torch.from_numpy(toks),
            *map(torch.from_numpy, extra), cfg, dtype=torch.float32)
    return out


def _port_prefill_decode(model, cfg, toks, n_prefill, extra, max_len=64):
    """Logits (2, 1 + decode steps, V) of a prefill then teacher-forced
    decode steps through the serve-loop steps, and the final cache."""
    prefill = serve_loop.make_prefill_step(cfg, dtype=torch.float32)
    step = serve_loop.make_serve_step(cfg, dtype=torch.float32)
    off = cfg.frontend_seq if cfg.family == "vlm" else 0
    cache = get_model(cfg).init_cache(cfg, 2, max_len, dtype=torch.float32,
                                      device="cpu")
    lg, cache = prefill(model, torch.from_numpy(toks[:, :n_prefill]),
                        *map(torch.from_numpy, extra), cache)
    out = [lg[:, 0]]
    for i in range(n_prefill, toks.shape[1]):
        lg, cache = step(model, torch.from_numpy(toks[:, i:i + 1]), cache,
                         torch.tensor([off + i] * 2))
        out.append(lg[:, 0])
    return torch.stack(out, 1), cache


def _jit(fn):
    """The JAX package's step, compiled once per shape (its eager scans
    recompile on every call)."""
    return jax.jit(fn, static_argnames=("cfg", "dtype"))


def _jax_forward(tree, jcfg, toks, extra):
    out, _ = _jit(jax_get_model(jcfg).forward)(
        tree, jnp.asarray(toks), *map(jnp.asarray, extra), jcfg,
        dtype=jnp.float32)
    return out


def _jax_prefill_decode(tree, jcfg, toks, n_prefill, extra, max_len=64):
    model = jax_get_model(jcfg)
    off = jcfg.frontend_seq if jcfg.family == "vlm" else 0
    cache = model.init_cache(jcfg, 2, max_len, dtype=jnp.float32)
    lg, cache = _jit(model.prefill)(tree, jnp.asarray(toks[:, :n_prefill]),
                                    *map(jnp.asarray, extra), cache, jcfg,
                                    dtype=jnp.float32)
    out = [np.asarray(lg[:, 0])]
    step = _jit(model.decode_step)
    for i in range(n_prefill, toks.shape[1]):
        lg, cache = step(tree, jnp.asarray(toks[:, i:i + 1]), cache,
                         jnp.array([off + i] * 2), jcfg, dtype=jnp.float32)
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, 1), cache


# ---------------------------------------------------------------------------
# the six reduced configurations
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    return _pair(request.param)


def test_forward_matches_jax(arch_pair):
    tree, model, jcfg, cfg = arch_pair
    toks, extra = _tokens(cfg, 12), _extra(cfg)
    want = _jax_forward(tree, jcfg, toks, extra)
    got = _port_forward(model, cfg, toks, extra)
    assert got.dtype == torch.float32
    _close(got, want)


def test_prefill_then_decode_matches_the_forward(arch_pair):
    """Prefill 8 tokens, decode 4 (teacher-forced): each step's logits
    within 5e-4 of the forward's at the same position."""
    _, model, _, cfg = arch_pair
    toks, extra = _tokens(cfg, 12, seed=1), _extra(cfg)
    full = _port_forward(model, cfg, toks, extra)
    off = cfg.frontend_seq if cfg.family == "vlm" else 0
    steps, _ = _port_prefill_decode(model, cfg, toks, 8, extra)
    err = (steps - full[:, off + 7:off + 12]).abs().max().item()
    assert err < DECODE_TOL, err


# ---------------------------------------------------------------------------
# the hybrid with a carried SSD state, and a tail layer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live_hybrid():
    """zamba2-7b.reduced(num_layers=5): two groups of two Mamba2 layers
    and a tail layer, A and dt redrawn in the port by
    ``ssm.init_published_a_dt`` and copied into the JAX tree."""
    tree, model, jcfg, cfg = _pair("zamba2-7b", num_layers=5)
    ssm.init_published_a_dt(model, seed=3)
    params = dict(model.named_parameters())
    k, n_groups, tail = hybrid._group_plan(cfg)
    assert (k, n_groups, tail) == (2, 2, 1)
    for name in ("A_log", "dt_bias"):
        tree["mamba_groups"][name] = np.stack([
            np.stack([params[f"mamba_groups.{g}.{j}.{name}"].numpy()
                      for j in range(k)]) for g in range(n_groups)])
        tree["tail_0"][name] = params[f"tail_0.{name}"].numpy().copy()
    return tree, model, jcfg, cfg


def test_hybrid_with_published_a_dt_matches_jax(live_hybrid):
    """40 tokens (chunks of 16): forward, and a 32-token prefill plus 8
    decode steps, against JAX's; the state carried out of the prefill
    is not negligible."""
    tree, model, jcfg, cfg = live_hybrid
    toks = _tokens(cfg, 40, seed=5)
    want = _jax_forward(tree, jcfg, toks, ())
    got = _port_forward(model, cfg, toks, ())
    _close(got, want, SSD_TOL)
    jsteps, jcache = _jax_prefill_decode(tree, jcfg, toks, 32, ())
    steps, cache = _port_prefill_decode(model, cfg, toks, 32, ())
    _close(steps, jsteps, SSD_TOL)
    _close(cache["mamba_groups"]["state"], jcache["mamba_groups"]["state"],
           SSD_TOL)
    _close(cache["tail_0"]["state"], jcache["tail_0"]["state"], SSD_TOL)
    np.testing.assert_array_equal(cache["shared_kv"]["len"].numpy(),
                                  np.asarray(jcache["shared_kv"]["len"]))
    assert (steps - got[:, 31:]).abs().max().item() < DECODE_TOL
    # with A = -1 and dt ~ 0.7 (the JAX init) exp(cum) over 16 steps is
    # ~1e-5; in the published ranges the carried state stays large
    state = cache["mamba_groups"]["state"]
    assert state.abs().amax(dim=(-1, -2, -3)).min() > 1e-2


def test_hybrid_cache_layout_and_launches(live_hybrid):
    """The cache keeps the JAX layout, the shared block's K/V per
    application; on the CPU a forward calls the SSD wrapper once per
    Mamba2 layer and the attention wrapper once per shared-block
    application (the launches a card run counts)."""
    _, model, _, cfg = live_hybrid
    cache = hybrid.init_cache(cfg, 2, 24, dtype=torch.float32, device="cpu")
    assert cache["mamba_groups"]["state"].shape == (
        2, 2, 2, ssm.ssm_dims(cfg)[1], cfg.ssm.head_dim, cfg.ssm.state_dim)
    assert cache["shared_kv"]["k"].shape == (2, 2, 24, cfg.num_kv_heads,
                                             cfg.head_dim)
    assert set(cache) == {"mamba_groups", "shared_kv", "tail_0"}
    calls = {"attention": 0, "ssd": 0}
    wrapped = {name: getattr(ops, name) for name in calls}

    def counting(name):
        def call(*args, **kw):
            calls[name] += 1
            return wrapped[name](*args, **kw)
        return call
    with pytest.MonkeyPatch.context() as mp:
        for name in calls:
            mp.setattr(ops, name, counting(name))
        _port_forward(model, cfg, _tokens(cfg, 20), ())
    assert calls == {"attention": 2, "ssd": 5}


# ---------------------------------------------------------------------------
# SWA: the ring buffer past its wrap
# ---------------------------------------------------------------------------

def test_swa_ring_buffer_across_its_wrap_matches_jax():
    """gemma3-12b.reduced(window=8) (one local layer of window 8, one
    global): a 12-token prefill (longer than the window) installs its
    last 8 keys in the ring, then 8 decode steps write slots 4..7 and
    0..3.  Logits and the ring's keys against JAX's, and the steps
    against the port's forward."""
    tree, model, jcfg, cfg = _pair("gemma3-12b", window=8)
    assert T._stack_plan(cfg)["windows"] == [8, 0]
    toks = _tokens(cfg, 20, seed=2)
    jsteps, jcache = _jax_prefill_decode(tree, jcfg, toks, 12, ())
    steps, cache = _port_prefill_decode(model, cfg, toks, 12, ())
    _close(steps, jsteps)
    ring = cache["blocks"]["pos0"]
    assert ring["k"].shape[2] == 8 and cache["blocks"]["pos1"]["k"].shape[
        2] == 64
    for key in ("k", "v"):
        _close(ring[key], jcache["blocks"]["pos0"][key])
    np.testing.assert_array_equal(ring["len"].numpy(), [[20, 20]])
    full = _port_forward(model, cfg, toks, ())
    assert (steps - full[:, 11:]).abs().max().item() < DECODE_TOL


# ---------------------------------------------------------------------------
# the plain attention ops against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, window=5),
    dict(causal=True, q_offset=7, kv_len=[9, 12]),
    dict(causal=False, kv_len=[3, 12]),
    dict(causal=True, bias=True),
], ids=["causal", "window", "offset-kv_len", "kv_len", "bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sdpa_matches_jax(kw, dtype):
    """GQA (4 q heads over 2 kv heads); in bf16 both cast the fp32
    probabilities to bf16 before PV (3e-2, DESIGN.md §12)."""
    rng = np.random.default_rng(len(kw))
    sq = 5 if "q_offset" in kw else 12
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
            for _ in range(2))
    jkw, tkw = dict(kw), dict(kw)
    if "kv_len" in kw:
        jkw["kv_len"] = jnp.asarray(kw["kv_len"])
        tkw["kv_len"] = torch.tensor(kw["kv_len"])
    if kw.get("bias"):
        bias = rng.standard_normal((2, 4, sq, 12)).astype(np.float32)
        jkw["bias"], tkw["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jL.sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)), **jkw)
    got = L.sdpa(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), **tkw)
    assert got.dtype == tdt
    _close(got.float(), np.asarray(want, np.float32),
           TOL if dtype == "float32" else 3e-2)


def test_repeat_kv_matches_jax():
    k = np.random.default_rng(0).standard_normal((2, 3, 2, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        L.repeat_kv(torch.from_numpy(k), 3).numpy(),
        np.asarray(jL.repeat_kv(jnp.asarray(k), 3)))


@pytest.mark.parametrize("h,kv,d,causal", [
    (4, 4, 112, True),      # zamba2-7b's shared block, MHA
    (4, 2, 112, True),      # ... under GQA
    (4, 4, 112, False),
    (4, 4, 32, True),       # the reduced configs' head dim
    (4, 2, 32, True),
])
def test_attention_plain_version_matches_pallas(h, kv, d, causal):
    """K2's plain version (the CPU side of ``ops.attention``) against
    the JAX package's flash-attention kernel in interpret mode, which
    pads 40 tokens and d=112 to 128 internally."""
    rng = np.random.default_rng(d + h + kv)
    q = rng.standard_normal((1, 40, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 40, kv, d)).astype(np.float32)
            for _ in range(2))
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, use_pallas=True)
    t = tuple(torch.from_numpy(a) for a in (q, k, v))
    _close(ops.attention(*t, causal=causal), want)
    _close(ref.attention_ref(*t, causal=causal), want)


def test_ssd_plain_versions_at_zamba2_shape_match_jax():
    """K4 at zamba2-7b's (p, n, chunk) = (64, 64, 128), l = 256 (two
    chunks), A and dt in the published ranges: the stage-wise twin
    against JAX's chunked oracle and interpret-mode kernel (1e-5), the
    sequential recurrence against JAX's (1e-5) and the kernel (1e-4)."""
    b, l, h, p, n, chunk = 1, 256, 2, 64, 64, 128
    assert (p, n, chunk) in ops.SSD_SHAPES
    rng = np.random.default_rng(64)
    gen = torch.Generator().manual_seed(64)
    dt, A = (a.numpy() for a in ssm.sample_dt_a((b, l, h), h, gen))
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    B, C = (rng.standard_normal((b, l, n)).astype(np.float32)
            for _ in range(2))
    t = tuple(torch.from_numpy(a) for a in (x, dt, A, B, C))
    j = tuple(jnp.asarray(a) for a in (x, dt, A, B, C))
    yk, sk = ssd_scan(*j, chunk=chunk)
    yc, sc = jssm.ssd_chunked(*j, chunk)
    y, st = ref.ssd_chunked_ref(*t, chunk=chunk)
    for got, want in ((y, yc), (st, sc), (y, yk), (st, sk)):
        _close(got, want)
    yr, sr = jref.ssd_ref(*j)
    y, st = ops.ssd(*t, chunk=chunk)
    for got, want, tol in ((y, yr, TOL), (st, sr, TOL), (y, yk, SSD_TOL),
                           (st, sk, SSD_TOL)):
        _close(got, want, tol)


# ---------------------------------------------------------------------------
# conversion, dispatch and sp_decode without a mesh (the MoE, MLA and
# encdec families are tests/test_torch_moe_mla_encdec.py's)
# ---------------------------------------------------------------------------

def test_load_jax_params_fills_groups_super_blocks_and_tail(live_hybrid):
    tree, model, _, cfg = live_hybrid
    names = dict(model.named_parameters())
    np.testing.assert_array_equal(
        names["mamba_groups.1.0.in_proj"].numpy(),
        tree["mamba_groups"]["in_proj"][1, 0])
    np.testing.assert_array_equal(names["shared_attn.attn.wq"].numpy(),
                                  tree["shared_attn"]["attn"]["wq"])
    assert "tail_0.conv_w" in names and "embed.unembed" in names
    dtree, dense, _, _ = _pair("gemma3-12b")
    dnames = dict(dense.named_parameters())
    np.testing.assert_array_equal(
        dnames["blocks.0.pos1.mlp.w_up"].numpy(),
        dtree["blocks"]["pos1"]["mlp"]["w_up"][0])
    assert "embed.unembed" not in dnames          # tied embeddings


def test_vlm_prefill_takes_patches():
    _, model, _, cfg = _pair("paligemma-3b")
    assert get_model(cfg).init is T.init
    patches = torch.zeros((1, cfg.frontend_seq, cfg.d_model))
    cache = get_model(cfg).init_cache(cfg, 1, 32, device="cpu")
    lg, cache = serve_loop.make_prefill_step(cfg)(
        model, torch.zeros((1, 4), dtype=torch.long), patches, cache)
    assert lg.shape == (1, 1, cfg.vocab_size) and lg.dtype == torch.float32
    assert cache["blocks"]["pos0"]["len"].tolist() == [
        [cfg.frontend_seq + 4]] * cfg.num_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sp_decode_without_a_mesh_is_the_plain_decode(dtype):
    """``sp_decode=True`` without a mesh runs the plain cached decode in
    both packages: a prefill of 8 tokens, then 4 decode steps of
    yi-6b.reduced().  fp32 through ``decode_step`` (JAX's
    ``make_serve_step`` has no dtype) within 1e-5; bf16 through both
    packages' ``make_serve_step(sp_decode=True)`` within 3e-2, DESIGN.md
    §12's bf16 budget.  Logits and the caches' k, v and len."""
    tree, model, jcfg, cfg = _pair("yi-6b")
    toks = _tokens(cfg, 12, seed=2)
    jm = jax_get_model(jcfg)
    if dtype == "float32":
        jdt, tdt, tol = jnp.float32, torch.float32, TOL
        jpre = _jit(jm.prefill)
        jstep = jax.jit(lambda p, t, c, pos: jm.decode_step(
            p, t, c, pos, jcfg, dtype=jnp.float32, sp_decode=True))
    else:
        jdt, tdt, tol = jnp.bfloat16, torch.bfloat16, 3e-2
        jpre = jax.jit(lambda p, t, c, cfg, dtype: jax_serve_loop
                       .make_prefill_step(cfg)(p, t, c),
                       static_argnames=("cfg", "dtype"))
        jstep = jax.jit(jax_serve_loop.make_serve_step(jcfg, sp_decode=True))
    jcache = jm.init_cache(jcfg, 2, 16, dtype=jdt)
    _, jcache = jpre(tree, jnp.asarray(toks[:, :8]), jcache, jcfg,
                     dtype=jdt)
    cache = T.init_cache(cfg, 2, 16, dtype=tdt, device="cpu")
    _, cache = serve_loop.make_prefill_step(cfg, dtype=tdt)(
        model, torch.from_numpy(toks[:, :8]), cache)
    step = serve_loop.make_serve_step(cfg, dtype=tdt, sp_decode=True)
    for i in range(8, 12):
        jlg, jcache = jstep(tree, jnp.asarray(toks[:, i:i + 1]), jcache,
                            jnp.array([i, i]))
        lg, cache = step(model, torch.from_numpy(toks[:, i:i + 1]), cache,
                         torch.tensor([i, i]))
        _close(lg, np.asarray(jlg, np.float32), tol)
    for key in ("k", "v", "len"):
        _close(cache["blocks"]["pos0"][key].float(),
               np.asarray(jcache["blocks"]["pos0"][key], np.float32), tol)
