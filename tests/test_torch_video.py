"""The video path of the port (``DIT_VIDEO``, ``frames > 1``) against the
JAX package's, on the CPU.

* ``dit.latent_shape`` and ``dit.token_count`` equal JAX's for the
  paper's three video classes, ``frames=0`` and image requests.
* The reduced video request (64x64, 9 frames: 3 latent frames, 48
  tokens) through both engines with the harness of
  ``tests/test_torch_engine.py`` (JAX weights converted, JAX draws):
  identical ``trace_signature`` and pixels within 1e-4 rel-L2 at SP-1,
  at SP-2 with §11 refresh and hit steps, and guided at cfg=2.
* K1 at D=3072 and K2/K3 at head dim 128 (``DIT_VIDEO``'s widths), and
  ``forward_sp_tokens`` at head dim 128, against the JAX package's
  Pallas kernels in interpret mode: max abs error over max abs reference
  <= 1e-5 in fp32.
* The positional embedding at video positions, with its tolerance
  stated in ``test_pos_embedding_at_video_positions``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.dit_models import DIT_IMAGE as JAX_DIT_IMAGE  # noqa: E402
from repro.configs.dit_models import DIT_VIDEO as JAX_DIT_VIDEO  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import dit as jdit  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.serving.cache_demo import _liven  # noqa: E402
from repro_torch.configs.dit_models import DIT_IMAGE, DIT_VIDEO  # noqa: E402
from repro_torch.convert import load_jax_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import dit  # noqa: E402

from test_torch_engine import (PORT, _numpy_tree,  # noqa: E402
                               _serve_both, fixed_sp)
from torch_threads import few_threads  # noqa: E402,F401

TOL = 1e-5
VIDEO_REQ = dict(height=64, width=64, frames=9, steps=3)   # 3 x 8 x 8 latent


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


# ---------------------------------------------------------------------------
# latent shape and token count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("video,height,width,frames,tokens", [
    (True, 480, 832, 49, 20280),       # video S: (13, 60, 104, 16)
    (True, 480, 832, 81, 32760),       # video M: (21, 60, 104, 16)
    (True, 720, 1280, 81, 75600),      # video L: (21, 90, 160, 16)
    (True, 480, 832, 0, 9360),         # frames=0: latent_frames=21
    (True, 64, 64, 9, 48),             # the reduced request below
    (True, 64, 64, 1, 16),             # one frame
    (False, 512, 512, 1, 1024),        # image S
    (False, 1024, 1024, 0, 4096),      # image M, latent_frames=1
])
def test_latent_shape_and_token_count_match_jax(video, height, width, frames,
                                                tokens):
    tcfg, jcfg = (DIT_VIDEO, JAX_DIT_VIDEO) if video else (DIT_IMAGE,
                                                           JAX_DIT_IMAGE)
    assert dit.latent_shape(tcfg, height, width, frames) == \
        jdit.latent_shape(jcfg, height, width, frames)
    assert dit.token_count(tcfg, height, width, frames) == \
        jdit.token_count(jcfg, height, width, frames) == tokens


# ---------------------------------------------------------------------------
# the reduced video request through both engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,cfg,cache_interval,guidance,modes", [
    (1, 1, None, None, [None, None, None]),
    (2, 1, 2, None, ["refresh", "hit", "refresh"]),
    (4, 2, None, 2.0, [None, None, None]),     # cfg2 x sp2, merge exchange
])
def test_engine_video_matches_jax(monkeypatch, k, cfg, cache_interval,
                                  guidance, modes):
    """DIT_VIDEO.reduced() serving a 64x64 request of 9 frames: the
    pixels keep the 3 latent frames, as the JAX package decodes them."""
    def requests(pkg):
        return [pkg.traj.Request(id="vid", model="dit-video", arrival=0.0,
                                 guidance=guidance, **VIDEO_REQ)]
    got_modes, _ = _serve_both(
        monkeypatch, lambda pkg: fixed_sp(pkg, k, cfg), requests,
        cache_interval=cache_interval,
        cfgs=(JAX_DIT_VIDEO.reduced(), DIT_VIDEO.reduced()))
    assert got_modes == modes


def test_engine_video_pixels_have_the_latent_frames():
    """The port's engine alone: one step at SP-1."""
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(DIT_VIDEO.reduced(), fixed_sp(PORT, 1), 1,
                        device="cpu")
    req = PORT.traj.Request(id="v", model="dit-video", arrival=0.0,
                            **dict(VIDEO_REQ, steps=1))
    try:
        eng.serve([req], timeout=60)
        px = eng.result_pixels(req)
    finally:
        eng.shutdown()
    f_lat = dit.latent_shape(DIT_VIDEO, 64, 64, 9)[0]
    assert px.shape == (f_lat, 64, 64, 3) and np.isfinite(px).all()


# ---------------------------------------------------------------------------
# the kernels' ops at the video widths, against the Pallas kernels
# ---------------------------------------------------------------------------

def _pair(rng, shape, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


@pytest.mark.parametrize("variant", ["mod_norm", "ln", "gated_residual",
                                     "full"])
def test_adaln_at_video_width_matches_pallas(variant):
    """K1 at DIT_VIDEO's d_model 3072 (the kernel's NV=24 class on the
    card), 50 rows: a ragged tail against the Pallas kernel's 128."""
    rng = np.random.default_rng(3)
    d = DIT_VIDEO.d_model
    x = _pair(rng, (1, 50, d))
    kw = {}
    if variant in ("mod_norm", "full"):
        kw["shift"], kw["scale"] = (_pair(rng, (1, d), 0.5)
                                    for _ in range(2))
    if variant in ("gated_residual", "full"):
        kw["gate"], kw["residual"] = _pair(rng, (1, d), 0.5), \
            _pair(rng, (1, 50, d))
    ln = variant != "gated_residual"
    got = ops.fused_adaln(x[0], **{k: v[0] for k, v in kw.items()}, ln=ln)
    want = jops.fused_adaln(x[1], **{k: v[1] for k, v in kw.items()}, ln=ln,
                            use_pallas=True)
    _close(got, want)


@pytest.mark.parametrize("sq,sk,offset", [
    (70, 200, None),        # self: ragged q and k against the kernel tiles
    (70, 77, None),         # cross to 77 text tokens
    (50, 200, 37),          # §11 splice at an offset off the 32-key tile
])
def test_attention_at_head_dim_128_matches_pallas(sq, sk, offset):
    rng = np.random.default_rng(sq + sk)
    h, d = 4, DIT_VIDEO.head_dim
    q = _pair(rng, (1, sq, h, d))
    k, v = (_pair(rng, (1, sk, h, d)) for _ in range(2))
    if offset is None:
        got = ops.attention(q[0], k[0], v[0])
        want = jops.attention(q[1], k[1], v[1], use_pallas=True)
    else:
        kf, vf = (_pair(rng, (1, sq, h, d)) for _ in range(2))
        got = ops.splice_attention(q[0], k[0], v[0], kf[0], vf[0],
                                   offset=offset)
        want = jops.splice_attention(q[1], k[1], v[1], kf[1], vf[1],
                                     offset=offset, use_pallas=True)
    _close(got, want)


# ---------------------------------------------------------------------------
# forward_sp_tokens at head dim 128
# ---------------------------------------------------------------------------

SMALL = dict(head_dim=128, num_heads=2, num_kv_heads=2, d_model=256)


@pytest.fixture(scope="module")
def video_pair():
    """JAX DiT params at DIT_VIDEO.reduced(head dim 128) with livened
    adaLN gates, and the port's DiT holding the same values."""
    jcfg = dataclasses.replace(JAX_DIT_VIDEO.reduced(**SMALL),
                               use_pallas=True)
    cfg = DIT_VIDEO.reduced(**SMALL)
    params, _ = jL.split_params(jdit.init(jax.random.PRNGKey(0), jcfg))
    holder = type("Holder", (), {})()
    holder.dit_params = params
    _liven(holder)
    model = dit.DiT(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    load_jax_params(model, _numpy_tree(holder.dit_params))
    return holder.dit_params, jcfg, model, cfg


@pytest.mark.parametrize("hit", [False, True])
def test_forward_sp_tokens_head_dim_128_matches_jax(video_pair, hit):
    """The video request's 48 tokens: SP-1 over all of them, or a §11
    hit on rank 1 of SP-2 (24 fresh tokens at offset 24), through JAX's
    Pallas kernels in interpret mode and the port's kernel wrappers."""
    jparams, jcfg, model, cfg = video_pair
    rng = np.random.default_rng(11)
    n_total = dit.token_count(cfg, *[VIDEO_REQ[k] for k in
                                     ("height", "width", "frames")])
    off, n_loc = (24, 24) if hit else (0, n_total)
    patch_dim = cfg.dit.patch_size ** 2 * cfg.dit.in_channels
    tok = rng.standard_normal((1, n_loc, patch_dim)).astype(np.float32)
    txt = rng.standard_normal((1, 77, cfg.dit.cond_dim)).astype(np.float32)
    t = np.array([700.0], np.float32)
    kv_shape = (1, n_total, cfg.num_kv_heads, cfg.head_dim)
    stale = {i: [rng.standard_normal(kv_shape).astype(np.float32)
                 for _ in range(2)] for i in range(cfg.num_layers)}

    def jax_gather(k, v, layer):
        if not hit:
            return k, v
        K, V = (jnp.asarray(a) for a in stale[layer])
        return jops.SplicedKV(K, V, k, v, off)

    def torch_gather(k, v, layer):
        if not hit:
            return k, v
        K, V = (torch.from_numpy(a) for a in stale[layer])
        return ops.SplicedKV(K, V, k, v, off)
    want = jdit.forward_sp_tokens(jparams, jnp.asarray(tok), jnp.asarray(t),
                                  jnp.asarray(txt), jcfg, pos_offset=off,
                                  n_total=n_total, kv_gather=jax_gather)
    with torch.inference_mode():
        got = dit.forward_sp_tokens(model, torch.from_numpy(tok),
                                    torch.from_numpy(t),
                                    torch.from_numpy(txt), cfg,
                                    pos_offset=off, n_total=n_total,
                                    kv_gather=torch_gather)
    assert np.abs(np.asarray(want)).max() > 0       # livened gates
    _close(got, want)


# ---------------------------------------------------------------------------
# the positional embedding at video positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_tokens", [20280, 75600])   # video S and L
def test_pos_embedding_at_video_positions(n_tokens):
    """``pos_embedding(n, 3072)`` against JAX's at the video token counts.

    The cause of the difference: the frequencies ``exp(-log(1e4) k/half)``
    come from two ``exp`` implementations (torch's and XLA's), which
    differ by one ulp on 141 of DIT_VIDEO's 1536 entries; neither is
    correctly rounded.  The phase ``pos * freq`` carries that ulp times
    the position, so after rounding to fp32 the two phases differ by up
    to an ulp of the phase, which is an ulp of the position: 2^-9 at
    20,280 and 2^-7 at 75,600.  Tolerance, max abs: two fp32 ulps of the
    token count (3.9e-3 at 20,280, 1.6e-2 at 75,600); measured 1.95e-3
    and 7.8e-3 max abs, 6.1e-5 and 2.3e-4 rel-L2.  With JAX's
    frequencies substituted the embeddings differ by at most one ulp of
    a value below 1 (2^-24; torch's and XLA's cos/sin differ there),
    which the test checks as well: the frequencies are the whole cause.
    """
    d = DIT_VIDEO.d_model
    half = d // 2
    want = np.asarray(jdit.pos_embedding(n_tokens, d))
    got = dit.pos_embedding(n_tokens, d).numpy()
    assert got.shape == want.shape == (n_tokens, d)
    err = np.abs(got - want).max()
    assert err <= 2 * np.spacing(np.float32(n_tokens)), err
    assert err > 0       # the two exps do differ at this width
    del got
    freqs = np.asarray(jnp.exp(-np.log(10000.0)
                               * jnp.arange(half, dtype=jnp.float32) / half))
    args = (torch.arange(n_tokens, dtype=torch.float32)[:, None]
            * torch.from_numpy(freqs.copy())[None])
    for part, fn in ((slice(0, half), torch.cos), (slice(half, d),
                                                   torch.sin)):
        diff = np.abs(fn(args).numpy() - want[:, part]).max()
        assert diff <= 2.0 ** -24, diff
