"""The port's models against the JAX package's on the same weights.

JAX parameter trees at ``DIT_IMAGE.reduced()`` are converted into the
port's modules (``repro_torch.convert``) and both frameworks run the same
numpy inputs on the CPU.  The JAX side runs its default (non-kernel)
path; the port always runs its kernel-shaped path, whose CPU versions
compute the same function.  Tolerance, per op and for the whole forward:
max abs error over max abs reference <= 1e-5 in fp32.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.dit_models import DIT_IMAGE as JAX_DIT_IMAGE  # noqa: E402
from repro.models import dit as jdit  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import text_encoder as jte  # noqa: E402
from repro.models import vae as jvae  # noqa: E402
from repro.serving.cache_demo import _liven  # noqa: E402
from repro_torch.configs.dit_models import DIT_IMAGE  # noqa: E402
from repro_torch.convert import load_jax_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import dit, text_encoder, vae  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

TOL = 1e-5
CFG = DIT_IMAGE.reduced()
JCFG = JAX_DIT_IMAGE.reduced()
GEN = torch.Generator().manual_seed(0)


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def dit_pair():
    """JAX DiT params with livened adaLN gates, and the port's DiT
    holding the same values."""
    params, _ = jL.split_params(jdit.init(jax.random.PRNGKey(0), JCFG))
    holder = types.SimpleNamespace(dit_params=params)
    _liven(holder)
    model = dit.DiT(CFG, generator=GEN, device="cpu")
    load_jax_params(model, _numpy_tree(holder.dit_params))
    return holder.dit_params, model


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_and_sdpa_match_jax():
    """rmsnorm and rope, and the port's attention (its kernel wrapper,
    which stands in for the JAX package's ``sdpa`` everywhere) against
    JAX's ``sdpa``, with GQA."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    pos = np.arange(9)[None]
    _close(L.rmsnorm(torch.from_numpy(w), torch.from_numpy(x)),
           jL.rmsnorm(jnp.asarray(w), jnp.asarray(x)))
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)),
           jL.apply_rope(jnp.asarray(x), jnp.asarray(pos)))
    k = rng.standard_normal((2, 9, 2, 32)).astype(np.float32)
    for causal in (False, True):
        _close(ops.attention(torch.from_numpy(x), torch.from_numpy(k),
                             torch.from_numpy(k), causal=causal),
               jL.sdpa(jnp.asarray(x), jnp.asarray(k), jnp.asarray(k),
                       causal=causal))


def test_patchify_roundtrip_matches_jax():
    lat = np.random.default_rng(1).standard_normal(
        (1, 1, 8, 8, 16)).astype(np.float32)
    tok = dit.patchify(torch.from_numpy(lat), 2)
    _close(tok, jdit.patchify(jnp.asarray(lat), 2))
    _close(dit.unpatchify(tok, lat.shape, 2), lat)


@pytest.mark.parametrize("t,tol", [
    (3.5, TOL), (90.0, TOL),
    # cos/sin of an fp32 phase near 1000 rad: one ulp of difference in a
    # frequency (the two frameworks' exp) moves the phase by ~1000 * 6e-8,
    # so the bound at t=999 is ~6e-5 whatever the implementation
    (999.0, 1e-4),
])
def test_embeddings_match_jax(t, tol):
    t = np.array([t], np.float32)
    _close(dit.timestep_embedding(torch.from_numpy(t), 256),
           jdit.timestep_embedding(jnp.asarray(t), 256), tol)
    _close(dit.pos_embedding(64, 128), jdit.pos_embedding(64, 128))


# ---------------------------------------------------------------------------
# DiT forward_sp_tokens
# ---------------------------------------------------------------------------

def _dit_inputs(seed, n_local, batch=1):
    rng = np.random.default_rng(seed)
    patch_dim = CFG.dit.patch_size ** 2 * CFG.dit.in_channels
    tok = rng.standard_normal((batch, n_local, patch_dim)).astype(np.float32)
    txt = rng.standard_normal((batch, 77, CFG.dit.cond_dim)) \
        .astype(np.float32)
    t = np.linspace(990.0, 400.0, batch).astype(np.float32)
    return rng, tok, txt, t


@pytest.mark.parametrize("batch", [1, 2])
def test_forward_sp_tokens_sp1_matches_jax(dit_pair, batch):
    jparams, model = dit_pair
    _, tok, txt, t = _dit_inputs(batch, 64, batch)

    def ident(k, v, layer):
        return k, v
    want = jdit.forward_sp_tokens(jparams, jnp.asarray(tok), jnp.asarray(t),
                                  jnp.asarray(txt), JCFG, pos_offset=0,
                                  n_total=64, kv_gather=ident)
    with torch.inference_mode():
        got = dit.forward_sp_tokens(model, torch.from_numpy(tok),
                                    torch.from_numpy(t),
                                    torch.from_numpy(txt), CFG, pos_offset=0,
                                    n_total=64, kv_gather=ident)
    assert np.abs(np.asarray(want)).max() > 0       # livened gates
    _close(got, want)


def test_forward_sp_tokens_cache_hit_matches_jax(dit_pair):
    """A §11 hit on rank 1 of SP-2: the port attends over a SplicedKV
    (the splice kernel's path), JAX over the materialized splice."""
    jparams, model = dit_pair
    rng, tok, txt, t = _dit_inputs(7, 32)
    off, n_total = 32, 64
    kv_shape = (1, n_total, CFG.num_kv_heads, CFG.head_dim)
    stale = {i: (rng.standard_normal(kv_shape).astype(np.float32),
                 rng.standard_normal(kv_shape).astype(np.float32))
             for i in range(CFG.num_layers)}

    def jax_hit(k, v, layer):
        K, V = (a.copy() for a in stale[layer])
        K[:, off:off + 32] = np.asarray(k)
        V[:, off:off + 32] = np.asarray(v)
        return jnp.asarray(K), jnp.asarray(V)

    def torch_hit(k, v, layer):
        K, V = (torch.from_numpy(a) for a in stale[layer])
        return ops.SplicedKV(K, V, k, v, off)
    want = jdit.forward_sp_tokens(jparams, jnp.asarray(tok), jnp.asarray(t),
                                  jnp.asarray(txt), JCFG, pos_offset=off,
                                  n_total=n_total, kv_gather=jax_hit)
    with torch.inference_mode():
        got = dit.forward_sp_tokens(model, torch.from_numpy(tok),
                                    torch.from_numpy(t),
                                    torch.from_numpy(txt), CFG,
                                    pos_offset=off, n_total=n_total,
                                    kv_gather=torch_hit)
    _close(got, want)


# ---------------------------------------------------------------------------
# text encoder and VAE
# ---------------------------------------------------------------------------

def test_text_encoder_matches_jax():
    # the text encoder config DiTPipeline builds (pipeline.py:43-46)
    tcfg = text_encoder.encoder_config(CFG.dit.cond_dim, vocab=512).reduced(
        d_model=CFG.dit.cond_dim, num_heads=4, num_kv_heads=4,
        head_dim=CFG.dit.cond_dim // 4, d_ff=CFG.dit.cond_dim * 2)
    jtcfg = jte.encoder_config(JCFG.dit.cond_dim, vocab=512).reduced(
        d_model=JCFG.dit.cond_dim, num_heads=4, num_kv_heads=4,
        head_dim=JCFG.dit.cond_dim // 4, d_ff=JCFG.dit.cond_dim * 2)
    params, _ = jL.split_params(jte.init(jax.random.PRNGKey(1), jtcfg))
    model = text_encoder.TextEncoder(tcfg, generator=GEN, device="cpu")
    load_jax_params(model, _numpy_tree(params))
    toks = np.random.default_rng(2).integers(0, 512, (2, 77))
    want = jte.encode(params, jnp.asarray(toks), jtcfg, dtype=jnp.float32)
    with torch.inference_mode():
        got = text_encoder.encode(model, torch.from_numpy(toks), tcfg,
                                  dtype=torch.float32)
    _close(got, want)


def test_vae_decode_matches_jax():
    params, _ = jL.split_params(jvae.init(jax.random.PRNGKey(2), JCFG,
                                          hidden=32))
    model = vae.VAE(CFG, hidden=32, generator=GEN, device="cpu")
    load_jax_params(model, _numpy_tree(params))
    lat = np.random.default_rng(3).standard_normal(
        (1, 1, 8, 8, CFG.dit.in_channels)).astype(np.float32)
    want = jvae.decode(params, jnp.asarray(lat), JCFG)
    with torch.inference_mode():
        got = vae.decode(model, torch.from_numpy(lat), CFG)
    _close(got, want)


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def test_load_jax_params_rejects_mismatched_trees():
    model = vae.VAE(CFG, hidden=32, generator=GEN, device="cpu")
    params, _ = jL.split_params(jvae.init(jax.random.PRNGKey(2), JCFG,
                                          hidden=32))
    tree = _numpy_tree(params)
    with pytest.raises(KeyError, match="no JAX leaf"):
        load_jax_params(model, {k: v for k, v in tree.items()
                                if k != "up3"})
    with pytest.raises(KeyError, match="no parameter"):
        load_jax_params(model, dict(tree, extra=np.zeros(3)))
    with pytest.raises(ValueError, match="JAX shape"):
        load_jax_params(model, dict(tree, up3=np.zeros((3, 3))))
