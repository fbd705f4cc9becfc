"""The port's Mamba2 path against the JAX package's on the same weights.

The SSD plain version (the kernel's CPU version, a sequential recurrence)
is held to the JAX oracle and to the interpret-mode Pallas kernel, and
``mamba2-1.3b.reduced()`` (livened ``A_log``/``dt_bias``, see
:func:`_liven`) runs in both frameworks from one JAX parameter tree on
the CPU, in fp32.  The port's chunked path is its sequential plain
version here, the JAX model's is the chunked jnp ``ssd_chunked``: two
summation orders over up to 40 steps, so blocks and logits are held to
1e-4 of the largest reference value (the JAX package's own kernel vs
sequential bound, ``tests/test_kernels.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd import ssd_scan  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.convert import load_jax_params  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import get_model, ssm  # noqa: E402
from repro_torch.serving import serve_loop  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401

TOL = 1e-4
CFG = get_config("mamba2-1.3b").reduced()
JCFG = jax_get_config("mamba2-1.3b").reduced()


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _liven(tree, seed=0):
    """Mamba2's published initialisation of A and dt (state-spaces/mamba,
    ``mamba2.py``): dt log-uniform in [1e-3, 1e-1] through the inverse
    softplus in ``dt_bias``, A = -U[1, 16] through ``A_log``.  With the
    JAX init (both zero) every head decays alike and the carried state
    underflows within a chunk."""
    rng = np.random.default_rng(seed)
    shape = np.shape(tree["blocks"]["A_log"])
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), shape))
    tree["blocks"]["dt_bias"] = (dt + np.log(-np.expm1(-dt))).astype(
        np.float32)
    tree["blocks"]["A_log"] = np.log(rng.uniform(1, 16, shape)).astype(
        np.float32)
    return tree


@pytest.fixture(scope="module")
def mamba_pair():
    """A livened JAX Mamba2 tree and the port's Mamba2 holding it."""
    params, _ = jL.split_params(jssm.init(jax.random.PRNGKey(0), JCFG))
    tree = _liven(jax.tree.map(np.asarray, params))
    model = ssm.Mamba2(CFG, device="cpu")
    load_jax_params(model, tree)
    return jax.tree.map(jnp.asarray, tree), model


def _ssd_inputs(seed, b, l, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32)
    C = rng.standard_normal((b, l, n)).astype(np.float32)
    return x, dt, A, B, C


# ---------------------------------------------------------------------------
# the SSD plain version (K4's CPU version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (1, 128, 2, 16, 16, 32),
    (2, 256, 4, 32, 16, 64),
    (1, 256, 2, 64, 32, 128),
])
def test_ssd_ref_matches_jax_oracle_and_kernel(b, l, h, p, n, chunk):
    inputs = _ssd_inputs(l + p, b, l, h, p, n)
    y, st = ops.ssd(*_t(*inputs), chunk=chunk)
    assert y.dtype == torch.float32 and st.shape == (b, h, p, n)
    yr, sr = jref.ssd_ref(*_j(*inputs))
    _close(y, yr, 1e-5)
    _close(st, sr, 1e-5)
    yk, sk = ssd_scan(*_j(*inputs), chunk=chunk)
    _close(y, yk)
    _close(st, sk)


def test_ssd_wrapper_takes_a_ragged_length():
    """l = 40 with chunk 16: the CPU version runs the recurrence over the
    40 steps, which is what the kernel's masked last chunk computes."""
    inputs = _ssd_inputs(5, 2, 40, 4, 16, 16)
    y, st = ops.ssd(*_t(*inputs), chunk=16)
    yr, sr = jref.ssd_ref(*_j(*inputs))
    _close(y, yr, 1e-5)
    _close(st, sr, 1e-5)


def test_published_a_dt_init_draws_in_mamba2_ranges():
    """``init_published_a_dt`` redraws every block's dt (through softplus
    of ``dt_bias``) log-uniform in [1e-3, 1e-1] and A in [-16, -1], the
    same for the same seed."""
    models = [ssm.Mamba2(CFG, device="cpu") for _ in range(2)]
    for m in models:
        ssm.init_published_a_dt(m, seed=7)
    for blk, twin in zip(models[0].blocks, models[1].blocks):
        dt = torch.nn.functional.softplus(blk.dt_bias.double())
        A = -torch.exp(blk.A_log.double())
        assert ((dt >= 1e-3 * (1 - 1e-5)) & (dt <= 1e-1 * (1 + 1e-5))).all()
        assert ((A >= -16) & (A <= -1)).all() and A.std() > 0
        assert torch.equal(blk.dt_bias, twin.dt_bias)
        assert torch.equal(blk.A_log, twin.A_log)


def test_ssd_ref_keeps_x_dtype_and_fp32_state():
    x, dt, A, B, C = _t(*_ssd_inputs(3, 1, 16, 2, 16, 16))
    y, st = ref.ssd_ref(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16())
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32


# ---------------------------------------------------------------------------
# the Mamba2 block and LM against JAX
# ---------------------------------------------------------------------------

def _block_params(tree, i):
    return jax.tree.map(lambda a: a[i], tree["blocks"])


@pytest.mark.parametrize("l", [12, 40])
def test_ssd_block_apply_without_cache_matches_jax(mamba_pair, l):
    tree, model = mamba_pair
    x = np.random.default_rng(l).standard_normal(
        (2, l, CFG.d_model)).astype(np.float32)
    want, _ = jssm.ssd_block_apply(_block_params(tree, 1), jnp.asarray(x),
                                   JCFG)
    with torch.inference_mode():
        got, cache = ssm.ssd_block_apply(model.blocks[1],
                                         torch.from_numpy(x), CFG)
    assert cache is None
    _close(got, want)


def test_ssd_block_apply_with_cache_matches_jax(mamba_pair):
    """A 40-token prefill into a fresh cache, then one decode token: the
    outputs and every cache entry agree."""
    tree, model = mamba_pair
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 40, CFG.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, CFG.d_model)).astype(np.float32)
    jp = _block_params(tree, 0)
    jc = jssm.ssd_block_cache(JCFG, 2, dtype=jnp.float32)
    tc = ssm.ssd_block_cache(CFG, 2, dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        for xin in (x, x1):
            want, jc = jssm.ssd_block_apply(jp, jnp.asarray(xin), JCFG,
                                            cache=jc)
            got, tc = ssm.ssd_block_apply(model.blocks[0],
                                          torch.from_numpy(xin), CFG,
                                          cache=tc)
            _close(got, want)
            for key in ("conv", "state"):
                _close(tc[key], jc[key])
            np.testing.assert_array_equal(tc["len"].numpy(), jc["len"])


def test_forward_prefill_and_decode_match_jax(mamba_pair):
    tree, model = mamba_pair
    toks = np.random.default_rng(4).integers(0, CFG.vocab_size, (2, 20))
    want, _ = jssm.forward(tree, jnp.asarray(toks), JCFG, dtype=jnp.float32)
    jc = jssm.init_cache(JCFG, 2, 64, dtype=jnp.float32)
    jlg, jc = jssm.prefill(tree, jnp.asarray(toks[:, :16]), jc, JCFG,
                           dtype=jnp.float32)
    jsteps = []
    for i in range(16, 20):
        lg, jc = jssm.decode_step(tree, jnp.asarray(toks[:, i:i + 1]), jc,
                                  jnp.array([i, i]), JCFG, dtype=jnp.float32)
        jsteps.append(lg)
    with torch.inference_mode():
        got, aux = ssm.forward(model, torch.from_numpy(toks), CFG,
                               dtype=torch.float32)
        cache = ssm.init_cache(CFG, 2, 64, dtype=torch.float32, device="cpu")
        lg, cache = ssm.prefill(model, torch.from_numpy(toks[:, :16]), cache,
                                CFG, dtype=torch.float32)
        steps = []
        for i in range(16, 20):
            out, cache = ssm.decode_step(
                model, torch.from_numpy(toks[:, i:i + 1]), cache,
                torch.tensor([i, i]), CFG, dtype=torch.float32)
            steps.append(out)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want)
    _close(lg, jlg)
    for out, jout in zip(steps, jsteps):
        _close(out, jout)
    assert cache["blocks"]["state"].shape == (
        CFG.num_layers, 2, *ssm.ssm_dims(CFG)[1:2], CFG.ssm.head_dim,
        CFG.ssm.state_dim)


def test_prefill_then_decode_matches_teacher_forced_forward(mamba_pair):
    """The port against itself, through the serve-loop steps: prefill 8
    tokens, decode 4, each logit within 5e-4 of the forward's (as
    ``tests/test_arch_smoke.py`` holds the JAX package)."""
    _, model = mamba_pair
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 12)))
    prefill = serve_loop.make_prefill_step(CFG, dtype=torch.float32)
    step = serve_loop.make_serve_step(CFG, dtype=torch.float32)
    with torch.inference_mode():
        full, _ = ssm.forward(model, toks, CFG, dtype=torch.float32)
    cache = ssm.init_cache(CFG, 2, 64, dtype=torch.float32, device="cpu")
    lg, cache = prefill(model, toks[:, :8], cache)
    errs = [(lg[:, 0] - full[:, 7]).abs().max().item()]
    for i in range(8, 12):
        lg, cache = step(model, toks[:, i:i + 1], cache,
                         torch.tensor([i, i]))
        errs.append((lg[:, 0] - full[:, i]).abs().max().item())
    assert max(errs) < 5e-4, errs


def test_bf16_default_runs_and_keeps_fp32_logits_and_state(mamba_pair):
    _, model = mamba_pair
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, CFG.vocab_size, (1, 18)))
    cache = ssm.init_cache(CFG, 1, device="cpu")
    lg, cache = serve_loop.make_prefill_step(CFG)(model, toks, cache)
    lg2, cache = serve_loop.make_serve_step(CFG)(
        model, lg.argmax(-1), cache, torch.tensor([18]))
    assert lg.dtype == lg2.dtype == torch.float32
    assert lg2.shape == (1, 1, CFG.vocab_size)
    assert torch.isfinite(lg2).all()
    assert cache["blocks"]["conv"].dtype == torch.bfloat16
    assert cache["blocks"]["state"].dtype == torch.float32
    assert cache["blocks"]["len"].tolist() == [[19]] * CFG.num_layers


# ---------------------------------------------------------------------------
# conversion, configs and dispatch
# ---------------------------------------------------------------------------

def test_load_jax_params_loads_the_ssm_init_tree(mamba_pair):
    tree, model = mamba_pair
    names = dict(model.named_parameters())
    assert {"embed.tok", "embed.unembed", "ln_final", "blocks.1.A_log",
            "blocks.0.in_proj"} <= set(names)
    np.testing.assert_array_equal(names["blocks.1.dt_bias"].numpy(),
                                  np.asarray(tree["blocks"]["dt_bias"][1]))
    np.testing.assert_array_equal(names["embed.unembed"].numpy(),
                                  np.asarray(tree["embed"]["unembed"]))
    assert isinstance(model.ln_final, torch.nn.Parameter)
    assert isinstance(model.blocks[0].norm, torch.nn.Parameter)


def test_configs_are_the_jax_packages():
    from repro.configs import list_archs as jax_list_archs
    assert list_archs() == jax_list_archs()
    for name in list_archs():
        assert repr(get_config(name)) == repr(jax_get_config(name))


@pytest.mark.parametrize("arch", ["dit-image"])
def test_families_not_yet_ported_raise(arch):
    """Every family is ported now: ``get_model`` returns the DiT module
    (``dit.forward``, the trainer's); the DiT has no prefill or decode
    step, so the serve-loop factories refuse it."""
    from repro_torch.models import dit
    cfg = get_config(arch)
    assert get_model(cfg) is dit
    for make in (serve_loop.make_prefill_step, serve_loop.make_serve_step):
        with pytest.raises(ValueError, match="no prefill or decode step"):
            make(cfg)
    assert get_model(CFG) is ssm
