"""The port's MoE, MLA and encoder-decoder LM families against the JAX
package's, on the CPU, in fp32, from one JAX parameter tree
(``repro_torch.convert.load_jax_params``), at ``.reduced()``:
``mixtral-8x7b`` (SWA + MoE), ``deepseek-v2-236b`` (MLA, one dense
prefix layer and MoE layers with a shared expert; at three layers, so the
stacked cache holds two super-blocks; also with ``q_lora_rank`` = 24,
which ``.reduced()`` turns off, so ``w_dq``/``q_norm`` run) and
``whisper-medium`` (encoder, decoder, cross-attention).

* Forward logits against JAX's: max abs error over max abs reference
  <= 1e-5; the MoE's load-balance loss <= 1e-6.
* Prefill of 8 tokens + 4 decode steps through the serve-loop steps
  against the port's forward: < 5e-4 (the JAX package's rule,
  ``tests/test_arch_smoke.py``).
* MLA's absorbed decode against the naive one: <= 1e-5.
* Whisper's cross cache after a prefill, and its prefill + decode
  logits, against JAX's: <= 1e-5.
* ``moe_apply`` alone against JAX's, 1e-5: with drops (a group routes
  more than 4096 copies, so the capacity is the factor's share and the
  ``keep`` masks must agree), with two tied router columns (the expert
  picks must be ``jax.lax.top_k``'s) and with two groups.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import load_jax_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import encdec, get_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import serve_loop  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401

TOL = 1e-5
AUX_TOL = 1e-6
DECODE_TOL = 5e-4


def _q_lora(cfg):
    return cfg.with_(mla=dataclasses.replace(cfg.mla, q_lora_rank=24))


#: case -> (arch, .reduced() overrides, a further change of the config)
CASES = {
    "mixtral-8x7b": ("mixtral-8x7b", {}, None),
    "deepseek-v2-236b": ("deepseek-v2-236b", {"num_layers": 3}, None),
    "deepseek-v2-236b-q_lora": ("deepseek-v2-236b", {"num_layers": 3},
                                _q_lora),
    "whisper-medium": ("whisper-medium", {}, None),
}
MLA_CASES = ["deepseek-v2-236b", "deepseek-v2-236b-q_lora"]
MOE_CASES = ["mixtral-8x7b", "deepseek-v2-236b", "deepseek-v2-236b-q_lora"]


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _configs(case):
    arch, overrides, tweak = CASES[case]
    jcfg = jax_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    if tweak is not None:
        jcfg, cfg = tweak(jcfg), tweak(cfg)
    return jcfg, cfg


def _pair(case):
    """The JAX params of the case (numpy leaves), the port's model holding
    them, and both configs."""
    jcfg, cfg = _configs(case)
    params, _ = jL.split_params(
        jax_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg))
    tree = jax.tree.map(np.asarray, params)
    model = get_model(cfg).init(cfg, device="cpu")
    load_jax_params(model, tree)
    return tree, model, jcfg, cfg


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, n))


def _extra(cfg, seed=1):
    """Whisper's stub frame embeddings (numpy), else nothing."""
    if cfg.family != "encdec":
        return ()
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, cfg.frontend_seq, cfg.d_model))
            .astype(np.float32),)


def _jit(fn):
    return jax.jit(fn, static_argnames=("cfg", "dtype"))


def _port_forward(model, cfg, toks, extra):
    with torch.inference_mode():
        return get_model(cfg).forward(
            model, torch.from_numpy(toks), *map(torch.from_numpy, extra),
            cfg, dtype=torch.float32)


def _port_prefill_decode(model, cfg, toks, n_prefill, extra, *,
                         mla_absorbed=False, max_len=32):
    """Logits (2, 1 + decode steps, V) of a prefill then teacher-forced
    decode steps through the serve-loop steps, and the final cache."""
    prefill = serve_loop.make_prefill_step(cfg, dtype=torch.float32)
    step = serve_loop.make_serve_step(cfg, dtype=torch.float32,
                                      mla_absorbed=mla_absorbed)
    cache = get_model(cfg).init_cache(cfg, 2, max_len, dtype=torch.float32,
                                      device="cpu")
    lg, cache = prefill(model, torch.from_numpy(toks[:, :n_prefill]),
                        *map(torch.from_numpy, extra), cache)
    out = [lg[:, 0]]
    for i in range(n_prefill, toks.shape[1]):
        lg, cache = step(model, torch.from_numpy(toks[:, i:i + 1]), cache,
                         torch.tensor([i, i]))
        out.append(lg[:, 0])
    return torch.stack(out, 1), cache


def _jax_prefill_decode(tree, jcfg, toks, n_prefill, extra, max_len=32):
    model = jax_get_model(jcfg)
    cache = model.init_cache(jcfg, 2, max_len, dtype=jnp.float32)
    lg, cache = _jit(model.prefill)(tree, jnp.asarray(toks[:, :n_prefill]),
                                    *map(jnp.asarray, extra), cache, jcfg,
                                    dtype=jnp.float32)
    out = [np.asarray(lg[:, 0])]
    step = _jit(model.decode_step)
    for i in range(n_prefill, toks.shape[1]):
        lg, cache = step(tree, jnp.asarray(toks[:, i:i + 1]), cache,
                         jnp.array([i, i]), jcfg, dtype=jnp.float32)
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, 1), cache


# ---------------------------------------------------------------------------
# the reduced configurations, end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(CASES))
def case_run(request):
    """The pair and both forwards over 16 tokens (JAX's once, jitted)."""
    tree, model, jcfg, cfg = _pair(request.param)
    toks, extra = _tokens(cfg, 16), _extra(cfg)
    want, want_aux = _jit(jax_get_model(jcfg).forward)(
        tree, jnp.asarray(toks), *map(jnp.asarray, extra), jcfg,
        dtype=jnp.float32)
    got, got_aux = _port_forward(model, cfg, toks, extra)
    return dict(case=request.param, tree=tree, model=model, jcfg=jcfg,
                cfg=cfg, want=np.asarray(want), want_aux=float(want_aux),
                got=got, got_aux=got_aux.item())


def test_forward_matches_jax(case_run):
    assert case_run["got"].dtype == torch.float32
    _close(case_run["got"], case_run["want"])


def test_aux_loss_matches_jax(case_run):
    """The load-balance loss summed over the MoE layers (zero without
    them, in both packages)."""
    got, want = case_run["got_aux"], case_run["want_aux"]
    assert abs(got - want) <= AUX_TOL, (got, want)
    assert (want > 0) == (case_run["case"] in MOE_CASES)


def test_prefill_then_decode_matches_the_forward(case_run):
    """Prefill 8 tokens, decode 4 (teacher-forced): each step's logits
    within 5e-4 of the forward's at the same position."""
    model, cfg = case_run["model"], case_run["cfg"]
    toks, extra = _tokens(cfg, 12, seed=1), _extra(cfg)
    full, _ = _port_forward(model, cfg, toks, extra)
    steps, _ = _port_prefill_decode(model, cfg, toks, 8, extra)
    err = (steps - full[:, 7:12]).abs().max().item()
    assert err < DECODE_TOL, err


@pytest.mark.parametrize("case", MLA_CASES)
def test_mla_absorbed_decode_matches_naive(case):
    """The absorbed decode scores q·w_uk against concat(latent, rope key)
    as one product; its logits are the naive decode's within 1e-5, and
    so is its latent cache (later layers' rows follow the earlier layers'
    outputs)."""
    _, model, _, cfg = _pair(case)
    toks = _tokens(cfg, 14, seed=2)
    naive, nc = _port_prefill_decode(model, cfg, toks, 8, ())
    absorbed, ac = _port_prefill_decode(model, cfg, toks, 8, (),
                                        mla_absorbed=True)
    _close(absorbed, naive)
    for key in ("c", "kr"):
        _close(ac["blocks"]["pos0"][key], nc["blocks"]["pos0"][key])
    np.testing.assert_array_equal(ac["blocks"]["pos0"]["len"].numpy(),
                                  nc["blocks"]["pos0"]["len"].numpy())


def test_mla_decode_matches_jax_and_keeps_the_latent_cache():
    """deepseek (q_lora) prefill + decode, naive and absorbed, against
    JAX's naive steps; the cache holds the latent ``c`` and the rope key
    ``kr`` for the dense prefix layer and each of the two super-blocks,
    equal to JAX's."""
    tree, model, jcfg, cfg = _pair("deepseek-v2-236b-q_lora")
    assert T._stack_plan(cfg)["n_super"] == 2 and hasattr(model, "dense_0")
    assert hasattr(model.dense_0, "mlp") and hasattr(model.blocks[1].pos0,
                                                     "moe")
    toks = _tokens(cfg, 12, seed=3)
    jsteps, jcache = _jax_prefill_decode(tree, jcfg, toks, 8, ())
    for absorbed in (False, True):
        steps, cache = _port_prefill_decode(model, cfg, toks, 8, (),
                                            mla_absorbed=absorbed)
        _close(steps, jsteps)
    m = cfg.mla
    assert cache["blocks"]["pos0"]["c"].shape == (2, 2, 32, m.kv_lora_rank)
    assert cache["blocks"]["pos0"]["kr"].shape == (2, 2, 32, 1,
                                                   m.qk_rope_head_dim)
    for key in ("c", "kr"):
        _close(cache["dense_0"][key], jcache["dense_0"][key])
        _close(cache["blocks"]["pos0"][key], jcache["blocks"]["pos0"][key])
    np.testing.assert_array_equal(cache["blocks"]["pos0"]["len"].numpy(),
                                  [[12, 12]] * 2)


def test_whisper_cross_cache_and_decode_match_jax():
    """The prefill computes each decoder layer's cross K/V from the
    encoder output into the cache's ``frontend_seq`` rows (JAX's within
    1e-5); the decode steps read them; logits against JAX's steps."""
    tree, model, jcfg, cfg = _pair("whisper-medium")
    toks, extra = _tokens(cfg, 12, seed=4), _extra(cfg, seed=5)
    jsteps, jcache = _jax_prefill_decode(tree, jcfg, toks, 8, extra)
    steps, cache = _port_prefill_decode(model, cfg, toks, 8, extra)
    _close(steps, jsteps)
    shape = (cfg.num_layers, 2, cfg.frontend_seq, cfg.num_kv_heads,
             cfg.head_dim)
    for key in ("k", "v"):
        assert cache["cross"][key].shape == shape
        _close(cache["cross"][key], jcache["cross"][key])
        _close(cache["self"][key], jcache["self"][key])
    np.testing.assert_array_equal(cache["self"]["len"].numpy(),
                                  np.asarray(jcache["self"]["len"]))


def _count_attention(fn):
    """Calls of the flash-attention wrapper (the launches a card run
    counts) while ``fn`` runs."""
    calls, real = [0], ops.attention

    def counting(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "attention", counting)
        fn()
    return calls[0]


def test_attention_kernel_calls_per_family():
    """Whisper reaches K2 in the encoder, every cross-attention and the
    forward's decoder self-attention: per layer a forward calls it 3
    times, a prefill 2 (encoder + cross), a decode step once.  Mixtral's
    SWA and DeepSeek's MLA call it never."""
    _, model, _, cfg = _pair("whisper-medium")
    n = cfg.num_layers
    assert cfg.num_encoder_layers == n
    toks, extra = _tokens(cfg, 6), _extra(cfg)
    x = tuple(map(torch.from_numpy, extra))
    cache = encdec.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
    prefill = serve_loop.make_prefill_step(cfg, dtype=torch.float32)
    step = serve_loop.make_serve_step(cfg, dtype=torch.float32)
    t = torch.from_numpy(toks)
    assert _count_attention(
        lambda: _port_forward(model, cfg, toks, extra)) == 3 * n
    assert _count_attention(
        lambda: prefill(model, t[:, :5], *x, cache)) == 2 * n
    assert _count_attention(
        lambda: step(model, t[:, 5:], cache, torch.tensor([5, 5]))) == n
    for case in ("mixtral-8x7b", "deepseek-v2-236b"):
        _, m, _, c = _pair(case)
        assert _count_attention(
            lambda: _port_forward(m, c, _tokens(c, 6), ())) == 0


@pytest.mark.parametrize("arch,module", [
    ("mixtral-8x7b", T), ("deepseek-v2-236b", T), ("whisper-medium", encdec)])
def test_get_model_and_serve_steps_take_the_family(arch, module):
    cfg = get_config(arch)
    assert get_model(cfg) is module
    assert callable(serve_loop.make_prefill_step(cfg))
    assert callable(serve_loop.make_serve_step(cfg, mla_absorbed=True))


# ---------------------------------------------------------------------------
# moe_apply alone: drops, ties, groups
# ---------------------------------------------------------------------------

def _moe_pair(num_groups=1, tie=None, seed=0):
    """A reduced mixtral MoE layer in both packages (JAX's init), with
    router column ``tie[1]`` set equal to column ``tie[0]``."""
    jcfg, cfg = (c.with_(moe=dataclasses.replace(c.moe,
                                                  num_groups=num_groups))
                 for c in _configs("mixtral-8x7b"))
    p, _ = jL.split_params(jL.moe_init(jax.random.PRNGKey(seed), jcfg))
    p = jax.tree.map(np.array, p)
    if tie is not None:
        p["router"][:, tie[1]] = p["router"][:, tie[0]]
    layer = L.MoE(cfg, generator=None, device="cpu")
    load_jax_params(layer, p)
    return p, layer, jcfg, cfg


def _jax_routing(p, x, jcfg):
    """JAX's expert picks and capacity mask for x (B, S, d), by the
    reference's own ops and slot rule (``layers.moe_apply``)."""
    m = jcfg.moe
    t = x.shape[0] * x.shape[1]
    n_g = max(1, min(m.num_groups, t))
    tg = t // n_g
    logits = jnp.einsum("gtd,de->gte", jnp.asarray(x).reshape(n_g, tg, -1),
                        jnp.asarray(p["router"]))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, gate_i = jax.lax.top_k(probs, m.top_k)
    gate_i = np.asarray(gate_i)
    flat = gate_i.reshape(n_g, -1)
    onehot = np.eye(m.num_experts, dtype=np.int64)[flat]
    slot = np.take_along_axis(np.cumsum(onehot, 1) - onehot, flat[..., None],
                              2)[..., 0]
    cap = tg * m.top_k if tg * m.top_k <= 4096 else int(max(4, round(
        tg * m.top_k / m.num_experts * m.capacity_factor)))
    return np.asarray(probs), gate_i, slot < cap


@pytest.mark.parametrize("label,shape,groups,tie", [
    # 2 x 1100 tokens route 4400 copies: capacity round(1375.0) = 1375 a
    # expert; the tokens lean to expert 0, which overflows
    ("drops", (2, 1100), 1, None),
    # columns 1 and 2 equal: their probabilities tie on every token
    ("ties", (2, 20), 1, (1, 2)),
    ("ties-at-the-top", (2, 20), 1, (0, 3)),
    ("two-groups", (2, 20), 2, None),
    ("two-groups-drops", (2, 4200), 2, None),
])
def test_moe_apply_matches_jax(label, shape, groups, tie):
    p, layer, jcfg, cfg = _moe_pair(groups, tie)
    x = np.random.default_rng(7).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    if "drops" in label:       # raise every token's expert-0 logit by 3
        r0 = p["router"][:, 0]
        x += 3.0 * r0 / (r0 @ r0)
    want, want_aux = jax.jit(jL.moe_apply, static_argnames="cfg")(
        p, jnp.asarray(x), cfg=jcfg)
    got, got_aux = L.moe_apply(layer, torch.from_numpy(x), cfg)
    _close(got, want)
    assert abs(got_aux.item() - float(want_aux)) <= AUX_TOL
    probs, gate_i, keep = _jax_routing(p, x, jcfg)
    t = shape[0] * shape[1]
    n_g = max(1, min(groups, t))
    xt = torch.from_numpy(x).reshape(n_g, t // n_g, -1)
    _, _, g_i, _, k_mask, cap = L.moe_route(layer, xt, cfg)
    np.testing.assert_array_equal(g_i.numpy(), gate_i)
    np.testing.assert_array_equal(k_mask.numpy(), keep)
    if "drops" in label:
        assert cap < t // n_g * cfg.moe.top_k and not keep.all()
    else:
        assert keep.all()
    if tie is not None:
        a, b = tie
        assert (probs[..., a] == probs[..., b]).all()
        # the tied pair straddles a pick on some tokens: the order decides
        both = np.isin(gate_i, [a, b]).sum(-1)
        assert (both == 1).any()


def test_moe_top_k_prefers_the_lower_index_on_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.4, 0.2, 0.4, 0.0]])
    vals, idx = L.top_k(probs, 2)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))
    assert idx.tolist() == [[1, 2], [0, 2]]
