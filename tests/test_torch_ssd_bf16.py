"""K4 in bf16 on the CPU: the tensor-core kernels' rounding in closed form,
and the ``ssd_bf16`` variant of the reduced SSD families against JAX.

The card's bf16 kernels (``csrc/ssd.cu``'s ``*_mma`` stages, the bf16
instances of ``csrc/ssd_bwd.cu``'s) cannot run here, so their arithmetic
is written out in PyTorch, rounding where they round: x, B, C and dy are
bf16; every product of two bf16 values is exact in fp32 and every sum is
fp32; the forward rounds the decay-weighted rows w_j B_j (w_j = dt_j
exp(cum_last - cum_j)) of the chunk states, the scores M'_ij = (C B^T)_ij
exp(cum_i - cum_j) dt_j and the carried state S_in to bf16 where they
enter a product, and y to bf16 at the end; the backward rounds xb = x dt
once, exp(cum_i) C_i (the state gradients' A operand), G and S_in as they
are staged, and M = (C B^T) L and P = L (dy . xb) where they enter a
product, while the state passes, the exps and every row and column sum
stay fp32.

The model is held, per output, within the bf16 budget of 3e-2 rel-L2
(DESIGN.md §12) to the JAX package's ``ssd_chunked`` at bf16 (which
rounds the scores, the decays and the carried states to bf16 instead) and
to ``jax.vjp`` of it for dx, ddt, dA, dB and dC, and to the port's plain
versions ``ref.ssd_ref`` and ``ref.ssd_bwd_ref`` (fp32 on the same bf16
values).  Then the reduced mamba2-1.3b and zamba2-7b under
``dryrun.apply_variant(cfg, "ssd_bf16")`` (intra_dtype="bfloat16", the
JAX package's variant of that name), with parameters carried across by
``convert.load_jax_params`` and A and dt in Mamba2's published ranges:
forward logits and one step's loss and gradients against JAX's within
3e-2 rel-L2, and the prefill + decode steps against the teacher-forced
forward.  ``-s`` prints every distance.
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
from repro.models import ssm as jssm  # noqa: E402
from repro.training import train_loop as jtl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import STACKED, _flatten, load_jax_params  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.dryrun import apply_variant  # noqa: E402
from repro_torch.models import get_model, ssm  # noqa: E402
from repro_torch.serving import serve_loop  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401

BF16_BUDGET = 3e-2
NAMES = ("dx", "ddt", "dA", "dB", "dC")
NEG = -1e30

#: (b, l, h, p, n, chunk): the small SSD_SHAPES entries, and the reduced
#: model's (16, 16, 16) at a ragged l (three chunks, the last of 8 rows)
CASES = [
    (2, 64, 4, 16, 16, 16),
    (1, 128, 2, 16, 16, 32),
    (2, 256, 3, 32, 16, 64),
    (2, 40, 4, 16, 16, 16),
]


def _bf(t):
    """``t`` rounded to bf16 (to nearest even, as the kernels' cvt.rn),
    back in fp32."""
    return t.to(torch.bfloat16).float()


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _states(xc, dtc, Bc, cum):
    """Stages 1-2 of the bf16 forward: the chunk states S_c^T = sum_j
    bf16(w_j B_j)^T x_j (fp32 sums), then the fp32 pass; returns S_in of
    every chunk and the final state (b, h, p, n)."""
    w = torch.exp(cum[..., -1:] - cum) * dtc                 # (b, nc, h, c)
    bw = _bf(w[..., None] * Bc[:, :, None])                  # (b,nc,h,c,n)
    states = torch.einsum("bchjn,bcjhp->bchpn", bw, xc)
    s_in = torch.empty_like(states)
    state = states.new_zeros(states[:, 0].shape)
    for k in range(cum.shape[1]):
        s_in[:, k] = state
        state = torch.exp(cum[:, k, :, -1])[..., None, None] * state \
            + states[:, k]
    return s_in, state


def _decay(cum):
    """L_ij = exp(cum_i - cum_j), masked to -1e30 before the exp above
    the diagonal, (b, nc, h, i, j)."""
    c = cum.shape[-1]
    causal = torch.ones((c, c), dtype=torch.bool).tril()
    seg = cum[..., :, None] - cum[..., None, :]
    return torch.exp(torch.where(causal, seg, torch.full_like(seg, NEG)))


def ssd_bf16_model(x, dt, A, B, C, chunk):
    """``csrc/ssd.cu``'s bf16 stages in closed form: (y in bf16, the
    final state in fp32).  Stage 4: y_i = sum_j bf16(M'_ij) x_j +
    exp(cum_i) (C_i . bf16(S_in)), M'_ij = (C B^T)_ij L_ij dt_j."""
    b, l, h, p = x.shape
    xc, dtc, Bc, Cc, _, cum, _, _ = ref._ssd_chunks(x, dt, A, B, C, (),
                                                   chunk)
    s_in, state = _states(xc, dtc, Bc, cum)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    m = _bf(cb[:, :, None] * _decay(cum) * dtc[..., None, :])
    y = torch.einsum("bchij,bcjhp->bcihp", m, xc)
    carried = torch.einsum("bcin,bchpn->bchip", Cc, _bf(s_in))
    y = y + (torch.exp(cum)[..., None] * carried).permute(0, 1, 3, 2, 4)
    return y.reshape(b, -1, h, p)[:, :l].to(x.dtype), state


def ssd_bwd_bf16_model(x, dt, A, B, C, dy, dstate, chunk):
    """``csrc/ssd_bwd.cu``'s bf16 instances in closed form: (dx, ddt,
    dA, dB, dC), each in its operand's dtype, as ``ref.ssd_bwd_ref``
    writes each term out, with the kernels' roundings (see the module's
    note); S_in and C B^T are the bf16 forward's."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    dtypes = (x.dtype, dt.dtype, A.dtype, B.dtype, C.dtype)
    xc, dtc, Bc, Cc, (dyc,), cum, _, _ = ref._ssd_chunks(
        x, dt, A, B, C, (dy,), chunk)
    s_in, _ = _states(xc, dtc, Bc, cum)
    nc = cum.shape[1]
    A = A.float()
    xb = _bf(xc * dtc.transpose(2, 3)[..., None])            # (b,nc,c,h,p)
    ec = torch.exp(cum)
    ed = torch.exp(cum[..., -1:] - cum)
    # stage 1: Q = sum_i bf16(exp(cum_i) C_i)^T dy_i; stage 2 in fp32
    q = torch.einsum("bchin,bcihp->bchpn",
                     _bf(ec[..., None] * Cc[:, :, None]), dyc)
    gn = torch.empty_like(q)
    g = q.new_zeros((b, h, p, n)) if dstate is None else dstate.float()
    for k in reversed(range(nc)):
        gn[:, k] = g
        g = torch.exp(cum[:, k, :, -1])[..., None, None] * g + q[:, k]
    # stage 3: G and S_in rounded as staged; Z = dy . xb in fp32, M and
    # P rounded where they enter a product, T = M Z from the fp32 values
    gb, sb = _bf(gn), _bf(s_in)
    decay = _decay(cum)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    pm = decay * torch.einsum("bcihp,bcjhp->bchij", dyc, xb)
    m = cb[:, :, None] * decay
    dxb_state = ed.transpose(2, 3)[..., None] * torch.einsum(
        "bcjn,bchpn->bcjhp", Bc, gb)
    dxb = torch.einsum("bchij,bcihp->bcjhp", _bf(m), dyc) + dxb_state
    dx = dxb * dtc.transpose(2, 3)[..., None]
    ddt = (xc * dxb).sum(-1).transpose(2, 3)                  # (b, nc, h, c)
    dC_state = ec[..., None] * torch.einsum("bcihp,bchpn->bchin", dyc, sb)
    dC = torch.einsum("bchij,bcjn->bcin", _bf(pm), Bc) + dC_state.sum(2)
    dB = torch.einsum("bchij,bcin->bcjn", _bf(pm), Cc) + (
        ed[..., None] * torch.einsum("bcjhp,bchpn->bchjn", xb, gb)).sum(2)
    t = cb[:, :, None] * pm
    w = torch.einsum("bcjhp,bcjhp->bchj", xb, dxb_state)
    dcum = t.sum(-1) - t.sum(-2) - w \
        + torch.einsum("bchin,bcin->bchi", dC_state, Cc)
    dcum[..., -1] += w.sum(-1) + torch.exp(cum[..., -1]) * (
        s_in * gn).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = ddt + A[:, None] * da
    dA = (dtc * da).sum((0, 1, 3))

    def unchunk(v, *tail):
        return v.reshape(b, -1, *tail)[:, :l]
    grads = (unchunk(dx, h, p), unchunk(ddt.transpose(2, 3), h), dA,
             unchunk(dB, n), unchunk(dC, n))
    return tuple(g.to(d) for g, d in zip(grads, dtypes))


def _inputs(seed, b, l, h, p, n):
    """x, B, C and dy as bf16 values (fp32 numpy arrays holding them), dt
    and A in Mamba2's published ranges, dstate fp32."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(int(rng.integers(2**31)))
    dt, A = ssm.sample_dt_a((b, l, h), h, gen)

    def bf(shape):
        return _bf(torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))).numpy()
    x, B, C, dy = (bf(s) for s in ((b, l, h, p), (b, l, n), (b, l, n),
                                   (b, l, h, p)))
    dstate = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt.numpy(), A.numpy(), B, C, dy, dstate


def _jax_ssd(chunk, l):
    """JAX's ``ssd_chunked`` at bf16 (x, B and C cast, dt and A fp32), the
    sequence zero-padded to whole chunks and y cut back to ``l``, as
    ``ssd_block_apply`` runs it."""
    pad = (-l) % chunk

    def fn(x, dt, A, B, C):
        x, dt, B, C = (jnp.pad(t, ((0, 0), (0, pad)) + ((0, 0),) * (
            t.ndim - 2)) for t in (x, dt, B, C))
        y, state = jssm.ssd_chunked(x.astype(jnp.bfloat16), dt, A,
                                    B.astype(jnp.bfloat16),
                                    C.astype(jnp.bfloat16), chunk)
        return y[:, :l], state
    return fn


def _port(x, dt, A, B, C):
    return (torch.from_numpy(x).bfloat16(), torch.from_numpy(dt),
            torch.from_numpy(A), torch.from_numpy(B).bfloat16(),
            torch.from_numpy(C).bfloat16())


@pytest.mark.parametrize("b,l,h,p,n,chunk", CASES)
def test_bf16_forward_model_matches_jax_and_the_plain_version(b, l, h, p, n,
                                                              chunk):
    x, dt, A, B, C, _, _ = _inputs(l + h + p, b, l, h, p, n)
    y, state = ssd_bf16_model(*_port(x, dt, A, B, C), chunk)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    jy, jstate = jax.jit(_jax_ssd(chunk, l))(x, dt, A, B, C)
    py, pstate = ref.ssd_ref(*_port(x, dt, A, B, C))
    errs = {"y vs jax": _rel_l2(y.float(), jy),
            "state vs jax": _rel_l2(state, jstate),
            "y vs ssd_ref": _rel_l2(y.float(), py.float()),
            "state vs ssd_ref": _rel_l2(state, pstate)}
    print(f"\nbf16 forward model {(b, l, h, p, n, chunk)}: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert max(errs.values()) <= BF16_BUDGET, errs
    # the model rounds where the kernels do: it is not the fp32 function
    assert errs["y vs ssd_ref"] > 1e-4, errs


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("b,l,h,p,n,chunk", CASES)
def test_bf16_backward_model_matches_jax_vjp_and_the_plain_version(
        b, l, h, p, n, chunk, with_dstate):
    x, dt, A, B, C, dy, dstate = _inputs(l + n + 3, b, l, h, p, n)
    dstate = dstate if with_dstate else None
    args = _port(x, dt, A, B, C)
    tdy = torch.from_numpy(dy).bfloat16()
    tds = None if dstate is None else torch.from_numpy(dstate)
    got = ssd_bwd_bf16_model(*args, tdy, tds, chunk)
    assert [g.dtype for g in got] == [a.dtype for a in args]
    cot = (jnp.asarray(dy), jnp.zeros((b, h, p, n), jnp.float32)
           if dstate is None else jnp.asarray(dstate))
    jgrads = jax.jit(lambda *a: jax.vjp(_jax_ssd(chunk, l), *a)[1](cot))(
        x, dt, A, B, C)
    plain = ref.ssd_bwd_ref(*args, tdy, tds, chunk=chunk)
    errs = {}
    for name, g, j, w in zip(NAMES, got, jgrads, plain):
        errs[f"{name} vs jax"] = _rel_l2(g.float(), np.asarray(j, np.float32))
        errs[f"{name} vs ssd_bwd_ref"] = _rel_l2(g.float(), w.float())
    print(f"\nbf16 backward model {(b, l, h, p, n, chunk)} dstate="
          f"{with_dstate}: " + ", ".join(f"{k} {v:.2e}"
                                         for k, v in errs.items()))
    assert max(errs.values()) <= BF16_BUDGET, errs


# ---------------------------------------------------------------------------
# the ssd_bf16 variant of the reduced SSD families
# ---------------------------------------------------------------------------

def _liven_ssd(tree, seed=0):
    """Every ``A_log`` and ``dt_bias`` leaf redrawn in Mamba2's published
    ranges (dt log-uniform in [1e-3, 1e-1] through the inverse softplus,
    A = -U[1, 16]), so that the carried state matters."""
    rng = np.random.default_rng(seed)
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            _liven_ssd(leaf, int(rng.integers(2**31)))
        elif key == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), leaf.shape))
            tree[key] = (dt + np.log(-np.expm1(-dt))).astype(np.float32)
        elif key == "A_log":
            tree[key] = np.log(rng.uniform(1, 16, leaf.shape)).astype(
                np.float32)
    return tree


@pytest.fixture(scope="module", params=["mamba2-1.3b", "zamba2-7b"])
def ssd_bf16_pair(request):
    """(JAX config, port config, JAX tree, port model) of the reduced
    ``request.param`` under the ssd_bf16 variant, one livened tree
    carried across."""
    cfg = apply_variant(get_config(request.param).reduced(), "ssd_bf16")
    base = jax_get_config(request.param).reduced()
    jcfg = base.with_(ssm=dataclasses.replace(base.ssm,
                                              intra_dtype="bfloat16"))
    assert cfg.ssm == dataclasses.replace(get_config(
        request.param).reduced().ssm, intra_dtype="bfloat16")
    assert dataclasses.asdict(jcfg.ssm) == dataclasses.asdict(cfg.ssm)
    params, _ = jL.split_params(
        jax_get_model(jcfg).init(jax.random.PRNGKey(0), jcfg))
    tree = _liven_ssd(jax.tree.map(np.asarray, params))
    model = get_model(cfg).init(cfg, device="cpu")
    load_jax_params(model, tree)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), model


def _tokens(cfg, seed, b=2, s=40):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s),
                                                dtype=np.int32)


def test_ssd_bf16_forward_logits_match_jax(ssd_bf16_pair):
    """40 tokens, three chunks of 16 (the last ragged: JAX pads it), the
    fp32 model around a bf16 SSD in both packages."""
    jcfg, cfg, tree, model = ssd_bf16_pair
    toks = _tokens(cfg, 5)
    want, _ = jax.jit(lambda p, t: jax_get_model(jcfg).forward(
        p, t, jcfg, dtype=jnp.float32))(tree, jnp.asarray(toks))
    with torch.inference_mode():
        got, _ = get_model(cfg).forward(model, torch.from_numpy(toks), cfg,
                                        dtype=torch.float32)
        fp32, _ = get_model(cfg).forward(
            model, torch.from_numpy(toks), get_config(cfg.name).reduced(),
            dtype=torch.float32)
    err = _rel_l2(got, want)
    moved = _rel_l2(got, fp32)
    print(f"\n{cfg.name} ssd_bf16 logits vs JAX: rel-L2 {err:.2e} (the "
          f"port's own fp32-intra logits {moved:.2e} away)")
    assert err <= BF16_BUDGET
    assert moved > 0      # the SSD ran in bf16


def test_ssd_bf16_loss_and_gradients_match_jax(ssd_bf16_pair):
    """One training step's loss and gradients (fp32 model, bf16 SSD):
    the port's autograd through K4's plain backward against
    ``jax.value_and_grad`` through ``ssd_chunked`` at bf16, every leaf
    within 3e-2 rel-L2."""
    jcfg, cfg, tree, model = ssd_bf16_pair
    toks = _tokens(cfg, 6)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -100, np.int32)],
                            axis=1)

    def jloss(p):
        logits, aux = jax_get_model(jcfg).forward(p, jnp.asarray(toks),
                                                  jcfg, dtype=jnp.float32)
        return jtl.cross_entropy(logits, jnp.asarray(labels)) + 0.01 * aux
    jl, jg = jax.jit(jax.value_and_grad(jloss))(tree)
    loss, _, grads = train_loop.grads_of(model, {
        "tokens": torch.from_numpy(toks),
        "labels": torch.from_numpy(labels)}, cfg, "none",
        dtype=torch.float32)
    jflat = _by_name(jax.tree.map(np.asarray, jg))
    assert grads.keys() == jflat.keys()
    errs = {name: _rel_l2(g.float().numpy(), jflat[name])
            for name, g in grads.items() if np.linalg.norm(jflat[name]) > 0}
    worst = max(errs, key=errs.get)
    print(f"\n{cfg.name} ssd_bf16 loss {float(loss):.6f} vs JAX "
          f"{float(jl):.6f}; {len(errs)} gradient leaves, worst rel-L2 "
          f"{errs[worst]:.2e} ({worst})")
    assert abs(float(loss) - float(jl)) <= BF16_BUDGET * abs(float(jl))
    assert errs[worst] <= BF16_BUDGET, errs


def _by_name(tree) -> dict:
    """A JAX tree's leaves by the port's parameter names (stacked layer
    axes split, as ``convert.load_jax_params`` does)."""
    out = {}
    for name, arr in _flatten(tree):
        top, _, rest = name.partition(".")
        axes = STACKED.get(top, 0)
        if axes:
            for idx in np.ndindex(arr.shape[:axes]):
                out[".".join([top, *map(str, idx), rest])] = arr[idx]
        else:
            out[name] = arr
    return out


def test_ssd_bf16_prefill_then_decode_matches_the_forward(ssd_bf16_pair):
    """The port at ssd_bf16 through the serve-loop steps: prefill 24
    tokens (K4 in bf16), decode 8 (the fp32 recurrence from the bf16
    prefill's state), each logit against the teacher-forced forward
    over the 32 tokens (K4 in bf16 over all of them)."""
    _, cfg, _, model = ssd_bf16_pair
    toks = torch.from_numpy(_tokens(cfg, 7, s=32))
    fam = get_model(cfg)
    with torch.inference_mode():
        full, _ = fam.forward(model, toks, cfg, dtype=torch.float32)
        cache = fam.init_cache(cfg, 2, 40, dtype=torch.float32,
                               device="cpu")
        lg, cache = serve_loop.make_prefill_step(cfg, dtype=torch.float32)(
            model, toks[:, :24], cache)
        step = serve_loop.make_serve_step(cfg, dtype=torch.float32)
        got, want = [lg[:, 0]], [full[:, 23]]
        for i in range(24, 32):
            lg, cache = step(model, toks[:, i:i + 1], cache,
                             torch.tensor([i, i]))
            got.append(lg[:, 0])
            want.append(full[:, i])
    got, want = torch.stack(got, 1), torch.stack(want, 1)
    err = ((got - want).abs().max() / want.abs().max()).item()
    print(f"\n{cfg.name} ssd_bf16 prefill 24 + decode 8 vs the forward: "
          f"max |diff| / max |logit| {err:.2e}")
    assert err <= BF16_BUDGET
