"""The backward kernels' plain versions, and the differentiable kernel
wrappers, on the CPU.

The JAX package's Pallas kernels have no backward (it trains through its
jnp path); the reference for each gradient is ``jax.vjp`` of the JAX
oracle (``repro.kernels.ref.attention_ref`` / ``adaln_ref``), which is
what that jnp training differentiates.  Here:

* ``ref.attention_bwd_ref`` (K2's backward, closed form) against
  autograd of the port's ``ref.attention_ref`` and against ``jax.vjp``
  of JAX's, for causal, GQA, cross (Sq != Sk) and ragged shapes at head
  dims 64, 112 and 128, and ``ref.attention_lse_ref`` against JAX's
  log-sum-exp of the same scores;
* ``ref.adaln_bwd_ref`` (K1's backward) the same way, for every variant;
* ``ops.attention`` / ``ops.fused_adaln`` backpropagating through their
  ``autograd.Function`` on CPU tensors (the closed forms), and
  ``ops.splice_attention`` refusing to (K4's backward has its own file,
  ``tests/test_torch_ssd_grads.py``);
* the rounding of K2's backward kernels in closed form: bf16 (P and dS
  rounded to bf16) and fp32 (split-TF32 products), each within its
  dtype's budget.

The refs compute in fp32 whatever their input (as the kernels do), so
``gradcheck`` in float64 does not apply; the comparisons are fp32.
Tolerance: rel-L2 per gradient <= 1e-5 in fp32, <= 3e-2 in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from torch_tf32 import tf32_product  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
ATTN_CASES = [
    # (b, sq, sk, h, kv, d, causal)
    (2, 24, 24, 4, 4, 64, True),       # causal
    (1, 20, 20, 8, 2, 64, False),      # GQA
    (2, 13, 37, 4, 4, 64, False),      # cross, Sq != Sk, ragged
    (1, 17, 17, 4, 2, 112, True),      # causal GQA at zamba2's head dim
    (1, 9, 70, 4, 1, 128, False),      # cross at d=128, one KV head
    (2, 33, 33, 8, 2, 128, True),      # yi-6b's causal GQA, odd length
]
ADALN_VARIANTS = {
    "ln": ((), True),
    "mod_norm": (("shift", "scale"), True),
    "modulate": (("shift", "scale"), False),
    "gated_residual": (("gate", "residual"), False),
    "ln_gated": (("gate", "residual"), True),
    "full": (("shift", "scale", "gate", "residual"), True),
    "modulate_gated": (("shift", "scale", "gate", "residual"), False),
}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _np(t):
    return t.detach().float().numpy()


def _attn_inputs(case, seed=0):
    b, sq, sk, h, kv, d, causal = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d),
                      (b, sq, h, d))], causal


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_bwd_ref_matches_autograd_and_jax_vjp(case):
    (q, k, v, do), causal = _attn_inputs(case)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ref.attention_ref(tq, tk, tv, causal=causal)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    lse = ref.attention_lse_ref(tq.detach(), tk.detach(), causal=causal)
    closed = ref.attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                   out.detach(), lse, torch.from_numpy(do),
                                   causal=causal)
    jout, vjp = jax.vjp(lambda a, b_, c: jref.attention_ref(
        a, b_, c, causal=causal), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    for name, c, a, j in zip("qkv", closed, auto, jgrads):
        assert _rel(_np(c), _np(a)) <= TOL["float32"], name
        assert _rel(_np(c), j) <= TOL["float32"], name
    # the log-sum-exp K2's forward writes, against JAX's of its scores
    b, sq, sk, h, kv, d, _ = case
    kr = np.repeat(k, h // kv, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, kr) / d ** 0.5
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((sq, sk), bool))[None, None], s,
                      -1e30)
    assert _rel(_np(lse), jax.nn.logsumexp(s, axis=-1)) <= 1e-6


@pytest.mark.parametrize("case", ATTN_CASES[:3], ids=str)
def test_attention_bwd_ref_in_bf16(case):
    """In bf16 the closed form runs in fp32 on the bf16 operands, as K2's
    backward does; autograd of the forward plain version agrees within
    the bf16 budget."""
    (q, k, v, do), causal = _attn_inputs(case, seed=1)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
                  for a in (q, k, v))
    tdo = torch.from_numpy(do).to(torch.bfloat16)
    out = ref.attention_ref(tq, tk, tv, causal=causal)
    auto = torch.autograd.grad(out, (tq, tk, tv), tdo)
    closed = ref.attention_bwd_ref(
        tq.detach(), tk.detach(), tv.detach(), out.detach(),
        ref.attention_lse_ref(tq.detach(), tk.detach(), causal=causal), tdo,
        causal=causal)
    for name, c, a in zip("qkv", closed, auto):
        assert c.dtype == torch.bfloat16
        assert _rel(_np(c), _np(a)) <= TOL["bfloat16"], name


#: yi-6b's causal GQA (32 query heads over 4 KV heads: group 8, head dim
#: 128) cut to one KV head and 96 tokens
YI_GQA_CASE = (2, 96, 96, 8, 1, 128, True)


def _attention_bwd_rounded(q, k, v, o, lse, do, causal, product=torch.einsum,
                           round_pds=lambda t: t):
    """K2's backward kernels in closed form, rounding where they do: the
    five products (S = Q K^T, dP = dO V^T, dV = P^T dO, dK = dS^T Q,
    dQ = dS K) through ``product`` (by default exact products of the
    operands summed in fp32); P = exp(S scale - lse), 0 where masked,
    dS = P (dP - D) and D = rowsum(dO O) in fp32; P and dS through
    ``round_pds`` before their products; the gradients in the inputs'
    dtype."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group = h // kv
    qf, dof = q.float(), do.float()
    kf = torch.repeat_interleave(k, group, dim=2).float()
    vf = torch.repeat_interleave(v, group, dim=2).float()
    s = product("bqhd,bkhd->bhqk", qf, kf) * d ** -0.5
    keep = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        keep = torch.tril(keep)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)
    ds = p * (product("bqhd,bkhd->bhqk", dof, vf) - delta[..., None])
    p, ds = round_pds(p), round_pds(ds)
    dq = product("bhqk,bkhd->bqhd", ds, kf) * d ** -0.5
    dk = product("bhqk,bqhd->bkhd", ds, qf) * d ** -0.5
    dv = product("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, sk, kv, group, d).sum(3)
    dv = dv.reshape(b, sk, kv, group, d).sum(3)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


@pytest.mark.parametrize("case", ATTN_CASES + [YI_GQA_CASE], ids=str)
def test_attention_bwd_bf16_rounding_within_budget(case):
    """The bf16 kernels' rounding points (P and dS to bf16 before their
    products) keep each gradient within the bf16 budget of the fp32
    closed form ``ref.attention_bwd_ref`` and of ``jax.vjp`` of the JAX
    oracle, on the same bf16 inputs."""
    (q, k, v, do), causal = _attn_inputs(case, seed=5)
    bf = torch.bfloat16
    tq, tk, tv, tdo = (torch.from_numpy(a).to(bf) for a in (q, k, v, do))
    o = ref.attention_ref(tq, tk, tv, causal=causal)
    lse = ref.attention_lse_ref(tq, tk, causal=causal)
    # the bf16 kernels' products are exact on bf16 operands; P and dS are
    # rounded to bf16 before theirs
    got = _attention_bwd_rounded(
        tq, tk, tv, o, lse, tdo, causal,
        round_pds=lambda t: t.to(torch.bfloat16).float())
    want = ref.attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal)
    _, vjp = jax.vjp(lambda a, b_, c: jref.attention_ref(
        a, b_, c, causal=causal), *(jnp.asarray(_np(t)) for t in (tq, tk, tv)))
    jgrads = vjp(jnp.asarray(_np(tdo)))
    for name, g, w, j in zip("qkv", got, want, jgrads):
        assert g.dtype == bf and g.shape == w.shape, name
        assert _rel(_np(g), _np(w)) <= TOL["bfloat16"], name
        assert _rel(_np(g), j) <= TOL["bfloat16"], name


@pytest.mark.parametrize("passes", [3, 1], ids=["3xTF32", "1xTF32"])
@pytest.mark.parametrize("case", ATTN_CASES + [YI_GQA_CASE], ids=str)
def test_attention_bwd_split_tf32_within_budget(case, passes):
    """The fp32 kernels' split-TF32 products (three TF32 products for each
    fp32 one) keep each gradient within the fp32 budget of the closed form
    ``ref.attention_bwd_ref`` and of ``jax.vjp`` of the JAX oracle; one
    TF32 product exceeds it at the same inputs for every gradient, so the
    budget tells the two apart."""
    (q, k, v, do), causal = _attn_inputs(case, seed=6)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = ref.attention_ref(tq, tk, tv, causal=causal)
    lse = ref.attention_lse_ref(tq, tk, causal=causal)
    # the fp32 kernels' products, P and dS split like every other operand
    got = _attention_bwd_rounded(
        tq, tk, tv, o, lse, tdo, causal,
        product=lambda eq, a, b: tf32_product(eq, a, b, passes))
    want = ref.attention_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal)
    _, vjp = jax.vjp(lambda a, b_, c: jref.attention_ref(
        a, b_, c, causal=causal), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    for name, g, w, j in zip("qkv", got, want, jgrads):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        errs = (_rel(_np(g), _np(w)), _rel(_np(g), j))
        if passes == 3:
            assert max(errs) <= TOL["float32"], (name, errs)
        else:
            assert min(errs) > TOL["float32"], (name, errs)


def _adaln_inputs(names, seed=0, b=2, n=11, d=48):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    dy = rng.standard_normal((b, n, d)).astype(np.float32)
    kw = {}
    for name in names:
        shape = (b, n, d) if name == "residual" else (b, d)
        kw[name] = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    return x, dy, kw


@pytest.mark.parametrize("variant", sorted(ADALN_VARIANTS))
def test_adaln_bwd_ref_matches_autograd_and_jax_vjp(variant):
    names, ln = ADALN_VARIANTS[variant]
    x, dy, kw = _adaln_inputs(names)
    order = ["x"] + list(names)
    tins = {"x": torch.from_numpy(x).requires_grad_(True),
            **{n: torch.from_numpy(a).requires_grad_(True)
               for n, a in kw.items()}}
    out = ref.adaln_ref(**tins, ln=ln)
    auto = dict(zip(order, torch.autograd.grad(
        out, [tins[n] for n in order], torch.from_numpy(dy))))
    closed = ref.adaln_bwd_ref(
        tins["x"].detach(), *(tins[n].detach() if n in tins else None
                              for n in ("shift", "scale", "gate")),
        torch.from_numpy(dy), ln=ln)
    closed = dict(zip(["x", "shift", "scale", "gate", "residual"], closed))

    def jfn(*args):
        return jref.adaln_ref(**dict(zip(order, args)), ln=ln)
    _, vjp = jax.vjp(jfn, jnp.asarray(x), *(jnp.asarray(kw[n])
                                           for n in names))
    jgrads = dict(zip(order, vjp(jnp.asarray(dy))))
    for name in ("x", "shift", "scale", "gate", "residual"):
        if name not in order:
            assert closed[name] is None, name
            continue
        assert _rel(_np(closed[name]), _np(auto[name])) <= TOL["float32"], \
            name
        assert _rel(_np(closed[name]), jgrads[name]) <= TOL["float32"], name


@pytest.mark.parametrize("variant", ["mod_norm", "full", "gated_residual"])
def test_adaln_bwd_ref_in_bf16(variant):
    names, ln = ADALN_VARIANTS[variant]
    x, dy, kw = _adaln_inputs(names, seed=2, d=256)
    bf = torch.bfloat16
    tins = {"x": torch.from_numpy(x).to(bf).requires_grad_(True),
            **{n: torch.from_numpy(a).to(bf).requires_grad_(True)
               for n, a in kw.items()}}
    order = ["x"] + list(names)
    tdy = torch.from_numpy(dy).to(bf)
    auto = torch.autograd.grad(ref.adaln_ref(**tins, ln=ln),
                               [tins[n] for n in order], tdy)
    closed = ref.adaln_bwd_ref(
        tins["x"].detach(), *(tins[n].detach() if n in tins else None
                              for n in ("shift", "scale", "gate")),
        tdy, ln=ln)
    closed = dict(zip(["x", "shift", "scale", "gate", "residual"], closed))
    for name, a in zip(order, auto):
        assert closed[name].dtype == bf
        assert _rel(_np(closed[name]), _np(a)) <= TOL["bfloat16"], name


@pytest.mark.parametrize("variant", ["gated_residual", "ln_gated", "full",
                                     "modulate_gated"])
def test_fused_adaln_bwd_hands_dy_on_as_dresidual(variant):
    """The residual's gradient is the output's: ``ops.fused_adaln_bwd``
    returns the incoming dy tensor itself (no copy, as the kernel path
    does), and backward() through ``ops.fused_adaln`` gives the residual
    dy's values."""
    names, ln = ADALN_VARIANTS[variant]
    x, dy, kw = _adaln_inputs(names, seed=4)
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    rows = {n: torch.from_numpy(kw[n]) for n in names if n != "residual"}
    dres = ops.fused_adaln_bwd(tx, dy=tdy, ln=ln, **rows)[4]
    assert dres is tdy
    res = torch.from_numpy(kw["residual"]).requires_grad_(True)
    ops.fused_adaln(tx, residual=res, ln=ln, **rows).backward(tdy)
    assert torch.equal(res.grad, tdy)


@pytest.mark.parametrize("case", ATTN_CASES[:4], ids=str)
def test_ops_attention_backpropagates_through_the_closed_form(case):
    """On CPU tensors ``ops.attention``'s Function runs the plain forward
    (with its log-sum-exp) and the closed-form backward: the gradients
    are ``jax.vjp``'s."""
    (q, k, v, do), causal = _attn_inputs(case, seed=3)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.attention(*ts, causal=causal)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    _, vjp = jax.vjp(lambda a, b_, c: jref.attention_ref(
        a, b_, c, causal=causal), *(jnp.asarray(a) for a in (q, k, v)))
    for t, j in zip(ts, vjp(jnp.asarray(do))):
        assert _rel(_np(t.grad), j) <= TOL["float32"]


@pytest.mark.parametrize("variant", sorted(ADALN_VARIANTS))
def test_ops_fused_adaln_backpropagates_through_the_closed_form(variant):
    names, ln = ADALN_VARIANTS[variant]
    x, dy, kw = _adaln_inputs(names, seed=4)
    order = ["x"] + list(names)
    ts = {"x": torch.from_numpy(x).requires_grad_(True),
          **{n: torch.from_numpy(a).requires_grad_(True)
             for n, a in kw.items()}}
    ops.fused_adaln(**ts, ln=ln).backward(torch.from_numpy(dy))

    def jfn(*args):
        return jref.adaln_ref(**dict(zip(order, args)), ln=ln)
    _, vjp = jax.vjp(jfn, jnp.asarray(x), *(jnp.asarray(kw[n])
                                           for n in names))
    for name, j in zip(order, vjp(jnp.asarray(dy))):
        assert ts[name].grad is not None, name
        assert _rel(_np(ts[name].grad), j) <= TOL["float32"], name


def test_wrappers_without_grad_build_no_graph():
    """Frozen operands, or inference mode: the plain call, no Function
    and no log-sum-exp (the serving path is unchanged)."""
    q = torch.randn(1, 8, 2, 32)
    assert ops.attention(q, q, q).grad_fn is None
    x = torch.randn(1, 8, 32, requires_grad=True)
    with torch.inference_mode():
        assert ops.fused_adaln(x).grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert ops.attention(qg, q, q).grad_fn is None
    assert ops.attention(qg, q, q).grad_fn is not None
    assert ops.fused_adaln(x).grad_fn is not None


def test_splice_attention_refuses_gradients():
    """K3 has no backward kernel: with grad on and an operand that
    requires grad it raises (on the CPU too, so the CPU never trains what
    the card cannot), and serves as before otherwise."""
    q = torch.randn(1, 4, 2, 16, requires_grad=True)
    kv = torch.randn(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ops.splice_attention(q, kv, kv, kv[:, :4], kv[:, :4], offset=2)
    with torch.no_grad():
        ops.splice_attention(q, kv, kv, kv[:, :4], kv[:, :4], offset=2)
