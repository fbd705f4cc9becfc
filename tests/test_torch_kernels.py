"""The port's kernel layer against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; these
are held to the JAX oracles (``repro.kernels.ref``) and to the Pallas
kernels run in interpret mode (``repro.kernels.ops`` with
``use_pallas=True``), on the same numpy inputs.  Tolerance: max abs
error over max abs reference, <= 1e-5 in fp32 and <= 3e-2 in bf16
(DESIGN.md §12).  tests/test_torch_cuda.py holds the CUDA kernels to
these plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX and a torch array of ``dtype`` (both
    round fp32 to bf16 to nearest even)."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _close(got, want, dtype):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else
                     jnp.asarray(got, jnp.float32), np.float64)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor) else
                      jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL[dtype], (err, TOL[dtype])


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# K2 flash attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    # (b, sq, sk, h, kv, d, causal)
    (1, 37, 77, 4, 4, 32, False),      # odd N against Lt=77 (cross)
    (2, 50, 50, 4, 2, 64, False),      # GQA
    (1, 33, 33, 2, 2, 128, True),      # causal, odd
    (1, 21, 21, 4, 4, 256, False),     # the text encoder's head_dim
    (1, 19, 19, 4, 4, 16, False),      # the reduced text encoder's
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", ATTN_CASES)
def test_attention_matches_jax(b, sq, sk, h, kv, d, causal, dtype):
    rng = np.random.default_rng(sq * d + h)
    arrays = [_normal(rng, s) for s in
              ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in arrays)
    got = ops.attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal), dtype)
    _close(got, jops.attention(jq, jk, jv, causal=causal, use_pallas=True),
           dtype)


# ---------------------------------------------------------------------------
# K3 splice attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 40, 80])       # first, middle, last
def test_splice_attention_matches_jax(offset, dtype):
    b, n_total, n_local, h, kv, d = 1, 120, 40, 4, 2, 32
    rng = np.random.default_rng(offset)
    shapes = ((b, n_local, h, d), (b, n_total, kv, d), (b, n_total, kv, d),
              (b, n_local, kv, d), (b, n_local, kv, d))
    pairs = [_pair(_normal(rng, s), dtype) for s in shapes]
    jx = [p[0] for p in pairs]
    tx = [p[1] for p in pairs]
    got = ops.splice_attention(*tx, offset=offset)
    _close(got, jref.splice_attention_ref(*jx, offset=offset), dtype)
    _close(got, jops.splice_attention(*jx, offset=offset, use_pallas=True),
           dtype)


def test_splice_equals_attention_over_spliced_kv():
    rng = np.random.default_rng(3)
    q, ks, vs = (torch.from_numpy(_normal(rng, s)) for s in
                 ((1, 16, 2, 32), (1, 48, 2, 32), (1, 48, 2, 32)))
    kf, vf = (torch.from_numpy(_normal(rng, (1, 16, 2, 32)))
              for _ in range(2))
    k, v = ks.clone(), vs.clone()
    k[:, 16:32], v[:, 16:32] = kf, vf
    torch.testing.assert_close(
        ops.splice_attention(q, ks, vs, kf, vf, offset=16),
        ops.attention(q, k, v), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K1 fused adaLN
# ---------------------------------------------------------------------------

ADALN_VARIANTS = {
    "mod_norm": ("shift", "scale"),
    "ln": (),
    "gated_residual": ("gate", "residual"),
    "full": ("shift", "scale", "gate", "residual"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(ADALN_VARIANTS))
@pytest.mark.parametrize("b,n,d", [(1, 37, 64), (2, 130, 96)])
def test_adaln_matches_jax(b, n, d, variant, dtype):
    rng = np.random.default_rng(n + d)
    arrays = {"x": _normal(rng, (b, n, d)),
              "shift": _normal(rng, (b, d), 0.2),
              "scale": _normal(rng, (b, d), 0.2),
              "gate": _normal(rng, (b, d), 0.2),
              "residual": _normal(rng, (b, n, d))}
    names = ADALN_VARIANTS[variant]
    ln = variant != "gated_residual"
    jx, tx = _pair(arrays["x"], dtype)
    jkw, tkw = {}, {}
    for name in names:
        jkw[name], tkw[name] = _pair(arrays[name], dtype)
    got = ops.fused_adaln(tx, ln=ln, **tkw)
    assert got.dtype == tx.dtype
    _close(got, jref.adaln_ref(jx, ln=ln, **jkw), dtype)
    _close(got, jops.fused_adaln(jx, ln=ln, use_pallas=True, **jkw), dtype)


@pytest.mark.parametrize("kwargs,msg", [
    (dict(shift=torch.zeros(1, 8)), "shift and scale"),
    (dict(gate=torch.zeros(1, 8)), "gate and residual"),
    (dict(ln=False), "identity"),
])
def test_adaln_rejects_malformed_variants(kwargs, msg):
    with pytest.raises(ValueError, match=msg):
        ops.fused_adaln(torch.zeros(1, 4, 8), **kwargs)


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Operands on more than one device are refused.  All on ``meta`` is
    the dry run's shape-only branch (``tests/test_torch_dryrun.py``);
    ``meta`` beside the CPU is refused either way round."""
    q = torch.zeros(1, 4, 2, 32, device="meta")
    c = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        ops.attention(c, q, q)
    with pytest.raises(ValueError, match="all on CUDA or all on meta"):
        ops.attention(q, c, c)


@pytest.mark.parametrize("fault,msg", [
    ("shape", "y has shape"),
    ("dtype", "y is torch.float64"),
    ("contiguous", "y must be contiguous"),
    ("unsupported", "float16 not supported"),
])
def test_operand_check_refuses_each_fault(fault, msg):
    """The wrappers' one-pass operand check, which the card's path runs
    before every launch."""
    like = torch.zeros(2, 4, 8, dtype=torch.float16 if fault == "unsupported"
                       else torch.float32)
    y = {"shape": torch.zeros(2, 4, 9),
         "dtype": torch.zeros(2, 4, 8, dtype=torch.float64),
         "contiguous": torch.zeros(2, 8, 4).transpose(1, 2),
         "unsupported": like}[fault]
    with pytest.raises(ValueError, match=msg):
        ops._check("k", like, ("x", like, (2, 4, 8)), ("y", y, (2, 4, 8)))


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
def test_operand_check_returns_the_kernel_dtype_code(dtype, code):
    x = torch.zeros(2, 4, 8, dtype=dtype)
    assert ops._check("k", x, ("x", x, (2, 4, 8)),
                      ("s", x[:, 0].contiguous(), (2, 8))) == code
