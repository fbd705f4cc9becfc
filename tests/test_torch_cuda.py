"""Every CUDA kernel against its plain PyTorch version, on the card.

These need a CUDA device and nvcc (the kernels have no CPU mode) and skip
elsewhere; the JAX side is not imported, so they run on a machine without
JAX:  ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerance: max abs error over max abs reference, <= 1e-5 in fp32 and
<= 3e-2 in bf16 (DESIGN.md §12).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
ATTN_CASES = [
    # (b, sq, sk, h, kv, d, causal)
    (1, 37, 77, 4, 4, 32, False),      # odd N against Lt=77 (cross)
    (2, 50, 50, 4, 2, 64, False),      # GQA
    (1, 33, 33, 2, 2, 128, True),      # causal, odd
    (1, 21, 21, 4, 4, 256, False),     # the text encoder's head_dim
    (1, 19, 19, 4, 4, 16, False),      # the reduced text encoder's
    (1, 200, 300, 24, 24, 64, False),  # several q and k tiles, ragged
    (1, 130, 130, 4, 4, 64, True),     # causal block skip over 3 tiles
]
ADALN_VARIANTS = {
    "mod_norm": ("shift", "scale"),
    "ln": (),
    "gated_residual": ("gate", "residual"),
    "full": ("shift", "scale", "gate", "residual"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card(rng, shape, dtype, device, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).to(device, getattr(torch, dtype))


def _close(got, want, dtype):
    torch.cuda.synchronize()
    got, want = got.double(), want.double()
    assert got.shape == want.shape
    err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
    assert err <= TOL[dtype], (err, TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", ATTN_CASES)
def test_cuda_attention_kernel(cuda_device, b, sq, sk, h, kv, d, causal,
                               dtype):
    rng = np.random.default_rng(0)
    q = _card(rng, (b, sq, h, d), dtype, cuda_device)
    k, v = (_card(rng, (b, sk, kv, d), dtype, cuda_device)
            for _ in range(2))
    before = ops.launches["attention"]
    got = ops.attention(q, k, v, causal=causal)
    assert ops.launches["attention"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, ref.attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 40, 80])       # first, middle, last
def test_cuda_splice_kernel(cuda_device, offset, dtype):
    rng = np.random.default_rng(offset)
    q = _card(rng, (1, 40, 4, 64), dtype, cuda_device)
    ks, vs = (_card(rng, (1, 120, 2, 64), dtype, cuda_device)
              for _ in range(2))
    kf, vf = (_card(rng, (1, 40, 2, 64), dtype, cuda_device)
              for _ in range(2))
    before = ops.launches["splice_attention"]
    got = ops.splice_attention(q, ks, vs, kf, vf, offset=offset)
    assert ops.launches["splice_attention"] == before + 1
    _close(got, ref.splice_attention_ref(q, ks, vs, kf, vf, offset=offset),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(ADALN_VARIANTS))
def test_cuda_adaln_kernel(cuda_device, variant, dtype):
    rng = np.random.default_rng(1)
    b, n, d = 2, 130, 1536
    t = {"x": _card(rng, (b, n, d), dtype, cuda_device),
         "residual": _card(rng, (b, n, d), dtype, cuda_device)}
    for name in ("shift", "scale", "gate"):
        t[name] = _card(rng, (b, d), dtype, cuda_device, 0.2)
    kw = {name: t[name] for name in ADALN_VARIANTS[variant]}
    ln = variant != "gated_residual"
    before = ops.launches["fused_adaln"]
    got = ops.fused_adaln(t["x"], ln=ln, **kw)
    assert ops.launches["fused_adaln"] == before + 1
    _close(got, ref.adaln_ref(t["x"], ln=ln, **kw), dtype)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(1, 8, 2, 48, device=cuda_device)        # head_dim 48
    with pytest.raises(ValueError, match="head_dim=48"):
        ops.attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ops.attention(q, q.transpose(1, 2).contiguous().transpose(1, 2), q)
    with pytest.raises(ValueError, match="float16"):
        h = q.half()
        ops.attention(h, h, h)
