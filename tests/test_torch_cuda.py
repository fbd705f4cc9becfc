"""Every CUDA kernel against its plain PyTorch version, on the card.

These need a CUDA device and nvcc (the kernels have no CPU mode) and skip
elsewhere; the JAX side is not imported, so they run on a machine without
JAX:  ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerance: max abs error over max abs reference, <= 1e-5 in fp32 and
<= 3e-2 in bf16 (DESIGN.md §12); the backward kernels' gradients by
rel-L2 per output, with the same budgets; the SSD scan against its sequential
plain version <= 1e-4 in fp32 (two summation orders over the sequence,
the JAX package's own kernel vs sequential bound in
``tests/test_kernels.py``), and its backward against the closed form by
rel-L2 with that budget.
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# K4's backward: fp32 tightened so that a kernel whose products lost the
# split-TF32 (one TF32 product: dA within 9.9e-5 at (64, 128, 128)) fails
# (tests/test_torch_ssd_grads.py, SSD_BWD_FP32_BUDGET)
SSD_BWD_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
ATTN_CASES = [
    # (b, sq, sk, h, kv, d, causal)
    (1, 37, 77, 4, 4, 32, False),      # odd N against Lt=77 (cross)
    (2, 50, 50, 4, 2, 64, False),      # GQA
    (1, 33, 33, 2, 2, 128, True),      # causal, odd
    (1, 21, 21, 4, 4, 256, False),     # the text encoder's head_dim
    (1, 19, 19, 4, 4, 16, False),      # the reduced text encoder's
    (1, 200, 300, 24, 24, 64, False),  # several q and k tiles, ragged
    (1, 130, 130, 4, 4, 64, True),     # causal block skip over 3 tiles
    # ragged q against the 64-query tile, ragged k against the 32-key tile
    (1, 130, 77, 24, 24, 64, False),
    (1, 200, 77, 24, 24, 64, False),
    (1, 130, 300, 24, 24, 64, False),
    (1, 160, 160, 4, 2, 64, True),     # causal GQA over 3 query tiles
    (1, 70, 100, 2, 2, 256, False),    # d=256's 32-query tile, 3 tiles
    (1, 130, 50, 2, 1, 128, False),    # d=128, one KV head
    # DIT_VIDEO's head dim 128 over a few thousand keys, both edges
    # ragged (1000 against the 64-query tile, 4100 against the 32-key
    # tile), and its cross-attention to 77 text tokens
    (1, 1000, 4100, 24, 24, 128, False),
    (1, 1000, 77, 24, 24, 128, False),
    # zamba2-7b's shared block at head dim 112 (7 column pairs a lane):
    # causal over several query tiles and ragged, under GQA, non-causal
    # with both edges ragged, and its full-width heads at 520 tokens
    (2, 130, 130, 4, 4, 112, True),
    (1, 33, 33, 2, 2, 112, True),
    (1, 160, 160, 4, 2, 112, True),
    (1, 130, 77, 4, 4, 112, False),
    (1, 520, 520, 32, 32, 112, True),
    # yi-6b's causal GQA (32 q heads over 4 kv heads) at head dim 128
    (1, 300, 300, 32, 4, 128, True),
    # whisper-medium at batch 4: the encoder's self-attention over the
    # 1500 frames (ragged against both tiles), the decoder's cross-
    # attention of a 4-token prompt and of a decode step to them
    (4, 1500, 1500, 16, 16, 64, False),
    (4, 4, 1500, 16, 16, 64, False),
    (4, 1, 1500, 16, 16, 64, False),
    # a few queries over 1500 ragged keys, as above, at every head dim,
    # under GQA and causal (Sq = Sk over one head): the tile grid of these
    # cannot fill the card's SMs, so the keys are split (_expect_split
    # says which); with 40 or 128 query heads it can, and the same shapes
    # take the tile kernel alone
    (1, 1, 1500, 8, 2, 64, False),
    (1, 4, 1500, 8, 2, 128, False),
    (2, 1, 1500, 4, 4, 112, False),
    (1, 4, 1500, 2, 1, 256, False),
    (1, 1, 1500, 4, 4, 16, False),
    (1, 4, 1500, 4, 2, 32, False),
    (1, 1500, 1500, 1, 1, 64, True),
    (1, 520, 520, 2, 2, 112, True),
    (4, 4, 1500, 40, 8, 64, False),
    (2, 1, 1500, 128, 16, 64, False),
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


def _close(got, want, dtype, tol=TOL):
    torch.cuda.synchronize()
    got, want = got.double(), want.double()
    assert got.shape == want.shape
    err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
    assert err <= tol[dtype], (err, tol[dtype])


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
@pytest.mark.parametrize("offset,sk,n", [
    (0, 120, 40), (40, 120, 40), (80, 120, 40),   # first, middle, last
    (77, 300, 100),       # segment edges inside 32-key tiles
])
def test_cuda_splice_kernel(cuda_device, offset, sk, n, dtype):
    rng = np.random.default_rng(offset)
    q = _card(rng, (1, n, 4, 64), dtype, cuda_device)
    ks, vs = (_card(rng, (1, sk, 2, 64), dtype, cuda_device)
              for _ in range(2))
    kf, vf = (_card(rng, (1, n, 2, 64), dtype, cuda_device)
              for _ in range(2))
    before = ops.launches["splice_attention"]
    got = ops.splice_attention(q, ks, vs, kf, vf, offset=offset)
    assert ops.launches["splice_attention"] == before + 1
    _close(got, ref.splice_attention_ref(q, ks, vs, kf, vf, offset=offset),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset,sk,n", [
    (0, 120, 40), (37, 300, 100), (200, 300, 100),
])
def test_cuda_splice_kernel_head_dim_112(cuda_device, offset, sk, n, dtype):
    """K3 through the attention template at head dim 112 (GQA)."""
    rng = np.random.default_rng(offset + 112)
    q = _card(rng, (1, n, 4, 112), dtype, cuda_device)
    ks, vs = (_card(rng, (1, sk, 2, 112), dtype, cuda_device)
              for _ in range(2))
    kf, vf = (_card(rng, (1, n, 2, 112), dtype, cuda_device)
              for _ in range(2))
    before = ops.launches["splice_attention"]
    got = ops.splice_attention(q, ks, vs, kf, vf, offset=offset)
    assert ops.launches["splice_attention"] == before + 1
    _close(got, ref.splice_attention_ref(q, ks, vs, kf, vf, offset=offset),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset,sk,n", [
    (1037, 4100, 1000),   # the video hit: 24 heads x 128, ragged offset
    (3900, 7800, 1950),   # rank 2 of SP-4 at 480x832x17 frames
])
def test_cuda_splice_kernel_head_dim_128(cuda_device, offset, sk, n, dtype):
    rng = np.random.default_rng(offset)
    q = _card(rng, (1, n, 24, 128), dtype, cuda_device)
    ks, vs = (_card(rng, (1, sk, 24, 128), dtype, cuda_device)
              for _ in range(2))
    kf, vf = (_card(rng, (1, n, 24, 128), dtype, cuda_device)
              for _ in range(2))
    before = ops.launches["splice_attention"]
    got = ops.splice_attention(q, ks, vs, kf, vf, offset=offset)
    assert ops.launches["splice_attention"] == before + 1
    _close(got, ref.splice_attention_ref(q, ks, vs, kf, vf, offset=offset),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(ADALN_VARIANTS))
# DIT_IMAGE; scalar path; widest; DIT_VIDEO (NV=24 float4 a lane)
@pytest.mark.parametrize("d", [1536, 100, 4096, 3072])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_adaln_kernel(cuda_device, variant, dtype, d, aligned):
    rng = np.random.default_rng(1)
    b, n = 2, 130
    t = {"x": _card(rng, (b, n, d), dtype, cuda_device),
         "residual": _card(rng, (b, n, d), dtype, cuda_device)}
    if not aligned:      # contiguous, one element past a 16-byte boundary
        x = torch.empty(b * n * d + 1, dtype=t["x"].dtype,
                        device=cuda_device)[1:].view(b, n, d)
        x.copy_(t["x"])
        assert x.is_contiguous() and x.data_ptr() % 16
        t["x"] = x
    for name in ("shift", "scale", "gate"):
        t[name] = _card(rng, (b, d), dtype, cuda_device, 0.2)
    kw = {name: t[name] for name in ADALN_VARIANTS[variant]}
    ln = variant != "gated_residual"
    before = ops.launches["fused_adaln"]
    got = ops.fused_adaln(t["x"], ln=ln, **kw)
    assert ops.launches["fused_adaln"] == before + 1
    _close(got, ref.adaln_ref(t["x"], ln=ln, **kw), dtype)


def _expect_split(b, sq, sk, h, d, dtype="bfloat16") -> bool:
    """Whether K2's ``dtype`` kernel should split the keys: its grid of
    64-query tiles cannot fill the card's SMs once, and the keys (in
    tiles of 64, 32 at bf16 d = 256 and fp32 d > 32) hold two pieces of
    two tiles or more, for fp32 at d = 256 (one block an SM) only where
    two pieces a tile fit the SMs; or, in fp32, three or more one-tile
    pieces that each get an SM of their own."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = -(-sq // 64) * b * h
    bf16 = dtype == "bfloat16"
    ktiles = -(-sk // (64 if d <= (128 if bf16 else 32) else 32))
    if tiles >= sms:
        return False
    if not bf16 and tiles * ktiles <= sms:
        return ktiles >= 3
    return ktiles >= 4 and (bf16 or d != 256 or 2 * tiles <= sms)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal",
                         [c for c in ATTN_CASES if c[2] >= 520])
def test_cuda_attention_bf16_route(cuda_device, b, sq, sk, h, kv, d,
                                   causal):
    """Each long-key bf16 case takes the route its grid calls for (split
    keys when the tile grid cannot fill the SMs, else the tile kernel
    alone), counted in ``ops.kernel_launches``; the output and the
    split path's log-sum-exp agree with the plain versions."""
    rng = np.random.default_rng(sq + sk + h)
    q = _card(rng, (b, sq, h, d), "bfloat16", cuda_device)
    k, v = (_card(rng, (b, sk, kv, d), "bfloat16", cuda_device)
            for _ in range(2))
    split = _expect_split(b, sq, sk, h, d)
    assert (ops.attention_splits(b, sq, sk, h, d) > 1) == split
    assert (ops.attention_splits(b, sq, sk, h, d, torch.float32) > 1) == \
        _expect_split(b, sq, sk, h, d, "float32")
    route = "attention bf16 split" if split else "attention bf16"
    before = dict(ops.kernel_launches)
    out, lse = ops.attention_lse(q, k, v, causal=causal)
    after = dict(ops.kernel_launches)
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    _close(out, ref.attention_ref(q, k, v, causal=causal), "bfloat16")
    assert _rel_l2(lse, ref.attention_lse_ref(q, k, causal=causal)) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", [
    c for c in ATTN_CASES if c[2] >= 520] + [
    (1, 77, 77, 4, 4, 256, False),     # the text encoder: 3 one-tile pieces
    (2, 77, 130, 4, 2, 32, False),     # 64-key tiles, GQA
    # DIT_IMAGE at a 512 px request's SP-4 shard: self over 1024 keys
    # splits, cross to 77 text tokens (3 key tiles, pieces sharing SMs)
    # does not; a 128 px shard's cross does (3 one-tile pieces), its self
    # over 2 key tiles does not
    (1, 256, 1024, 24, 24, 64, False),
    (1, 256, 77, 24, 24, 64, False),
    (1, 16, 77, 24, 24, 64, False),
    (1, 16, 64, 24, 24, 64, False),
])
def test_cuda_attention_fp32_route(cuda_device, b, sq, sk, h, kv, d, causal):
    """Each long-key fp32 case, and two short grids whose fp32 pieces are
    one key tile, takes the split-TF32 kernel's route its grid calls for
    (split keys when the tile grid cannot fill the SMs: whisper's
    cross-attention of a prompt and of a decode step; else the tile
    kernel alone), counted in ``ops.kernel_launches``; the output within
    the fp32 budget and the log-sum-exp within 1e-6 of the plain
    versions."""
    rng = np.random.default_rng(sq + sk + h)
    q = _card(rng, (b, sq, h, d), "float32", cuda_device)
    k, v = (_card(rng, (b, sk, kv, d), "float32", cuda_device)
            for _ in range(2))
    split = _expect_split(b, sq, sk, h, d, "float32")
    assert (ops.attention_splits(b, sq, sk, h, d, torch.float32) > 1) == split
    route = "attention fp32 split" if split else "attention fp32"
    before = dict(ops.kernel_launches)
    out, lse = ops.attention_lse(q, k, v, causal=causal)
    after = dict(ops.kernel_launches)
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    _close(out, ref.attention_ref(q, k, v, causal=causal), "float32")
    assert _rel_l2(lse, ref.attention_lse_ref(q, k, causal=causal)) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,offset", [
    (1, 256, 1024, 24, 24, 64, False, None),   # a 512 px SP-4 shard
    (1, 256, 1024, 24, 24, 64, False, 512),    # its §11 hit
    (2, 40, 300, 4, 2, 128, False, None),      # GQA, ragged keys
    (1, 300, 300, 2, 2, 64, True, None)])      # causal
def test_cuda_attention_any_split_count(cuda_device, dtype, b, sq, sk, h, kv,
                                        d, causal, offset):
    """K2 and K3 in 1 to 8 key pieces, as a caller passing its own count
    (a timing script) runs them, each within the dtype's budget of the
    plain version: the walk and the combine hold at every piece count,
    not only at the library's."""
    rng = np.random.default_rng(sq + sk)
    q = _card(rng, (b, sq, h, d), dtype, cuda_device)
    k, v = (_card(rng, (b, sk, kv, d), dtype, cuda_device) for _ in range(2))
    if offset is None:
        want = ref.attention_ref(q, k, v, causal=causal)
    else:
        kf, vf = (_card(rng, (b, sq, kv, d), dtype, cuda_device)
                  for _ in range(2))
        want = ref.splice_attention_ref(q, k, v, kf, vf, offset=offset)
    for n in range(1, 9):
        got = (ops._attention_fwd(q, k, v, causal, False, n)[0]
               if offset is None else
               ops._splice_fwd(q, k, v, kf, vf, offset, n))
        _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", [
    (4, 1, 1500, 16, 16, 64, False),      # split keys
    (1, 1500, 1500, 1, 1, 64, True),      # split keys, causal
    (1, 200, 300, 24, 24, 64, False),     # the tile kernel
    (1, 70, 100, 2, 2, 256, False)])
def test_cuda_attention_fp32_is_deterministic(cuda_device, b, sq, sk, h, kv,
                                              d, causal):
    """Two fp32 forward calls give the same bits, output and lse: the
    split pieces are merged in a fixed order, with no atomics."""
    rng = np.random.default_rng(12)
    q = _card(rng, (b, sq, h, d), "float32", cuda_device)
    k, v = (_card(rng, (b, sk, kv, d), "float32", cuda_device)
            for _ in range(2))
    first = ops.attention_lse(q, k, v, causal=causal)
    second = ops.attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,offset", [
    (1, 256, 1024, 24, 24, 64, False, None),   # a 512 px SP-4 shard
    (1, 256, 1024, 24, 24, 64, False, 512),    # its §11 hit
    (2, 40, 300, 4, 2, 128, False, None),      # GQA, ragged keys
    (1, 300, 300, 2, 2, 64, True, None)])      # causal
def test_cuda_attention_any_split_count(cuda_device, dtype, b, sq, sk, h, kv,
                                        d, causal, offset):
    """K2 and K3 in 1 to 8 key pieces, as a caller passing its own count
    (a timing script) runs them, each within the dtype's budget of the
    plain version: the walk and the combine hold at every piece count,
    not only at the library's."""
    rng = np.random.default_rng(sq + sk)
    q = _card(rng, (b, sq, h, d), dtype, cuda_device)
    k, v = (_card(rng, (b, sk, kv, d), dtype, cuda_device) for _ in range(2))
    if offset is None:
        want = ref.attention_ref(q, k, v, causal=causal)
    else:
        kf, vf = (_card(rng, (b, sq, kv, d), dtype, cuda_device)
                  for _ in range(2))
        want = ref.splice_attention_ref(q, k, v, kf, vf, offset=offset)
    for n in range(1, 9):
        got = (ops._attention_fwd(q, k, v, causal, False, n)[0]
               if offset is None else
               ops._splice_fwd(q, k, v, kf, vf, offset, n))
        _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", [
    (4, 1, 1500, 16, 16, 64, False),      # split keys
    (1, 1500, 1500, 1, 1, 64, True),      # split keys, causal
    (1, 200, 300, 24, 24, 64, False),     # the tile kernel
    (1, 70, 100, 2, 2, 256, False)])
def test_cuda_attention_bf16_is_deterministic(cuda_device, b, sq, sk, h, kv,
                                              d, causal):
    """Two bf16 forward calls give the same bits, output and lse: the
    split pieces are merged in a fixed order, with no atomics."""
    rng = np.random.default_rng(12)
    q = _card(rng, (b, sq, h, d), "bfloat16", cuda_device)
    k, v = (_card(rng, (b, sk, kv, d), "bfloat16", cuda_device)
            for _ in range(2))
    first = ops.attention_lse(q, k, v, causal=causal)
    second = ops.attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 112, 128])
@pytest.mark.parametrize("sq,h,offset,sk,n", [
    (100, 4, 77, 300, 100),    # fresh rows [77, 177): edges inside tiles
    (300, 4, 130, 900, 300),   # [130, 430), the stale tail ragged
    (4, 2, 701, 1500, 100),    # a few queries: split keys, edges inside
    (1, 2, 0, 1500, 37),       # pieces and a tile
])
def test_cuda_splice_bf16_segment_edges(cuda_device, d, sq, h, offset, sk,
                                        n):
    """K3 in bf16 at segment edges inside a 64-key tile, on the tile
    kernel and (a few queries over 1500 keys) on split keys."""
    rng = np.random.default_rng(offset + d)
    q = _card(rng, (1, sq, h, d), "bfloat16", cuda_device)
    ks, vs = (_card(rng, (1, sk, 2, d), "bfloat16", cuda_device)
              for _ in range(2))
    kf, vf = (_card(rng, (1, n, 2, d), "bfloat16", cuda_device)
              for _ in range(2))
    split = _expect_split(1, sq, sk, h, d)
    route = "attention bf16 split" if split else "attention bf16"
    before = ops.kernel_launches[route]
    got = ops.splice_attention(q, ks, vs, kf, vf, offset=offset)
    assert ops.kernel_launches[route] == before + 1
    _close(got, ref.splice_attention_ref(q, ks, vs, kf, vf, offset=offset),
           "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 112, 128])
@pytest.mark.parametrize("sq,h,offset,sk,n", [
    (100, 4, 0, 300, 100),     # fresh rows first: [0, 100)
    (100, 4, 77, 300, 100),    # [77, 177): edges inside tiles
    (100, 4, 200, 300, 100),   # fresh rows last: [200, 300)
    (300, 4, 130, 900, 300),   # [130, 430), the stale tail ragged
    (4, 2, 701, 1500, 100),    # a few queries: split keys, edges inside
    (1, 2, 0, 1500, 37),       # pieces and a tile
])
def test_cuda_splice_fp32_segment_edges(cuda_device, d, sq, h, offset, sk,
                                        n):
    """K3 in fp32 (split-TF32) with the fresh rows first, in the middle
    and last, their edges inside a key tile, on the tile kernel and (a
    few queries over 1500 keys) on split keys, each by its route."""
    rng = np.random.default_rng(offset + d + 1)
    q = _card(rng, (1, sq, h, d), "float32", cuda_device)
    ks, vs = (_card(rng, (1, sk, 2, d), "float32", cuda_device)
              for _ in range(2))
    kf, vf = (_card(rng, (1, n, 2, d), "float32", cuda_device)
              for _ in range(2))
    split = _expect_split(1, sq, sk, h, d, "float32")
    route = "attention fp32 split" if split else "attention fp32"
    before = ops.kernel_launches[route]
    got = ops.splice_attention(q, ks, vs, kf, vf, offset=offset)
    assert ops.kernel_launches[route] == before + 1
    _close(got, ref.splice_attention_ref(q, ks, vs, kf, vf, offset=offset),
           "float32")


#: K2's backward: causal, GQA, cross (Sq != Sk), ragged against the
#: 64-row tile (32 at d=256), every head dim of ops.HEAD_DIMS, and the
#: training path's shapes at small batch
ATTN_BWD_CASES = [
    # (b, sq, sk, h, kv, d, causal)
    (1, 37, 77, 4, 4, 32, False),      # cross, both edges ragged
    (2, 50, 50, 4, 2, 64, False),      # GQA
    (1, 33, 33, 2, 2, 128, True),      # causal, odd
    (1, 130, 130, 4, 4, 64, True),     # causal over 3 tiles
    (1, 160, 160, 4, 2, 112, True),    # causal GQA at zamba2's head dim
    (1, 70, 100, 2, 2, 256, False),    # d=256's 32-row tile
    (1, 19, 19, 4, 4, 16, False),      # the reduced text encoder's
    (2, 200, 64, 24, 24, 64, False),   # DIT_IMAGE's cross to 64 tokens
    (1, 300, 300, 32, 4, 128, True),   # yi-6b's causal GQA
    (2, 150, 150, 16, 16, 64, False),  # whisper's encoder self, ragged
    # the bf16 tensor-core kernels' tile edges (16 rows a warp; 64 keys a
    # dK/dV block, 32 at d=256; 64 or 32 queries a dK/dV step; 64
    # queries a dQ block): Sq and Sk of 1, 15, 17, 63, 65 and 129
    (1, 1, 1, 2, 2, 64, False),
    (1, 1, 129, 4, 2, 128, False),
    (1, 129, 1, 2, 1, 16, False),
    (1, 15, 17, 4, 4, 32, False),
    (2, 17, 15, 4, 2, 64, False),
    (1, 63, 65, 2, 2, 112, False),
    (1, 65, 63, 2, 2, 256, False),
    (1, 15, 15, 2, 2, 64, True),
    (1, 17, 17, 2, 2, 256, True),
    (1, 65, 65, 4, 4, 64, True),
    (1, 129, 129, 2, 2, 256, True),
    # causal over several tiles at d=112 and d=128; GQA group 8 at d=128
    (1, 257, 257, 4, 2, 112, True),
    (2, 193, 193, 4, 4, 128, True),
    (1, 129, 129, 16, 2, 128, True),
    (1, 100, 150, 16, 2, 128, False),
]


def _rel_l2(got, want):
    torch.cuda.synchronize()
    got, want = got.double(), want.double()
    assert got.shape == want.shape
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", ATTN_BWD_CASES)
def test_cuda_attention_backward_kernel(cuda_device, b, sq, sk, h, kv, d,
                                        causal, dtype):
    """K2's forward log-sum-exp and its backward kernels against the plain
    versions on the same inputs (rel-L2 per output, 1e-5 fp32, 3e-2
    bf16); one backward call counts one launch."""
    rng = np.random.default_rng(d + sq)
    q = _card(rng, (b, sq, h, d), dtype, cuda_device)
    k, v = (_card(rng, (b, sk, kv, d), dtype, cuda_device)
            for _ in range(2))
    do = _card(rng, (b, sq, h, d), dtype, cuda_device)
    out, lse = ops.attention_lse(q, k, v, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    assert _rel_l2(lse, ref.attention_lse_ref(q, k, causal=causal)) <= 1e-6
    _close(out, ref.attention_ref(q, k, v, causal=causal), dtype)
    o = ref.attention_ref(q, k, v, causal=causal).contiguous()
    lse = ref.attention_lse_ref(q, k, causal=causal)
    before = ops.launches["attention_bwd"]
    got = ops.attention_bwd(q, k, v, o, lse, do, causal=causal)
    assert ops.launches["attention_bwd"] == before + 1
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
    sizes = _one_key_sizes(q, k, v, do) if sk == 1 else {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in sizes:
            err = (g.double() - w.double()).norm().item() / sizes[name]
        else:
            err = _rel_l2(g, w)
        assert err <= TOL[dtype], (name, err)


def _one_key_sizes(q, k, v, do) -> dict:
    """With one key the softmax is constant, so dq and dk are 0: each is
    scale times dS = dP - D, the difference of two equal sums over the
    head dim, where rel-L2 measures rounding noise against noise.  Their
    errors are held instead against the size of what cancels: the sum of
    |dO| |v| times |k| (dq) or |q| (dk)."""
    d, group = q.shape[3], q.shape[2] // k.shape[2]
    kr, vr = (torch.repeat_interleave(t, group, dim=2).double().abs()
              for t in (k, v))
    s = (do.double().abs() * vr).sum(-1, keepdim=True) * d ** -0.5
    return {"dq": (s * kr).norm().item(),
            "dk": (s * q.double().abs()).sum(1).norm().item()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", [
    (2, 200, 200, 8, 2, 64, True), (1, 130, 77, 4, 4, 128, False),
    (1, 70, 100, 2, 2, 256, False)])
def test_cuda_attention_backward_is_deterministic(cuda_device, b, sq, sk, h,
                                                 kv, d, causal, dtype):
    """Two backward calls on the same inputs give the same bits: every
    gradient element is summed by one thread in a fixed order (no
    atomics)."""
    rng = np.random.default_rng(11)
    q, do = (_card(rng, (b, sq, h, d), dtype, cuda_device) for _ in range(2))
    k, v = (_card(rng, (b, sk, kv, d), dtype, cuda_device)
            for _ in range(2))
    o, lse = ops.attention_lse(q, k, v, causal=causal)
    first = ops.attention_bwd(q, k, v, o, lse, do, causal=causal)
    second = ops.attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b_), name


def _sass_functions(lib) -> dict:
    """{mangled function name: its SASS} of a built library, by
    ``cuobjdump -sass``; skips where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        pytest.skip("cuobjdump not found")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=600).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {f: "\n".join(body) for f, body in funcs.items()}


#: per dtype, the operand type of the HMMA (tensor-core) instructions its
#: backward products compile to (m16n8k16 on bf16, m16n8k8 on TF32, as
#: ``cuobjdump -sass`` spells them) and the dtype's code in the kernels'
#: mangled names
BWD_HMMA = {"bfloat16": (".BF16", "13__nv_bfloat16"),
            "float32": (".TF32", "f")}


def _attention_backward_sass(dtype) -> tuple[dict, dict]:
    """({mangled name: SASS} of K2's dK/dV and dQ kernels of ``dtype``,
    the same of every function of the library): one dK/dV and one dQ
    kernel at every head dim of ``ops.HEAD_DIMS``, each holding the
    dtype's HMMA."""
    from repro_torch.kernels import build
    build.load()
    funcs = _sass_functions(build.library_path())
    operand, code = BWD_HMMA[dtype]
    found = {}
    for kernel in ("attn_bwd_dkdv_mma_kernel", "attn_bwd_dq_mma_kernel"):
        mine = {f: body for f, body in funcs.items()
                if f"{len(kernel)}{kernel}I{code}Li" in f}
        assert len(mine) == len(ops.HEAD_DIMS), (kernel, sorted(mine))
        for f, body in mine.items():
            assert any("HMMA" in line and operand in line
                       for line in body.splitlines()), (f, operand)
        found.update(mine)
    return found, funcs


@pytest.mark.cuda
def test_cuda_attention_backward_bf16_runs_on_tensor_cores(cuda_device):
    """The bf16 dK/dV and dQ kernels of every head dim hold bf16 HMMA
    (tensor core) instructions."""
    _attention_backward_sass("bfloat16")


@pytest.mark.cuda
def test_cuda_attention_backward_fp32_runs_split_tf32(cuda_device):
    """The fp32 dK/dV and dQ kernels of every head dim hold TF32 HMMA
    instructions, three to each fp32 product (a count divisible by 3),
    and no other backward kernel is left: every ``attn_bwd`` function of
    the library is the D kernel or one of the two tensor-core templates
    (the CUDA-core fp32 kernels are gone)."""
    found, funcs = _attention_backward_sass("float32")
    for f, body in found.items():
        count = sum("HMMA" in line for line in body.splitlines())
        assert count and count % 3 == 0, (f, count)
        assert "BF16" not in body, f
    names = [f for f in funcs if "attn_bwd" in f]
    allowed = ("attn_bwd_delta_kernel", "attn_bwd_dkdv_mma_kernel",
               "attn_bwd_dq_mma_kernel")
    assert names and all(any(a in f for a in allowed) for f in names), names
    assert len(names) == 2 + 4 * len(ops.HEAD_DIMS), names


def _attention_forward_sass(code) -> tuple[dict, dict]:
    """({mangled name: SASS} of K2's forward tile kernel of the dtype
    whose mangled code is ``code``, at every head dim of
    ``ops.HEAD_DIMS``, the same of every function of the library)."""
    from repro_torch.kernels import build
    build.load()
    funcs = _sass_functions(build.library_path())
    prefix = f"_ZN5gfdit15attn_mma_kernelI{code}Li"
    tiles = {f: body for f, body in funcs.items() if f.startswith(prefix)}
    dims = sorted(int(f[len(prefix):].split("E")[0]) for f in tiles)
    assert dims == sorted(ops.HEAD_DIMS), sorted(tiles)
    return tiles, funcs


@pytest.mark.cuda
def test_cuda_attention_forward_bf16_runs_on_tensor_cores(cuda_device):
    """K2's (and K3's) bf16 forward: one tensor-core tile kernel at every
    head dim of ``ops.HEAD_DIMS``, each holding bf16 HMMA instructions,
    and the split-key combine kernel; no CUDA-core forward is left
    (``attn_kernel<T, D>``, of either dtype)."""
    tiles, funcs = _attention_forward_sass(BWD_HMMA["bfloat16"][1])
    for f, body in tiles.items():
        assert any("HMMA" in line and ".BF16" in line
                   for line in body.splitlines()), f
    assert [f for f in funcs
            if f.startswith("_ZN5gfdit19attn_combine_kernel")], sorted(funcs)
    assert not [f for f in funcs if f.startswith("_ZN5gfdit11attn_kernel")]


@pytest.mark.cuda
def test_cuda_attention_forward_fp32_runs_split_tf32(cuda_device):
    """K2's (and K3's) fp32 forward: the tile kernel at every head dim of
    ``ops.HEAD_DIMS`` holds TF32 HMMA instructions, three to each fp32
    product (a count divisible by 3) and no bf16 ones; a combine kernel
    writes fp32, and no fp32 kernel on the CUDA cores is left
    (``attn_kernel<float, D>``)."""
    tiles, funcs = _attention_forward_sass(BWD_HMMA["float32"][1])
    for f, body in tiles.items():
        count = sum("HMMA" in line for line in body.splitlines())
        assert count and count % 3 == 0, (f, count)
        assert all(".TF32" in line for line in body.splitlines()
                   if "HMMA" in line), f
        assert "BF16" not in body, f
    assert [f for f in funcs
            if f.startswith("_ZN5gfdit19attn_combine_kernelIfE")], \
        sorted(funcs)
    assert not [f for f in funcs if f.startswith("_ZN5gfdit11attn_kernelIf")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_attention_bwd_rejects_misaligned_operands(cuda_device, dtype):
    """The backward kernels stage q, k, v and dO by 16-byte cp.async in
    both dtypes: a contiguous operand off a 16-byte boundary is refused,
    never copied."""
    dt = getattr(torch, dtype)
    q = torch.zeros(1, 8, 2, 64, device=cuda_device, dtype=dt)
    lse = torch.zeros(1, 2, 8, device=cuda_device)
    do = torch.zeros(q.numel() + 1, device=cuda_device, dtype=dt)[1:]
    do = do.view(q.shape)
    assert do.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.attention_bwd(q, q, q, q, lse, do)


ADALN_BWD_VARIANTS = sorted(ADALN_VARIANTS) + ["modulate"]


def _adaln_bwd_inputs(rng, b, n, d, dtype, device, variant, offset=0):
    """x and dy of (b, n, d), the variant's (B, D) rows as keywords, and
    ln; with ``offset`` x starts that many elements past an allocation
    (16-byte misaligned for an odd offset: the kernel's scalar path)."""
    x = _card(rng, (b, n, d), dtype, device)
    if offset:
        moved = torch.empty(b * n * d + offset, dtype=x.dtype,
                            device=device)[offset:].view(b, n, d)
        moved.copy_(x)
        x = moved
    dy = _card(rng, (b, n, d), dtype, device)
    t = {name: _card(rng, (b, d), dtype, device, 0.2)
         for name in ("shift", "scale", "gate")}
    names = ADALN_VARIANTS.get(variant, ("shift", "scale"))
    kw = {name: t[name] for name in names if name != "residual"}
    return x, dy, kw, variant not in ("gated_residual", "modulate")


def _adaln_bwd_close(got, want, dtype):
    for name, g, w in zip(("dx", "dshift", "dscale", "dgate", "dresidual"),
                          got, want):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, name
            err = _rel_l2(g, w)
            assert err <= TOL[dtype], (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ADALN_BWD_VARIANTS)
# DIT_IMAGE; ragged against a block's rows, and D=100 (a vector path of
# 25 float4 in fp32, the scalar path in bf16); widest; one token row; a
# DIT_VIDEO shard (5070 rows of 3072)
@pytest.mark.parametrize("b,d,n", [(2, 1536, 130), (2, 100, 37),
                                   (2, 4096, 20), (1, 1536, 1),
                                   (1, 3072, 5070)])
def test_cuda_adaln_backward_kernel(cuda_device, variant, dtype, b, d, n):
    """K1's backward against its plain version, every variant (and
    shift/scale without LN), rel-L2 per output."""
    rng = np.random.default_rng(d + n)
    x, dy, kw, ln = _adaln_bwd_inputs(rng, b, n, d, dtype, cuda_device,
                                      variant)
    before = ops.launches["fused_adaln_bwd"]
    got = ops.fused_adaln_bwd(x, dy=dy, ln=ln, **kw)
    assert ops.launches["fused_adaln_bwd"] == before + 1
    _adaln_bwd_close(got, ref.adaln_bwd_ref(x, dy=dy, ln=ln, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ADALN_BWD_VARIANTS)
@pytest.mark.parametrize("d,n", [(1536, 130), (1000, 45)])
def test_cuda_adaln_backward_scalar_path(cuda_device, variant, dtype, d, n):
    """With x one element off a 16-byte boundary the kernel runs its
    scalar instantiation (V = 1), held to the same budget."""
    rng = np.random.default_rng(5)
    x, dy, kw, ln = _adaln_bwd_inputs(rng, 2, n, d, dtype, cuda_device,
                                      variant, offset=1)
    assert x.is_contiguous() and x.data_ptr() % 16
    got = ops.fused_adaln_bwd(x, dy=dy, ln=ln, **kw)
    _adaln_bwd_close(got, ref.adaln_bwd_ref(x, dy=dy, ln=ln, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ADALN_BWD_VARIANTS)
def test_cuda_adaln_backward_is_deterministic(cuda_device, variant, dtype):
    """Two calls on the same inputs give the same bits: the row sums run
    in a fixed order, and each column sum adds its blocks' partials in a
    fixed order (no atomics).  (2, 300, 1536) spreads each batch row over
    many blocks of several rows."""
    rng = np.random.default_rng(13)
    x, dy, kw, ln = _adaln_bwd_inputs(rng, 2, 300, 1536, dtype, cuda_device,
                                      variant)
    first = ops.fused_adaln_bwd(x, dy=dy, ln=ln, **kw)
    second = ops.fused_adaln_bwd(x, dy=dy, ln=ln, **kw)
    torch.cuda.synchronize()
    for name, a, b_ in zip(("dx", "dshift", "dscale", "dgate"), first,
                           second):
        assert (a is None) == (b_ is None), name
        if a is not None:
            assert torch.equal(a, b_), name


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["gated_residual", "full"])
def test_cuda_adaln_backward_hands_dy_on_as_dresidual(cuda_device, variant):
    """The residual's gradient is the output's: the wrapper returns the
    incoming dy tensor itself, as the plain version does, and writes no
    copy; through autograd the residual's gradient is dy's values."""
    rng = np.random.default_rng(17)
    x, dy, kw, ln = _adaln_bwd_inputs(rng, 2, 64, 256, "float32",
                                      cuda_device, variant)
    dres = ops.fused_adaln_bwd(x, dy=dy, ln=ln, **kw)[4]
    assert dres is dy and dres.data_ptr() == dy.data_ptr()
    res = torch.zeros_like(x, requires_grad=True)
    ops.fused_adaln(x, residual=res, ln=ln, **kw).backward(dy)
    assert torch.equal(res.grad, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(ADALN_VARIANTS))
def test_cuda_adaln_gradient_matches_the_plain_version(cuda_device, variant,
                                                      dtype):
    """backward() through ``ops.fused_adaln`` on the card (K1 and its
    backward kernel) gives the gradients of autograd through
    ``ref.adaln_ref`` on the same inputs on the card, every operand."""
    rng = np.random.default_rng(19)
    b, n, d = 2, 77, 1536
    args = {"x": _card(rng, (b, n, d), dtype, cuda_device)}
    for name in ADALN_VARIANTS[variant]:
        shape = (b, n, d) if name == "residual" else (b, d)
        args[name] = _card(rng, shape, dtype, cuda_device, 0.2)
    ln = variant != "gated_residual"
    dy = _card(rng, (b, n, d), dtype, cuda_device)
    grads = []
    for fn in (ops.fused_adaln, ref.adaln_ref):
        leaves = {k: v.detach().requires_grad_(True) for k, v in
                  args.items()}
        fn(**leaves, ln=ln).backward(dy)
        grads.append({k: v.grad for k, v in leaves.items()})
    for name in args:
        assert _rel_l2(grads[0][name], grads[1][name]) <= TOL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_adaln_backward_plan_fills_the_card(cuda_device, dtype):
    """At DIT_IMAGE's training shape (2, 1024, 1536) the row kernel's grid
    covers every SM, and every batch row's blocks together walk its 1024
    rows (the rule the wrapper sizes its scratch by)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for ln, mod, gated in ((1, 1, 0), (1, 0, 0), (0, 0, 1), (1, 1, 1)):
        plan = ops.adaln_bwd_plan(2, 1024, 1536, ln=ln, mod=mod,
                                  gated=gated, dtype=getattr(torch, dtype))
        chunks, rows = plan["blocks_a_batch_row"], plan["rows_a_block"]
        assert 2 * chunks >= sms, plan
        assert (chunks - 1) * rows < 1024 <= chunks * rows, plan
        assert plan["blocks_per_sm"] >= 1, plan


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["attention", "fused_adaln",
                                     "splice_attention", "ssd"])
def test_cuda_no_wrapper_drops_a_gradient(cuda_device, wrapper):
    """A backward() through each kernel wrapper on the card gives the
    plain versions' gradients (autograd of ``ref.py`` on the CPU, same
    inputs), or the wrapper raises: no operand that requires grad is
    left without one.  K2, K1 and K4 backpropagate through their
    backward kernels (K4 within its two-order budget: the plain version
    is the sequential recurrence); K3 has none and refuses."""
    rng = np.random.default_rng(7)

    def leaf(*shape, scale=1.0):
        return _card(rng, shape, "float32", cuda_device, scale) \
            .requires_grad_(True)
    if wrapper == "splice_attention":
        args = (leaf(1, 8, 2, 64), leaf(1, 16, 2, 64), leaf(1, 16, 2, 64),
                leaf(1, 8, 2, 64), leaf(1, 8, 2, 64))
        with pytest.raises(NotImplementedError, match="no backward kernel"):
            ops.splice_attention(*args, offset=4)
        return
    if wrapper == "ssd":       # y and the final state both carry one
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        dt, A = ssm.sample_dt_a((1, 40, 2), 2, gen)
        args = (leaf(1, 40, 2, 16), dt.requires_grad_(True),
                A.requires_grad_(True), leaf(1, 40, 16), leaf(1, 40, 16))
        outs = ops.ssd(*args, chunk=16)
        grads = [torch.from_numpy(rng.standard_normal(o.shape).astype(
            np.float32)).to(cuda_device) for o in outs]
        torch.autograd.backward(outs, grads)
        cpu = [a.detach().cpu().requires_grad_(True) for a in args]
        torch.autograd.backward(ref.ssd_ref(*cpu), [g.cpu() for g in grads])
        for a, c in zip(args, cpu):
            assert a.grad is not None and a.grad.is_cuda
            assert _rel_l2(a.grad, c.grad.to(cuda_device)) <= \
                SSD_TOL["float32"]
        return
    if wrapper == "attention":
        args = (leaf(2, 40, 4, 64), leaf(2, 40, 2, 64), leaf(2, 40, 2, 64))
        kernel = lambda *a: ops.attention(*a, causal=True)  # noqa: E731
        plain = lambda *a: ref.attention_ref(*a, causal=True)  # noqa: E731
    else:
        args = (leaf(2, 40, 96), leaf(2, 96, scale=0.2),
                leaf(2, 96, scale=0.2), leaf(2, 96, scale=0.2),
                leaf(2, 40, 96))
        kernel, plain = ops.fused_adaln, ref.adaln_ref
    dy = torch.from_numpy(rng.standard_normal(args[0].shape).astype(
        np.float32)).to(cuda_device)
    kernel(*args).backward(dy)
    cpu = [a.detach().cpu().requires_grad_(True) for a in args]
    plain(*cpu).backward(dy.cpu())
    for a, c in zip(args, cpu):
        assert a.grad is not None and a.grad.is_cuda
        assert _rel_l2(a.grad, c.grad.to(cuda_device)) <= 1e-5


@pytest.mark.cuda
def test_cuda_serving_calls_launch_no_backward_path(cuda_device):
    """Under inference_mode, and with operands that do not require grad,
    K2 and K1 return outputs without a grad_fn and K2 writes no
    log-sum-exp: the serving path launches what it did before."""
    q = torch.randn(1, 64, 2, 64, device=cuda_device)
    x = torch.randn(1, 64, 128, device=cuda_device, requires_grad=True)
    with torch.inference_mode():
        assert ops.fused_adaln(x).grad_fn is None
    assert ops.attention(q, q, q).grad_fn is None
    assert ops.fused_adaln(x).grad_fn is not None


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dit-image", "yi-6b", "whisper-medium",
                                  "mamba2-1.3b", "zamba2-7b"])
def test_cuda_reduced_train_step_matches_the_cpu(cuda_device, arch):
    """One fp32 step of the reduced model on the card (K1/K2/K4 and their
    backward kernels) and on the CPU (plain versions, closed-form
    backward), same weights and batch: the loss and every parameter
    leaf's gradient within 1e-4 rel-L2 (the card-vs-CPU budget of the
    LM checks), and the updated weights of a bf16 step within 3e-2.  The
    SSD families' A and dt in Mamba2's published ranges, 24 tokens over
    two chunks of 16; their bf16 step is held by its update (new - old
    weights) where the fp32 gradient is above a third of its leaf's RMS,
    as ``tests/test_torch_training.py`` holds the bf16 step to JAX's: a
    first AdamW step moves each weight by about lr * sign(g), and
    zero-initialised leaves (the conv biases) hold nothing else, so where
    g is near zero a bf16 rounding flips the whole weight on either side
    (zamba2's ``conv_b`` moved 0.20 rel-L2 apart over the whole leaf)."""
    from repro_torch.models import dit, get_model
    from repro_torch.training import optimizer, train_loop
    cfg = get_config(arch).reduced()
    family = get_model(cfg)
    cpu = family.init(cfg, device="cpu")
    if cfg.family == "dit":
        dit.liven_adaln(cpu, cfg.d_model)
    if cfg.ssm is not None:
        ssm.init_published_a_dt(cpu, seed=3)
    card = family.init(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    old = {k: v.clone() for k, v in cpu.state_dict().items()}
    batch = train_loop.synth_batch(cfg, 2, 24, device="cpu",
                                   generator=torch.Generator().manual_seed(3))
    if cfg.family == "dit":        # 16 x 16 latents: 64 tokens
        batch = {k: v[:, :, :16, :16] if v.ndim == 5 else v
                 for k, v in batch.items()}
    got = {}
    for name, model in (("cpu", cpu), ("card", card)):
        dev = next(model.parameters()).device
        b = {k: v.to(dev) for k, v in batch.items()}
        loss, _, grads = train_loop.grads_of(model, b, cfg, "none",
                                             dtype=torch.float32)
        got[name] = (float(loss), {k: g.cpu() for k, g in grads.items()})
        step = train_loop.make_train_step(cfg, remat="full")
        step(model, optimizer.adamw_init(dict(model.named_parameters())), b)
    (lc, gc), (lg, gg) = got["cpu"], got["card"]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for name in gc:
        assert gg[name].norm() > 0 or gc[name].norm() == 0, name
        err = ((gg[name].double() - gc[name].double()).norm()
               / gc[name].double().norm().clamp_min(1e-30)).item()
        assert err <= 1e-4, (name, err)
    for (name, p), q in zip(card.named_parameters(), cpu.parameters()):
        if cfg.ssm is None:
            assert _rel_l2(p, q.to(cuda_device)) <= TOL["bfloat16"], name
            continue
        g = gc[name].abs()
        held = g > g.double().square().mean().sqrt() / 3
        assert held.any(), name
        was = old[name].to(cuda_device)
        assert _rel_l2((p - was)[held.to(cuda_device)],
                       (q.to(cuda_device) - was)[held.to(cuda_device)]) \
            <= TOL["bfloat16"], name


@pytest.mark.cuda
def test_cuda_ssd_grad_fn_launches_ssd_bwd(cuda_device):
    """A CUDA ``ops.ssd`` under grad returns outputs with a grad_fn whose
    backward launches K4's backward kernel once (and nothing else)."""
    rng = np.random.default_rng(3)
    x, dt, A, B, C = _ssd_inputs(rng, 1, 40, 2, 16, 16, "float32",
                                 cuda_device)
    x.requires_grad_(True)
    y, state = ops.ssd(x, dt, A, B, C, chunk=16)
    assert y.grad_fn is not None
    before = dict(ops.launches)
    y.sum().backward()
    torch.cuda.synchronize()
    after = dict(ops.launches)
    assert after["ssd_bwd"] == before["ssd_bwd"] + 1
    assert {k: v for k, v in after.items() if k != "ssd_bwd"} == \
        {k: v for k, v in before.items() if k != "ssd_bwd"}
    assert x.grad is not None and torch.isfinite(x.grad).all()


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


@pytest.mark.cuda
def test_cuda_attention_rejects_misaligned_operands(cuda_device):
    """The attention kernel copies 16-byte chunks with cp.async: a
    contiguous operand that starts off a 16-byte boundary is refused."""
    q = torch.zeros(1, 8, 2, 64, device=cuda_device)
    k = torch.zeros(1 * 8 * 2 * 64 + 1, device=cuda_device)[1:].view(q.shape)
    assert k.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.attention(q, k, q)


def _ssd_inputs(rng, b, l, h, p, n, dtype, device):
    """dt and A in Mamba2's published ranges (``ssm.sample_dt_a``), so the
    state carried across chunks does not underflow to zero."""
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**31)))
    dt, A = ssm.sample_dt_a((b, l, h), h, gen)
    x = _card(rng, (b, l, h, p), dtype, device)
    B, C = (_card(rng, (b, l, n), dtype, device) for _ in range(2))
    return x, dt, A, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,n,chunk", ops.SSD_SHAPES)
@pytest.mark.parametrize("ragged", [False, True])
def test_cuda_ssd_kernel(cuda_device, p, n, chunk, dtype, ragged):
    rng = np.random.default_rng(p + n + chunk)
    b, h = 2, 3
    l = 3 * chunk + (chunk // 2 + 1 if ragged else 0)
    x, dt, A, B, C = _ssd_inputs(rng, b, l, h, p, n, dtype, cuda_device)
    before = ops.launches["ssd"]
    y, st = ops.ssd(x, dt, A, B, C, chunk=chunk)
    assert ops.launches["ssd"] == before + 1
    assert y.dtype == x.dtype and st.dtype == torch.float32
    yr, sr = ref.ssd_ref(x, dt, A, B, C)
    _close(y, yr, dtype, SSD_TOL)
    _close(st, sr, dtype, SSD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (1, 300, 4, 64, 128, 128),    # batch 1, full width, ragged
    (2, 50, 3, 64, 128, 128),     # l < chunk: one partial chunk
    (2, 10, 3, 16, 16, 32),       # ... of a narrow shape
    (2, 128, 3, 64, 128, 128),    # l equal to one chunk
    (2, 1000, 4, 16, 16, 16),     # many chunks at the reduced shape
    (1, 2080, 8, 64, 64, 128),    # zamba2-7b's shape at its ragged forward
])
def test_cuda_ssd_stage_edges(cuda_device, b, l, h, p, n, chunk, dtype):
    """The chunk-parallel stages at the edges of their grids: one block
    row, one partial or one whole chunk, 63 chunks in the state pass."""
    rng = np.random.default_rng(b * l + p)
    x, dt, A, B, C = _ssd_inputs(rng, b, l, h, p, n, dtype, cuda_device)
    before = ops.launches["ssd"]
    y, st = ops.ssd(x, dt, A, B, C, chunk=chunk)
    assert ops.launches["ssd"] == before + 1
    assert y.shape == x.shape and st.shape == (b, h, p, n)
    yr, sr = ref.ssd_ref(x, dt, A, B, C)
    _close(y, yr, dtype, SSD_TOL)
    _close(st, sr, dtype, SSD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("p,n,chunk", [(64, 128, 128), (16, 16, 16)])
def test_cuda_ssd_carried_state_dominates(cuda_device, p, n, chunk):
    """x is zero past the first chunk and the decay slow (dt = 1e-3), so
    every later y is the carried state's term alone: a fault in the
    state pass or in C . S_in shows in full."""
    rng = np.random.default_rng(7)
    b, h, l = 2, 3, 5 * chunk + 3
    x, dt, A, B, C = _ssd_inputs(rng, b, l, h, p, n, "float32", cuda_device)
    x[:, chunk:] = 0
    dt.fill_(1e-3)
    y, st = ops.ssd(x, dt, A, B, C, chunk=chunk)
    yr, sr = ref.ssd_ref(x, dt, A, B, C)
    assert yr[:, chunk:].abs().max() > 0.1 * yr[:, :chunk].abs().max()
    _close(y, yr, "float32", SSD_TOL)
    _close(st, sr, "float32", SSD_TOL)


@pytest.mark.cuda
def test_cuda_ssd_counts_one_launch_per_call(cuda_device):
    """One ``ops.ssd`` call runs four stage kernels and counts one
    launch; no other counter moves."""
    rng = np.random.default_rng(1)
    x, dt, A, B, C = _ssd_inputs(rng, 1, 40, 2, 16, 16, "float32",
                                 cuda_device)
    before = dict(ops.launches)
    for _ in range(3):
        ops.ssd(x, dt, A, B, C, chunk=16)
    torch.cuda.synchronize()
    after = dict(ops.launches)
    assert after["ssd"] == before["ssd"] + 3
    assert {k: v for k, v in after.items() if k != "ssd"} == \
        {k: v for k, v in before.items() if k != "ssd"}


@pytest.mark.cuda
def test_cuda_ssd_rejects_misaligned_operands(cuda_device):
    """The stage kernels copy 16-byte chunks with cp.async: a contiguous
    x that starts off a 16-byte boundary is refused."""
    rng = np.random.default_rng(2)
    x, dt, A, B, C = _ssd_inputs(rng, 1, 32, 2, 16, 16, "float32",
                                 cuda_device)
    odd = torch.empty(x.numel() + 1, device=cuda_device)[1:].view(x.shape)
    odd.copy_(x)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.ssd(odd, dt, A, B, C, chunk=16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_backward_takes_a_misaligned_incoming_gradient(cuda_device,
                                                                dtype):
    """A contiguous output gradient at an odd storage offset: ``ops.ssd_bwd``
    refuses it (its kernels read dy in 16-byte chunks), so ``_SSD.backward``
    copies it into an aligned buffer, and the gradients equal those of
    the same dy aligned, bit for bit."""
    rng = np.random.default_rng(4)
    x, dt, A, B, C = _ssd_inputs(rng, 1, 40, 2, 16, 16, dtype, cuda_device)
    dy = _card(rng, x.shape, dtype, cuda_device)
    odd = torch.empty(dy.numel() + 1, dtype=dy.dtype,
                      device=cuda_device)[1:].view(dy.shape)
    odd.copy_(dy)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    _, _, scratch = ops.ssd_for_grad(x, dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.ssd_bwd(x, dt, A, B, C, odd, None, chunk=16, scratch=scratch)
    grads = []
    for g in (dy, odd):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, dt, B, C)]
        y, _ = ops.ssd(leaves[0], leaves[1], A, leaves[2], leaves[3],
                       chunk=16)
        y.backward(g)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    rng = np.random.default_rng(0)
    x, dt, A, B, C = _ssd_inputs(rng, 1, 32, 2, 16, 16, "float32",
                                 cuda_device)
    with pytest.raises(ValueError, match="unsupported"):
        ops.ssd(x, dt, A, B, C, chunk=8)
    with pytest.raises(ValueError, match="float32"):
        ops.ssd(x, dt.double(), A, B, C, chunk=16)
    with pytest.raises(ValueError, match="B is"):
        ops.ssd(x, dt, A, B.bfloat16(), C, chunk=16)


@pytest.mark.cuda
@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,n,chunk", ops.SSD_SHAPES)
@pytest.mark.parametrize("ragged", [False, True])
def test_cuda_ssd_bwd_kernel(cuda_device, p, n, chunk, dtype, ragged,
                             with_dstate):
    """K4's backward (four stage kernels, one launch) against
    ``ref.ssd_bwd_ref`` on the same inputs and output gradients, the
    scratch from K4's forward: rel-L2 per output within the backward's
    budget (fp32 2e-5: split-TF32 products, the plain version summing in
    another order)."""
    rng = np.random.default_rng(p + n + chunk + 1)
    b, h = 2, 3
    l = 3 * chunk + (chunk // 2 + 1 if ragged else 0)
    x, dt, A, B, C = _ssd_inputs(rng, b, l, h, p, n, dtype, cuda_device)
    dy = _card(rng, (b, l, h, p), dtype, cuda_device)
    dstate = (_card(rng, (b, h, p, n), "float32", cuda_device)
              if with_dstate else None)
    _, _, scratch = ops.ssd_for_grad(x, dt, A, B, C, chunk=chunk)
    before = ops.launches["ssd_bwd"]
    got = ops.ssd_bwd(x, dt, A, B, C, dy, dstate, chunk=chunk,
                      scratch=scratch)
    assert ops.launches["ssd_bwd"] == before + 1
    want = ref.ssd_bwd_ref(x, dt, A, B, C, dy, dstate, chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert _rel_l2(g, w) <= SSD_BWD_TOL[dtype], (name, _rel_l2(g, w))


@pytest.mark.cuda
def test_cuda_ssd_bwd_masks_the_decay_before_the_exp(cuda_device):
    """fp32 at mamba2-1.3b's (64, 128, 128), ragged, with one head at the
    edge of Mamba2's published ranges (dt = 1e-1, A = -16), so that a
    chunk's cum spans more than 88.7: above the diagonal cum_i - cum_j
    would overflow exp to inf, and inf * 0 = NaN wherever the decay is
    not masked before the exp.  Every output finite and within budget."""
    rng = np.random.default_rng(12)
    b, l, h, p, n, chunk = 2, 2 * 128 + 37, 3, 64, 128, 128
    x, dt, A, B, C = _ssd_inputs(rng, b, l, h, p, n, "float32", cuda_device)
    dt[..., 0] = 1e-1
    A[0] = -16.0
    dy = _card(rng, (b, l, h, p), "float32", cuda_device)
    dstate = _card(rng, (b, h, p, n), "float32", cuda_device)
    _, _, scratch = ops.ssd_for_grad(x, dt, A, B, C, chunk=chunk)
    cum = scratch[:b * 3 * h * chunk].view(b, 3, h, chunk)
    assert (cum[..., 0] - cum[..., -1]).max().item() > 88.7
    got = ops.ssd_bwd(x, dt, A, B, C, dy, dstate, chunk=chunk,
                      scratch=scratch)
    want = ref.ssd_bwd_ref(x, dt, A, B, C, dy, dstate, chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert torch.isfinite(g).all(), name
        assert _rel_l2(g, w) <= SSD_BWD_TOL["float32"], (name, _rel_l2(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_bwd_is_deterministic(cuda_device, dtype):
    """No atomics: two calls on the same inputs agree bit for bit (the
    remat check of ``chip_smoke.py`` rests on it)."""
    rng = np.random.default_rng(9)
    x, dt, A, B, C = _ssd_inputs(rng, 2, 300, 4, 64, 128, dtype,
                                 cuda_device)
    dy = _card(rng, x.shape, dtype, cuda_device)
    _, _, scratch = ops.ssd_for_grad(x, dt, A, B, C, chunk=128)
    first = ops.ssd_bwd(x, dt, A, B, C, dy, chunk=128, scratch=scratch)
    second = ops.ssd_bwd(x, dt, A, B, C, dy, chunk=128, scratch=scratch)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_cuda_ssd_bf16_forward_is_deterministic(cuda_device):
    """The bf16 forward's tensor-core stages: two calls on the same
    inputs agree bit for bit (y and the final state), at mamba2-1.3b's
    (p, n, chunk) with a ragged l."""
    rng = np.random.default_rng(10)
    x, dt, A, B, C = _ssd_inputs(rng, 2, 300, 4, 64, 128, "bfloat16",
                                 cuda_device)
    first = ops.ssd(x, dt, A, B, C, chunk=128)
    second = ops.ssd(x, dt, A, B, C, chunk=128)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_cuda_ssd_fp32_forward_is_deterministic(cuda_device):
    """The fp32 forward's split-TF32 stages: two calls on the same inputs
    agree bit for bit (y, the final state and the scratch the backward
    reads), at mamba2-1.3b's (p, n, chunk) with a ragged l; the remat
    check of ``chip_smoke.py`` rests on it."""
    rng = np.random.default_rng(13)
    x, dt, A, B, C = _ssd_inputs(rng, 2, 300, 4, 64, 128, "float32",
                                 cuda_device)
    y0, s0, scratch0 = ops.ssd_for_grad(x, dt, A, B, C, chunk=128)
    y1, s1, scratch1 = ops.ssd_for_grad(x, dt, A, B, C, chunk=128)
    assert torch.equal(y0, y1) and torch.equal(s0, s1)
    # the scratch's written parts: cum, the chunk states (S_in; chunk 0's
    # slot holds its own chunk state) and C B^T's (j, i) entries with j <=
    # i (the tiles above the diagonal are never written)
    sizes = ops._ssd_scratch_sizes(2, 300, 4, 64, 128, 128)
    (c0, st0, cb0), (c1, st1, cb1) = (t.split(sizes)
                                      for t in (scratch0, scratch1))
    assert torch.equal(c0, c1) and torch.equal(st0, st1)
    low = torch.ones(128, 128, dtype=torch.bool, device=cuda_device).triu()
    assert torch.equal(cb0.view(2, 3, 128, 128)[..., low],
                       cb1.view(2, 3, 128, 128)[..., low])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_counts_its_dtype(cuda_device, dtype):
    """K4's forward and backward count each call under their dtype in
    ``ops.kernel_launches`` (fp32 and bf16 run different stage
    kernels), and nothing else there."""
    rng = np.random.default_rng(11)
    x, dt, A, B, C = _ssd_inputs(rng, 1, 40, 2, 16, 16, dtype, cuda_device)
    tag = {"float32": "fp32", "bfloat16": "bf16"}[dtype]
    before = dict(ops.kernel_launches)
    _, _, scratch = ops.ssd_for_grad(x, dt, A, B, C, chunk=16)
    ops.ssd_bwd(x, dt, A, B, C, torch.ones_like(x), chunk=16,
                scratch=scratch)
    after = dict(ops.kernel_launches)
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r in (f"ssd {tag}", f"ssd_bwd {tag}")) for r in after}


@pytest.mark.cuda
def test_cuda_ssd_bf16_runs_on_tensor_cores(cuda_device):
    """K4's bf16 forward stages 1, 3 and 4 and its backward's stages 1
    and 3 hold bf16 HMMA (tensor core) instructions at every (p, n,
    chunk) of ``ops.SSD_SHAPES``; the fp32 backward's hold TF32 ones;
    no bf16 instance of the CUDA-core forward stages is left, and no
    CUDA-core backward kernel at all."""
    from repro_torch.kernels import build
    build.load()
    funcs = _sass_functions(build.library_path())
    kernels = {"ssd_chunk_state_mma": ("13__nv_bfloat16",),
               "ssd_cb_mma": ("13__nv_bfloat16",),
               "ssd_chunk_scan_mma": ("13__nv_bfloat16",),
               "ssd_bwd_dstate_mma": ("13__nv_bfloat16", "f"),
               "ssd_bwd_chunk_mma": ("13__nv_bfloat16", "f")}
    for kernel, codes in kernels.items():
        for code in codes:
            operand = BWD_HMMA["bfloat16" if code != "f" else "float32"][0]
            mine = {f: body for f, body in funcs.items()
                    if f"{len(kernel)}{kernel}I{code}Li" in f}
            assert len(mine) == len(ops.SSD_SHAPES), (kernel, sorted(mine))
            for f, body in mine.items():
                assert any("HMMA" in line and operand in line
                           for line in body.splitlines()), (f, operand)
    for kernel in ("ssd_chunk_state", "ssd_cb", "ssd_chunk_scan"):
        assert not [f for f in funcs
                    if f"{len(kernel)}{kernel}I13__nv_bfloat16" in f], kernel
    assert not [f for f in funcs if "ssd_bwd_chunkI" in f
                or "ssd_bwd_chunk_dstate" in f]


@pytest.mark.cuda
def test_cuda_ssd_fp32_runs_split_tf32(cuda_device):
    """K4's fp32 forward: the float instances of stages 1, 3 and 4
    (``ssd_chunk_state_mma``, ``ssd_cb_mma``, ``ssd_chunk_scan_mma``) at
    every (p, n, chunk) of ``ops.SSD_SHAPES`` hold TF32 HMMA instructions,
    three to each fp32 product (a count divisible by 3), and no bf16 ones;
    no CUDA-core forward stage (``ssd_chunk_state``, ``ssd_cb``,
    ``ssd_chunk_scan``) of either dtype is left in the library."""
    from repro_torch.kernels import build
    build.load()
    funcs = _sass_functions(build.library_path())
    for kernel in ("ssd_chunk_state_mma", "ssd_cb_mma", "ssd_chunk_scan_mma"):
        mine = {f: body for f, body in funcs.items()
                if f"{len(kernel)}{kernel}IfLi" in f}
        assert len(mine) == len(ops.SSD_SHAPES), (kernel, sorted(mine))
        for f, body in mine.items():
            count = sum("HMMA" in line for line in body.splitlines())
            assert count and count % 3 == 0, (f, count)
            assert all(".TF32" in line for line in body.splitlines()
                       if "HMMA" in line), f
            assert "BF16" not in body, f
    for kernel in ("ssd_chunk_state", "ssd_cb", "ssd_chunk_scan"):
        assert not [f for f in funcs if f"{len(kernel)}{kernel}I" in f], \
            kernel


@pytest.mark.cuda
def test_cuda_ssd_bwd_needs_the_forwards_scratch(cuda_device, monkeypatch):
    rng = np.random.default_rng(4)
    x, dt, A, B, C = _ssd_inputs(rng, 1, 32, 2, 16, 16, "float32",
                                 cuda_device)
    with pytest.raises(ValueError, match="scratch"):
        ops.ssd_bwd(x, dt, A, B, C, torch.ones_like(x), chunk=16)
    _, _, scratch = ops.ssd_for_grad(x, dt, A, B, C, chunk=16)
    with pytest.raises(ValueError, match="scratch"):
        ops.ssd_bwd(x, dt, A, B, C, torch.ones_like(x), chunk=16,
                    scratch=scratch[1:])
    # its own scratch: the kernel's rule sizes it, and a float short of
    # that rule is refused, not written past
    rule = ops._fn("gfdit_ssd_bwd_scratch")
    assert rule(1, 32, 2, 16, 16, 16) == 4 * (16 * 16 + 1 + 2 * 16 * 16 + 1)
    assert rule(1, 32, 2, 16, 16, 48) == -1
    short = {"gfdit_ssd_bwd_scratch": lambda *a: rule(*a) - 1}
    real = ops._fn
    monkeypatch.setattr(ops, "_fn", lambda name: short.get(name) or real(name))
    with pytest.raises(RuntimeError, match="ssd_bwd: kernel launch"):
        ops.ssd_bwd(x, dt, A, B, C, torch.ones_like(x), chunk=16,
                    scratch=scratch)


@pytest.mark.cuda
def test_cuda_mamba2_reduced_matches_the_cpu(cuda_device):
    """mamba2-1.3b.reduced() with the same livened weights: the card (K4)
    against the CPU (the sequential plain version), fp32 logits."""
    cfg = get_config("mamba2-1.3b").reduced()
    cpu = ssm.Mamba2(cfg, device="cpu")
    ssm.init_published_a_dt(cpu, seed=3)
    rng = np.random.default_rng(3)
    card = ssm.Mamba2(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    before = ops.launches["ssd"]
    with torch.inference_mode():
        want, _ = ssm.forward(cpu, toks, cfg, dtype=torch.float32)
        got, _ = ssm.forward(card, toks.to(cuda_device), cfg,
                             dtype=torch.float32)
    assert ops.launches["ssd"] == before + cfg.num_layers
    err = (torch.linalg.vector_norm(got.cpu().double() - want.double())
           / torch.linalg.vector_norm(want.double())).item()
    assert err <= 1e-4, err


@pytest.mark.cuda
def test_cuda_hybrid_reduced_matches_the_cpu(cuda_device):
    """zamba2-7b.reduced(num_layers=5) (two groups and a tail layer) with
    the same livened weights: forward (K2 causal once per shared-block
    application, K4 once per Mamba2 layer) and a 32-token prefill plus 8
    decode steps through the serve-loop steps, the card against the CPU
    (plain versions), fp32 logits within 1e-4 rel-L2."""
    from repro_torch.models import hybrid
    from repro_torch.serving import serve_loop
    cfg = get_config("zamba2-7b").reduced(num_layers=5)
    cpu = hybrid.Hybrid(cfg, device="cpu")
    ssm.init_published_a_dt(cpu, seed=4)
    card = hybrid.Hybrid(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 40)))
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        t = toks.to(next(model.parameters()).device)
        before = dict(ops.launches)
        with torch.inference_mode():
            full, _ = hybrid.forward(model, t, cfg, dtype=torch.float32)
        if name == "card":
            assert ops.launches["attention"] == before["attention"] + 2
            assert ops.launches["ssd"] == before["ssd"] + cfg.num_layers
        prefill = serve_loop.make_prefill_step(cfg, dtype=torch.float32)
        step = serve_loop.make_serve_step(cfg, dtype=torch.float32)
        cache = hybrid.init_cache(cfg, 2, 40, dtype=torch.float32,
                                  device=t.device)
        lg, cache = prefill(model, t[:, :32], cache)
        steps = [lg[:, 0]]
        for i in range(32, 40):
            lg, cache = step(model, t[:, i:i + 1], cache,
                             torch.full((2,), i, device=t.device))
            steps.append(lg[:, 0])
        out[name] = [full.cpu().double(),
                     torch.stack(steps, 1).cpu().double()]
    for got, want in zip(out["card"], out["cpu"]):
        err = (torch.linalg.vector_norm(got - want)
               / torch.linalg.vector_norm(want)).item()
        assert err <= 1e-4, err


@pytest.mark.cuda
def test_cuda_moe_picks_match_the_cpu_on_ties(cuda_device):
    """A reduced mixtral MoE layer in bf16 whose router columns 1 and 2 are
    equal, on integer-valued inputs: every logit is exact on both sides,
    so probabilities tie wherever logits do (columns 1 and 2 always), and
    the card's expert picks must be the CPU's (``jax.lax.top_k``'s order,
    the lower index first); outputs within the bf16 budget."""
    from repro_torch.models import layers as L
    cfg = get_config("mixtral-8x7b").reduced()
    gen = torch.Generator().manual_seed(5)
    cpu = L.MoE(cfg, generator=gen, device="cpu")
    with torch.no_grad():
        cpu.router.copy_(torch.randint(-2, 3, cpu.router.shape,
                                       generator=gen) / 8)
        cpu.router[:, 2] = cpu.router[:, 1]
    card = L.MoE(cfg, generator=None, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    x = torch.randint(-2, 3, (2, 64, cfg.d_model), generator=gen).bfloat16()
    picks, outs = {}, {}
    for name, layer in (("cpu", cpu), ("card", card)):
        xs = x.to(next(layer.parameters()).device)
        with torch.inference_mode():
            probs, _, gate_i, _, _, _ = L.moe_route(layer, xs.reshape(
                1, -1, cfg.d_model), cfg)
            outs[name] = L.moe_apply(layer, xs, cfg)[0].float().cpu()
        picks[name] = gate_i.cpu()
        assert torch.equal(probs[..., 1], probs[..., 2])
    assert torch.equal(picks["card"], picks["cpu"])
    # the tied pair splits on some tokens, and then expert 1 is picked
    one = (picks["card"] == 1).any(-1) ^ (picks["card"] == 2).any(-1)
    assert one.any() and not (picks["card"] == 2).any(-1)[one].any()
    _close(outs["card"], outs["cpu"], "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,overrides", [
    ("mixtral-8x7b", {}),
    ("deepseek-v2-236b", {"num_layers": 3}),
    ("whisper-medium", {}),
])
def test_cuda_moe_mla_encdec_reduced_match_the_cpu(cuda_device, arch,
                                                   overrides):
    """Reduced mixtral (SWA + MoE), deepseek (MLA, a dense prefix layer,
    two MoE super-blocks; with q_lora_rank 24, which .reduced() turns
    off) and whisper (K2 in the encoder and every cross-attention) with
    the same weights: forward over 40 tokens, and a 32-token prefill plus
    8 decode steps (deepseek: absorbed), the card against the CPU, fp32
    logits within 1e-4 rel-L2."""
    import dataclasses

    from repro_torch.models import get_model
    from repro_torch.serving import serve_loop
    cfg = get_config(arch).reduced(**overrides)
    if cfg.mla is not None:
        cfg = cfg.with_(mla=dataclasses.replace(cfg.mla, q_lora_rank=24))
    family = get_model(cfg)
    cpu = family.init(cfg, device="cpu")
    card = family.init(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.frontend_seq, cfg.d_model)).astype(np.float32))
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        dev = next(model.parameters()).device
        t = toks.to(dev)
        extra = (frames.to(dev),) if cfg.family == "encdec" else ()
        before = ops.launches["attention"]
        with torch.inference_mode():
            full, _ = family.forward(model, t, *extra, cfg,
                                     dtype=torch.float32)
        if name == "card":
            want = 3 * cfg.num_layers if cfg.family == "encdec" else 0
            assert ops.launches["attention"] == before + want
        prefill = serve_loop.make_prefill_step(cfg, dtype=torch.float32)
        step = serve_loop.make_serve_step(
            cfg, dtype=torch.float32, mla_absorbed=cfg.mla is not None)
        cache = family.init_cache(cfg, 2, 40, dtype=torch.float32,
                                  device=dev)
        lg, cache = prefill(model, t[:, :32], *extra, cache)
        steps = [lg[:, 0]]
        for i in range(32, 40):
            lg, cache = step(model, t[:, i:i + 1], cache,
                             torch.full((2,), i, device=dev))
            steps.append(lg[:, 0])
        out[name] = [full.cpu().double(),
                     torch.stack(steps, 1).cpu().double()]
    for got, want in zip(out["card"], out["cpu"]):
        err = (torch.linalg.vector_norm(got - want)
               / torch.linalg.vector_norm(want)).item()
        assert err <= 1e-4, err


@pytest.mark.cuda
def test_cuda_elastic_demo_and_dropped_engines_free_the_card(cuda_device,
                                                            monkeypatch):
    """The elastic scenario on the card at DIT_IMAGE.reduced(): identical
    wall and sim traces and telemetry (exact), and after every engine's
    shutdown the card holds no more live tensors than before the demo
    (cuBLAS's per-handle workspaces freed first), with the garbage
    collector off."""
    import gc

    from repro_torch.configs.dit_models import DIT_IMAGE
    from repro_torch.serving import elastic_demo
    from repro_torch.serving.engine import ServingEngine

    def settled():
        torch.cuda.synchronize()
        if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
            torch._C._cuda_clearCublasWorkspaces()
        return torch.cuda.memory_allocated()

    held, real = [], ServingEngine.shutdown

    def shutdown(eng):
        real(eng)
        held.append(settled() - base)
    monkeypatch.setattr(ServingEngine, "shutdown", shutdown)
    base = settled()
    gc.disable()
    try:
        res = elastic_demo.run_demo(DIT_IMAGE.reduced(), device=cuda_device)
    finally:
        gc.enable()
    assert res["trace_match"] and res["telemetry_match"]
    assert res["wall"]["metrics"]["completed"] == 2
    assert len(held) >= 7 and max(held) <= 0, held


@pytest.mark.cuda
def test_cuda_reduced_video_request_is_served(cuda_device):
    """DIT_VIDEO.reduced() serving a 64x64 request of 9 frames at SP-2
    with §11 refresh and hit steps on the card: pixels of the latent
    frame count (3, 64, 64, 3), finite, through K1-K3."""
    from repro_torch.configs.dit_models import DIT_VIDEO
    from repro_torch.core.scheduler import Decision, Policy
    from repro_torch.core.trajectory import ExecutionLayout, Request
    from repro_torch.models import dit
    from repro_torch.serving.cache_demo import _liven
    from repro_torch.serving.engine import ServingEngine

    class SP2(Policy):
        """Encode/decode on one rank, every denoise step on two."""
        name = "sp2"

        def schedule(self, view):
            out, free = [], list(view.free_ranks)
            for t, _, _ in sorted(view.ready, key=lambda x: x[0].id):
                k = 2 if t.kind == "denoise" else 1
                if len(free) < k:
                    break
                out.append(Decision(t.id, ExecutionLayout(tuple(free[:k]))))
                free = free[k:]
            return out

    cfg = DIT_VIDEO.reduced()
    eng = ServingEngine(cfg, SP2(), 4, cache_interval=2, device=cuda_device)
    req = Request(id="vid", model="dit-video", height=64, width=64,
                  frames=9, steps=2, arrival=0.0)
    ops.reset_launches()
    try:
        _liven(eng.pipeline)
        eng.serve([req], timeout=120)
        px = eng.result_pixels(req)
        modes = [e.get("cache") for e in eng.cp.events
                 if e["ev"] == "dispatch" and e["kind"] == "denoise"]
    finally:
        eng.shutdown()
    assert modes == ["refresh", "hit"]
    assert px.shape == (dit.latent_shape(cfg, 64, 64, 9)[0], 64, 64, 3)
    assert np.isfinite(px).all()
    assert all(ops.launches[k] > 0 for k in
               ("fused_adaln", "attention", "splice_attention"))


@pytest.mark.cuda
def test_cuda_sim_fidelity_leg_serves_every_request(cuda_device, tmp_path,
                                                    monkeypatch):
    """``repro_torch.benchmarks.sim_fidelity``'s real-runtime leg on the
    card at DIT_IMAGE.reduced() (one policy): all 12 requests complete
    on the thread runtime and on the simulator replay, through K1 and
    K2, and the calibrated table is written."""
    from repro_torch.benchmarks import common, sim_fidelity
    from repro_torch.configs.dit_models import DIT_IMAGE
    monkeypatch.setattr(sim_fidelity, "POLICIES", ["edf"])
    monkeypatch.setattr(common, "serving_config",
                        lambda device: DIT_IMAGE.reduced())
    ops.reset_launches()
    got = sim_fidelity.run(cuda_device, tmp_path, demos=False)
    m = got["edf"]
    assert m["real_completed"] == m["sim_completed"] == m["requests"] == 12
    assert ops.launches["fused_adaln"] > 0 and ops.launches["attention"] > 0
    assert (tmp_path / "cost_table_h100.json").exists()


def _reduced_pair(arch, device):
    """``arch``'s reduced model on the CPU and a copy on ``device``, with
    a seeded batch of 2 x 24 tokens."""
    from repro_torch.models import dit, get_model
    from repro_torch.training import train_loop
    cfg = get_config(arch).reduced()
    cpu = get_model(cfg).init(cfg, device="cpu")
    if cfg.family == "dit":
        dit.liven_adaln(cpu, cfg.d_model)
    card = get_model(cfg).init(cfg, device=device)
    card.load_state_dict(cpu.state_dict())
    batch = train_loop.synth_batch(cfg, 2, 24, device="cpu",
                                   generator=torch.Generator().manual_seed(3))
    if cfg.family == "dit":        # 16 x 16 latents: 64 tokens
        batch = {k: v[:, :, :16, :16] if v.ndim == 5 else v
                 for k, v in batch.items()}
    return cfg, cpu, card, batch


def _grads(model, batch, cfg, remat="none"):
    from repro_torch.training import train_loop
    dev = next(model.parameters()).device
    loss, _, grads = train_loop.grads_of(
        model, {k: v.to(dev) for k, v in batch.items()}, cfg, remat,
        dtype=torch.float32)
    return float(loss), grads


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-medium", "deepseek-v2-236b"])
def test_cuda_encdec_and_mla_moe_gradients_match_the_cpu(cuda_device, arch):
    """whisper (K2's backward at its three sites) and deepseek (MLA and
    the MoE, plain ops): one fp32 loss and every gradient leaf of the
    reduced model, card against CPU, within 1e-4 rel-L2."""
    cfg, cpu, card, batch = _reduced_pair(arch, cuda_device)
    (lc, gc), (lg, gg) = (_grads(m, batch, cfg) for m in (cpu, card))
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for name in gc:
        assert _rel_l2(gg[name], gc[name].to(cuda_device)) <= 1e-4, name


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-6b", "dit-image"])
def test_cuda_selective_remat_gradients_are_bitwise(cuda_device, arch):
    cfg, _, card, batch = _reduced_pair(arch, cuda_device)
    ln, gn = _grads(card, batch, cfg, "none")
    ls, gs = _grads(card, batch, cfg, "selective")
    assert ls == ln
    assert [k for k in gn if not torch.equal(gn[k], gs[k])] == []


def _flipped(got, want, method):
    """Elements of two compressed leaves on either side of a boundary: an
    int8 code that differs, or a top-k membership that differs."""
    if method == "topk":
        return (got != 0) != (want != 0)
    if got.ndim == 0:
        return torch.zeros((), dtype=torch.bool)

    def codes(q):
        return torch.round(q / (q.abs().max() / 127.0))
    return codes(got) != codes(want)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["int8", "topk"])
def test_cuda_compression_matches_the_cpu(cuda_device, method):
    """``training/compression.py`` on the card against the CPU on the
    same reduced yi-6b gradients: equal payload bytes, and every leaf
    within 1e-4 rel-L2 but for the elements on either side of an int8
    rounding or the top-k threshold (a flip moves its element by a whole
    quantum); those must be rare (at most 1e-4 of the elements)."""
    from repro_torch.training import compression
    cfg, cpu, _, batch = _reduced_pair("yi-6b", cuda_device)
    _, grads = _grads(cpu, batch, cfg)
    want = compression.compress_decompress(grads, method)
    got = compression.compress_decompress(
        {k: g.to(cuda_device) for k, g in grads.items()}, method)
    got = {k: g.cpu() for k, g in got.items()}
    flips = 0
    for name in want:
        flipped = _flipped(got[name], want[name], method)
        flips += int(flipped.sum())
        assert _rel_l2(got[name][~flipped], want[name][~flipped]) <= 1e-4, \
            name
    assert flips <= 1e-4 * sum(g.numel() for g in want.values()), flips
    assert compression.compressed_bytes(got, method) == \
        compression.compressed_bytes(want, method)


@pytest.mark.cuda
def test_cuda_resilient_trainer_restart_is_bitwise(cuda_device, tmp_path):
    """The crash/restart of tests/test_torch_training.py on the card with
    reduced yi-6b: a crash at step 5 of 8 and a restart from the step-4
    snapshot and the data cursor give the uninterrupted run's weights
    and AdamW moments bit for bit."""
    from repro_torch.models import get_model
    from repro_torch.training import (data, fault_tolerance, optimizer,
                                      train_loop)
    cfg = get_config("yi-6b").reduced()
    step_fn = train_loop.make_train_step(cfg, remat="none", lr=1e-3)

    def init_state():
        m = get_model(cfg).init(cfg, device=cuda_device,
                                generator=torch.Generator(
                                    device=cuda_device).manual_seed(0))
        return m, optimizer.adamw_init(dict(m.named_parameters()))

    class Batches:
        def __init__(self):
            self.p = data.TokenPipeline(cfg, batch=2, seq=16, seed=9)

        def __next__(self):
            return {k: torch.from_numpy(v).to(cuda_device)
                    for k, v in next(self.p).items()}

        def seek(self, s):
            self.p.seek(s)

        def cursor(self):
            return self.p.cursor()

    def trainer(sub, every):
        return fault_tolerance.ResilientTrainer(
            tmp_path / sub, step_fn, init_state, save_every=every,
            async_save=False)
    ref = trainer("ref", 100).run(Batches(), num_steps=8)
    with pytest.raises(RuntimeError, match="simulated crash"):
        trainer("crash", 2).run(Batches(), num_steps=8, crash_at=5)
    out = trainer("crash", 2).run(Batches(), num_steps=8)
    (m1, o1), (m2, o2) = ref["state"], out["state"]
    assert int(o1.step) == int(o2.step) == 8
    p1, p2 = dict(m1.named_parameters()), dict(m2.named_parameters())
    for name in p1:
        assert p2[name].is_cuda
        assert torch.equal(p1[name], p2[name]), name
        assert torch.equal(o1.m[name], o2.m[name]), name
        assert torch.equal(o1.v[name], o2.v[name]), name


# The fp32 products' split-TF32 GEMM (ops.linear, csrc/gemm.cu) at the
# benchmark cells' shapes, (m, n, k): image-interactive's (1024 and 4096
# tokens: q/k/v/o, gate and up, down, the patch embedding, the output
# head), the text's 77 tokens (text projection, cross k/v), video-l's
# 18,480 tokens (the K = 14,336 down product among them: its 5,376 TF32
# products an output would drift under the tensor cores' truncating sum
# if the kernel did not add its fresh accumulators on the CUDA cores),
# and ragged edges against every tile dimension.
GEMM_CASES = [
    (1024, 1536, 1536), (1024, 8960, 1536), (1024, 1536, 8960),
    (1024, 1536, 64), (1024, 64, 1536), (4096, 1536, 1536),
    (77, 1536, 1024), (77, 3072, 3072), (18480, 3072, 3072),
    (18480, 14336, 3072), (18480, 3072, 14336), (18480, 3072, 192),
    (18480, 192, 3072), (130, 196, 100), (1, 64, 64), (77, 64, 192),
]


def _gemm_operands(m, n, k, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=device)
    w = torch.randn((k, n), generator=g, device=device) * k ** -0.5
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("m, n, k", GEMM_CASES)
def test_cuda_gemm_against_fp64(cuda_device, m, n, k):
    """Within 1e-5 rel-L2 of the fp64 product, the budget of every fp32
    card case, every output finite."""
    x, w = _gemm_operands(m, n, k, cuda_device)
    y = ops.linear(x, w)
    torch.cuda.synchronize()
    exact = x.double() @ w.double()
    err = ((y.double() - exact).norm() / exact.norm()).item()
    assert y.shape == (m, n) and torch.isfinite(y).all()
    assert err <= TOL["float32"], err


@pytest.mark.cuda
def test_cuda_gemm_leading_dims_and_counts(cuda_device):
    """x (B, S, K) gives (B, S, N); each call is one launch, counted under
    the wrapper and the kernel."""
    x, w = _gemm_operands(2 * 300, 256, 512, cuda_device, seed=1)
    ops.reset_launches()
    y = ops.linear(x.view(2, 300, 512), w)
    y2 = ops.linear(x, w)
    torch.cuda.synchronize()
    assert y.shape == (2, 300, 256)
    assert torch.equal(y.view(600, 256), y2)
    assert ops.launches["linear"] == ops.kernel_launches["gemm fp32"] == 2


@pytest.mark.cuda
def test_cuda_gemm_refuses_what_it_does_not_take(cuda_device):
    """A misaligned or non-contiguous operand, K or N off a multiple of 4,
    or bf16 raises: nothing is copied, nothing falls back."""
    x, w = _gemm_operands(128, 128, 128, cuda_device)
    buf = torch.zeros(128 * 128 + 1, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        ops.linear(buf[1:].view(128, 128), w)
    with pytest.raises(ValueError, match="contiguous"):
        ops.linear(x, w.t())
    with pytest.raises(ValueError, match="multiples of 4"):
        ops.linear(x[:, :126].contiguous(), w[:126].contiguous())
    with pytest.raises(ValueError, match="float32"):
        ops.linear(x.bfloat16(), w.bfloat16())


@pytest.mark.cuda
def test_cuda_products_by_route(cuda_device):
    """``sharding.ctx.product`` on the card: an fp32 token-row product
    whose tiles fill the card launches the kernel; one that wants a
    gradient, one of batch rows and a transposed weight stay cuBLAS's,
    bit for bit, each counted by its reason; bf16 is neither launched nor
    counted."""
    from repro_torch.sharding.ctx import product
    x, w = _gemm_operands(1024, 1536, 64, cuda_device, seed=2)
    ops.reset_launches()
    y = product(x.view(1, 1024, 64), w)
    assert ops.kernel_launches["gemm fp32"] == 1
    wg = w.clone().requires_grad_(True)
    assert torch.equal(product(x, wg), x @ wg)
    assert torch.equal(product(x[:8], w), x[:8] @ w)
    wt = w.t().contiguous().t()
    assert torch.equal(product(x, wt), x @ wt)
    assert torch.equal(product(x.bfloat16(), w.bfloat16()),
                       x.bfloat16() @ w.bfloat16())
    assert ops.kernel_launches["gemm fp32"] == 1
    assert ops.library_products == {"rows": 1, "grad": 1, "dtensor": 0,
                                    "align": 1, "experts": 0}
    exact = x.double() @ w.double()
    assert ((y.view(1024, 1536).double() - exact).norm()
            / exact.norm()).item() <= TOL["float32"]


@pytest.mark.cuda
def test_cuda_gemm_runs_split_tf32(cuda_device):
    """The GEMM at every tile height holds TF32 tensor-core instructions
    (wgmma: HGMMA) in a count divisible by 3, three to each fp32 product,
    and no bf16 ones."""
    from repro_torch.kernels import build
    build.load()
    funcs = _sass_functions(build.library_path())
    found = {rows: body for rows in ops.GEMM_TILE_ROWS
             for f, body in funcs.items()
             if f"gemm_3xtf32_kernelILi{rows}E" in f}
    assert sorted(found) == sorted(ops.GEMM_TILE_ROWS), sorted(funcs)
    for rows, body in found.items():
        mma = [line for line in body.splitlines()
               if "GMMA" in line or "HMMA" in line]
        assert mma and len(mma) % 3 == 0, (rows, len(mma))
        assert all("TF32" in line for line in mma), rows
        assert "BF16" not in body, rows
