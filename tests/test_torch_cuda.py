"""Every CUDA kernel against its plain PyTorch version, on the card.

These need a CUDA device and nvcc (the kernels have no CPU mode) and skip
elsewhere; the JAX side is not imported, so they run on a machine without
JAX:  ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Tolerance: max abs error over max abs reference, <= 1e-5 in fp32 and
<= 3e-2 in bf16 (DESIGN.md §12); the SSD scan against its sequential
plain version <= 1e-4 in fp32 (two summation orders over the sequence,
the JAX package's own kernel vs sequential bound in
``tests/test_kernels.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SSD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
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
@pytest.mark.parametrize("variant", sorted(ADALN_VARIANTS))
@pytest.mark.parametrize("d", [1536, 100, 4096])  # DiT; scalar path; widest
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
