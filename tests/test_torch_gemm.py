"""The fp32 products' route and rounding, on the CPU.

``ops.linear`` runs ``csrc/gemm.cu``'s split-TF32 kernel on the card
(``tests/test_torch_cuda.py`` holds it to the fp64 product there); here:
the rule that sends a product to it or leaves it to cuBLAS
(``ops.gemm_route``, a pure function of what the operands show), the
tile rule, the plain version, and the kernel's rounding in closed form
(``tests/torch_tf32.py``) at the served DiTs' contraction widths.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.sharding.ctx import product
from torch_tf32 import tf32_product

F32, BF16 = torch.float32, torch.bfloat16

# (case, dtype, device, x shape, w shape, extra facts, route): one case
# for each route and each reason the rule gives, on a card of 132 SMs
SMS = 132
ROUTES = [
    ("dit q/k/v/o at image S", F32, "cuda", (1, 1024, 1536), (1536, 1536),
     {}, "gemm"),
    ("video SwiGLU down", F32, "cuda", (1, 18480, 14336), (14336, 3072),
     {}, "gemm"),
    ("cross k/v of 77 text tokens", F32, "cuda", (1, 77, 1536),
     (1536, 1536), {}, "rows"),
    ("x_embed, 64 patch features", F32, "cuda", (1, 1024, 64), (64, 1536),
     {}, "gemm"),
    ("final_out, 64 output columns", F32, "cuda", (1, 1024, 1536),
     (1536, 64), {}, "rows"),
    ("tiles filling half the SMs", F32, "cuda", (1, 1056, 1536),
     (1536, 768), {}, "gemm"),
    ("tiles filling under half the SMs", F32, "cuda", (1, 960, 1536),
     (1536, 768), {}, "rows"),
    ("the CPU", F32, "cpu", (1, 1024, 1536), (1536, 1536), {}, "other"),
    ("meta", F32, "meta", (1, 1024, 1536), (1536, 1536), {}, "other"),
    ("bf16", BF16, "cuda", (1, 1024, 1536), (1536, 1536), {}, "other"),
    ("mixed dtypes", None, "cuda", (1, 1024, 1536), (1536, 1536), {},
     "other"),
    ("shapes x @ w refuses", F32, "cuda", (1, 1024, 1024), (1536, 1536),
     {}, "other"),
    ("a DTensor", F32, "cuda", (1, 1024, 1536), (1536, 1536),
     {"dtensor": True}, "dtensor"),
    ("expert weights (E, d, f)", F32, "cuda", (1, 8, 65, 1536),
     (8, 1536, 4096), {}, "experts"),
    ("a gradient wanted", F32, "cuda", (1, 1024, 1536), (1536, 1536),
     {"grad": True}, "grad"),
    ("adaLN modulation, batch rows", F32, "cuda", (1, 1536), (1536, 9216),
     {}, "rows"),
    ("63 rows", F32, "cuda", (63, 1536), (1536, 1536), {}, "rows"),
    ("32 output columns", F32, "cuda", (1, 1024, 1536), (1536, 32), {},
     "rows"),
    ("K not a multiple of 4", F32, "cuda", (1, 1024, 1538), (1538, 1536),
     {}, "align"),
    ("N not a multiple of 4", F32, "cuda", (1, 1024, 1536), (1536, 1538),
     {}, "align"),
    ("a transposed weight", F32, "cuda", (1, 1024, 1536), (1536, 1536),
     {"contiguous": False}, "align"),
    ("an operand off 16 bytes", F32, "cuda", (1, 1024, 1536),
     (1536, 1536), {"aligned": False}, "align"),
]


@pytest.mark.parametrize("case", ROUTES, ids=[c[0] for c in ROUTES])
def test_route_of_each_product(case):
    _, dtype, device, xs, ws, facts, want = case
    assert ops.gemm_route(dtype, device, x_shape=xs, w_shape=ws, sms=SMS,
                          **facts) == want
    assert want == "gemm" or want == "other" or \
        want in ops.LIBRARY_REASONS


def test_every_reason_has_a_case():
    assert {c[-1] for c in ROUTES} == {"gemm", "other",
                                       *ops.LIBRARY_REASONS}


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_products_take_the_plain_path_uncounted(grad):
    """On CPU tensors ``product`` is ``x @ w`` bit for bit, through
    ``ops.linear``'s plain version alike, and counts nothing."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 100, 64, generator=g, requires_grad=grad)
    w = torch.randn(64, 128, generator=g)
    ops.reset_launches()
    assert ops.product_route(x, w) == "other"
    assert torch.equal(product(x, w), x @ w)
    if not grad:
        assert torch.equal(ops.linear(x, w), x @ w)
    assert not any(ops.library_products.values())
    assert ops.launches["linear"] == ops.kernel_launches["gemm fp32"] == 0


def test_library_counter_counts_reasons_only():
    ops.reset_launches()
    for route in ("rows", "rows", "grad", "gemm", "other", "align"):
        ops.count_library(route)
    assert ops.library_products == {"rows": 2, "grad": 1, "dtensor": 0,
                                    "align": 1, "experts": 0}
    ops.reset_launches()
    assert not any(ops.library_products.values())


# (m, n, tile rows at 132 SMs): image S (1024 tokens) fills the card with
# 96-row tiles (11 x 12 = 132 tiles of q/k/v/o); image M, video and the
# SwiGLU's wide products keep 128; a product of one wave either way takes
# the smaller tiles
TILES = [(1024, 1536, 96), (1024, 8960, 96), (4096, 1536, 128),
         (4096, 8960, 128), (18480, 3072, 128), (18480, 14336, 128),
         (77, 1536, 96), (1024, 64, 96), (18480, 192, 96)]


@pytest.mark.parametrize("m, n, rows", TILES)
def test_tile_rule_at_the_cells_shapes(m, n, rows):
    assert ops.gemm_tile_rows(m, n, 132) == rows


def test_tile_rule_only_instantiated_rows():
    for m in (1, 64, 77, 1000, 1024, 4096, 18480):
        for n in (64, 192, 1536, 8960, 14336):
            for sms in (1, 78, 132):
                assert ops.gemm_tile_rows(m, n, sms) in ops.GEMM_TILE_ROWS


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


# the served DiTs' contraction widths: wan2.1's d_model and d_ff, wan2.2's
@pytest.mark.parametrize("k", [1536, 3072, 8960, 14336])
def test_split_tf32_rounding_at_the_products_widths(k):
    """The kernel's arithmetic in closed form: split-TF32 stays within
    1e-6 rel-L2 of the fp64 product at every served K, where one TF32
    product a product is over 1e-4 (the benchmark's limits are 2e-5 to
    6e-5; the kernel sums its fresh accumulators on the CUDA cores, so no
    long tensor-core sum enters here)."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((16, k), dtype=np.float32))
    w = torch.from_numpy((rng.standard_normal((k, 96)) / np.sqrt(k))
                         .astype(np.float32))
    exact = x.double() @ w.double()
    three = tf32_product("mk,kn->mn", x, w, passes=3).double()
    one = tf32_product("mk,kn->mn", x, w, passes=1).double()
    assert _rel_l2(three, exact) < 1e-6
    assert _rel_l2(one, exact) > 1e-4


def test_dit_denoise_products_by_route(monkeypatch):
    """One denoise call (``dit.forward_sp_tokens``) of the reduced DiT at
    1024 tokens, its products routed as on a card of 4 SMs, where the
    reduced widths' token rows fill the card as the full widths' fill an
    H100 (the rule told its operands lie there; ``ops.linear`` replaced
    by a counting ``x @ w``): per layer q, k, v, o, cross q and o, gate,
    up and down, with the patch embedding and the output head, take the
    kernel (9 L + 2); the 77 text tokens' products (the text projection,
    cross k and v), the modulations and the timestep MLP (batch rows)
    are left to cuBLAS (3 L + 4); the output is the plain forward's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import dit

    cfg = get_config("dit-image").reduced()
    g = torch.Generator().manual_seed(0)
    model = dit.init(cfg, generator=g, device="cpu")
    patch = cfg.dit.patch_size ** 2 * cfg.dit.in_channels   # 64
    tokens = 1024
    toks = torch.randn((1, tokens, patch), generator=g)
    txt = torch.randn((1, 77, cfg.dit.cond_dim), generator=g)
    t = torch.full((1,), 500.0)

    def forward():
        with torch.inference_mode():
            return dit.forward_sp_tokens(
                model, toks, t, txt, cfg, pos_offset=0, n_total=tokens,
                kv_gather=lambda k, v, i: (k, v))

    plain = forward()
    kernel = []

    def on_card(x, w):
        return ops.gemm_route(x.dtype if x.dtype == w.dtype else None,
                              "cuda", x_shape=x.shape, w_shape=w.shape,
                              sms=4)

    def counted(x, w):
        kernel.append((tuple(x.shape), tuple(w.shape)))
        return x @ w

    monkeypatch.setattr(ops, "product_route", on_card)
    monkeypatch.setattr(ops, "linear", counted)
    ops.reset_launches()
    routed = forward()
    layers = cfg.num_layers
    assert len(kernel) == 9 * layers + 2, kernel
    assert ops.library_products == {**dict.fromkeys(ops.LIBRARY_REASONS, 0),
                                    "rows": 3 * layers + 4}
    assert all(x[1] == tokens for x, _ in kernel), kernel
    assert torch.equal(routed, plain)
    ops.reset_launches()
