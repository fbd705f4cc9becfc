"""K4's fp32 forward on the tensor cores, its rounding in closed form on the CPU.

The card's fp32 stages (``csrc/ssd.cu``'s ``*_mma`` kernels, fp32
instances) run every product in split-TF32: each fp32 operand splits into
hi = tf32(x) and lo = tf32(x - hi) and each product is three TF32 ones.
They cannot run here, so ``ssd_fp32_model`` writes the stage-wise SSD
(``ref.ssd_chunked_ref``'s stages) out with each tensor-core product done
by ``torch_tf32.tf32_product`` on the operands the kernels split: stage 1's
(w B)^T x with w_j = dt_j exp(cum_last - cum_j) folded into B's rows
before the split, stage 3's C B^T, stage 4's C S_in and M' x with M'_ij =
(C B^T)_ij exp(cum_i - cum_j) dt_j built in fp32 before the split.  The
scan of dt A, the pass of states across chunks and the exps stay fp32, as
on the CUDA cores.

With split-TF32 (``passes=3``) y and the final state hold within 1e-5 of
the largest reference value of the JAX package's chunked jnp
``repro.models.ssm.ssd_chunked`` and of its interpret-mode Pallas kernel
``repro.kernels.ssd.ssd_scan`` where ``l`` is a multiple of the chunk, and
within K4's 1e-4 of the sequential ``ref.ssd_ref`` at ragged ``l``; one
TF32 product (``passes=1``) stays above the card's fp32 budget of 1e-4
(``chip_smoke.SSD_BUDGET``, ``tests/test_torch_cuda.py`` ``SSD_TOL``), so
the card's checks tell the two apart.  The backward kernels read the
forward's scratch (S_in and C B^T), which now carries split-TF32 error: fed
into the split-TF32 backward of ``tests/test_torch_ssd_grads.py``, every
gradient stays within 1e-5 rel-L2 of ``ref.ssd_bwd_ref``.  ``-s`` prints
every distance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd import ssd_scan  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from test_torch_ssd_grads import _ssd_bwd_rounded  # noqa: E402
from torch_tf32 import tf32_product  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401

#: the card's fp32 budget for K4's forward (max abs error over the largest
#: reference value, against the sequential ``ref.ssd_ref``)
SSD_FP32_BUDGET = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC")

#: (b, l, h, p, n, chunk): mamba2-1.3b.reduced()'s (16, 16, 16), a ragged
#: l past one full-width chunk, zamba2-7b's (64, 64, 128) and
#: mamba2-1.3b's (64, 128, 128)
CASES = [
    (2, 64, 4, 16, 16, 16),
    (2, 40, 4, 16, 16, 16),
    (1, 130, 2, 64, 128, 128),
    (1, 256, 3, 64, 64, 128),
    (1, 256, 2, 64, 128, 128),
]


def ssd_fp32_model(x, dt, A, B, C, chunk, passes):
    """``csrc/ssd.cu``'s fp32 stages in closed form, each tensor-core
    product by ``tf32_product(..., passes)``: (y, the final state, S_in
    (b, nc, h, p, n), C B^T (b, nc, i, j)), the last two as the backward
    reads them from the forward's scratch."""
    b, l, h, p = x.shape

    def product(eq, a, b_):
        return tf32_product(eq, a, b_, passes)
    xc, dtc, Bc, Cc, _, cum, _, _ = ref._ssd_chunks(x, dt, A, B, C, (),
                                                   chunk)
    # stage 1: S_c^T = sum_j (w_j B_j)^T x_j, the weight folded into B's
    # rows before the split; stage 2 in fp32
    w = torch.exp(cum[..., -1:] - cum) * dtc                 # (b, nc, h, c)
    states = product("bchjn,bcjhp->bchpn", w[..., None] * Bc[:, :, None],
                     xc)
    s_in = torch.empty_like(states)
    state = states.new_zeros(states[:, 0].shape)
    for k in range(cum.shape[1]):
        s_in[:, k] = state
        state = torch.exp(cum[:, k, :, -1])[..., None, None] * state \
            + states[:, k]
    # stage 3: C B^T; stage 4: exp(cum_i) (C_i . S_in) + M' x
    cb = product("bcin,bcjn->bcij", Cc, Bc)
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    seg = cum[..., :, None] - cum[..., None, :]               # (b,nc,h,i,j)
    decay = torch.exp(torch.where(causal, seg, torch.full_like(seg, -1e30)))
    m = cb[:, :, None] * decay * dtc[..., None, :]
    y = product("bchij,bcjhp->bcihp", m, xc)
    carried = product("bcin,bchpn->bchip", Cc, s_in)
    y = y + (torch.exp(cum)[..., None] * carried).permute(0, 1, 3, 2, 4)
    return y.reshape(b, -1, h, p)[:, :l], state, s_in, cb


def _inputs(seed, b, l, h, p, n):
    """x, dt, A, B, C, dy and dstate as numpy fp32, dt and A in Mamba2's
    published ranges (``ssm.sample_dt_a``), so the carried state and its
    gradient are not ~0."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(int(rng.integers(2**31)))
    dt, A = ssm.sample_dt_a((b, l, h), h, gen)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32)
    C = rng.standard_normal((b, l, n)).astype(np.float32)
    dy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dstate = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt.numpy(), A.numpy(), B, C), dy, dstate


def _max_rel(got, want) -> float:
    """Max abs error over the largest reference value (the card's K4
    metric)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _torch(*arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("b,l,h,p,n,chunk", CASES)
def test_ssd_fp32_split_tf32_matches_the_jax_oracles(b, l, h, p, n, chunk):
    """Split-TF32 y and final state: within 1e-5 of JAX's ``ssd_chunked``
    and of the interpret-mode ``ssd_scan`` (both chunked, as the kernels)
    where l is a multiple of the chunk; within K4's 1e-4 of the sequential
    ``ref.ssd_ref`` at every l."""
    operands, _, _ = _inputs(l + p + n, b, l, h, p, n)
    y, state, _, _ = ssd_fp32_model(*_torch(*operands), chunk, passes=3)
    assert y.dtype == torch.float32 and state.shape == (b, h, p, n)
    yr, sr = ref.ssd_ref(*_torch(*operands))
    errs = {"y ssd_ref": _max_rel(y, yr), "state ssd_ref": _max_rel(state, sr)}
    if l % chunk == 0:
        jin = tuple(jnp.asarray(a) for a in operands)
        for name, (yj, sj) in (("ssd_chunked", jssm.ssd_chunked(*jin, chunk)),
                               ("ssd_scan", ssd_scan(*jin, chunk=chunk))):
            errs[f"y {name}"] = _max_rel(y, yj)
            errs[f"state {name}"] = _max_rel(state, sj)
    print(f"ssd fp32 split-TF32 {(b, l, h, p, n, chunk)}: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    for name, err in errs.items():
        assert err <= (SSD_FP32_BUDGET if "ssd_ref" in name else 1e-5), \
            (name, err)


@pytest.mark.parametrize("b,l,h,p,n,chunk", CASES)
def test_ssd_fp32_one_tf32_product_fails_the_cards_budget(b, l, h, p, n,
                                                         chunk):
    """One TF32 product a product (the hi parts alone) puts y and the
    final state each past the card's fp32 budget against ``ref.ssd_ref``,
    and split-TF32 keeps both under a tenth of it: a kernel whose products
    lost the split fails the card's K4 checks."""
    operands, _, _ = _inputs(l + p + n, b, l, h, p, n)
    args = _torch(*operands)
    yr, sr = ref.ssd_ref(*args)
    errs = {}
    for passes in (1, 3):
        y, state, _, _ = ssd_fp32_model(*args, chunk, passes=passes)
        errs[passes] = (_max_rel(y, yr), _max_rel(state, sr))
    print(f"ssd fp32 {(b, l, h, p, n, chunk)} (y, state) vs ssd_ref: "
          f"1xTF32 {errs[1][0]:.2e}, {errs[1][1]:.2e}; 3xTF32 "
          f"{errs[3][0]:.2e}, {errs[3][1]:.2e}")
    assert min(errs[1]) > SSD_FP32_BUDGET, errs
    assert max(errs[3]) < SSD_FP32_BUDGET / 10, errs


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("b,l,h,p,n,chunk", CASES)
def test_ssd_bwd_on_the_split_tf32_forwards_scratch(b, l, h, p, n, chunk,
                                                    with_dstate):
    """The split-TF32 backward of ``tests/test_torch_ssd_grads.py`` fed
    the split-TF32 forward's S_in and C B^T, as the card's backward reads
    them from the forward's scratch: every gradient within 1e-5 rel-L2 of
    the fp32 closed form ``ref.ssd_bwd_ref``."""
    operands, dy, dstate = _inputs(l + n + 3, b, l, h, p, n)
    args = _torch(*operands, dy, dstate if with_dstate else None)
    _, _, s_in, cb = ssd_fp32_model(*args[:5], chunk, passes=3)
    got = _ssd_bwd_rounded(*args, chunk,
                           lambda eq, a, b_: tf32_product(eq, a, b_, 3),
                           fwd=(s_in, cb))
    want = ref.ssd_bwd_ref(*args, chunk=chunk)
    errs = {name: _rel_l2(g, w) for name, g, w in zip(NAMES, got, want)}
    print(f"ssd_bwd fp32 on the split-TF32 forward's scratch "
          f"{(b, l, h, p, n, chunk)}: " + ", ".join(
              f"{k} {v:.2e}" for k, v in errs.items()))
    assert max(errs.values()) <= 1e-5, errs
