"""K4's backward (the SSD chunked-scan gradient) on the CPU.

``ref.ssd_bwd_ref`` is the closed-form plain version of ``csrc/
ssd_bwd.cu``: dx, ddt, dA, dB and dC of the SSD for an output gradient
dy and, optionally, a final-state gradient.  Its reference is ``jax.vjp``
of the JAX package's SSD, on the same numpy inputs (A and dt drawn in
Mamba2's published ranges by ``ssm.sample_dt_a``, so the state carried
across chunks and its gradient are not ~0):

* of the chunked jnp ``repro.models.ssm.ssd_chunked`` where ``l`` is a
  multiple of the chunk: both chunked, within 1e-5 of the largest
  reference value per output (largest error measured 4.4e-6, dA at
  (1, 256, 2, 64, 32, 128));
* of the sequential oracle ``repro.kernels.ref.ssd_ref`` at ragged ``l``
  (the last chunk zero-filled): two summation orders, K4's 1e-4 budget
  (largest measured 8.5e-7).

Then ``ops.ssd`` under autograd on CPU tensors: its gradients are
``ssd_bwd_ref``'s, bit for bit, with and without a final-state
gradient, and without grad it builds no graph.  Last, the rounding of the
fp32 kernels in closed form: ``ssd_bwd_ref``'s algorithm with every
product that ``csrc/ssd_bwd.cu`` runs on the tensor cores done in
split-TF32 keeps each gradient within 1e-5 rel-L2 of the fp32 closed
form; one TF32 product a product does not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401
from torch_tf32 import tf32_product  # noqa: E402

NAMES = ("dx", "ddt", "dA", "dB", "dC")


def _inputs(seed, b, l, h, p, n):
    """x, dt, A, B, C and the gradients dy, dstate, as numpy fp32."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(int(rng.integers(2**31)))
    dt, A = ssm.sample_dt_a((b, l, h), h, gen)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    B = rng.standard_normal((b, l, n)).astype(np.float32)
    C = rng.standard_normal((b, l, n)).astype(np.float32)
    dy = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dstate = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt.numpy(), A.numpy(), B, C), dy, dstate


def _close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def _jax_grads(fn, operands, dy, dstate):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in operands))
    ds = jnp.zeros_like(out[1]) if dstate is None else jnp.asarray(dstate)
    return vjp((jnp.asarray(dy), ds))


def _torch(*arrays):
    return tuple(None if a is None else torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (2, 64, 4, 16, 16, 16),       # mamba2-1.3b.reduced()'s shape
    (1, 128, 2, 16, 16, 32),
    (2, 256, 3, 32, 16, 64),
    (1, 256, 2, 64, 32, 128),
])
def test_ssd_bwd_ref_matches_the_chunked_jax_oracle(b, l, h, p, n, chunk,
                                                    with_dstate):
    operands, dy, dstate = _inputs(l + p, b, l, h, p, n)
    dstate = dstate if with_dstate else None
    got = ref.ssd_bwd_ref(*_torch(*operands, dy, dstate), chunk=chunk)
    want = _jax_grads(lambda *a: jssm.ssd_chunked(*a, chunk), operands, dy,
                      dstate)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-5, name)


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (2, 40, 4, 16, 16, 16),       # the reduced model's ragged prefill
    (1, 10, 2, 16, 16, 32),       # l < chunk: one partial chunk
    (1, 130, 2, 64, 32, 128),     # one row past the first chunk
])
def test_ssd_bwd_ref_matches_the_recurrence_at_ragged_l(b, l, h, p, n,
                                                       chunk, with_dstate):
    operands, dy, dstate = _inputs(l + 7, b, l, h, p, n)
    dstate = dstate if with_dstate else None
    got = ref.ssd_bwd_ref(*_torch(*operands, dy, dstate), chunk=chunk)
    want = _jax_grads(jref.ssd_ref, operands, dy, dstate)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, 1e-4, name)


def test_ssd_bwd_ref_carries_the_gradient_back_across_chunks():
    """dy is zero in the first chunk, so the first chunk's dx comes from
    the reverse state pass alone, and it is not negligible."""
    operands, dy, _ = _inputs(11, 1, 96, 2, 16, 16)
    operands[1][:] = 1e-3          # dt: a slow decay
    dy[:, :16] = 0
    got = ref.ssd_bwd_ref(*_torch(*operands, dy, None), chunk=16)
    want = _jax_grads(jref.ssd_ref, operands, dy, None)
    assert got[0][:, :16].abs().max() > 0.1 * got[0][:, 16:].abs().max()
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, 1e-4, name)


def test_ssd_bwd_ref_keeps_each_operands_dtype():
    operands, dy, dstate = _inputs(3, 1, 20, 2, 16, 16)
    x, dt, A, B, C = _torch(*operands)
    got = ref.ssd_bwd_ref(x.bfloat16(), dt, A, B.bfloat16(), C.bfloat16(),
                          torch.from_numpy(dy).bfloat16(),
                          torch.from_numpy(dstate), chunk=16)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    assert [g.shape for g in got] == [x.shape, dt.shape, A.shape, B.shape,
                                      C.shape]


@pytest.mark.parametrize("with_dstate", [False, True],
                         ids=["no-dstate", "dstate"])
def test_ssd_under_grad_backpropagates_through_the_plain_backward(
        with_dstate):
    """``ops.ssd`` with operands that require grad runs its autograd
    Function; on CPU tensors the forward is the sequential recurrence and
    the backward ``ref.ssd_bwd_ref``, so ``torch.autograd.grad`` gives
    its gradients exactly (the final state's only when it is used)."""
    operands, dy, dstate = _inputs(5, 2, 40, 3, 16, 16)
    leaves = [t.clone().requires_grad_(True) for t in _torch(*operands)]
    y, state = ops.ssd(*leaves, chunk=16)
    assert y.grad_fn is not None and state.grad_fn is not None
    dy_t, ds_t = _torch(dy, dstate)
    loss = (y * dy_t).sum()
    if with_dstate:
        loss = loss + (state * ds_t).sum()
    got = torch.autograd.grad(loss, leaves)
    want = ops.ssd_bwd(*_torch(*operands), dy_t,
                       ds_t if with_dstate else None, chunk=16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    want_ref = ref.ssd_bwd_ref(*_torch(*operands), dy_t,
                               ds_t if with_dstate else None, chunk=16)
    assert all(torch.equal(w, r) for w, r in zip(want, want_ref))


def test_ssd_without_grad_builds_no_graph():
    """Frozen operands, no_grad or inference mode: the plain call, no
    Function (the serving path launches what it did)."""
    operands, _, _ = _inputs(6, 1, 20, 2, 16, 16)
    x, dt, A, B, C = _torch(*operands)
    assert ops.ssd(x, dt, A, B, C, chunk=16)[0].grad_fn is None
    xg = x.clone().requires_grad_(True)
    with torch.no_grad():
        assert ops.ssd(xg, dt, A, B, C, chunk=16)[0].grad_fn is None
    with torch.inference_mode():
        assert ops.ssd(xg, dt, A, B, C, chunk=16)[0].grad_fn is None
    assert ops.ssd(xg, dt, A, B, C, chunk=16)[0].grad_fn is not None


def _ssd_bwd_rounded(x, dt, A, B, C, dy, dstate, chunk, product, fwd=None):
    """``ref.ssd_bwd_ref``'s gradients with each product that the fp32
    kernels run on the tensor cores done by ``product(eq, a, b)``, on the
    operands they split: stage 1's (exp(cum) C)^T dy; stage 3's Z = dy
    xb^T, M^T dy (M = (C B^T) L), B G, P^T C, xb G^T, P B and dy S_in^T,
    P = L Z.  The state pass, the exps and the row sums stay fp32, as on
    the CUDA cores.  ``fwd``: the (S_in (b, nc, h, p, n), C B^T (b, nc,
    i, j)) of a forward to read, as the kernels read the forward's
    scratch; else the fp32 ones."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    xc, dtc, Bc, Cc, (dyc,), cum, s_in, _ = ref._ssd_chunks(
        x, dt, A, B, C, (dy,), chunk)
    nc = cum.shape[1]
    xb = xc * dtc.transpose(2, 3)[..., None]                 # (b,nc,c,h,p)
    ec = torch.exp(cum)
    ed = torch.exp(cum[..., -1:] - cum)
    q = product("bchin,bcihp->bchpn", ec[..., None] * Cc[:, :, None], dyc)
    gn = torch.empty_like(q)
    g = q.new_zeros((b, h, p, n)) if dstate is None else dstate.float()
    for k in reversed(range(nc)):
        gn[:, k] = g
        g = torch.exp(cum[:, k, :, -1])[..., None, None] * g + q[:, k]
    causal = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    seg = cum[..., :, None] - cum[..., None, :]               # (b,nc,h,i,j)
    decay = torch.exp(torch.where(causal, seg, torch.full_like(seg, -1e30)))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)              # the forward's
    if fwd is not None:
        s_in, cb = fwd
    pm = decay * product("bcihp,bcjhp->bchij", dyc, xb)
    m = cb[:, :, None] * decay
    dxb_state = ed.transpose(2, 3)[..., None] * product(
        "bcjn,bchpn->bcjhp", Bc, gn)
    dxb = product("bchij,bcihp->bcjhp", m, dyc) + dxb_state
    dx = dxb * dtc.transpose(2, 3)[..., None]
    ddt = (xc * dxb).sum(-1).transpose(2, 3)
    dC_state = ec[..., None] * product("bcihp,bchpn->bchin", dyc, s_in)
    dC = product("bchij,bcjn->bcin", pm, Bc) + dC_state.sum(2)
    dB = product("bchij,bcin->bcjn", pm, Cc) + (ed[..., None] * product(
        "bcjhp,bchpn->bchjn", xb, gn)).sum(2)
    t = cb[:, :, None] * pm
    w = torch.einsum("bcjhp,bcjhp->bchj", xb, dxb_state)
    dcum = t.sum(-1) - t.sum(-2) - w \
        + torch.einsum("bchin,bcin->bchi", dC_state, Cc)
    dcum[..., -1] += w.sum(-1) + torch.exp(cum[..., -1]) * (
        s_in * gn).sum((-1, -2))
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    ddt = ddt + A.float()[:, None] * da
    dA = (dtc * da).sum((0, 1, 3))

    def unchunk(v, *tail):
        return v.reshape(b, -1, *tail)[:, :l]
    return (unchunk(dx, h, p), unchunk(ddt.transpose(2, 3), h), dA,
            unchunk(dB, n), unchunk(dC, n))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


#: the card's fp32 budget for K4's backward (``chip_smoke.py``,
#: ``tests/test_torch_cuda.py``): one TF32 product a product keeps dA at
#: mamba2-1.3b's (p, n, chunk) within 9.9e-5 rel-L2 (the other outputs
#: ~3e-4), inside the 1e-4 of the SSD's forward, so the backward's is
#: tightened to this; split-TF32 keeps every output under 2.3e-6 here
SSD_BWD_FP32_BUDGET = 2e-5


@pytest.mark.parametrize("passes", [3, 1], ids=["3xTF32", "1xTF32"])
@pytest.mark.parametrize("b,l,h,p,n,chunk,with_dstate", [
    (2, 64, 4, 16, 16, 16, False),    # mamba2-1.3b.reduced()'s shape
    (2, 60, 4, 16, 16, 16, True),     # ragged, the train-cpu phase's length
    (1, 130, 2, 64, 32, 128, False),  # ragged past one full-width chunk
    (1, 256, 3, 64, 64, 128, True),   # zamba2-7b's (p, n, chunk)
    (1, 256, 2, 64, 128, 128, False),  # mamba2-1.3b's
])
def test_ssd_bwd_split_tf32_within_budget(b, l, h, p, n, chunk, with_dstate,
                                          passes):
    """The fp32 kernels' split-TF32 products (three TF32 products for each
    fp32 one) keep each gradient within 1e-5 rel-L2 of the fp32 closed
    form ``ref.ssd_bwd_ref`` (and of ``jax.vjp`` of the chunked JAX SSD,
    at the lengths it takes); one TF32 product stays above
    ``SSD_BWD_FP32_BUDGET`` for every output, so the card's fp32 budget
    tells the two apart."""
    operands, dy, dstate = _inputs(l + n + 2, b, l, h, p, n)
    dstate = dstate if with_dstate else None
    args = _torch(*operands, dy, dstate)
    got = _ssd_bwd_rounded(*args, chunk,
                           lambda eq, a, b_: tf32_product(eq, a, b_, passes))
    want = ref.ssd_bwd_ref(*args, chunk=chunk)
    errs = {name: _rel_l2(g, w) for name, g, w in zip(NAMES, got, want)}
    if passes == 3:
        assert max(errs.values()) <= 1e-5, errs
        if l % chunk == 0:
            jgrads = _jax_grads(lambda *a: jssm.ssd_chunked(*a, chunk),
                                operands, dy, dstate)
            for name, g, j in zip(NAMES, got, jgrads):
                assert _rel_l2(g, j) <= 1e-5, name
    else:
        assert min(errs.values()) > SSD_BWD_FP32_BUDGET, errs
