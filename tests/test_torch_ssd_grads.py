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
gradient, and without grad it builds no graph.
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
